"""Dependency-free ONNX export + execution for the policy-value topology.

The PyTorch port's own copy of ``xiangqi_alphazero_tpu.serve.onnx_lite``
(numpy only; the port imports nothing of the JAX package). The graph name
and producer strings are kept as the JAX package writes them, so the two
exporters write byte-identical files for the same weights.

The reference verifies its ONNX export by running it under onnxruntime
(reference: training/export_model.py:57-67). Where neither ``onnx`` nor
``onnxruntime`` is installed, this module writes and runs the graph without
them:

- ``write_model``: emits a genuine ONNX file (IR v7 / opset 13) by
  encoding the protobuf wire format directly — Conv / BatchNormalization /
  Relu / Add / Flatten / Gemm / Tanh nodes, dynamic batch dimension,
  input ``state`` and outputs ``policy`` / ``value`` exactly like the
  reference's torch.onnx export. Consumers with the real ``onnx`` package
  can load it unchanged.
- ``load_model`` / ``run_model``: a protobuf parser + numpy executor for
  ONNX graphs restricted to that op set (plus MatMul / Reshape /
  Identity), used by ``serve.export.verify_export`` as the onnxruntime
  fallback. It executes any such file, including ones produced by the
  reference's own exporter.

Weight layout comes in as a reference-layout torch state dict (numpy
values), the layout of the port's net (``models/resnet.py``), so the ONNX
artifact and the ``.pt`` artifact hold the same arrays.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

# ---------------------------------------------------------------------------
# protobuf wire-format encoding (the subset ONNX needs)
# ---------------------------------------------------------------------------

_F32, _I64 = 1, 7  # TensorProto.DataType


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1  # two's-complement for negative int64
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_field(field: int, data: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(data)) + data


def _str_field(field: int, s: str) -> bytes:
    return _len_field(field, s.encode())


def _int_field(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v)


def _float_field(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _tensor(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.float32:
        dt = _F32
    elif arr.dtype == np.int64:
        dt = _I64
    else:
        raise TypeError(f"unsupported tensor dtype {arr.dtype}")
    body = b"".join(_int_field(1, d) for d in arr.shape)
    body += _int_field(2, dt)
    body += _str_field(8, name)
    body += _len_field(9, arr.tobytes())
    return body


def _attr_int(name: str, v: int) -> bytes:
    return _str_field(1, name) + _int_field(3, v) + _int_field(20, 2)


def _attr_ints(name: str, vs: Sequence[int]) -> bytes:
    body = _str_field(1, name)
    body += b"".join(_int_field(8, v) for v in vs)
    return body + _int_field(20, 7)


def _attr_float(name: str, v: float) -> bytes:
    return _str_field(1, name) + _float_field(2, v) + _int_field(20, 1)


def _node(
    op: str,
    inputs: Sequence[str],
    outputs: Sequence[str],
    attrs: Sequence[bytes] = (),
) -> bytes:
    body = b"".join(_str_field(1, i) for i in inputs)
    body += b"".join(_str_field(2, o) for o in outputs)
    body += _str_field(4, op)
    body += b"".join(_len_field(5, a) for a in attrs)
    return body


def _value_info(name: str, shape: Sequence[Union[int, str]]) -> bytes:
    dims = b""
    for d in shape:
        dim = _str_field(2, d) if isinstance(d, str) else _int_field(1, d)
        dims += _len_field(1, dim)
    tensor_type = _int_field(1, _F32) + _len_field(2, dims)
    type_proto = _len_field(1, tensor_type)
    return _str_field(1, name) + _len_field(2, type_proto)


# ---------------------------------------------------------------------------
# writer: the fixed XiangqiNet topology as an opset-13 graph
# ---------------------------------------------------------------------------


def write_model(
    path: str, state_dict: Dict[str, np.ndarray], channels: int, blocks: int
) -> str:
    """Write the network as ONNX. ``state_dict`` uses the reference torch
    names/layout (the port's ``XiangqiNet.state_dict()``), values as numpy."""
    sd = {k: np.asarray(v, np.float32) for k, v in state_dict.items()}
    nodes: List[bytes] = []
    inits: List[bytes] = []

    def conv(x: str, y: str, prefix: str, kernel: Tuple[int, int]) -> None:
        w = f"{prefix}.weight"
        inits.append(_tensor(w, sd[w]))
        pad = kernel[0] // 2
        nodes.append(
            _node(
                "Conv",
                [x, w],
                [y],
                [
                    _attr_ints("kernel_shape", list(kernel)),
                    _attr_ints("pads", [pad, pad, pad, pad]),
                    _attr_ints("strides", [1, 1]),
                    _attr_ints("dilations", [1, 1]),
                    _attr_int("group", 1),
                ],
            )
        )

    def bn(x: str, y: str, prefix: str) -> None:
        names = []
        for suffix in ("weight", "bias", "running_mean", "running_var"):
            n = f"{prefix}.{suffix}"
            inits.append(_tensor(n, sd[n]))
            names.append(n)
        nodes.append(
            _node(
                "BatchNormalization",
                [x] + names,
                [y],
                [_attr_float("epsilon", 1e-5)],
            )
        )

    def relu(x: str, y: str) -> None:
        nodes.append(_node("Relu", [x], [y]))

    def gemm(x: str, y: str, prefix: str) -> None:
        w, b = f"{prefix}.weight", f"{prefix}.bias"
        inits.append(_tensor(w, sd[w]))
        inits.append(_tensor(b, sd[b]))
        nodes.append(_node("Gemm", [x, w, b], [y], [_attr_int("transB", 1)]))

    conv("state", "in.conv", "input_conv.0", (3, 3))
    bn("in.conv", "in.bn", "input_conv.1")
    relu("in.bn", "trunk0")
    x = "trunk0"
    for i in range(blocks):
        p = f"res_blocks.{i}"
        conv(x, f"{p}.c1", f"{p}.conv1", (3, 3))
        bn(f"{p}.c1", f"{p}.b1", f"{p}.bn1")
        relu(f"{p}.b1", f"{p}.r1")
        conv(f"{p}.r1", f"{p}.c2", f"{p}.conv2", (3, 3))
        bn(f"{p}.c2", f"{p}.b2", f"{p}.bn2")
        nodes.append(_node("Add", [f"{p}.b2", x], [f"{p}.sum"]))
        relu(f"{p}.sum", f"trunk{i + 1}")
        x = f"trunk{i + 1}"

    conv(x, "p.conv", "policy_head.0", (1, 1))
    bn("p.conv", "p.bn", "policy_head.1")
    relu("p.bn", "p.relu")
    nodes.append(_node("Flatten", ["p.relu"], ["p.flat"], [_attr_int("axis", 1)]))
    gemm("p.flat", "policy", "policy_head.4")

    conv(x, "v.conv", "value_head.0", (1, 1))
    bn("v.conv", "v.bn", "value_head.1")
    relu("v.bn", "v.relu")
    nodes.append(_node("Flatten", ["v.relu"], ["v.flat"], [_attr_int("axis", 1)]))
    gemm("v.flat", "v.fc1", "value_head.4")
    relu("v.fc1", "v.r1")
    gemm("v.r1", "v.fc2", "value_head.6")
    nodes.append(_node("Tanh", ["v.fc2"], ["value"]))

    graph = b"".join(_len_field(1, n) for n in nodes)
    # the JAX package's names, kept for byte-identical files
    graph += _str_field(2, "xiangqi_alphazero_tpu")
    graph += b"".join(_len_field(5, t) for t in inits)
    graph += _len_field(11, _value_info("state", ["batch", 15, 10, 9]))
    graph += _len_field(12, _value_info("policy", ["batch", 8100]))
    graph += _len_field(12, _value_info("value", ["batch", 1]))

    model = _int_field(1, 7)  # IR version 7 <-> opset 13
    model += _str_field(2, "xiangqi_alphazero_tpu.onnx_lite")
    model += _len_field(8, _int_field(2, 13))  # opset_import {version: 13}
    model += _len_field(7, graph)
    with open(path, "wb") as f:
        f.write(model)
    return path


# ---------------------------------------------------------------------------
# parser: protobuf wire format -> message dicts
# ---------------------------------------------------------------------------


def _decode(buf: bytes) -> List[Tuple[int, int, Union[int, bytes]]]:
    """Decode one message into (field, wire, value) records."""
    out = []
    i, n = 0, len(buf)
    while i < n:
        key, shift = 0, 0
        while True:
            b = buf[i]
            i += 1
            key |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        field, wire = key >> 3, key & 7
        if wire == 0:  # varint
            v, shift = 0, 0
            while True:
                b = buf[i]
                i += 1
                v |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            out.append((field, wire, v))
        elif wire == 2:  # length-delimited
            ln, shift = 0, 0
            while True:
                b = buf[i]
                i += 1
                ln |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            out.append((field, wire, buf[i : i + ln]))
            i += ln
        elif wire == 5:  # fixed32
            out.append((field, wire, buf[i : i + 4]))
            i += 4
        elif wire == 1:  # fixed64
            out.append((field, wire, buf[i : i + 8]))
            i += 8
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
    return out


def _fields(buf: bytes, field: int) -> List[Union[int, bytes]]:
    return [v for f, _, v in _decode(buf) if f == field]


def _first(buf: bytes, field: int, default=None):
    vals = _fields(buf, field)
    return vals[0] if vals else default


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims = [int(v) for v in _fields(buf, 1)]
    dtype = int(_first(buf, 2, _F32))
    name = _first(buf, 8, b"").decode()
    raw = _first(buf, 9)
    np_dt = {_F32: np.float32, _I64: np.int64}[dtype]
    if raw is not None:
        arr = np.frombuffer(raw, np_dt).reshape(dims).copy()
    elif dtype == _F32:  # packed float_data (field 4)
        data = _first(buf, 4, b"")
        arr = np.frombuffer(data, np.float32).reshape(dims).copy()
    else:  # packed int64_data (field 7)
        data = _first(buf, 7, b"")
        vals, i = [], 0
        while i < len(data):
            v, shift = 0, 0
            while True:
                b = data[i]
                i += 1
                v |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            if v >= 1 << 63:
                v -= 1 << 64
            vals.append(v)
        arr = np.asarray(vals, np.int64).reshape(dims)
    return name, arr


def _parse_attrs(node_buf: bytes) -> Dict[str, Union[int, float, list, np.ndarray]]:
    attrs = {}
    for a in _fields(node_buf, 5):
        name = _first(a, 1, b"").decode()
        atype = int(_first(a, 20, 0))
        if atype == 1:  # FLOAT
            attrs[name] = struct.unpack("<f", _first(a, 2))[0]
        elif atype == 2:  # INT
            v = int(_first(a, 3, 0))
            attrs[name] = v - (1 << 64) if v >= 1 << 63 else v
        elif atype == 4:  # TENSOR
            attrs[name] = _parse_tensor(_first(a, 5))[1]
        elif atype == 7:  # INTS
            attrs[name] = [
                int(v) - (1 << 64) if int(v) >= 1 << 63 else int(v)
                for v in _fields(a, 8)
            ]
        # other types unused by this op set
    return attrs


def load_model(path: str) -> Dict:
    """Parse an ONNX file into {nodes, initializers, inputs, outputs}."""
    with open(path, "rb") as f:
        buf = f.read()
    graph = _first(buf, 7)
    if graph is None:
        raise ValueError(f"{path}: no graph in ONNX model")
    nodes = []
    for nb in _fields(graph, 1):
        nodes.append(
            {
                "op": _first(nb, 4, b"").decode(),
                "inputs": [v.decode() for v in _fields(nb, 1)],
                "outputs": [v.decode() for v in _fields(nb, 2)],
                "attrs": _parse_attrs(nb),
            }
        )
    inits = dict(_parse_tensor(t) for t in _fields(graph, 5))
    inputs = [_first(vi, 1, b"").decode() for vi in _fields(graph, 11)]
    outputs = [_first(vi, 1, b"").decode() for vi in _fields(graph, 12)]
    return {"nodes": nodes, "initializers": inits,
            "inputs": inputs, "outputs": outputs}


# ---------------------------------------------------------------------------
# numpy executor
# ---------------------------------------------------------------------------


def _run_conv(x, w, b, attrs):
    strides = attrs.get("strides", [1, 1])
    pads = attrs.get("pads", [0, 0, 0, 0])
    dil = attrs.get("dilations", [1, 1])
    if attrs.get("group", 1) != 1 or dil != [1, 1]:
        raise NotImplementedError("grouped/dilated Conv not supported")
    n, c, h, wd = x.shape
    m, _, kh, kw = w.shape
    ph0, pw0, ph1, pw1 = pads
    sh, sw = strides
    xp = np.pad(x, ((0, 0), (0, 0), (ph0, ph1), (pw0, pw1)))
    ho = (h + ph0 + ph1 - kh) // sh + 1
    wo = (wd + pw0 + pw1 - kw) // sw + 1
    out = np.zeros((n, m, ho, wo), np.float32)
    for i in range(kh):
        for j in range(kw):
            patch = xp[:, :, i : i + ho * sh : sh, j : j + wo * sw : sw]
            out += np.einsum("nchw,mc->nmhw", patch, w[:, :, i, j])
    if b is not None:
        out += b.reshape(1, -1, 1, 1)
    return out


def run_model(model: Dict, feeds: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Execute a parsed graph on numpy inputs; returns the graph outputs."""
    env: Dict[str, np.ndarray] = dict(model["initializers"])
    env.update({k: np.asarray(v) for k, v in feeds.items()})
    for nd in model["nodes"]:
        op, ins, attrs = nd["op"], nd["inputs"], nd["attrs"]
        a = [env[i] if i else None for i in ins]
        if op == "Conv":
            y = _run_conv(a[0], a[1], a[2] if len(a) > 2 else None, attrs)
        elif op == "BatchNormalization":
            x, scale, bias, mean, var = a[:5]
            eps = attrs.get("epsilon", 1e-5)
            shape = (1, -1) + (1,) * (x.ndim - 2)
            y = (x - mean.reshape(shape)) / np.sqrt(
                var.reshape(shape) + eps
            ) * scale.reshape(shape) + bias.reshape(shape)
        elif op == "Relu":
            y = np.maximum(a[0], 0)
        elif op == "Add":
            y = a[0] + a[1]
        elif op == "Flatten":
            axis = attrs.get("axis", 1)
            lead = int(np.prod(a[0].shape[:axis])) if axis else 1
            y = a[0].reshape(lead, -1)
        elif op == "Gemm":
            A = a[0].T if attrs.get("transA", 0) else a[0]
            B = a[1].T if attrs.get("transB", 0) else a[1]
            y = attrs.get("alpha", 1.0) * (A @ B)
            if len(a) > 2 and a[2] is not None:
                y = y + attrs.get("beta", 1.0) * a[2]
        elif op == "MatMul":
            y = a[0] @ a[1]
        elif op == "Tanh":
            y = np.tanh(a[0])
        elif op == "Sigmoid":
            y = 1.0 / (1.0 + np.exp(-a[0]))
        elif op == "Identity":
            y = a[0]
        elif op == "Reshape":
            shape = [int(s) for s in np.asarray(a[1]).ravel()]
            shape = [
                a[0].shape[i] if s == 0 else s for i, s in enumerate(shape)
            ]
            y = a[0].reshape(shape)
        elif op == "Constant":
            y = attrs["value"]
        else:
            raise NotImplementedError(f"onnx_lite walker: op {op!r}")
        env[nd["outputs"][0]] = np.asarray(y, np.float32) if y.dtype != np.int64 else y
    return {o: env[o] for o in model["outputs"]}


def run_file(path: str, feeds: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return run_model(load_model(path), feeds)
