"""Model export (reference: training/export_model.py).

Port of ``xiangqi_alphazero_tpu.serve.export``. Every function takes the
port's net (``models/resnet.py::XiangqiNet``), whose module names are the
reference's, and writes the same files as the JAX exporter does for the
same weights:

- ``export_npz``: the flax-named ``params/...`` and ``batch_stats/...``
  arrays (``models/convert.py::jax_from_state_dict``) plus the JSON
  architecture manifest, with the JAX package's ``"format"`` string, so the
  archives interoperate.
- ``export_torch_checkpoint``: a reference-layout ``.pt``, the net's own
  state dict plus its ``config``.
- ``export_torchscript``: a trace of the reference forward (NCHW input
  ``[B, 15, 10, 9]``, as the reference's TorchScript takes).
- ``export_onnx``: opset 13 through ``torch.onnx`` when the ``onnx``
  package is present, else the dependency-free writer ``onnx_lite``.
- ``verify_export``: loads an artifact back from disk and holds its
  forward against the port's own float32 forward of the net, with TF32
  off on the card.

Every artifact is written from a float32 copy of the net on the CPU, so
the files do not depend on the device the net was trained or served on.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
from typing import Dict

import numpy as np
import torch
import torch.nn as nn

from ..models import XiangqiNet, jax_from_state_dict, state_dict_from_jax

NPZ_FORMAT = "xiangqi_alphazero_tpu.npz.v1"   # the JAX exporter's format string


def model_config(net: XiangqiNet) -> Dict[str, int]:
    """The topology the exporters record, in the JAX CLI's key order."""
    return {"num_channels": net.channels, "num_res_blocks": net.blocks}


def _cpu_state_dict(net: XiangqiNet) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in net.state_dict().items()}


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def export_npz(path: str, net: XiangqiNet) -> str:
    """Portable archive: flattened flax-named arrays + architecture manifest
    (``<path without extension>.manifest.json``)."""
    tree = jax_from_state_dict(_cpu_state_dict(net), net.blocks)
    arrays = {f"params/{k}": v for k, v in _flatten(tree["params"]).items()}
    arrays.update({f"batch_stats/{k}": v for k, v in _flatten(tree["batch_stats"]).items()})
    np.savez_compressed(path, **arrays)
    manifest = {
        "format": NPZ_FORMAT,
        "model": model_config(net),
        "arrays": sorted(arrays),
        "input": {"name": "state", "shape": [None, 10, 9, 15], "layout": "NHWC"},
        "outputs": [
            {"name": "policy", "shape": [None, 8100]},
            {"name": "value", "shape": [None, 1]},
        ],
    }
    with open(os.path.splitext(path)[0] + ".manifest.json", "w") as f:
        json.dump(manifest, f, indent=2)
    return path


def export_torch_checkpoint(path: str, net: XiangqiNet, iteration: int = 0) -> str:
    """Write a reference-compatible ``.pt`` (loadable by the reference demo
    and its export_model.py, by the JAX package and by this one)."""
    torch.save(
        {"model_state_dict": _cpu_state_dict(net), "config": model_config(net),
         "iteration": iteration},
        path,
    )
    return path


class ReferenceForward(nn.Module):
    """The reference's forward over the port net's modules: NCHW input
    ``[B, 15, 10, 9]``, outputs (policy logits ``[B, 8100]``, value
    ``[B, 1]``). Its state dict keys are the net's."""

    def __init__(self, net: XiangqiNet):
        super().__init__()
        self.input_conv = net.input_conv
        self.res_blocks = net.res_blocks
        self.policy_head = net.policy_head
        self.value_head = net.value_head

    def forward(self, x: torch.Tensor):
        y = self.input_conv(x)
        for block in self.res_blocks:
            y = block(y)
        return self.policy_head(y), self.value_head(y)


def _reference_module(net: XiangqiNet) -> ReferenceForward:
    """A float32 CPU copy of ``net`` in eval mode, as the reference module."""
    return ReferenceForward(copy.deepcopy(net).float().cpu().eval()).eval()


def export_torchscript(path: str, net: XiangqiNet) -> str:
    """TorchScript trace (reference: export_model.py:71-87) of the weights."""
    traced = torch.jit.trace(_reference_module(net), torch.zeros(1, 15, 10, 9))
    traced.save(path)
    return path


def export_onnx(path: str, net: XiangqiNet) -> str:
    """ONNX export (reference: export_model.py:35-49): opset 13, dynamic
    batch axis, input 'state', outputs 'policy'/'value'. Uses the legacy
    TorchScript exporter when the ``onnx`` package is present, else the
    dependency-free protobuf writer in ``onnx_lite``, which emits the same
    opset-13 graph for this fixed topology."""
    try:
        import onnx  # noqa: F401 - serialization backend of the exporter
    except ImportError:
        from . import onnx_lite

        np_sd = {k: v.numpy() for k, v in _cpu_state_dict(net).items()
                 if "num_batches" not in k}
        return onnx_lite.write_model(path, np_sd, net.channels, net.blocks)

    torch.onnx.export(
        _reference_module(net),
        (torch.zeros(1, 15, 10, 9),),
        path,
        input_names=["state"],
        output_names=["policy", "value"],
        dynamic_axes={"state": {0: "batch"}, "policy": {0: "batch"}, "value": {0: "batch"}},
        opset_version=13,
        dynamo=False,
    )
    return path


@contextlib.contextmanager
def full_float32():
    """TF32 off for cuDNN convolutions and for matmuls, restored after.

    The ground truth of a verification is the net's float32 forward: on
    trained weights a reduced-precision forward drifted to max|dlogits| 1.31
    in the JAX package and failed a correct artifact
    (``xiangqi_alphazero_tpu/serve/export.py:213-236``)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _port_forward(net: XiangqiNet, x_nchw: np.ndarray, device) -> tuple:
    """(logits, value[B]) of a float32 copy of ``net`` on ``device``."""
    n = copy.deepcopy(net).float().to(device).eval()
    n.dtype = torch.float32
    x = torch.from_numpy(np.ascontiguousarray(x_nchw.transpose(0, 2, 3, 1))).to(device)
    with torch.no_grad():
        logits, value = n(x)
    return logits.cpu().numpy(), value.cpu().numpy().reshape(-1)


def verify_export(fmt: str, path: str, net: XiangqiNet, atol: float = 2e-3,
                  device=None) -> Dict[str, float]:
    """Numerically verify an exported artifact against the port's float32
    forward of ``net`` on fixed random inputs (reference:
    export_model.py:57-67 smoke-verifies its ONNX with onnxruntime). Loads
    the artifact BACK from disk and runs it: the ``.pt`` and the npz in the
    port's net and TorchScript through ``torch.jit.load``, on ``device``
    (the net's own by default); ONNX under onnxruntime when installed, else
    the ``onnx_lite`` numpy walker. Raises AssertionError on divergence;
    returns the max abs diffs.

    fmt: 'torch' | 'torchscript' | 'onnx' | 'npz'."""
    if fmt not in ("torch", "torchscript", "onnx", "npz"):
        raise ValueError(f"unknown export format {fmt!r}")
    dev = torch.device(device) if device is not None else next(net.parameters()).device
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 15, 10, 9)).astype(np.float32)
    with full_float32():
        want_logits, want_value = _port_forward(net, x, dev)
        if fmt == "npz":
            tree: Dict[str, dict] = {"params": {}, "batch_stats": {}}
            with np.load(path) as data:
                for key in data.files:
                    node = tree
                    parts = key.split("/")
                    for part in parts[:-1]:
                        node = node.setdefault(part, {})
                    node[parts[-1]] = data[key]
            loaded = XiangqiNet(net.channels, net.blocks)
            loaded.load_state_dict(
                state_dict_from_jax(tree["params"], tree["batch_stats"], net.blocks))
            got_logits, got_value = _port_forward(loaded, x, dev)
        elif fmt == "torch":
            ck = torch.load(path, map_location="cpu", weights_only=True)
            loaded = XiangqiNet(int(ck["config"]["num_channels"]),
                                int(ck["config"]["num_res_blocks"]))
            loaded.load_state_dict(ck["model_state_dict"])
            got_logits, got_value = _port_forward(loaded, x, dev)
        elif fmt == "torchscript":
            module = torch.jit.load(path, map_location=dev).eval()
            with torch.no_grad():
                pol, val = module(torch.from_numpy(x).to(dev))
            got_logits, got_value = pol.cpu().numpy(), val.cpu().numpy().reshape(-1)
        else:
            try:
                import onnxruntime as ort

                sess = ort.InferenceSession(path, providers=["CPUExecutionProvider"])
                pol, val = sess.run(["policy", "value"], {"state": x})
            except ImportError:
                from . import onnx_lite

                out = onnx_lite.run_file(path, {"state": x})
                pol, val = out["policy"], out["value"]
            got_logits, got_value = np.asarray(pol), np.asarray(val).reshape(-1)

    diff_logits = float(np.max(np.abs(got_logits - want_logits)))
    diff_value = float(np.max(np.abs(got_value - want_value)))
    if not (diff_logits <= atol and diff_value <= atol):
        raise AssertionError(
            f"{fmt} export diverges from the net's float32 forward: "
            f"max|dlogits|={diff_logits:.2e} max|dvalue|={diff_value:.2e}"
        )
    return {"max_abs_dlogits": diff_logits, "max_abs_dvalue": diff_value}


EXPORTERS = {
    "npz": export_npz,
    "torch": export_torch_checkpoint,
    "torchscript": export_torchscript,
    "onnx": export_onnx,
}
