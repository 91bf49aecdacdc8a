"""Weights carried across from the JAX package, without JAX.

- ``state_dict_from_jax`` turns the flax variable trees, as nested dicts of
  numpy arrays, into this package's (reference-layout) state dict. It is a
  jax-free copy of ``xiangqi_alphazero_tpu/serve/export.py::
  to_torch_state_dict``: conv kernels go HWIO -> OIHW, and the two dense
  layers that follow a flatten have their input rows permuted from the NHWC
  flatten order (H, W, C) to the NCHW order (C, H, W).
- ``jax_from_state_dict`` is its inverse, a copy of
  ``xiangqi_alphazero_tpu/models/torch_import.py::convert_state_dict``: a
  reference-layout state dict back to flax-named ``params``/``batch_stats``
  trees of numpy arrays, the layout of the npz export.
- ``load_reference_pt`` reads a reference-layout ``.pt``
  (``{"model_state_dict", "config"}``), the file the JAX package's
  ``serve export --format torch`` writes and its ``Predictor`` reads.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .resnet import XiangqiNet


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))  # a writable copy


def state_dict_from_jax(
    params: Mapping, batch_stats: Mapping, blocks: int
) -> Dict[str, torch.Tensor]:
    """flax ``params``/``batch_stats`` (nested dicts of numpy arrays) ->
    reference-layout torch state dict."""
    p, s = params, batch_stats
    sd: Dict[str, torch.Tensor] = {}

    def conv(dst: str, kernel) -> None:
        sd[f"{dst}.weight"] = _t(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))

    def bn(dst: str, pp: Mapping, ss: Mapping) -> None:
        sd[f"{dst}.weight"] = _t(pp["scale"])
        sd[f"{dst}.bias"] = _t(pp["bias"])
        sd[f"{dst}.running_mean"] = _t(ss["mean"])
        sd[f"{dst}.running_var"] = _t(ss["var"])
        sd[f"{dst}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)

    def dense_pre_flatten(dst: str, kernel, bias, c: int, h: int = 10, w: int = 9) -> None:
        k = np.asarray(kernel).reshape(h, w, c, -1).transpose(3, 2, 0, 1)
        sd[f"{dst}.weight"] = _t(k.reshape(-1, c * h * w))
        sd[f"{dst}.bias"] = _t(bias)

    conv("input_conv.0", p["Conv_0"]["kernel"])
    bn("input_conv.1", p["BatchNorm_0"], s["BatchNorm_0"])
    for i in range(blocks):
        bp, bs = p[f"ResBlock_{i}"], s[f"ResBlock_{i}"]
        conv(f"res_blocks.{i}.conv1", bp["Conv_0"]["kernel"])
        conv(f"res_blocks.{i}.conv2", bp["Conv_1"]["kernel"])
        bn(f"res_blocks.{i}.bn1", bp["BatchNorm_0"], bs["BatchNorm_0"])
        bn(f"res_blocks.{i}.bn2", bp["BatchNorm_1"], bs["BatchNorm_1"])
    conv("policy_head.0", p["Conv_1"]["kernel"])
    bn("policy_head.1", p["BatchNorm_1"], s["BatchNorm_1"])
    dense_pre_flatten("policy_head.4", p["Dense_0"]["kernel"], p["Dense_0"]["bias"], 32)
    conv("value_head.0", p["Conv_2"]["kernel"])
    bn("value_head.1", p["BatchNorm_2"], s["BatchNorm_2"])
    dense_pre_flatten("value_head.4", p["Dense_1"]["kernel"], p["Dense_1"]["bias"], 4)
    sd["value_head.6.weight"] = _t(np.asarray(p["Dense_2"]["kernel"]).T)
    sd["value_head.6.bias"] = _t(p["Dense_2"]["bias"])
    return sd


def _conv_hwio(w) -> np.ndarray:
    return np.transpose(_np(w), (2, 3, 1, 0))


def _dense_after_flatten(w, c: int, h: int = 10, wd: int = 9) -> np.ndarray:
    """torch Linear weight [out, c*h*w] -> flax Dense kernel [h*w*c, out]."""
    w = _np(w)
    out = w.shape[0]
    return w.reshape(out, c, h, wd).transpose(2, 3, 1, 0).reshape(h * wd * c, out)


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def jax_from_state_dict(sd: Mapping, blocks: int) -> Dict[str, dict]:
    """Reference-layout state dict (tensors or numpy arrays) -> flax
    ``{"params", "batch_stats"}`` trees of numpy arrays (reference module
    paths, training/model.py:55-85: input_conv.{0,1},
    res_blocks.{i}.{conv1,bn1,conv2,bn2}, policy_head.{0,1,4},
    value_head.{0,1,4,6})."""
    g = lambda k: _np(sd[k])  # noqa: E731
    params: dict = {}
    stats: dict = {}

    def bn(dst: str, src: str) -> None:
        params[dst] = {"scale": g(f"{src}.weight"), "bias": g(f"{src}.bias")}
        stats[dst] = {"mean": g(f"{src}.running_mean"), "var": g(f"{src}.running_var")}

    params["Conv_0"] = {"kernel": _conv_hwio(sd["input_conv.0.weight"])}
    bn("BatchNorm_0", "input_conv.1")
    for i in range(blocks):
        blk_p: dict = {}
        blk_s: dict = {}
        blk_p["Conv_0"] = {"kernel": _conv_hwio(sd[f"res_blocks.{i}.conv1.weight"])}
        blk_p["Conv_1"] = {"kernel": _conv_hwio(sd[f"res_blocks.{i}.conv2.weight"])}
        for j, bn_name in enumerate(("bn1", "bn2")):
            blk_p[f"BatchNorm_{j}"] = {
                "scale": g(f"res_blocks.{i}.{bn_name}.weight"),
                "bias": g(f"res_blocks.{i}.{bn_name}.bias"),
            }
            blk_s[f"BatchNorm_{j}"] = {
                "mean": g(f"res_blocks.{i}.{bn_name}.running_mean"),
                "var": g(f"res_blocks.{i}.{bn_name}.running_var"),
            }
        params[f"ResBlock_{i}"] = blk_p
        stats[f"ResBlock_{i}"] = blk_s

    params["Conv_1"] = {"kernel": _conv_hwio(sd["policy_head.0.weight"])}
    bn("BatchNorm_1", "policy_head.1")
    params["Dense_0"] = {
        "kernel": _dense_after_flatten(sd["policy_head.4.weight"], 32),
        "bias": g("policy_head.4.bias"),
    }
    params["Conv_2"] = {"kernel": _conv_hwio(sd["value_head.0.weight"])}
    bn("BatchNorm_2", "value_head.1")
    params["Dense_1"] = {
        "kernel": _dense_after_flatten(sd["value_head.4.weight"], 4),
        "bias": g("value_head.4.bias"),
    }
    params["Dense_2"] = {"kernel": g("value_head.6.weight").T, "bias": g("value_head.6.bias")}
    return {"params": params, "batch_stats": stats}


def load_reference_pt(path: str) -> XiangqiNet:
    """The net stored in a reference-layout ``.pt``, in eval mode on the CPU.
    The topology comes from its ``config`` (128ch/6res when absent, as the
    JAX package's loader assumes)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    sd = payload.get("model_state_dict", payload)
    mc = payload.get("config", {})
    net = XiangqiNet(
        channels=int(mc.get("num_channels", 128)),
        blocks=int(mc.get("num_res_blocks", 6)),
    )
    net.load_state_dict(sd)
    return net.eval()
