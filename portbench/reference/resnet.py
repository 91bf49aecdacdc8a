"""Plain PyTorch forward of the Xiangqi policy-value ResNet.

The network of the public reference (wenjunyang/xiangqi-alphazero,
training/model.py:39-107): input conv 15 -> C (3x3, no bias) + batch norm +
ReLU; ``blocks`` residual blocks of two 3x3 convs with batch norm, the
identity added before the second ReLU; a policy head conv 1x1 -> 32 + batch
norm + ReLU + dense 2880 -> 8100; a value head conv 1x1 -> 4 + batch norm +
ReLU + dense 360 -> 128 + ReLU + dense 128 -> 1 + tanh. The heads flatten
in (channel, row, column) order. Batch norm has eps 1e-5.

Parameters are a flat dict in the reference's state-dict layout (the names
below), float32. Nothing here imports the program under test.

``quant`` (the control of the correctness check) rounds the operands of
every convolution and dense layer, and their gradients, before they are
used; the default runs them as given.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

ROWS, COLS, PLANES = 10, 9, 15
ACTION_SPACE = 8100
POLICY_CH, VALUE_CH, VALUE_HIDDEN = 32, 4, 128
BN_EPS = 1e-5


def layers(channels: int, blocks: int) -> List[Tuple[str, str, tuple]]:
    """(name, kind, weight shape) of every layer in forward order; kind is
    ``conv``, ``dense`` or ``bn`` (shape ``(channels,)``)."""
    c = channels
    out = [("input_conv.0", "conv", (c, PLANES, 3, 3)), ("input_conv.1", "bn", (c,))]
    for i in range(blocks):
        p = f"res_blocks.{i}"
        out += [(f"{p}.conv1", "conv", (c, c, 3, 3)), (f"{p}.bn1", "bn", (c,)),
                (f"{p}.conv2", "conv", (c, c, 3, 3)), (f"{p}.bn2", "bn", (c,))]
    out += [("policy_head.0", "conv", (POLICY_CH, c, 1, 1)), ("policy_head.1", "bn", (POLICY_CH,)),
            ("policy_head.4", "dense", (ACTION_SPACE, POLICY_CH * ROWS * COLS)),
            ("value_head.0", "conv", (VALUE_CH, c, 1, 1)), ("value_head.1", "bn", (VALUE_CH,)),
            ("value_head.4", "dense", (VALUE_HIDDEN, VALUE_CH * ROWS * COLS)),
            ("value_head.6", "dense", (1, VALUE_HIDDEN))]
    return out


def trainable_names(channels: int, blocks: int) -> List[str]:
    """Names of the trainable leaves, in the module's parameter order."""
    names = []
    for name, kind, _ in layers(channels, blocks):
        if kind == "conv":
            names.append(f"{name}.weight")
        else:
            names += [f"{name}.weight", f"{name}.bias"]
    return names


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def forward(params: Dict[str, torch.Tensor], feats: torch.Tensor, train: bool,
            quant: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits f32[B, 8100], value f32[B]) of NHWC features f32[B, 10, 9, 15].
    ``train``: batch norm by the batch's own statistics, else by the running
    ones."""
    q = quant or _identity
    P = params

    def conv(x, name, pad):
        return F.conv2d(q(x), q(P[f"{name}.weight"]), padding=pad)

    def bn(x, name):
        return F.batch_norm(x, None if train else P[f"{name}.running_mean"],
                            None if train else P[f"{name}.running_var"],
                            P[f"{name}.weight"], P[f"{name}.bias"], train, 0.0, BN_EPS)

    def dense(x, name):
        return F.linear(q(x), q(P[f"{name}.weight"]), P[f"{name}.bias"])

    x = feats.permute(0, 3, 1, 2)
    y = torch.relu(bn(conv(x, "input_conv.0", 1), "input_conv.1"))
    i = 0
    while f"res_blocks.{i}.conv1.weight" in P:
        p = f"res_blocks.{i}"
        h = torch.relu(bn(conv(y, f"{p}.conv1", 1), f"{p}.bn1"))
        y = torch.relu(bn(conv(h, f"{p}.conv2", 1), f"{p}.bn2") + y)
        i += 1
    ph = torch.relu(bn(conv(y, "policy_head.0", 0), "policy_head.1")).flatten(1)
    logits = dense(ph, "policy_head.4")
    vh = torch.relu(bn(conv(y, "value_head.0", 0), "value_head.1")).flatten(1)
    value = torch.tanh(dense(torch.relu(dense(vh, "value_head.4")), "value_head.6"))
    return logits, value[:, 0]


class _Fp8(torch.autograd.Function):
    """Round to float8 with one scale per tensor (its largest magnitude at
    the format's largest finite value): values to e4m3 on the way forward,
    gradients to e5m2 on the way back, as float8 training keeps them."""

    @staticmethod
    def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        top = torch.finfo(dtype).max
        scale = x.abs().amax().clamp(min=1e-30) / top
        return (x / scale).to(dtype).float() * scale

    @staticmethod
    def forward(ctx, x):
        return _Fp8._round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _Fp8._round(g, torch.float8_e5m2)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float8 (``_Fp8``), returned in float32: the control's
    rounding of every convolution's and dense layer's operands."""
    return _Fp8.apply(x)
