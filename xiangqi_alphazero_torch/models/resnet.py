"""Policy-value ResNet for Xiangqi as a PyTorch module.

Port of ``xiangqi_alphazero_tpu.models.resnet`` with the same topology
(reference: training/model.py:39-107): input conv 15->C (3x3) + BN + ReLU, a
C-channel residual tower xN (two 3x3 convs with BN, identity add, ReLU), a
policy head conv1x1->32 + BN + ReLU + dense to 8100 logits, a value head
conv1x1->4 + BN + ReLU + dense 128 + ReLU + dense 1 + tanh. Defaults C=128,
N=6.

- The module names are the reference's (``input_conv.*``,
  ``res_blocks.{i}.conv1/bn1/conv2/bn2``, ``policy_head.{0,1,4}``,
  ``value_head.{0,1,4,6}``), so a reference-layout ``.pt`` loads with a
  plain ``load_state_dict``.
- The input is NHWC float [B, 10, 9, 15] like the JAX net; it is permuted
  to NCHW inside, and the heads flatten in NCHW order, as the reference
  layout's dense weights expect.
- BatchNorm eps is 1e-5; flax ``momentum=0.9`` is torch ``momentum=0.1``.
  In training mode the running variance is updated with the batch's biased
  variance, as flax does (``BatchNorm2d``); torch's own layer would use the
  unbiased one.
- ``init_net`` draws flax's initial distributions (``lecun_normal``
  kernels, zero biases) from an explicit ``torch.Generator``.
- ``dtype`` is the compute type (autocast); parameters stay float32 and the
  head outputs are float32. Convolutions and the dense layers run on cuDNN
  and ``torch.matmul``, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

ACTION_SPACE = 8100
ROWS, COLS, PLANES = 10, 9, 15


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's running statistics: a training batch
    is normalized by its mean and biased variance, and the running variance
    moves toward that same biased variance (torch's layer moves it toward
    the unbiased one, n / (n - 1) times larger). Evaluation mode is torch's
    own. The state dict keys are ``nn.BatchNorm2d``'s.

    ``process_group`` (None: the local batch) makes a training batch the
    global batch of that group's ranks: the data-parallel learner sets it
    (``parallel/sharding.py::set_bn_group``), as JAX's sharded step
    normalises by the whole sharded batch."""

    process_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.process_group is not None:
            from ..parallel.sharding import global_batch_norm

            return global_batch_norm(self, x)
        # torch moves a running variance to (1 - m) old + m u, u the unbiased
        # variance; weighing that 1 - 1/n against (1 - m) old gives
        # (1 - m) old + m u (n - 1) / n, the biased variance's update. The
        # op keeps the variance it updates for its backward: it gets a copy.
        n = x.numel() // x.shape[1]
        var = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, var, self.weight, self.bias,
                         True, self.momentum, self.eps)
        with torch.no_grad():
            self.running_var.mul_(1.0 - self.momentum).lerp_(var, 1.0 - 1.0 / n)
        return y


def _bn(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=1e-5, momentum=0.1)


class ResBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1, bias=False)
        self.bn1 = _bn(channels)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1, bias=False)
        self.bn2 = _bn(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(self.bn2(self.conv2(y)) + x)


class XiangqiNet(nn.Module):
    """Policy-value net. Input NHWC float [B, 10, 9, 15]; returns
    (logits float32[B, 8100], value float32[B, 1])."""

    def __init__(self, channels: int = 128, blocks: int = 6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.channels = int(channels)
        self.blocks = int(blocks)
        self.dtype = dtype
        self.input_conv = nn.Sequential(
            nn.Conv2d(PLANES, channels, 3, padding=1, bias=False),
            _bn(channels),
            nn.ReLU(),
        )
        self.res_blocks = nn.ModuleList(ResBlock(channels) for _ in range(blocks))
        self.policy_head = nn.Sequential(
            nn.Conv2d(channels, 32, 1, bias=False),
            _bn(32),
            nn.ReLU(),
            nn.Flatten(),
            nn.Linear(32 * ROWS * COLS, ACTION_SPACE),
        )
        self.value_head = nn.Sequential(
            nn.Conv2d(channels, 4, 1, bias=False),
            _bn(4),
            nn.ReLU(),
            nn.Flatten(),
            nn.Linear(4 * ROWS * COLS, 128),
            nn.ReLU(),
            nn.Linear(128, 1),
            nn.Tanh(),
        )

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.permute(0, 3, 1, 2)   # NHWC -> NCHW
        with torch.autocast(
            x.device.type, dtype=self.dtype, enabled=self.dtype != torch.float32
        ):
            y = self.input_conv(x)
            for block in self.res_blocks:
                y = block(y)
            logits = self.policy_head(y)
            value = self.value_head(y)
        return logits.float(), value.float()


# flax's lecun_normal: a normal truncated at two standard deviations, scaled
# so that the truncated draw has variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def _truncated_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard normal draws truncated to [-2, 2], by redrawing the ones
    outside (the policy head's 23M draws take a tenth of a second, against
    ~2 s for the inverse-CDF ``trunc_normal_``)."""
    w = torch.randn(shape, generator=generator).reshape(-1)
    idx = torch.nonzero(w.abs() > 2.0)[:, 0]
    while idx.numel():
        redrawn = torch.randn(idx.numel(), generator=generator)
        w[idx] = redrawn
        idx = idx[redrawn.abs() > 2.0]
    return w.reshape(shape)


def _init_weights(net: XiangqiNet, generator: torch.Generator) -> XiangqiNet:
    """Draw ``net``'s weights from flax's initial distributions, as the JAX
    package's ``init_net`` does: ``lecun_normal`` conv and dense kernels
    (truncated normal, variance 1 / fan_in), zero biases, batch-norm scale 1
    and bias 0, running mean 0 and variance 1. The draws come from
    ``generator``, so the values differ from JAX's; the distribution is
    the same."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                std = math.sqrt(1.0 / m.weight[0].numel()) / _TRUNC_STD
                m.weight.copy_(_truncated_normal(m.weight.shape, generator) * std)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return net


def init_net(generator: torch.Generator, channels: int = 128, blocks: int = 6,
             dtype: torch.dtype = torch.float32, device="cpu") -> XiangqiNet:
    """A net on ``device`` with ``_init_weights``'s draws from ``generator``
    (the JAX package's ``init_net``). It is built on the meta device first,
    so torch's own initializers, which draw from the global generator, never
    run."""
    with torch.device("meta"):
        net = XiangqiNet(channels, blocks, dtype)
    return _init_weights(net.to_empty(device=device), generator)


def count_parameters(net: nn.Module) -> int:
    """Total trainable parameter count (reference: model.py:127-129)."""
    return sum(p.numel() for p in net.parameters() if p.requires_grad)


def policy_value_fn(net: XiangqiNet) -> Callable:
    """(features[B,10,9,15]) -> (softmax policy[B,8100], value[B])."""

    def f(feats: torch.Tensor):
        logits, value = net(feats)
        return torch.softmax(logits, dim=-1), value[:, 0]

    return f


def policy_logits_fn(net: XiangqiNet) -> Callable:
    """(features[B,10,9,15]) -> (raw logits[B,8100], value[B]) — for
    ``run_mcts(..., logits_eval=True)``."""

    def f(feats: torch.Tensor):
        logits, value = net(feats)
        return logits, value[:, 0]

    return f
