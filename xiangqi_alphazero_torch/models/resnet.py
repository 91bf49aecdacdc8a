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
- ``dtype`` is the compute type (autocast); parameters stay float32 and the
  head outputs are float32. Convolutions and the dense layers run on cuDNN
  and ``torch.matmul``, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn as nn

ACTION_SPACE = 8100
ROWS, COLS, PLANES = 10, 9, 15


def _bn(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=1e-5, momentum=0.1)


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
