"""Operations and bytes that the work needs, counted from shapes.

The net's counts are multiply-adds times two of its convolutions and dense
layers (batch norm, ReLU and the softmax are left out, as a model-FLOPs
count leaves them out). A training row costs three forwards: the forward,
and a backward of twice its work.
"""

from __future__ import annotations

from .reference import resnet

SQUARES = resnet.ROWS * resnet.COLS


def forward_flops(channels: int, blocks: int) -> int:
    """FLOPs of one position's forward at ``channels`` x ``blocks``."""
    c = channels
    conv3 = 2 * SQUARES * 9
    flops = conv3 * resnet.PLANES * c + blocks * 2 * conv3 * c * c
    flops += 2 * SQUARES * c * (resnet.POLICY_CH + resnet.VALUE_CH)
    flops += 2 * resnet.POLICY_CH * SQUARES * resnet.ACTION_SPACE
    flops += 2 * resnet.VALUE_CH * SQUARES * resnet.VALUE_HIDDEN + 2 * resnet.VALUE_HIDDEN
    return flops


def train_flops(channels: int, blocks: int) -> int:
    """FLOPs of one training row: forward and backward."""
    return 3 * forward_flops(channels, blocks)


def legal_mask_bytes(rows: int) -> int:
    """Bytes the legal-move mask must move for ``rows`` positions: each
    board (90 int8) and side (1 int8) read once, each 8,100-entry bool row
    written once."""
    return rows * (SQUARES + 1 + resnet.ACTION_SPACE)
