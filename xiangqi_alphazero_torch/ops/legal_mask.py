"""The legal-move mask kernel: wrapper, constants and dispatch.

``legal_mask_cuda`` launches the hand-written CUDA kernel
``csrc/legal_mask.cu`` (the port of the TPU kernel
``xiangqi_alphazero_tpu/ops/legal_mask.py::legal_mask_pallas``); its plain
PyTorch version is ``engine/env.py::legal_mask``. ``legal_mask`` dispatches
on the tensor's device: a CPU tensor goes to the plain version, a CUDA
tensor to the kernel, which either launches or raises. The kernel is built
with ``nvcc`` at first use (``ops/_build.py``); its per-action constants are
built from ``engine/tables.py`` and uploaded once per device.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from ..engine import env as E
from ..engine import tables as _tables
from . import _build

SOURCE = "legal_mask"   # csrc/legal_mask.cu
_MAX_BLOCK = 8          # blocker squares per action (csrc kMaxBlock)

# flag bits per action, in the order of csrc/legal_mask.cu's kKing0..kAligned
_FLAG_TABLES = (
    ("KING_A", 0), ("KING_A", 1), ("ADV_A", 0), ("ADV_A", 1),
    ("ELE_A", 0), ("ELE_A", 1), ("PAWN_A", 0), ("PAWN_A", 1),
    ("HORSE_A", None), ("ALIGNED_A", None),
)


def action_constants() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(flags int16[8100], nblock uint8[8100], block uint8[8100, 8]): each
    action's geometry bits and the squares that must be empty for it (the
    nonzero rows of the BLOCK table's column)."""
    t = _tables.tables()
    flags = np.zeros(E.ACTION_SPACE, np.int16)
    for bit, (key, side) in enumerate(_FLAG_TABLES):
        table = t[key] if side is None else t[key][side]
        flags |= table.astype(np.int16) << bit
    block = t["BLOCK"].T.astype(bool)                   # [8100, 90]
    nblock = block.sum(axis=1).astype(np.uint8)
    assert int(nblock.max()) <= _MAX_BLOCK
    squares = np.zeros((E.ACTION_SPACE, _MAX_BLOCK), np.uint8)
    for a in np.flatnonzero(nblock):
        sq = np.flatnonzero(block[a])
        squares[a, : len(sq)] = sq
    return flags, nblock, squares


@functools.lru_cache(maxsize=None)
def _device_constants(device: torch.device) -> Tuple[torch.Tensor, ...]:
    return tuple(torch.from_numpy(c).to(device) for c in action_constants())


@functools.lru_cache(maxsize=1)
def _launcher():
    fn = _build.load(SOURCE).xq_legal_mask
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


class LegalMaskKernel:
    """Callable wrapper of the CUDA kernel; ``launches`` counts the kernel
    launches it made."""

    def __init__(self) -> None:
        self.launches = 0

    def __call__(self, board: torch.Tensor, side: torch.Tensor) -> torch.Tensor:
        if not board.is_cuda:
            raise ValueError(f"legal_mask kernel needs a CUDA tensor, got {board.device}")
        if board.dtype != torch.int8 or side.dtype != torch.int8:
            raise TypeError(f"boards and sides must be int8, got {board.dtype}, {side.dtype}")
        if board.dim() != 2 or board.shape[1] != E.NSQ or side.shape != board.shape[:1]:
            raise ValueError(f"want board [B, 90] and side [B], got {board.shape}, {side.shape}")
        if side.device != board.device:
            raise ValueError("board and side must be on one device")
        if not (board.is_contiguous() and side.is_contiguous()):
            raise ValueError("board and side must be contiguous")
        batch = board.shape[0]
        out = torch.empty((batch, E.ACTION_SPACE), dtype=torch.bool, device=board.device)
        if batch == 0:
            return out
        flags, nblock, block = _device_constants(board.device)
        with torch.cuda.device(board.device):
            status = _launcher()(
                board.data_ptr(), side.data_ptr(), flags.data_ptr(),
                nblock.data_ptr(), block.data_ptr(), out.data_ptr(), batch,
                torch.cuda.current_stream().cuda_stream,
            )
        if status != 0:
            raise RuntimeError(f"legal_mask kernel launch failed: CUDA error {status}")
        self.launches += 1
        return out


legal_mask_cuda = LegalMaskKernel()


def legal_mask(board: torch.Tensor, side: torch.Tensor) -> torch.Tensor:
    """bool[B, 8100] legal mask: the plain version for a CPU tensor, the
    kernel for a CUDA tensor."""
    if board.device.type == "cpu":
        return E.legal_mask(board, side)
    return legal_mask_cuda(board, side)
