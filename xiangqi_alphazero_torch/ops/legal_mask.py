"""The legal-move mask kernel: wrapper, candidate tables, launch plan and
dispatch.

``legal_mask_cuda`` launches the hand-written CUDA kernel
``csrc/legal_mask.cu`` (the port of the TPU kernel
``xiangqi_alphazero_tpu/ops/legal_mask.py::legal_mask_pallas``); its plain
PyTorch version is ``engine/env.py::legal_mask``. ``legal_mask`` dispatches
on the tensor's device: a CPU tensor goes to the plain version, a CUDA
tensor to the kernel, which either launches or raises. The kernel is built
with ``nvcc`` at first use (``ops/_build.py``).

The kernel walks the candidate moves of the side to move's own pieces, not
all 8,100 actions. ``action_constants`` builds its table once from
``engine/tables.py``: for each geometry class and from-square, the list of
destinations and, per destination, the squares that must be empty (the
action's column of ``BLOCK``). ``launch_plan`` says how many blocks share
one board's row; the kernel derives each block's board and action range
from it exactly as ``block_ranges`` does.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..engine import env as E
from ..engine import tables as _tables
from . import _build

SOURCE = "legal_mask"            # csrc/legal_mask.cu
KERNEL_SYMBOL = "legal_mask_by_piece"   # the __global__ function's name

# Geometry classes, in the order of csrc/legal_mask.cu's class index: the
# per-side king, advisor, elephant and pawn tables, then horse and aligned
# (rook or cannon). Each row is the table of engine/tables.py it regroups.
CLASSES = (
    ("KING_A", 0), ("KING_A", 1), ("ADV_A", 0), ("ADV_A", 1),
    ("ELE_A", 0), ("ELE_A", 1), ("PAWN_A", 0), ("PAWN_A", 1),
    ("HORSE_A", None), ("ALIGNED_A", None),
)
CAP = 17                  # destinations per (class, from): a rook's 8 + 9 (csrc kCap)
EMPTY = 0xFFFFFFFF        # an unused slot of the table
MAX_BLOCKS_PER_BOARD = 64


def file_major(square):
    """A square's index in file-major order (file * 10 + rank): the squares
    of one file are consecutive there, as those of one rank are in the
    board's own order."""
    return (square % E.COLS) * E.ROWS + square // E.COLS


def _entry(to: int, blockers: np.ndarray) -> int:
    """One table entry: bits 0-6 the destination, bits 8-14 / 16-22 the
    bit range [lo, hi) of the blocker squares, bit 24 set when that range
    is in file-major order (a file's ray) rather than square order."""
    lo = hi = fm = 0
    if len(blockers):
        idx, fm = np.sort(blockers), 0
        if idx[-1] - idx[0] + 1 != len(idx):
            idx, fm = np.sort(file_major(blockers)), 1
        assert idx[-1] - idx[0] + 1 == len(idx), blockers
        lo, hi = int(idx[0]), int(idx[-1]) + 1
    return int(to) | lo << 8 | hi << 16 | fm << 24


@functools.lru_cache(maxsize=1)
def action_constants() -> np.ndarray:
    """uint32[10, 90, CAP]: for each geometry class of ``CLASSES`` and each
    from-square, the entries (``_entry``) of the destinations in ascending
    order, then ``EMPTY``. Read-only."""
    t = _tables.tables()
    block = t["BLOCK"].astype(bool)                       # [90, 8100]
    out = np.full((len(CLASSES), E.NSQ, CAP), EMPTY, np.uint32)
    for c, (key, side) in enumerate(CLASSES):
        geom = (t[key] if side is None else t[key][side]).reshape(E.NSQ, E.NSQ)
        for f in range(E.NSQ):
            dests = np.flatnonzero(geom[f])
            assert len(dests) <= CAP
            for i, to in enumerate(dests):
                out[c, f, i] = _entry(to, np.flatnonzero(block[:, f * E.NSQ + to]))
    out.setflags(write=False)
    return out


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """``blocks_per_board`` blocks share each board's row; block i takes
    board i // blocks_per_board and actions [lo, lo + chunk) of it (cut at
    8100), lo = (i % blocks_per_board) * chunk."""

    blocks_per_board: int
    chunk: int   # a multiple of 16, so each block's stores stay 16-byte aligned

    def grid(self, batch: int) -> int:
        return batch * self.blocks_per_board


def default_blocks_per_board(batch: int) -> int:
    """Split a board's row over 8 blocks while the batch leaves SMs idle
    (serving's B = 1..8; the split's gain there is measured by
    chip_smoke.py phase 7)."""
    return 1 if batch >= 16 else 8


@functools.lru_cache(maxsize=None)
def launch_plan(batch: int, blocks_per_board: Optional[int] = None) -> LaunchPlan:
    s = default_blocks_per_board(batch) if blocks_per_board is None else blocks_per_board
    if s not in (1, 2, 4, 8, 16, 32, MAX_BLOCKS_PER_BOARD):
        raise ValueError(f"blocks_per_board must be a power of 2 up to "
                         f"{MAX_BLOCKS_PER_BOARD}, got {s}")
    chunk = -(-E.ACTION_SPACE // s)
    chunk = -(-chunk // 16) * 16
    # the last block keeps at least 16 actions (its store loop assumes a
    # head of at most 12 bytes fits)
    assert E.ACTION_SPACE - (s - 1) * chunk >= 16
    return LaunchPlan(s, chunk)


def block_ranges(batch: int, plan: LaunchPlan) -> Tuple[np.ndarray, ...]:
    """(board, lo, hi) of every block of the grid: the kernel's own index
    arithmetic, for the tests."""
    i = np.arange(plan.grid(batch), dtype=np.int64)
    lo = (i % plan.blocks_per_board) * plan.chunk
    return i // plan.blocks_per_board, lo, np.minimum(lo + plan.chunk, E.ACTION_SPACE)


def candidate_counts() -> np.ndarray:
    """int64[90]: per from-square, the number of table entries of each
    geometry class c in bits 5c..5c+4 (one load gives a square's counts)."""
    counts = (action_constants() != EMPTY).sum(axis=2).astype(np.int64)   # [10, 90]
    return (counts << (5 * np.arange(len(CLASSES)))[:, None]).sum(axis=0)


@functools.lru_cache(maxsize=None)
def _device_constants(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The candidate table and the packed entry counts, on ``device``."""
    return (torch.from_numpy(action_constants().view(np.int32).copy()).to(device),
            torch.from_numpy(candidate_counts()).to(device))


@functools.lru_cache(maxsize=1)
def _launcher():
    fn = _build.load(SOURCE).xq_legal_mask
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


class LegalMaskKernel:
    """Callable wrapper of the CUDA kernel; ``launches`` counts its calls
    that launched the kernel (one per call, whatever the grid)."""

    def __init__(self) -> None:
        self.launches = 0

    def __call__(self, board: torch.Tensor, side: torch.Tensor,
                 blocks_per_board: Optional[int] = None) -> torch.Tensor:
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
        out = torch.empty((board.shape[0], E.ACTION_SPACE), dtype=torch.bool, device=board.device)
        if board.shape[0] == 0:
            return out
        with torch.cuda.device(board.device):
            status = self._launch(board, side, out, blocks_per_board)
        if status != 0:
            raise RuntimeError(f"legal_mask kernel launch failed: CUDA error {status}")
        self.launches += 1
        return out

    def _launch(self, board, side, out, blocks_per_board) -> int:
        """Launch on the current stream; returns cudaGetLastError()."""
        plan = launch_plan(board.shape[0], blocks_per_board)
        if out.data_ptr() % 16:
            raise RuntimeError("the kernel's 16-byte stores need a 16-byte aligned output")
        cand, ncand = _device_constants(board.device)
        return _launcher()(
            board.data_ptr(), side.data_ptr(), cand.data_ptr(), ncand.data_ptr(),
            out.data_ptr(), board.shape[0], plan.blocks_per_board, plan.chunk,
            torch.cuda.current_stream().cuda_stream,
        )


legal_mask_cuda = LegalMaskKernel()


def legal_mask(board: torch.Tensor, side: torch.Tensor) -> torch.Tensor:
    """bool[B, 8100] legal mask: the plain version for a CPU tensor, the
    kernel for a CUDA tensor."""
    if board.device.type == "cpu":
        return E.legal_mask(board, side)
    return legal_mask_cuda(board, side)
