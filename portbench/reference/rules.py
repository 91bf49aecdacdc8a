"""Plain Xiangqi rules: legal moves, the move itself, and the net's input planes.

A scan-based movegen over a flat board list, written after the public
reference's rules (wenjunyang/xiangqi-alphazero, training/game.py: movegen
297-424, attack detection 176-265, legality 441-490, features 618-640),
including its quirks: the king's palace test looks at the destination only,
and the enemy king attacks along all four rays like a rook. Nothing here
imports the program under test.

Layouts: square = row * 9 + col (row 0 = red's back rank); action =
from * 90 + to; pieces 1 king, 2 advisor, 3 elephant, 4 horse, 5 rook,
6 cannon, 7 pawn, red positive, black negative; side +1 = red to move.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

ROWS, COLS, NSQ = 10, 9, 90
KING, ADVISOR, ELEPHANT, HORSE, ROOK, CANNON, PAWN = 1, 2, 3, 4, 5, 6, 7

_ORTH = ((1, 0), (-1, 0), (0, 1), (0, -1))
_DIAG = ((1, 1), (1, -1), (-1, 1), (-1, -1))
_HORSE = ((2, 1), (2, -1), (-2, 1), (-2, -1), (1, 2), (1, -2), (-1, 2), (-1, -2))
_ELEPHANT = ((2, 2), (2, -2), (-2, 2), (-2, -2))
_ADVISOR_SPOTS = {1: ((0, 3), (0, 5), (1, 4), (2, 3), (2, 5)),
                  -1: ((7, 3), (7, 5), (8, 4), (9, 3), (9, 5))}


def _on(r: int, c: int) -> bool:
    return 0 <= r < ROWS and 0 <= c < COLS


def _in_palace(r: int, c: int, side: int) -> bool:
    return 3 <= c <= 5 and (0 <= r <= 2 if side == 1 else 7 <= r <= 9)


def initial_board() -> List[int]:
    b = [0] * NSQ
    back = (ROOK, HORSE, ELEPHANT, ADVISOR, KING, ADVISOR, ELEPHANT, HORSE, ROOK)
    for c, p in enumerate(back):
        b[c], b[9 * COLS + c] = p, -p
    for c in (1, 7):
        b[2 * COLS + c], b[7 * COLS + c] = CANNON, -CANNON
    for c in (0, 2, 4, 6, 8):
        b[3 * COLS + c], b[6 * COLS + c] = PAWN, -PAWN
    return b


def find_king(b: Sequence[int], side: int) -> Optional[int]:
    """The king's square, looked for in its palace only."""
    for r in (range(0, 3) if side == 1 else range(7, 10)):
        for c in range(3, 6):
            if b[r * COLS + c] == KING * side:
                return r * COLS + c
    return None


def attacked(b: Sequence[int], s: int, by: int) -> bool:
    """Is square ``s`` attacked by side ``by``?"""
    kr, kc = divmod(s, COLS)
    for dr, dc in _ORTH:
        r, c, screen = kr + dr, kc + dc, 0
        while _on(r, c):
            p = b[r * COLS + c]
            if p:
                if screen == 0:
                    if p in (ROOK * by, KING * by):
                        return True
                    screen = 1
                else:
                    if p == CANNON * by:
                        return True
                    break
            r, c = r + dr, c + dc
    for dr, dc in _HORSE:
        r, c = kr + dr, kc + dc
        if _on(r, c) and b[r * COLS + c] == HORSE * by:
            leg = (r - dr // 2) * COLS + c if abs(dr) == 2 else r * COLS + (c - dc // 2)
            if b[leg] == 0:
                return True
    fwd = 1 if by == 1 else -1
    if _on(kr - fwd, kc) and b[(kr - fwd) * COLS + kc] == PAWN * by:
        return True
    if (kr >= 5) if by == 1 else (kr <= 4):
        for c in (kc - 1, kc + 1):
            if 0 <= c < COLS and b[kr * COLS + c] == PAWN * by:
                return True
    return False


def _kings_facing(b: Sequence[int]) -> bool:
    rk, bk = find_king(b, 1), find_king(b, -1)
    if rk is None or bk is None or rk % COLS != bk % COLS:
        return False
    lo, hi = sorted((rk // COLS, bk // COLS))
    return all(b[r * COLS + rk % COLS] == 0 for r in range(lo + 1, hi))


def _dests(b: Sequence[int], s: int) -> List[int]:
    """Pseudo-legal destinations of the piece on ``s``."""
    p = b[s]
    side, kind = (1 if p > 0 else -1), abs(p)
    r, c = divmod(s, COLS)
    out: List[int] = []

    def takeable(t: int) -> bool:
        return b[t] == 0 or (b[t] > 0) != (p > 0)

    if kind == KING:
        for dr, dc in _ORTH:
            if _in_palace(r + dr, c + dc, side) and takeable((r + dr) * COLS + c + dc):
                out.append((r + dr) * COLS + c + dc)
    elif kind == ADVISOR:
        for dr, dc in _DIAG:
            if (r + dr, c + dc) in _ADVISOR_SPOTS[side] and takeable((r + dr) * COLS + c + dc):
                out.append((r + dr) * COLS + c + dc)
    elif kind == ELEPHANT:
        for dr, dc in _ELEPHANT:
            nr, nc = r + dr, c + dc
            if (_on(nr, nc) and (nr <= 4 if side == 1 else nr >= 5)
                    and b[(r + dr // 2) * COLS + c + dc // 2] == 0 and takeable(nr * COLS + nc)):
                out.append(nr * COLS + nc)
    elif kind == HORSE:
        for dr, dc in _HORSE:
            nr, nc = r + dr, c + dc
            leg = (r + dr // 2) * COLS + c if abs(dr) == 2 else r * COLS + c + dc // 2
            if _on(nr, nc) and b[leg] == 0 and takeable(nr * COLS + nc):
                out.append(nr * COLS + nc)
    elif kind in (ROOK, CANNON):
        for dr, dc in _ORTH:
            nr, nc = r + dr, c + dc
            while _on(nr, nc) and b[nr * COLS + nc] == 0:
                out.append(nr * COLS + nc)
                nr, nc = nr + dr, nc + dc
            if kind == CANNON:   # jump one screen
                nr, nc = nr + dr, nc + dc
                while _on(nr, nc) and b[nr * COLS + nc] == 0:
                    nr, nc = nr + dr, nc + dc
            if _on(nr, nc) and (b[nr * COLS + nc] > 0) != (p > 0):
                out.append(nr * COLS + nc)
    elif kind == PAWN:
        fwd = 1 if side == 1 else -1
        if _on(r + fwd, c) and takeable((r + fwd) * COLS + c):
            out.append((r + fwd) * COLS + c)
        if (r >= 5) if side == 1 else (r <= 4):
            for nc in (c - 1, c + 1):
                if 0 <= nc < COLS and takeable(r * COLS + nc):
                    out.append(r * COLS + nc)
    return out


def _safe(b: List[int], f: int, t: int) -> bool:
    """Own king present, kings not facing, own king not attacked after f -> t."""
    moving, captured = b[f], b[t]
    b[t], b[f] = moving, 0
    try:
        side = 1 if moving > 0 else -1
        k = find_king(b, side)
        return k is not None and not _kings_facing(b) and not attacked(b, k, -side)
    finally:
        b[f], b[t] = moving, captured


def legal_actions(board: Sequence[int], side: int) -> List[int]:
    """Every legal action of ``side`` on ``board``, ascending."""
    b = [int(x) for x in board]
    out = [s * NSQ + t for s in range(NSQ) if b[s] and (b[s] > 0) == (side > 0)
           for t in _dests(b, s) if _safe(b, s, t)]
    return sorted(out)


def apply(board: Sequence[int], action: int) -> List[int]:
    """The board after ``action``."""
    b = [int(x) for x in board]
    f, t = divmod(action, NSQ)
    b[t], b[f] = b[f], 0
    return b


def features(board: torch.Tensor, side: torch.Tensor) -> torch.Tensor:
    """Input planes NHWC f32[B, 10, 9, 15] of boards int8[B, 90] and sides
    int8[B]: planes 0-6 the side to move's pieces (king .. pawn), 7-13 the
    opponent's, 14 one where red is to move."""
    b = board.long().reshape(-1, ROWS, COLS)
    s = side.long().reshape(-1, 1, 1)
    planes = [b == k * s for k in range(1, 8)] + [b == -k * s for k in range(1, 8)]
    planes.append((s > 0).expand_as(b))
    return torch.stack(planes, dim=-1).float()


def decode_features(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(boards int8[B, 90], sides int8[B]) that planes f32[B, 10, 9, 15]
    describe, read back as ``features`` writes them (a square with no
    plane set is empty; which of several planes wins does not matter, since
    the planes are compared again with ``features`` of the result)."""
    f = feats.reshape(-1, NSQ, 15)
    side = np.where(f[:, :, 14].max(axis=1) > 0.5, 1, -1).astype(np.int8)
    kind = np.arange(1, 8)
    own = (f[:, :, :7] > 0.5) * kind
    opp = (f[:, :, 7:14] > 0.5) * kind
    board = (own.max(axis=2) - opp.max(axis=2)) * side[:, None]
    return board.astype(np.int8), side
