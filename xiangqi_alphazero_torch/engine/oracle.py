"""Pure-Python Xiangqi rules oracle.

The semantics contract is bit-exactness with the reference engine
(reference: training/game.py — movegen 297-424, attack detection 176-265,
legality 441-490, terminal rules 565-616, features 618-640). This module is
deliberately implemented independently of ``tables.py`` (scan-based, flat
board list) so it can serve as a *differential* oracle for the vectorized
JAX environment, mirroring the reference's own Python-vs-Cython test pattern
(reference: training/test_cython.py:87-123).

It is also the host-side engine for the serving/demo layer, where a single
interactive game does not justify a device round-trip.

This is the PyTorch port's own copy of ``xiangqi_alphazero_tpu.engine.oracle``
(the port imports nothing of the JAX package). ``legal_actions`` runs the
port's native C++ core (``engine/native``) when it is built, as the JAX
oracle does, and the Python movegen when no compiler is present or
``use_python_rules(True)`` forces it.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

ROWS, COLS, NSQ = 10, 9, 90
ACTION_SPACE = NSQ * NSQ

KING, ADVISOR, ELEPHANT, HORSE, ROOK, CANNON, PAWN = 1, 2, 3, 4, 5, 6, 7

PIECE_VALUES = (0, 0, 20, 20, 40, 90, 45, 10)  # by abs(code), king = 0

PIECE_NAMES = {
    0: "．", 1: "帅", 2: "仕", 3: "相", 4: "马", 5: "车", 6: "炮", 7: "兵",
    -1: "将", -2: "士", -3: "象", -4: "马", -5: "车", -6: "炮", -7: "卒",
}

_FORCE_PYTHON_RULES = False


def use_python_rules(force: bool) -> None:
    """Force the pure-Python movegen (disable the native core)."""
    global _FORCE_PYTHON_RULES
    _FORCE_PYTHON_RULES = force


def _native_lib():
    if _FORCE_PYTHON_RULES:
        return None
    from . import native

    return native.load()


_ORTH = ((1, 0), (-1, 0), (0, 1), (0, -1))
_DIAG = ((1, 1), (1, -1), (-1, 1), (-1, -1))
_HORSE = ((2, 1), (2, -1), (-2, 1), (-2, -1), (1, 2), (1, -2), (-1, 2), (-1, -2))
_ELEPHANT = ((2, 2), (2, -2), (-2, 2), (-2, -2))


def encode_action(fr: int, fc: int, tr: int, tc: int) -> int:
    return (fr * COLS + fc) * NSQ + (tr * COLS + tc)


def decode_action(a: int) -> Tuple[int, int, int, int]:
    f, t = a // NSQ, a % NSQ
    return f // COLS, f % COLS, t // COLS, t % COLS


def _in_board(r: int, c: int) -> bool:
    return 0 <= r < ROWS and 0 <= c < COLS


def _in_palace(r: int, c: int, side: int) -> bool:
    if not (3 <= c <= 5):
        return False
    return 0 <= r <= 2 if side == 1 else 7 <= r <= 9


def _advisor_spot(r: int, c: int, side: int) -> bool:
    if side == 1:
        return (r, c) in ((0, 3), (0, 5), (1, 4), (2, 3), (2, 5))
    return (r, c) in ((7, 3), (7, 5), (8, 4), (9, 3), (9, 5))


def initial_board() -> List[int]:
    b = [0] * NSQ
    back = (ROOK, HORSE, ELEPHANT, ADVISOR, KING, ADVISOR, ELEPHANT, HORSE, ROOK)
    for c, p in enumerate(back):
        b[c] = p
        b[9 * COLS + c] = -p
    for c in (1, 7):
        b[2 * COLS + c] = CANNON
        b[7 * COLS + c] = -CANNON
    for c in (0, 2, 4, 6, 8):
        b[3 * COLS + c] = PAWN
        b[6 * COLS + c] = -PAWN
    return b


class Position:
    """A single mutable game, reference-equivalent semantics throughout."""

    __slots__ = ("board", "side", "ply", "quiet", "history", "_legal_cache")

    def __init__(self):
        self.board: List[int] = initial_board()
        self.side = 1  # 1 red to move, -1 black
        self.ply = 0
        self.quiet = 0  # consecutive non-capture plies
        self.history: List[bytes] = []  # pre-move board snapshots
        self._legal_cache: Optional[List[int]] = None

    # ------------------------------------------------------------- helpers
    def copy(self) -> "Position":
        p = Position.__new__(Position)
        p.board = list(self.board)
        p.side = self.side
        p.ply = self.ply
        p.quiet = self.quiet
        p.history = list(self.history)
        p._legal_cache = None
        return p

    def at(self, r: int, c: int) -> int:
        return self.board[r * COLS + c]

    def find_king(self, side: int) -> Optional[int]:
        """Palace-scan king lookup (reference: game.py:426-439)."""
        target = KING * side
        rows = range(0, 3) if side == 1 else range(7, 10)
        for r in rows:
            for c in range(3, 6):
                if self.board[r * COLS + c] == target:
                    return r * COLS + c
        return None

    # ----------------------------------------------------- attack detection
    def attacked(self, s: int, by: int) -> bool:
        """Is square s attacked by side ``by``?

        Reverse scan from the target, matching reference game.py:176-265
        exactly — including its quirk of treating the enemy king as a
        rook-like ray attacker on all four directions.
        """
        b = self.board
        kr, kc = s // COLS, s % COLS
        e_rook, e_cannon = ROOK * by, CANNON * by
        e_horse, e_pawn, e_king = HORSE * by, PAWN * by, KING * by

        for d_r, d_c in _ORTH:
            r, c = kr + d_r, kc + d_c
            screen = 0
            while _in_board(r, c):
                p = b[r * COLS + c]
                if p != 0:
                    if screen == 0:
                        if p == e_rook or p == e_king:
                            return True
                        screen = 1
                    else:
                        if p == e_cannon:
                            return True
                        break
                r += d_r
                c += d_c

        for d_r, d_c in _HORSE:
            r, c = kr + d_r, kc + d_c
            if _in_board(r, c) and b[r * COLS + c] == e_horse:
                # leg is adjacent to the horse, toward the target
                if abs(d_r) == 2:
                    leg_r, leg_c = r - d_r // 2, c
                else:
                    leg_r, leg_c = r, c - d_c // 2
                if b[leg_r * COLS + leg_c] == 0:
                    return True

        fwd = 1 if by == 1 else -1
        r = kr - fwd
        if _in_board(r, kc) and b[r * COLS + kc] == e_pawn:
            return True
        crossed = kr >= 5 if by == 1 else kr <= 4
        if crossed:
            for c in (kc - 1, kc + 1):
                if 0 <= c < COLS and b[kr * COLS + c] == e_pawn:
                    return True
        return False

    def in_check(self, side: int) -> bool:
        k = self.find_king(side)
        if k is None:
            return True
        return self.attacked(k, -side)

    def _kings_facing(self) -> bool:
        rk, bk = self.find_king(1), self.find_king(-1)
        if rk is None or bk is None:
            return False
        if rk % COLS != bk % COLS:
            return False
        c = rk % COLS
        lo, hi = min(rk // COLS, bk // COLS), max(rk // COLS, bk // COLS)
        return all(self.board[r * COLS + c] == 0 for r in range(lo + 1, hi))

    # ------------------------------------------------------------- movegen
    def _piece_dests(self, s: int) -> List[int]:
        """Pseudo-legal destinations for the piece at s (no self-check test)."""
        b = self.board
        p = b[s]
        side = 1 if p > 0 else -1
        kind = abs(p)
        r, c = s // COLS, s % COLS
        out: List[int] = []

        def takeable(t: int) -> bool:
            q = b[t]
            return q == 0 or (q > 0) != (p > 0)

        if kind == KING:
            for d_r, d_c in _ORTH:
                nr, nc = r + d_r, c + d_c
                if _in_palace(nr, nc, side) and takeable(nr * COLS + nc):
                    out.append(nr * COLS + nc)
        elif kind == ADVISOR:
            for d_r, d_c in _DIAG:
                nr, nc = r + d_r, c + d_c
                if _advisor_spot(nr, nc, side) and takeable(nr * COLS + nc):
                    out.append(nr * COLS + nc)
        elif kind == ELEPHANT:
            for d_r, d_c in _ELEPHANT:
                nr, nc = r + d_r, c + d_c
                if not _in_board(nr, nc):
                    continue
                if side == 1 and nr > 4:
                    continue
                if side == -1 and nr < 5:
                    continue
                if b[(r + d_r // 2) * COLS + (c + d_c // 2)] != 0:
                    continue
                if takeable(nr * COLS + nc):
                    out.append(nr * COLS + nc)
        elif kind == HORSE:
            for d_r, d_c in _HORSE:
                nr, nc = r + d_r, c + d_c
                if not _in_board(nr, nc):
                    continue
                if abs(d_r) == 2:
                    leg = (r + d_r // 2) * COLS + c
                else:
                    leg = r * COLS + (c + d_c // 2)
                if b[leg] != 0:
                    continue
                if takeable(nr * COLS + nc):
                    out.append(nr * COLS + nc)
        elif kind == ROOK:
            for d_r, d_c in _ORTH:
                nr, nc = r + d_r, c + d_c
                while _in_board(nr, nc):
                    t = nr * COLS + nc
                    if b[t] == 0:
                        out.append(t)
                    else:
                        if (b[t] > 0) != (p > 0):
                            out.append(t)
                        break
                    nr += d_r
                    nc += d_c
        elif kind == CANNON:
            for d_r, d_c in _ORTH:
                nr, nc = r + d_r, c + d_c
                while _in_board(nr, nc) and b[nr * COLS + nc] == 0:
                    out.append(nr * COLS + nc)
                    nr += d_r
                    nc += d_c
                nr += d_r
                nc += d_c
                while _in_board(nr, nc):
                    t = nr * COLS + nc
                    if b[t] != 0:
                        if (b[t] > 0) != (p > 0):
                            out.append(t)
                        break
                    nr += d_r
                    nc += d_c
        elif kind == PAWN:
            fwd = 1 if side == 1 else -1
            nr = r + fwd
            if _in_board(nr, c) and takeable(nr * COLS + c):
                out.append(nr * COLS + c)
            crossed = r >= 5 if side == 1 else r <= 4
            if crossed:
                for nc in (c - 1, c + 1):
                    if 0 <= nc < COLS and takeable(r * COLS + nc):
                        out.append(r * COLS + nc)
        return out

    def _move_safe(self, f: int, t: int) -> bool:
        """Own king exists, kings don't face, own king unattacked after f->t
        (reference: game.py:441-490, in-place make/unmake)."""
        b = self.board
        moving, captured = b[f], b[t]
        b[t], b[f] = moving, 0
        try:
            side = 1 if moving > 0 else -1
            k = self.find_king(side)
            if k is None:
                return False
            if self._kings_facing():
                return False
            return not self.attacked(k, -side)
        finally:
            b[f], b[t] = moving, captured

    def legal_actions(self) -> List[int]:
        """All legal actions for the side to move, ascending (cached).

        Uses the native C++ core when available (same auto-detect-with-
        fallback contract as the reference's Cython loader, game.py:31-47,
        501-518); ``use_python_rules(True)`` forces the pure-Python path
        (differential tests rely on it)."""
        if self._legal_cache is not None:
            return self._legal_cache
        if _native_lib():
            from . import native

            out = native.gen_legal(self.board_array(), self.side)
        else:
            out = []
            for s in range(NSQ):
                p = self.board[s]
                if p == 0 or (p > 0) != (self.side > 0):
                    continue
                for t in self._piece_dests(s):
                    if self._move_safe(s, t):
                        out.append(s * NSQ + t)
            out.sort()
        self._legal_cache = out
        return out

    def legal_moves(self) -> List[Tuple[int, int, int, int]]:
        return [decode_action(a) for a in self.legal_actions()]

    # ---------------------------------------------------------------- play
    def apply(self, a: int) -> None:
        f, t = a // NSQ, a % NSQ
        captured = self.board[t]
        self.history.append(bytes((x & 0xFF) for x in self.board))
        self.board[t] = self.board[f]
        self.board[f] = 0
        self.quiet = 0 if captured != 0 else self.quiet + 1
        self.side = -self.side
        self.ply += 1
        self._legal_cache = None

    def material(self, side: int) -> int:
        return sum(
            PIECE_VALUES[abs(p)] for p in self.board if p != 0 and (p > 0) == (side > 0)
        )

    def result(self) -> Tuple[bool, Optional[int]]:
        """(done, winner): 1 red, -1 black, 0 draw, None ongoing.

        Condition order matches reference game.py:565-616 exactly.
        """
        if self.find_king(1) is None:
            return True, -1
        if self.find_king(-1) is None:
            return True, 1
        if not self.legal_actions():
            return True, -self.side
        if self.quiet >= 120:
            return True, 0
        if self.ply >= 200:
            diff = self.material(1) - self.material(-1)
            return True, 1 if diff > 30 else (-1 if diff < -30 else 0)
        if len(self.history) >= 6:
            cur = bytes((x & 0xFF) for x in self.board)
            if sum(1 for h in self.history[-12:] if h == cur) >= 3:
                return True, 0
        return False, None

    # ------------------------------------------------------------ features
    def features(self) -> np.ndarray:
        """15 NN planes, (15, 10, 9) float32 (reference: game.py:618-640):
        0-6 own pieces, 7-13 opponent pieces, 14 = 1.0 iff red to move."""
        f = np.zeros((15, ROWS, COLS), dtype=np.float32)
        b = np.asarray(self.board, dtype=np.int8).reshape(ROWS, COLS)
        for k in range(1, 8):
            f[k - 1] = b == k * self.side
            f[7 + k - 1] = b == -k * self.side
        if self.side == 1:
            f[14] = 1.0
        return f

    def board_array(self) -> np.ndarray:
        return np.asarray(self.board, dtype=np.int8)

    def render(self) -> str:
        lines = []
        for r in range(ROWS - 1, -1, -1):
            lines.append(
                f"{r} " + " ".join(PIECE_NAMES[self.at(r, c)] for c in range(COLS))
            )
            if r == 5:
                lines.append("  ＝＝＝＝＝＝＝＝＝")
        lines.append("  " + " ".join(str(c) for c in range(COLS)))
        lines.append(f"to move: {'red' if self.side == 1 else 'black'}  ply: {self.ply}")
        return "\n".join(lines)
