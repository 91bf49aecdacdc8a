"""Precomputed constant tables for the vectorized Xiangqi engine.

All geometry of the game is baked into dense numpy tables at import time so the
JAX environment can compute full 8100-action legal masks with matmuls, static
gathers and elementwise ops only — no data-dependent control flow. This is the
TPU-native replacement for the reference's per-piece scan loops
(reference: training/game.py:297-424 and training/cython_engine/game_core.pyx).

Conventions (identical to the reference, game.py:12-19):
- square  s = r * 9 + c, r in [0,10) with row 0 = red base, c in [0,9)
- action  a = f * 90 + t  (from-square, to-square), ACTION_SPACE = 8100
- piece codes: 1 king, 2 advisor, 3 elephant, 4 horse, 5 rook, 6 cannon,
  7 pawn; red positive, black negative, 0 empty
- side index: 0 = red (+1), 1 = black (-1)

This is the PyTorch port's verbatim copy of
``xiangqi_alphazero_tpu.engine.tables`` (the port imports nothing of the JAX
package); the legal-mask kernel's per-action constants are built from it.
"""

from __future__ import annotations

import functools

import numpy as np

ROWS, COLS, NSQ = 10, 9, 90
ACTION_SPACE = NSQ * NSQ

KING, ADVISOR, ELEPHANT, HORSE, ROOK, CANNON, PAWN = 1, 2, 3, 4, 5, 6, 7

# Material values indexed by abs(piece code) (reference: game.py:74).
PIECE_VAL = np.array([0, 0, 20, 20, 40, 90, 45, 10], dtype=np.int32)


def sq(r: int, c: int) -> int:
    return r * COLS + c


def _initial_board() -> np.ndarray:
    """Start position (reference: game.py:139-159)."""
    b = np.zeros(NSQ, dtype=np.int8)
    back = [ROOK, HORSE, ELEPHANT, ADVISOR, KING, ADVISOR, ELEPHANT, HORSE, ROOK]
    for c, p in enumerate(back):
        b[sq(0, c)] = p
        b[sq(9, c)] = -p
    for c in (1, 7):
        b[sq(2, c)] = CANNON
        b[sq(7, c)] = -CANNON
    for c in (0, 2, 4, 6, 8):
        b[sq(3, c)] = PAWN
        b[sq(6, c)] = -PAWN
    return b


def _in_palace(r: int, c: int, side: int) -> bool:
    if not (3 <= c <= 5):
        return False
    return r <= 2 if side == 0 else r >= 7


_ADVISOR_SPOTS = (
    frozenset({sq(0, 3), sq(0, 5), sq(1, 4), sq(2, 3), sq(2, 5)}),  # red
    frozenset({sq(7, 3), sq(7, 5), sq(8, 4), sq(9, 3), sq(9, 5)}),  # black
)


@functools.lru_cache(maxsize=1)
def tables() -> dict:
    """Build every constant table once. Returns a dict of numpy arrays."""
    A = np.arange(ACTION_SPACE)
    FR = (A // NSQ).astype(np.int32)
    TO = (A % NSQ).astype(np.int32)
    fr, fc = FR // COLS, FR % COLS
    tr, tc = TO // COLS, TO % COLS
    dr, dc = tr - fr, tc - fc

    same_row = (fr == tr) & (fc != tc)
    same_col = (fc == tc) & (fr != tr)
    aligned_a = same_row | same_col

    # BLOCK[s, a] = 1 iff square s must be empty for action a's geometry:
    # strictly-between squares for ray moves, the elephant eye, the horse leg.
    # Ray / elephant / horse geometries never share an (f, t) displacement, so
    # one table serves all three — one occ @ BLOCK matmul yields, per action,
    # the number of geometric blockers (for cannons, the screen count).
    block = np.zeros((NSQ, ACTION_SPACE), dtype=np.int8)
    for a in range(ACTION_SPACE):
        f, t = int(FR[a]), int(TO[a])
        f_r, f_c, t_r, t_c = f // COLS, f % COLS, t // COLS, t % COLS
        d_r, d_c = t_r - f_r, t_c - f_c
        if (f_r == t_r) != (f_c == t_c):  # rank/file aligned, f != t
            sr, sc = np.sign(d_r), np.sign(d_c)
            r, c = f_r + sr, f_c + sc
            while (r, c) != (t_r, t_c):
                block[sq(r, c), a] = 1
                r += sr
                c += sc
        elif abs(d_r) == 2 and abs(d_c) == 2:  # elephant eye
            block[sq(f_r + d_r // 2, f_c + d_c // 2), a] = 1
        elif {abs(d_r), abs(d_c)} == {1, 2}:  # horse leg
            if abs(d_r) == 2:
                block[sq(f_r + d_r // 2, f_c), a] = 1
            else:
                block[sq(f_r, f_c + d_c // 2), a] = 1

    # Per-piece pseudo-move geometry over the action space.
    orth_step = (np.abs(dr) + np.abs(dc)) == 1
    diag_step = (np.abs(dr) == 1) & (np.abs(dc) == 1)

    king_a = np.zeros((2, ACTION_SPACE), dtype=bool)
    adv_a = np.zeros((2, ACTION_SPACE), dtype=bool)
    ele_a = np.zeros((2, ACTION_SPACE), dtype=bool)
    pawn_a = np.zeros((2, ACTION_SPACE), dtype=bool)
    for si in (0, 1):
        dest_palace = np.array([_in_palace(r, c, si) for r, c in zip(tr, tc)])
        # Reference checks only the destination square for palace membership
        # (game.py:304-321) — replicated here.
        king_a[si] = orth_step & dest_palace
        dest_adv = np.array([s in _ADVISOR_SPOTS[si] for s in TO])
        adv_a[si] = diag_step & dest_adv
        own_half = (tr <= 4) if si == 0 else (tr >= 5)
        ele_a[si] = (np.abs(dr) == 2) & (np.abs(dc) == 2) & own_half
        fwd = 1 if si == 0 else -1
        crossed = (fr >= 5) if si == 0 else (fr <= 4)
        pawn_a[si] = ((dr == fwd) & (dc == 0)) | (
            (dr == 0) & (np.abs(dc) == 1) & crossed
        )
    horse_a = ((np.abs(dr) == 2) & (np.abs(dc) == 1)) | (
        (np.abs(dr) == 1) & (np.abs(dc) == 2)
    )

    # Square-pair tables for reverse attack detection.
    rs = np.arange(NSQ) // COLS
    cs = np.arange(NSQ) % COLS
    drs = rs[:, None] - rs[None, :]  # [x, y]: row(x) - row(y)
    dcs = cs[:, None] - cs[None, :]
    aligned_sq = ((drs == 0) != (dcs == 0))  # same rank xor same file, x != y

    # BTW[x, y, z] = 1 iff z strictly between x and y (aligned pairs only).
    btw = np.zeros((NSQ, NSQ, NSQ), dtype=np.int8)
    for x in range(NSQ):
        xr, xc = x // COLS, x % COLS
        for y in range(NSQ):
            if not aligned_sq[x, y]:
                continue
            yr, yc = y // COLS, y % COLS
            sr, scl = np.sign(yr - xr), np.sign(yc - xc)
            r, c = xr + sr, xc + scl
            while (r, c) != (yr, yc):
                btw[x, y, sq(r, c)] = 1
                r += sr
                c += scl

    # Horse attack geometry + leg square per ordered pair x -> y
    # (reference: game.py:95-100, 234-239 — the leg is adjacent to the horse).
    kleg = np.zeros((NSQ, NSQ), dtype=np.int32)
    for x in range(NSQ):
        xr, xc = x // COLS, x % COLS
        for y in range(NSQ):
            yr, yc = y // COLS, y % COLS
            d_r, d_c = yr - xr, yc - xc
            if {abs(d_r), abs(d_c)} == {1, 2}:
                if abs(d_r) == 2:
                    kleg[x, y] = sq(xr + d_r // 2, xc)
                else:
                    kleg[x, y] = sq(xr, xc + d_c // 2)
    horse_pair = np.zeros((NSQ, NSQ), dtype=bool)
    for x in range(NSQ):
        xr, xc = x // COLS, x % COLS
        for y in range(NSQ):
            yr, yc = y // COLS, y % COLS
            if {abs(yr - xr), abs(yc - xc)} == {1, 2}:
                horse_pair[x, y] = True

    # PAWN_ATK[e, s, k]: a pawn of side e at s attacks k
    # (reference: game.py:243-263 — side attacks gated on the river).
    pawn_atk = np.zeros((2, NSQ, NSQ), dtype=bool)
    for e in (0, 1):
        fwd = 1 if e == 0 else -1
        for s in range(NSQ):
            s_r, s_c = s // COLS, s % COLS
            r2 = s_r + fwd
            if 0 <= r2 < ROWS:
                pawn_atk[e, s, sq(r2, s_c)] = True
            crossed = s_r >= 5 if e == 0 else s_r <= 4
            if crossed:
                for c2 in (s_c - 1, s_c + 1):
                    if 0 <= c2 < COLS:
                        pawn_atk[e, s, sq(s_r, c2)] = True

    palace_sq = np.array(
        [
            [sq(r, c) for r in (0, 1, 2) for c in (3, 4, 5)],
            [sq(r, c) for r in (7, 8, 9) for c in (3, 4, 5)],
        ],
        dtype=np.int32,
    )

    mirror_sq = (rs * COLS + (COLS - 1 - cs)).astype(np.int32)
    mirror_act = (mirror_sq[FR] * NSQ + mirror_sq[TO]).astype(np.int32)

    return {
        "FR": FR,
        "TO": TO,
        "ALIGNED_A": aligned_a,
        "BLOCK": block,
        "KING_A": king_a,
        "ADV_A": adv_a,
        "ELE_A": ele_a,
        "HORSE_A": horse_a,
        "PAWN_A": pawn_a,
        "ALIGNED_SQ": aligned_sq,
        "BTW": btw,
        "HORSE_PAIR": horse_pair,
        "KLEG": kleg,
        "PAWN_ATK": pawn_atk,
        "PALACE_SQ": palace_sq,
        "MIRROR_SQ": mirror_sq,
        "MIRROR_ACT": mirror_act,
        "PIECE_VAL": PIECE_VAL,
        "INIT_BOARD": _initial_board(),
    }
