"""Hand-made boards at the edges of the rules, for the legal-mask checks.

Random playouts rarely reach these, so the parity tests and
``chip_smoke.py`` add them to the boards they compare the kernel on.
``wild_boards`` goes further, to piece sets no game reaches.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .tables import sq


def _board(pieces: Dict[Tuple[int, int], int]) -> np.ndarray:
    b = np.zeros(90, np.int8)
    for (r, c), p in pieces.items():
        b[sq(r, c)] = p
    return b


def edge_boards() -> Dict[str, Tuple[np.ndarray, int]]:
    """name -> (int8[90] board, side to move)."""
    return {
        # the side to move has no king: no move is legal
        "no_king": (_board({(0, 0): 5, (3, 4): 7, (9, 4): -1}), 1),
        # flying general: the rook between the kings may only slide along
        # the file
        "flying_general": (_board({(0, 4): 1, (4, 4): 5, (9, 4): -1, (9, 0): -5}), 1),
        # kings face on an open file: every move that keeps the file open
        # is illegal
        "kings_facing": (_board({(0, 4): 1, (9, 4): -1, (3, 0): 7}), 1),
        # cannon screens: a capture over one screen, none over two, and no
        # quiet move past a screen
        "cannon_screens": (_board({
            (0, 3): 1, (2, 1): 6, (5, 1): 7, (8, 1): -5, (2, 4): -7,
            (2, 6): -4, (2, 8): -5, (9, 5): -1,
        }), 1),
        # a black cannon checks through one screen: the king steps aside or
        # a second screen goes in
        "cannon_check": (_board({
            (0, 4): 1, (3, 4): 7, (7, 4): -6, (0, 0): 5, (9, 3): -1, (5, 2): 6,
        }), 1),
        # horse legs: a blocked leg stops both the horse's move and its
        # check
        "horse_leg": (_board({
            (0, 4): 1, (2, 5): -4, (1, 5): 2, (4, 4): 4, (5, 4): -7,
            (9, 3): -1, (3, 0): 7,
        }), 1),
        # every king move steps into an attack (rook file, facing king,
        # horse); only the pawn may move
        "king_boxed": (_board({
            (0, 4): 1, (9, 5): -5, (9, 3): -1, (2, 2): -4, (3, 0): 7,
        }), 1),
        # black to move, pinned by a red rook and threatened by crossed pawns
        "black_pinned": (_board({
            (9, 4): -1, (8, 4): -3, (0, 4): 5, (0, 3): 1, (7, 3): 7,
            (8, 5): 7, (6, 0): -7,
        }), -1),
        # in check from a crossed pawn beside the king
        "pawn_check": (_board({(9, 4): -1, (9, 3): 7, (0, 5): 1, (5, 0): -5}), -1),
        # a cannon checks over an enemy screen: capturing the screen puts a
        # new screen on the same square, so the check stays
        "cannon_screen_capture": (_board({
            (0, 4): 1, (7, 4): -6, (4, 4): -7, (4, 0): 5, (9, 3): -1,
        }), 1),
        # a rook on a horse's leg: every rook move uncovers the horse's check
        "horse_discovered": (_board({
            (0, 4): 1, (2, 5): -4, (1, 5): 5, (9, 3): -1, (3, 0): 7,
        }), 1),
    }


def wild_boards(n: int = 32, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(int8[n, 90] boards, int8[n] sides) of seeded random piece sets that
    no game reaches: 4-30 pieces drawn mostly from rooks, cannons, horses and
    pawns (so a side often has three or more of one), and kings in turn
    missing for the side to move, facing on an open file, anywhere on the
    board, or several on a side. They pin the mask's slot semantics (the
    first 2 rooks, 2 cannons, 2 horses and 5 pawns in square order, the
    first king)."""
    rng = np.random.default_rng(seed)
    boards = np.zeros((n, 90), np.int8)
    sides = np.where(rng.random(n) < 0.5, 1, -1).astype(np.int8)
    for i in range(n):
        squares = rng.permutation(90)
        count = int(rng.integers(4, 31))
        kinds = rng.choice([2, 3, 4, 5, 6, 7], size=count, p=[0.05, 0.05, 0.15, 0.3, 0.2, 0.25])
        boards[i, squares[:count]] = kinds * rng.choice([1, -1], size=count)
        free, s = squares[count:], int(sides[i])
        mode = i % 4
        if mode == 0:       # only the enemy has a king
            boards[i, free[0]] = -s
        elif mode == 1:     # kings face each other on an open file
            c = int(rng.integers(3, 6))
            boards[i, [sq(r, c) for r in range(10)]] = 0
            boards[i, sq(int(rng.integers(0, 3)), c)] = 1
            boards[i, sq(int(rng.integers(7, 10)), c)] = -1
        elif mode == 2:     # one king each, anywhere
            boards[i, free[0]], boards[i, free[1]] = 1, -1
        else:               # several kings on a side
            boards[i, free[: int(rng.integers(2, 5))]] = s
            boards[i, free[5: 5 + int(rng.integers(1, 3))]] = -s
    return boards, sides
