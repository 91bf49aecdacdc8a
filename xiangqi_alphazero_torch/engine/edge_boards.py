"""Hand-made boards at the edges of the rules, for the legal-mask checks.

Random playouts rarely reach these, so the parity tests and
``chip_smoke.py`` add them to the boards they compare the kernel on.
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
    }
