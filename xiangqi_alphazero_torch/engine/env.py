"""Batched Xiangqi environment in PyTorch.

Port of ``xiangqi_alphazero_tpu.engine.env``. Every function works on a
leading batch axis (the JAX package writes single-board functions and
vmaps them). The semantics are the JAX package's, bit for bit:

- ``legal_mask`` is the plain PyTorch version of the legal-move mask: the
  geometric blocker counts come from ONE ``occupancy @ BLOCK`` product, and
  the king-safety filter updates compacted enemy attacker slots (2 rooks,
  2 cannons, the enemy king, 2 horses, 5 pawns) by each move's (from, to)
  deltas, with a 9-square palace sub-pass for king moves. The CPU path runs
  it; on the card ``legal_mask_batch`` launches the hand-written CUDA
  kernel (``ops/legal_mask.py``) instead, and ``chip_smoke.py`` holds the
  two against each other.
- ``step_batch`` applies one move per game, keeps the 12-slot pre-move
  snapshot ring for the repetition rule, evaluates the terminal conditions
  in the reference's priority order, and freezes finished games.

Moves are applied with plain indexed writes: the dense one-hot selects of
the JAX package only worked around a TPU scatter miscompile.

Layouts follow the JAX package at every public function: boards int8[B, 90]
(square = row * 9 + col, row 0 = red base), sides int8[B] (+1 red to move),
actions a = from * 90 + to, features NHWC float32[B, 10, 9, 15].
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import profiling as _profiling
from . import tables as _tables

ROWS, COLS, NSQ = 10, 9, 90
ACTION_SPACE = NSQ * NSQ
HIST_LEN = 12  # repetition window (reference: game.py:607-614)

# screen count that makes each ray slot an attacker: 2 rooks, 2 cannons,
# enemy king ("flying general")
_RAY_WANT = (0, 0, 1, 1, 0)


@functools.lru_cache(maxsize=None)
def _T(device: torch.device) -> dict:
    """The constant tables as tensors on ``device`` (built once per device)."""
    t = _tables.tables()
    long_keys = ("FR", "TO", "KLEG", "PALACE_SQ", "MIRROR_SQ", "MIRROR_ACT")
    out = {}
    for k, v in t.items():
        if k in long_keys:
            out[k] = torch.from_numpy(v.astype(np.int64)).to(device)
        elif k == "BLOCK":
            out["BLOCK_F"] = torch.from_numpy(v.astype(np.float32)).to(device)
        elif k == "BTW":
            out[k] = torch.from_numpy(v.astype(np.int16)).to(device)
        else:
            out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    out["RAY_WANT"] = torch.tensor(_RAY_WANT, dtype=torch.int16, device=device)
    out["SQ"] = torch.arange(NSQ, device=device)
    return out


@dataclasses.dataclass
class EnvState:
    """A batch of games; every field has the batch on its leading axis."""

    board: torch.Tensor   # int8[B, 90]
    side: torch.Tensor    # int8[B], +1 red to move / -1 black
    ply: torch.Tensor     # int32[B], move_count
    quiet: torch.Tensor   # int32[B], consecutive non-capture plies
    hist: torch.Tensor    # int8[B, HIST_LEN, 90], pre-move snapshot ring
    done: torch.Tensor    # bool[B]
    winner: torch.Tensor  # int8[B]: 1 red, -1 black, 0 draw (valid when done)
    legal: torch.Tensor   # bool[B, 8100], legal mask for `side`

    def replace(self, **kw) -> "EnvState":
        return dataclasses.replace(self, **kw)

    def map(self, fn) -> "EnvState":
        """A state of ``fn`` applied to every field (all are batch-major)."""
        return EnvState(**{f.name: fn(getattr(self, f.name)) for f in dataclasses.fields(self)})

    def to(self, device) -> "EnvState":
        return self.map(lambda x: x.to(device))


def cat_states(states: Sequence[EnvState]) -> EnvState:
    """Concatenate batches of games along the batch axis."""
    return EnvState(**{
        f.name: torch.cat([getattr(s, f.name) for s in states])
        for f in dataclasses.fields(EnvState)
    })


# --------------------------------------------------------------------------
# Attacker slots (shared by the legal mask and the check test)
# --------------------------------------------------------------------------


def _find_slots(bi: torch.Tensor, code: torch.Tensor, n: int):
    """The first ``n`` squares (ascending) holding piece ``code`` per board:
    (int64[B, n] squares, bool[B, n] valid). Unfilled slots take the lowest
    non-matching squares, like ``jax.lax.top_k`` on the 0/1 match vector;
    they are masked by ``valid`` wherever they are read."""
    sq = torch.arange(NSQ, device=bi.device)
    key = torch.where(bi == code[:, None], sq, sq + NSQ)
    first = key.sort(dim=1).values[:, :n]
    return first % NSQ, first < NSQ


def _first(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True per row (0 when there is none), as argmax."""
    return mask.to(torch.uint8).argmax(dim=1)


def _attackers(bi: torch.Tensor, s: torch.Tensor):
    """Enemy attacker slots of the side ``s`` (int64[B], +-1) to move."""
    rk_i, rk_v = _find_slots(bi, -s * 5, 2)
    cn_i, cn_v = _find_slots(bi, -s * 6, 2)
    hs_i, hs_v = _find_slots(bi, -s * 4, 2)
    pw_i, pw_v = _find_slots(bi, -s * 7, 5)
    is_ek = bi == -s[:, None]
    ek, ek_v = _first(is_ek), is_ek.any(dim=1)
    ray_s = torch.cat([rk_i, cn_i, ek[:, None]], dim=1)     # [B, 5]
    ray_v = torch.cat([rk_v, cn_v, ek_v[:, None]], dim=1)
    return ray_s, ray_v, hs_i, hs_v, pw_i, pw_v


# --------------------------------------------------------------------------
# Legal move mask (the kernel's plain version)
# --------------------------------------------------------------------------


def legal_mask(board: torch.Tensor, side: torch.Tensor) -> torch.Tensor:
    """bool[B, 8100] legal-action mask for ``side`` (int8[B]) on ``board``
    (int8[B, 90]). Plain PyTorch; ``legal_mask_batch`` dispatches."""
    T = _T(board.device)
    FR, TO = T["FR"], T["TO"]
    bsz = board.shape[0]
    bi = board.long()
    s = side.long()
    si = (s < 0).long()   # 0 red / 1 black
    ei = 1 - si

    occ = board != 0
    occ_i = occ.to(torch.int16)
    # blocker counts are small integers (<= 8): exact in float32
    blockcnt = occ.float() @ T["BLOCK_F"]
    b0 = blockcnt < 0.5
    b1 = (blockcnt > 0.5) & (blockcnt < 1.5)

    pf = bi[:, FR]
    pt = bi[:, TO]
    spf = pf * s[:, None]   # own piece kinds positive at the from-square
    spt = pt * s[:, None]
    own_t = spt > 0
    enemy_t = spt < 0
    empty_t = pt == 0
    occ_t = ~empty_t

    pseudo = (
        ((spf == 1) & T["KING_A"][si])
        | ((spf == 2) & T["ADV_A"][si])
        | ((spf == 3) & T["ELE_A"][si] & b0)
        | ((spf == 4) & T["HORSE_A"] & b0)
        | ((spf == 5) & T["ALIGNED_A"] & b0)
        | ((spf == 7) & T["PAWN_A"][si])
    ) & ~own_t
    pseudo |= (spf == 6) & T["ALIGNED_A"] & ((b0 & empty_t) | (b1 & enemy_t))

    # ---- king-safety filter -------------------------------------------
    is_my_king = bi == s[:, None]
    has_king = is_my_king.any(dim=1)
    k = _first(is_my_king)                                     # [B]
    ray_s, ray_v, hs_i, hs_v, pw_i, pw_v = _attackers(bi, s)
    want = T["RAY_WANT"]

    # Generic path: the king stays at k; the move is (FR[a], TO[a]).
    btwrows = T["BTW"][ray_s, k[:, None]]                      # [B, 5, 90]
    cnt0 = (btwrows * occ_i[:, None, :]).sum(dim=-1, dtype=torch.int16)
    zero = torch.zeros((), dtype=torch.int16, device=board.device)
    cntp = (
        cnt0[:, :, None]
        - btwrows[:, :, FR]
        + torch.where(occ_t[:, None, :], zero, btwrows[:, :, TO])
    )
    ray_hit = (
        (ray_v & T["ALIGNED_SQ"][ray_s, k[:, None]])[:, :, None]
        & (TO != ray_s[:, :, None])
        & (cntp == want[None, :, None])
    )
    unsafe = ray_hit.any(dim=1)

    hs_geom = T["HORSE_PAIR"][hs_i, k[:, None]]                # [B, 2]
    hs_leg = T["KLEG"][hs_i, k[:, None]]
    hs_locc = occ_i.gather(1, hs_leg)
    leg = hs_leg[:, :, None]
    loccp = torch.where(
        TO == leg, 1, torch.where(FR == leg, 0, hs_locc[:, :, None])
    )
    horse_hit = (
        (hs_v & hs_geom)[:, :, None]
        & (TO != hs_i[:, :, None])
        & (loccp == 0)
    )
    unsafe |= horse_hit.any(dim=1)

    pw_geom = T["PAWN_ATK"][ei[:, None], pw_i, k[:, None]]     # [B, 5]
    pawn_hit = (pw_v & pw_geom)[:, :, None] & (TO != pw_i[:, :, None])
    unsafe |= pawn_hit.any(dim=1)

    # King-move path: 9 candidate palace destinations j, king vacates k.
    pal = T["PALACE_SQ"][si]                                   # [B, 9]
    rows_pal = T["BTW"][ray_s[:, :, None], pal[:, None, :]]    # [B, 5, 9, 90]
    cnt0p = (rows_pal * occ_i[:, None, None, :]).sum(dim=-1, dtype=torch.int16)
    at_k = rows_pal.gather(3, k[:, None, None, None].expand(bsz, 5, 9, 1))
    cntpp = cnt0p - at_k[..., 0]
    pal_ray = (
        (ray_v[:, :, None] & T["ALIGNED_SQ"][ray_s[:, :, None], pal[:, None, :]])
        & (pal[:, None, :] != ray_s[:, :, None])
        & (cntpp == want[None, :, None])
    )
    unsafe_pal = pal_ray.any(dim=1)                            # [B, 9]

    pgeom = T["HORSE_PAIR"][hs_i[:, :, None], pal[:, None, :]]  # [B, 2, 9]
    pleg = T["KLEG"][hs_i[:, :, None], pal[:, None, :]]
    pleg_occ = occ_i.gather(1, pleg.reshape(bsz, -1)).reshape(pleg.shape)
    ploccp = torch.where(
        pleg == pal[:, None, :],
        1,
        torch.where(pleg == k[:, None, None], 0, pleg_occ),
    )
    pal_horse = (
        hs_v[:, :, None]
        & pgeom
        & (pal[:, None, :] != hs_i[:, :, None])
        & (ploccp == 0)
    )
    unsafe_pal |= pal_horse.any(dim=1)

    pal_pawn = (
        pw_v[:, :, None]
        & T["PAWN_ATK"][ei[:, None, None], pw_i[:, :, None], pal[:, None, :]]
        & (pal[:, None, :] != pw_i[:, :, None])
    )
    unsafe_pal |= pal_pawn.any(dim=1)

    unsafe_sq = torch.zeros((bsz, NSQ), dtype=torch.bool, device=board.device)
    unsafe_sq.scatter_(1, pal, unsafe_pal)
    king_unsafe = unsafe_sq[:, TO]

    safe = torch.where(FR == k[:, None], ~king_unsafe, ~unsafe)
    return pseudo & safe & has_king[:, None]


def is_in_check(board: torch.Tensor, side: torch.Tensor) -> torch.Tensor:
    """bool[B]: is ``side``'s king attacked? (reference: game.py:652-661)."""
    T = _T(board.device)
    bi = board.long()
    s = side.long()
    ei = (s > 0).long()   # attacker side index
    occ_i = (board != 0).to(torch.int16)
    is_my_king = bi == s[:, None]
    k = _first(is_my_king)
    ray_s, ray_v, hs_i, hs_v, pw_i, pw_v = _attackers(bi, s)

    btwrows = T["BTW"][ray_s, k[:, None]]                      # [B, 5, 90]
    cnt = (btwrows * occ_i[:, None, :]).sum(dim=-1, dtype=torch.int16)
    att = (
        ray_v & T["ALIGNED_SQ"][ray_s, k[:, None]] & (cnt == T["RAY_WANT"])
    ).any(dim=1)
    leg_occ = occ_i.gather(1, T["KLEG"][hs_i, k[:, None]])
    att |= (hs_v & T["HORSE_PAIR"][hs_i, k[:, None]] & (leg_occ == 0)).any(dim=1)
    att |= (pw_v & T["PAWN_ATK"][ei[:, None], pw_i, k[:, None]]).any(dim=1)
    return att | ~is_my_king.any(dim=1)


def legal_mask_batch(board: torch.Tensor, side: torch.Tensor) -> torch.Tensor:
    """Batched legal mask bool[B, 8100]. A CUDA tensor goes to the
    hand-written kernel (``ops/legal_mask.py``), a CPU tensor to the plain
    ``legal_mask``; the two are bit-identical."""
    from ..ops import legal_mask as lm   # it imports this module

    return lm.legal_mask(board, side)


# --------------------------------------------------------------------------
# Features / material / mirror
# --------------------------------------------------------------------------


def features(board: torch.Tensor, side: torch.Tensor) -> torch.Tensor:
    """NN planes NHWC float32[B, 10, 9, 15] (reference: game.py:618-640):
    0-6 own pieces, 7-13 opponent, 14 = 1.0 iff red to move."""
    b = board.reshape(-1, ROWS, COLS, 1)
    kinds = torch.arange(1, 8, device=board.device) * side.long()[:, None]
    kinds = kinds.to(board.dtype)[:, None, None, :]           # [B, 1, 1, 7]
    own = b == kinds
    opp = b == -kinds
    turn = (side > 0)[:, None, None, None].expand(-1, ROWS, COLS, 1)
    return torch.cat([own, opp, turn], dim=-1).float()


def material(board: torch.Tensor, side) -> torch.Tensor:
    """int32[B] material score for ``side`` (an int or int8[B])
    (reference: game.py:552-563, 74)."""
    T = _T(board.device)
    bi = board.long()
    s = torch.as_tensor(side, device=board.device).long().reshape(-1, 1)
    v = T["PIECE_VAL"][bi.abs()]
    return torch.where(bi * s > 0, v, 0).sum(dim=1, dtype=torch.int32)


def mirror_board(board: torch.Tensor) -> torch.Tensor:
    return board[..., _T(board.device)["MIRROR_SQ"]]


def mirror_actions(actions: torch.Tensor) -> torch.Tensor:
    return _T(actions.device)["MIRROR_ACT"][actions.long()]


# --------------------------------------------------------------------------
# Game lifecycle
# --------------------------------------------------------------------------


def _terminal(
    board: torch.Tensor,
    side: torch.Tensor,
    ply: torch.Tensor,
    quiet: torch.Tensor,
    hist: torch.Tensor,
    legal: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(done bool[B], winner int8[B]) in the reference's exact priority
    order (reference: game.py:565-616). ``side`` is the player now to move.
    Like the JAX package, an ongoing game's winner reads -1 (the first
    condition's winner); it is meaningful only where ``done``."""
    r_king = (board == 1).any(dim=1)
    b_king = (board == -1).any(dim=1)
    no_moves = ~legal.any(dim=1)

    diff = material(board, 1) - material(board, -1)
    adjud = torch.where(diff > 30, 1, torch.where(diff < -30, -1, 0))

    slot = torch.arange(HIST_LEN, device=board.device)
    valid = slot[None, :] < ply[:, None]
    same = (hist == board[:, None, :]).all(dim=2) & valid
    rep3 = (ply >= 6) & (same.sum(dim=1) >= 3)

    conds = torch.stack(
        [~r_king, ~b_king, no_moves, quiet >= 120, ply >= 200, rep3], dim=1
    )
    ones = torch.ones_like(adjud)
    winners = torch.stack(
        [-ones, ones, -side.long(), 0 * ones, adjud, 0 * ones], dim=1
    )
    first = _first(conds)
    winner = winners.gather(1, first[:, None])[:, 0].to(torch.int8)
    return conds.any(dim=1), winner


def apply_move(board: torch.Tensor, f: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Move the piece on square f[b] to square t[b] (a new tensor;
    f == t empties the square, as in the JAX package)."""
    idx = torch.arange(board.shape[0], device=board.device)
    out = board.clone()
    out[idx, t] = board[idx, f]
    out[idx, f] = 0
    return out


def update_hist(hist: torch.Tensor, ply: torch.Tensor, board: torch.Tensor) -> torch.Tensor:
    """hist[b, ply[b] % HIST_LEN] = board[b] (a new tensor)."""
    idx = torch.arange(board.shape[0], device=board.device)
    out = hist.clone()
    out[idx, ply.long() % HIST_LEN] = board
    return out


def step_core(state: EnvState, action: torch.Tensor) -> EnvState:
    """Board/counter/history update ONLY — ``legal``/``done``/``winner`` are
    left STALE (the search descent re-walks interior nodes whose status is
    in the tree). Does NOT freeze finished games."""
    a = action.long()
    f, t = a // NSQ, a % NSQ
    idx = torch.arange(a.shape[0], device=a.device)
    captured = state.board[idx, t]
    quiet = torch.where(captured != 0, 0, state.quiet + 1).to(torch.int32)
    return state.replace(
        board=apply_move(state.board, f, t),
        side=-state.side,
        ply=state.ply + 1,
        quiet=quiet,
        hist=update_hist(state.hist, state.ply, state.board),
    )


@_profiling.spanned("env.evaluate")
def evaluate_batch(state: EnvState) -> EnvState:
    """Fill in ``legal``/``done``/``winner`` from the core fields (the legal
    mask runs the CUDA kernel on the card)."""
    legal = legal_mask_batch(state.board, state.side)
    done, winner = _terminal(
        state.board, state.side, state.ply, state.quiet, state.hist, legal
    )
    return state.replace(legal=legal, done=done, winner=winner)


def step_batch(state: EnvState, action: torch.Tensor) -> EnvState:
    """Apply ``action`` (int[B] in [0, 8100)) per game. Finished games
    freeze: their fields come back unchanged."""
    new = evaluate_batch(step_core(state, action))
    out = {}
    for f in dataclasses.fields(EnvState):
        o, n = getattr(state, f.name), getattr(new, f.name)
        keep = state.done.reshape((-1,) + (1,) * (o.dim() - 1))
        out[f.name] = torch.where(keep, o, n)
    return EnvState(**out)


def reset_batch(batch: int, device="cpu") -> EnvState:
    """``batch`` games at the start position."""
    T = _T(torch.device(device))
    board = T["INIT_BOARD"].expand(batch, NSQ).contiguous()
    side = torch.ones(batch, dtype=torch.int8, device=board.device)
    zeros = torch.zeros(batch, dtype=torch.int32, device=board.device)
    return EnvState(
        board=board,
        side=side,
        ply=zeros,
        quiet=zeros.clone(),
        hist=torch.zeros((batch, HIST_LEN, NSQ), dtype=torch.int8, device=board.device),
        done=torch.zeros(batch, dtype=torch.bool, device=board.device),
        winner=torch.zeros(batch, dtype=torch.int8, device=board.device),
        legal=legal_mask_batch(board, side),
    )


def state_from_numpy(
    board: np.ndarray,
    side: int,
    ply: int = 0,
    quiet: int = 0,
    hist: Optional[np.ndarray] = None,
    device="cpu",
) -> EnvState:
    """A batch of ONE game built from host data. Its legal mask goes through
    ``legal_mask_batch``, so on the card the root's mask comes from the
    kernel."""
    dev = torch.device(device)
    b = torch.as_tensor(np.asarray(board, np.int8).reshape(1, NSQ), device=dev)
    s = torch.tensor([side], dtype=torch.int8, device=dev)
    h = np.zeros((HIST_LEN, NSQ), np.int8) if hist is None else hist
    h = torch.as_tensor(np.asarray(h, np.int8).reshape(1, HIST_LEN, NSQ), device=dev)
    p = torch.tensor([ply], dtype=torch.int32, device=dev)
    q = torch.tensor([quiet], dtype=torch.int32, device=dev)
    legal = legal_mask_batch(b, s)
    done, winner = _terminal(b, s, p, q, h, legal)
    return EnvState(
        board=b, side=s, ply=p, quiet=q, hist=h, done=done, winner=winner,
        legal=legal,
    )
