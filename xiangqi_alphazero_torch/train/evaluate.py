"""Gated model evaluation: candidate vs incumbent, alternating colors.

Port of ``xiangqi_alphazero_tpu.train.evaluate``. Reference semantics
(training/train.py:449-535): temperature 0 and no root noise,
eval_simulations per move; a game not finished at max_game_length is a draw
(no material adjudication here, unlike self-play); win_rate = (wins +
0.5*draws) / games, promotion at >= eval_win_rate (in the trainer).

All eval games run in one lockstep batch, split into contiguous color halves
(the candidate is red in the first half). Eval games start from the initial
position with no openings, so every live game sits at the same ply: at each
ply exactly one model is to move in each half, and each model searches only
its half. Split over ranks (``parallel/sharding.py::make_sharded_eval``),
a rank holds a block of the match, and its games take their colours from
their global index. The match is a host loop, one ply per iteration; the search and
the pick are deterministic, so no generator is needed. The per-half search
and pick are hooks (``_make_body``), which the arena (``arena.py``) fills
with other searches, budgets and temperature sampling.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..engine import env as E
from ..search import mcts as M


class EvalSettings(NamedTuple):
    num_simulations: int = 100
    c_puct: float = 1.5
    max_children: int = 128
    max_game_length: int = 300


class EvalOut(NamedTuple):
    new_wins: torch.Tensor
    old_wins: torch.Tensor
    draws: torch.Tensor
    winners: torch.Tensor     # int8[B] (+1 red, -1 black, 0 draw)
    new_is_red: torch.Tensor  # bool[B]
    avg_plies: torch.Tensor   # f32 scalar, mean game length
    plies_run: int = 0        # plies the loop ran (each: two searches, one step)


def _greedy(res: M.SearchResult) -> torch.Tensor:
    # reference temp-0 pick: first max-visit child in movegen order
    slot = M.greedy_slots(res)
    return res.actions.gather(1, slot[:, None])[:, 0]


def _make_body(
    eval_new: Callable, eval_old: Callable, batch: int, s: EvalSettings,
    logits_eval: bool,
    select_new: Optional[Callable] = None,
    select_old: Optional[Callable] = None,
    search_new: Optional[Callable] = None,
    search_old: Optional[Callable] = None,
    shard: Optional[M.Shard] = None,
) -> Callable:
    """Per-ply body of the color-halved lockstep match: (states, t) ->
    states.

    ``select_new``/``select_old`` map a search result to each half's
    actions; the default is the reference's deterministic greedy pick
    (temperature 0, train.py:478-496). ``search_new``/``search_old`` map
    ``(eval_fn, states)`` to a result and default to the PUCT search at
    ``s.num_simulations`` with no noise. The arena overrides them to pit
    other algorithms and budgets (for example gumbel-32 against puct-200);
    this is the one copy of the color-half logic every match shares. With
    ``shard`` the batch is that block of the global match, and the halves
    go by global game index."""
    mcfg = M.MCTSConfig(s.num_simulations, s.c_puct, max_children=s.max_children)

    def default_search(ev, st):
        return M.run_mcts(ev, st, mcfg, add_noise=False, logits_eval=logits_eval)

    select_new = select_new or _greedy
    select_old = select_old or _greedy
    search_new = search_new or default_search
    search_old = search_old or default_search
    offset, total = (0, batch) if shard is None else (shard.offset, shard.total)
    new_is_red = torch.arange(offset, offset + batch) < total // 2

    def body(states: E.EnvState, t: int) -> E.EnvState:
        # red moves at even plies: search the games where the candidate
        # moves with its model, the others with the incumbent's (in the
        # whole match, the candidate's half first)
        new_moves = (new_is_red if t % 2 == 0 else ~new_is_red).to(states.board.device)
        act = torch.empty(batch, dtype=torch.int32, device=states.board.device)
        for moves, ev, search, select in ((new_moves, eval_new, search_new, select_new),
                                          (~new_moves, eval_old, search_old, select_old)):
            idx = torch.nonzero(moves)[:, 0]
            if idx.numel():
                act[idx] = select(search(ev, states.map(lambda x: x[idx]))).to(torch.int32)
        return E.step_batch(states, act)

    return body


def _finalize(states: E.EnvState, batch: int, plies_run: int,
              shard: Optional[M.Shard] = None) -> EvalOut:
    offset, total = (0, batch) if shard is None else (shard.offset, shard.total)
    dev = states.board.device
    new_is_red = torch.arange(offset, offset + batch, device=dev) < total // 2
    winners = torch.where(states.done, states.winner, 0).to(torch.int8)
    new_won = ((winners == 1) & new_is_red) | ((winners == -1) & ~new_is_red)
    old_won = ((winners == -1) & new_is_red) | ((winners == 1) & ~new_is_red)
    return EvalOut(
        new_wins=new_won.sum(dtype=torch.int32),
        old_wins=old_won.sum(dtype=torch.int32),
        draws=(winners == 0).sum(dtype=torch.int32),
        winners=winners,
        new_is_red=new_is_red,
        avg_plies=states.ply.float().mean(),
        plies_run=plies_run,
    )


def evaluate_pair(
    eval_new: Callable,
    eval_old: Callable,
    batch: int,
    s: EvalSettings,
    device,
    logits_eval: bool = False,
    *,
    select_new: Optional[Callable] = None,
    select_old: Optional[Callable] = None,
    search_new: Optional[Callable] = None,
    search_old: Optional[Callable] = None,
    shard: Optional[M.Shard] = None,
) -> EvalOut:
    """Play the match of ``batch`` games (even: two color halves) on
    ``device``. ``eval_new``/``eval_old`` map features to (policy or
    logits, value), as for ``run_mcts``; the hooks are ``_make_body``'s.
    With ``shard`` the games are that block of the global match, which
    runs until no game of any shard is alive. Call under
    ``torch.inference_mode()`` with both nets in eval mode."""
    if (batch if shard is None else shard.total) % 2:
        raise ValueError("eval batch must be even (color halves)")
    body = _make_body(eval_new, eval_old, batch, s, logits_eval, select_new,
                      select_old, search_new, search_old, shard)
    states = E.reset_batch(batch, device=torch.device(device))
    any_alive = bool if shard is None else shard.any
    t = 0
    while t < s.max_game_length and any_alive(not bool(states.done.all())):
        states = body(states, t)
        t += 1
    return _finalize(states, batch, t, shard)
