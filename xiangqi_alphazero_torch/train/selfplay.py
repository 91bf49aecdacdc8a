"""Lockstep self-play: the whole fleet of games plays one ply at a time.

Port of ``xiangqi_alphazero_tpu.train.selfplay`` (selfplay.py:48-480), with
its semantics: random openings (a game that ends in its opening restarts
fresh), material adjudication at the move cap, the binary and anneal
temperature schedules with their clocks, both resign gates, playout-cap
randomization with the per-ply and the per-game coin, the z labels, and the
Gumbel search (``search_algo="gumbel"``: the acted move is the halving's
winner and the recorded pi its improved policy, with no temperature and no
Dirichlet noise). The module doc and ``SelfPlaySettings`` of the JAX package
give the reference lines of each.

The game loop is a plain host loop, one ply per iteration, that stops when no
game is alive (the JAX package's hosted segments only kept each TPU program
short). Every lane of the fleet is searched and stepped at every ply, the
finished ones too, as in the JAX package, so the record holds the same
arrays.

Every random draw is made on the CPU from one ``torch.Generator`` and moved
to the device: the opening lengths and moves here, the cap coins here, the
Dirichlet gamma and the sampling Gumbels in ``search/mcts.py``, the root
Gumbels in ``search/gumbel.py``. So the card and the CPU play the same games
from the same seed. A fleet split over ranks (``parallel/sharding.py``)
draws each block at the global batch's shape and keeps its own rows
(``shard``), so 2 ranks play the games 1 rank plays. Tests replace the
draw functions (``_draw_*`` here,
``_gamma``/``_gumbel`` and ``_root_gumbel`` there) to inject the JAX
package's draws.

Under ``utils/profiling.py``'s ``recording()`` a call records its phases as
spans: ``selfplay.call`` (the root), ``selfplay.openings``, each ply's
``selfplay.alive_check`` and ``selfplay.ply`` (with ``selfplay.act``,
``selfplay.record``, ``selfplay.env_step`` and ``selfplay.resign``), and a
``draw.*`` span around each draw with its copy to the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..engine import env as E
from ..search import gumbel as G
from ..search import mcts as M
from ..utils import profiling as P


class SelfPlaySettings(NamedTuple):
    """The JAX package's settings (see its ``SelfPlaySettings`` for what
    each reference loop does)."""

    num_simulations: int = 80
    c_puct: float = 1.5
    max_children: int = 128
    max_game_length: int = 200
    temperature_threshold: int = 15
    temperature_schedule: str = "binary"
    random_opening_moves: int = 4
    enable_resign: bool = True
    resign_threshold: float = -0.85
    resign_check_steps: int = 3
    search_algo: str = "puct"
    max_considered: int = 16
    playout_cap_prob: float = 1.0
    playout_cap_sims: int = 0
    playout_cap_per_game: bool = False


class SelfPlayOut(NamedTuple):
    boards: torch.Tensor      # int8[T, B, 90]
    sides: torch.Tensor       # int8[T, B]
    pi_actions: torch.Tensor  # int32[T, B, K]
    pi_probs: torch.Tensor    # f32[T, B, K]
    values: torch.Tensor      # f32[T, B]  (z labels)
    rec: torch.Tensor         # bool[T, B] sample validity
    winners: torch.Tensor     # int8[B]
    plies: torch.Tensor       # int32[B] recorded plies per game
    total_moves: torch.Tensor  # int32[B] final move_count per game
    # the simulation count of the search run at each ply of the loop, one
    # entry per ply (each simulation and each env step launches the legal
    # mask once)
    sims_per_ply: Tuple[int, ...] = ()


@dataclasses.dataclass
class SPCarry:
    """Loop state between plies."""

    states: E.EnvState
    forced: torch.Tensor         # bool[B] resign/adjudication ended
    forced_winner: torch.Tensor  # int8[B]
    resign_run: torch.Tensor     # int32[B]
    n_rec: torch.Tensor          # int32[B]
    t: int
    boards: torch.Tensor
    sides: torch.Tensor
    pi_actions: torch.Tensor
    pi_probs: torch.Tensor
    rec: torch.Tensor


# ------------------------------------------------------------------ draws


def _draw_opening_counts(batch: int, n_max: int, gen: torch.Generator) -> torch.Tensor:
    """Per-game opening length, uniform in [0, n_max] (jax.random.randint)."""
    return torch.randint(0, n_max + 1, (batch,), generator=gen)


def _draw_opening_gumbel(batch: int, gen: torch.Generator) -> torch.Tensor:
    """Gumbel[B, 8100] for one round of uniform random opening moves."""
    return M._gumbel((batch, E.ACTION_SPACE), gen, "cpu")


def _draw_coin(p: float, shape, gen: torch.Generator) -> torch.Tensor:
    """Bernoulli(p) playout-cap coins of ``shape`` (() = one per ply)."""
    return torch.rand(shape, generator=gen) < p


# ---------------------------------------------------------------- helpers


def temperature_at(t: torch.Tensor, s: SelfPlaySettings) -> torch.Tensor:
    """Per-game sampling temperature at time base ``t``: total moves for
    the binary schedule, recorded steps for the anneal one (see the JAX
    package's ``temperature_at``)."""
    thr = s.temperature_threshold
    if s.temperature_schedule == "anneal":
        frac = (t - thr).float() / 10.0
        return torch.where(
            t < thr, 1.0, torch.where(t < thr + 10, 1.0 - 0.9 * frac, 0.1)
        ).float()
    return torch.where(t < thr, 1.0, 0.3).float()


def _uniform_legal_action(legal: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Uniform sample over each row's legal actions by Gumbel-max."""
    return torch.where(legal, g, -torch.inf).argmax(dim=-1).to(torch.int32)


def _adjudicate(board: torch.Tensor) -> torch.Tensor:
    """Material adjudication winner (reference: parallel_selfplay.py:77-86)."""
    diff = E.material(board, 1) - E.material(board, -1)
    return torch.where(diff > 30, 1, torch.where(diff < -30, -1, 0)).to(torch.int8)


def _select(mask: torch.Tensor, new: E.EnvState, old: E.EnvState) -> E.EnvState:
    """``new``'s fields where ``mask`` (per game), else ``old``'s."""
    out = {}
    for f in dataclasses.fields(E.EnvState):
        n, o = getattr(new, f.name), getattr(old, f.name)
        out[f.name] = torch.where(mask.reshape((-1,) + (1,) * (n.dim() - 1)), n, o)
    return E.EnvState(**out)


def _alive(c: SPCarry) -> torch.Tensor:
    return ~c.states.done & ~c.forced


def _is_serial(s: SelfPlaySettings) -> bool:
    """Whether the SERIAL reference loop's cap/resign semantics apply.
    Gumbel mode always uses the parallel loop's (adjudication at the move
    cap, resign gate > 10 recorded plies): it has no temperature at all."""
    return s.temperature_schedule == "anneal" and s.search_algo != "gumbel"


# ------------------------------------------------------------------- loop


@P.spanned("selfplay.openings")
def _init_carry(batch: int, s: SelfPlaySettings, gen: torch.Generator, device,
                shard: Optional[M.Shard] = None) -> SPCarry:
    """Fresh games + random openings (reference: parallel_selfplay.py:60-69)."""
    T, K = s.max_game_length, s.max_children
    total = M.global_shape((batch,), shard)[0]
    fresh = E.reset_batch(batch, device=device)
    states = fresh
    with P.span("draw.opening"):
        n_rand = M.own_rows(_draw_opening_counts(total, s.random_opening_moves, gen),
                            shard).to(device)
    aborted = torch.zeros(batch, dtype=torch.bool, device=device)
    for r in range(s.random_opening_moves):
        active = (r < n_rand) & ~aborted & ~states.done
        with P.span("draw.opening"):
            g = M.own_rows(_draw_opening_gumbel(total, gen), shard).to(device)
        act = _uniform_legal_action(states.legal, g)
        states = _select(active, E.step_batch(states, act), states)
        ended = active & states.done
        states = _select(ended, fresh, states)
        aborted = aborted | ended

    def z(*shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return SPCarry(
        states=states,
        forced=z(batch, dtype=torch.bool),
        forced_winner=z(batch, dtype=torch.int8),
        resign_run=z(batch, dtype=torch.int32),
        n_rec=z(batch, dtype=torch.int32),
        t=0,
        boards=z(T, batch, 90, dtype=torch.int8),
        sides=z(T, batch, dtype=torch.int8),
        pi_actions=torch.full((T, batch, K), -1, dtype=torch.int32, device=device),
        pi_probs=z(T, batch, K, dtype=torch.float32),
        rec=z(T, batch, dtype=torch.bool),
    )


def _make_body(
    eval_fn: Callable, batch: int, s: SelfPlaySettings, logits_eval: bool,
    gen: torch.Generator, shard: Optional[M.Shard] = None,
) -> Callable[[SPCarry], int]:
    """The per-ply body: advances the carry in place by one ply and returns
    the number of simulations its search ran."""
    gumbel = s.search_algo == "gumbel"
    capped = 0.0 < s.playout_cap_prob < 1.0 and s.playout_cap_sims > 0
    per_game = capped and s.playout_cap_per_game
    if per_game and gumbel:
        raise ValueError(
            "playout_cap_per_game needs search_algo='puct' (the gumbel "
            "halving schedule is static; use the batch-global coin)")
    serial = _is_serial(s)

    def search(states, sims, add_noise, **kw):
        if gumbel:
            gcfg = G.GumbelConfig(num_simulations=sims,
                                  max_considered=min(s.max_considered, s.max_children),
                                  max_children=s.max_children)
            return G.run_gumbel_mcts(eval_fn, states, gcfg, logits_eval=logits_eval,
                                     generator=gen, shard=shard)
        cfg = M.MCTSConfig(sims, s.c_puct, max_children=s.max_children)
        return M.run_mcts(eval_fn, states, cfg, add_noise=add_noise,
                          logits_eval=logits_eval, generator=gen, shard=shard, **kw)

    @P.spanned("selfplay.ply")
    def body(c: SPCarry) -> int:
        alive = _alive(c)
        if not serial:
            # parallel loop: material adjudication at the TOTAL-move cap,
            # checked at loop top (parallel_selfplay.py:79-89)
            adj = alive & (c.states.ply >= s.max_game_length)
            c.forced = c.forced | adj
            c.forced_winner = torch.where(adj, _adjudicate(c.states.board), c.forced_winner)
            alive = alive & ~adj

        dev = c.states.board.device
        if per_game:
            # independent coin per (game, move), one search with per-game
            # simulation budgets
            with P.span("draw.coin"):
                coins = M.own_rows(_draw_coin(s.playout_cap_prob,
                                              M.global_shape((batch,), shard), gen),
                                   shard).to(dev)
            budget = torch.where(coins, s.num_simulations, s.playout_cap_sims).to(torch.int32)
            res = search(c.states, s.num_simulations, True, sim_budget=budget,
                         noise_mask=coins)
            sims, is_full = s.num_simulations, coins[:, None]
        elif capped:
            # one coin per ply for the whole fleet: the full search, or a
            # cheap one run noiseless (KataGo §3.1)
            with P.span("draw.coin"):
                is_full = bool(_draw_coin(s.playout_cap_prob, (), gen))
            sims = s.num_simulations if is_full else s.playout_cap_sims
            res = search(c.states, sims, is_full)
        else:
            sims = s.num_simulations
            res = search(c.states, sims, True)

        with P.span("selfplay.act"):
            if gumbel:
                # paper semantics: train on the improved policy, act the
                # halving winner (the Gumbel sample is the exploration)
                pi = torch.where(res.valid, res.pi_improved, 0.0)
                act = res.chosen
            else:
                # schedule clock: total moves (parallel) vs recorded (serial)
                temp = temperature_at(c.n_rec if serial else c.states.ply, s)
                pi = M.action_probs_slots(res, temp)
                act = M.sample_actions(res, temp, gen, shard)
            if capped:
                # cheap searches carry NO policy target (value-only sample)
                pi = torch.where(torch.as_tensor(is_full, device=dev), pi, 0.0)

        with P.span("selfplay.record"):
            c.boards[c.t] = c.states.board
            c.sides[c.t] = c.states.side
            c.pi_actions[c.t] = res.actions
            c.pi_probs[c.t] = pi
            c.rec[c.t] = alive

        with P.span("selfplay.env_step"):
            states = _select(alive, E.step_batch(c.states, act), c.states)
        c.n_rec = c.n_rec + alive.to(torch.int32)

        # resign: the parallel loop checks the post-move state with no
        # terminal check in between (a resign overwrites the verdict of a
        # move that just ended the game); the serial loop skips finished
        # games and gates on step > 40 instead of > 10 recorded samples
        if s.enable_resign:
            with P.span("selfplay.resign"):
                _, val = M.evaluate(eval_fn, E.features(states.board, states.side))
                gate = alive & (c.n_rec > (40 if serial else 10))
                if serial:
                    gate = gate & ~states.done
                c.resign_run = torch.where(
                    gate & (val < s.resign_threshold),
                    c.resign_run + 1,
                    torch.where(gate, 0, c.resign_run),
                ).to(torch.int32)
                trigger = gate & (c.resign_run >= s.resign_check_steps)
                c.forced = c.forced | trigger
                c.forced_winner = torch.where(trigger, -states.side,
                                              c.forced_winner).to(torch.int8)
        c.states = states
        c.t += 1
        return sims

    return body


def _finalize(out: SPCarry, s: SelfPlaySettings, sims_per_ply) -> SelfPlayOut:
    # games still alive after the loop hit the move cap: material
    # adjudication in the parallel loop, a plain draw in the serial loop
    leftover = _alive(out)
    if _is_serial(s):
        cap_verdict = torch.zeros_like(out.forced_winner)
    else:
        cap_verdict = _adjudicate(out.states.board)
    forced_winner = torch.where(leftover, cap_verdict, out.forced_winner)
    # forced verdicts take precedence over the board's own
    winners = torch.where(
        out.forced | leftover,
        forced_winner,
        torch.where(out.states.done, out.states.winner, 0),
    ).to(torch.int8)

    # z labels vs recorded player (reference: parallel_selfplay.py:120-129)
    w = winners[None, :].int()
    sd = out.sides.int()
    z = torch.where(w == 0, 0.0, torch.where(sd == w, 1.0, -1.0)).float()
    z = torch.where(out.rec, z, 0.0)
    return SelfPlayOut(
        boards=out.boards,
        sides=out.sides,
        pi_actions=out.pi_actions,
        pi_probs=out.pi_probs,
        values=z,
        rec=out.rec,
        winners=winners,
        plies=out.n_rec,
        total_moves=out.states.ply,
        sims_per_ply=tuple(sims_per_ply),
    )


@P.spanned("selfplay.call")
def selfplay_games(
    eval_fn: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
    batch: int,
    s: SelfPlaySettings,
    generator: torch.Generator,
    device,
    logits_eval: bool = False,
    shard: Optional[M.Shard] = None,
) -> SelfPlayOut:
    """Play ``batch`` games on ``device`` to completion, one ply per loop
    iteration. ``eval_fn(features) -> (policy or logits, value)``, as for
    ``run_mcts``; ``generator`` is the CPU generator every draw comes from.
    With ``shard`` the games are that block of a global batch: each draw
    is the global batch's, of which they keep their rows, and the loop runs
    until no game of any shard is alive. Call under
    ``torch.inference_mode()`` with a net in eval mode."""
    if s.search_algo not in ("puct", "gumbel"):
        raise ValueError(f"unknown search_algo {s.search_algo!r}")
    if generator.device.type != "cpu":
        raise ValueError("self-play draws come from a CPU generator")
    device = torch.device(device)
    body = _make_body(eval_fn, batch, s, logits_eval, generator, shard)
    c = _init_carry(batch, s, generator, device, shard)
    any_alive = bool if shard is None else shard.any
    sims_per_ply = []
    while c.t < s.max_game_length:
        with P.span("selfplay.alive_check"):   # the loop's one blocking read a ply
            if not any_alive(bool(_alive(c).any())):
                break
        sims_per_ply.append(body(c))
    return _finalize(c, s, sims_per_ply)
