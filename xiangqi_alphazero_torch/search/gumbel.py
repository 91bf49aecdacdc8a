"""Gumbel AlphaZero search: policy improvement with sequential halving.

Port of ``xiangqi_alphazero_tpu.search.gumbel`` ("Policy improvement by
planning with Gumbel", Danihelka et al., ICLR 2022; the mctx-style root
procedure), with its semantics, over the same batched tree, env and backup
as the PUCT search (``search/mcts.py``):

- root: one Gumbel g(a) per legal slot; the top-m slots by g + logits are
  the candidates (no Dirichlet noise: the Gumbel sample is the
  exploration);
- sequential halving: the budget is split into ceil(log2 m) phases
  (``halving_schedule``); each phase visits its survivors round-robin, then
  keeps the top half by g + logits + sigma(q), with
  sigma(q) = (c_visit + max_b N(b)) * c_scale * q;
- the acted move (``chosen``) is the final argmax of that score;
- interior nodes select argmax_a pi'(a) - N(a) / (1 + sum_b N(b)),
  pi' = softmax(logits + sigma(completed Q)), exact ties going to the least
  packed slot key (movegen order), as the PUCT select;
- the training target is the improved policy pi' at the root over all legal
  slots (``pi_improved``).

It is an opt-in mode: strength per simulation for low-latency serving and
few-simulation training. Tree memory, node allocation (simulation i creates
node i+1), the env step and the backup are the PUCT search's; only the
root (forced to the schedule's candidate) and the interior rule differ.

Differences from the JAX package, none of which changes a result:

- The root draws are one [B, K] block from a CPU ``torch.Generator`` in
  row-major order (``_root_gumbel``), so lane i's row is the same whatever
  the batch width, as JAX's one row per split key is. JAX and torch streams
  differ; tests inject JAX's draws here.
- ``top_k`` and the halving's ``argsort`` are stable sorts
  (``torch.sort(stable=True)``): equal scores keep ascending slot order, as
  ``jax.lax.top_k`` and ``jnp.argsort`` give them; ``torch.topk`` promises
  no order of ties. The softmaxes are written out (exp, then a divide by
  the sum), as ``jax.nn.softmax`` computes them.
"""

from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from ..engine import env as E
from ..utils import profiling as P
from . import mcts as M
from .mcts import MCTSConfig, init_tree, make_slot_priors, unpack_actions


class GumbelConfig(NamedTuple):
    num_simulations: int = 32
    max_considered: int = 16   # m: root candidates entering the halving
    c_visit: float = 50.0      # sigma(q) = (c_visit + max_N) * c_scale * q
    c_scale: float = 0.1       # (paper / mctx defaults)
    max_children: int = 128


class GumbelResult(NamedTuple):
    actions: torch.Tensor      # i32[B, K] root actions (-1 pad)
    visits: torch.Tensor       # i32[B, K] root visit counts
    valid: torch.Tensor        # bool[B, K]
    chosen: torch.Tensor       # i32[B] the Gumbel-selected action (-1 if none)
    pi_improved: torch.Tensor  # f32[B, K] softmax(logits + sigma(completed Q))
    root_value: torch.Tensor   # f32[B] raw network value at the root
    order: torch.Tensor        # i32[B, K] movegen-precedence key (as mcts)


def halving_schedule(budget: int, m: int) -> List[Tuple[int, int]]:
    """Sequential-halving segments as [(m_p, num_sims)] with
    sum(num_sims) == budget. Phase p visits its m_p survivors round-robin;
    leftover budget extends the final phase (still round-robin over the
    final survivors)."""
    m = max(1, m)
    phases = max(1, math.ceil(math.log2(m))) if m > 1 else 1
    segs: List[Tuple[int, int]] = []
    remaining = budget
    m_p = m
    for p in range(phases):
        if remaining <= 0:
            break
        per = max(1, budget // (phases * m_p))
        cnt = min(per * m_p, remaining)
        segs.append((m_p, cnt))
        remaining -= cnt
        m_p = max(1, m_p // 2)
    if remaining > 0:
        # remaining > 0 implies every phase appended (segs is non-empty):
        # spend the leftovers as one extra halved phase over the survivors
        segs.append((max(1, segs[-1][0] // 2), remaining))
    if not segs:  # budget <= 0: one zero-sim segment keeps the search
        segs = [(m, 0)]  # well-formed (final scoring over raw priors)
    assert sum(c for _, c in segs) == max(budget, 0), segs
    return segs


def _sigma(q: torch.Tensor, max_n: torch.Tensor, cfg: GumbelConfig) -> torch.Tensor:
    """Monotone Q transform: (c_visit + max_b N(b)) * c_scale * q."""
    return (cfg.c_visit + max_n) * cfg.c_scale * q


def _completed_q(
    n: torch.Tensor, w: torch.Tensor, prior: torch.Tensor, valid: torch.Tensor,
    raw_value: torch.Tensor,
) -> torch.Tensor:
    """Q over all children [B, K] with unvisited entries filled by the value
    mix v_mix = (v_node + sum_N * weighted_visited_Q) / (1 + sum_N) (the
    paper's completedQ / mctx qtransform_completed_by_mix_value)."""
    visited = n > 0
    q = torch.where(visited, w / n.clamp(min=1.0), 0.0)
    sum_n = n.sum(dim=-1)
    pv = torch.where(visited & valid, prior, 0.0)
    wq = (pv * q).sum(dim=-1) / pv.sum(dim=-1).clamp(min=1e-12)
    v_mix = torch.where(sum_n > 0, (raw_value + sum_n * wq) / (1.0 + sum_n), raw_value)
    return torch.where(visited, q, v_mix[:, None])


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """exp(x - max) / sum, over the last axis (``jax.nn.softmax``)."""
    e = torch.exp(x - x.max(dim=-1, keepdim=True).values)
    return e / e.sum(dim=-1, keepdim=True)


def _log_priors(p: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """log p at the valid slots, -inf elsewhere. log p differs from the true
    logits by a per-node constant, which cancels in every softmax and
    argmax."""
    return torch.where(valid, torch.log(p.clamp(min=1e-30)), -torch.inf)


def gumbel_rule(node_val: torch.Tensor, forced: torch.Tensor, cfg: GumbelConfig) -> Callable:
    """The Gumbel select for ``mcts._descend``: the root edge is the
    schedule's ``forced`` slot; an interior node takes
    argmax pi'(a) - N(a) / (1 + sum N) (the paper's deterministic
    "planning at non-root nodes"), exact ties to the least packed key."""
    bidx = torch.arange(node_val.shape[0], device=node_val.device)

    def select(cur, depth, node_n, e_n, e_w, pr, acts, valid):
        cq = _completed_q(e_n, e_w, pr, valid, node_val[bidx, cur])
        sig = _sigma(cq, e_n.max(dim=-1, keepdim=True).values, cfg)
        pi2 = _softmax(torch.where(valid, _log_priors(pr, valid) + sig, -torch.inf))
        score = torch.where(valid, pi2 - e_n / (1.0 + e_n.sum(dim=-1, keepdim=True)),
                            -torch.inf)
        return torch.where(depth == 0, forced, M.tie_break(score, valid, acts))

    return select


def _root_gumbel(batch: int, k: int, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Standard Gumbel draws [batch, k] for the root candidates, made on the
    CPU (from ``generator``, else torch's default CPU generator) in
    row-major order, so lane i's row does not depend on ``batch``; moved to
    ``device``."""
    if generator is not None and generator.device.type != "cpu":
        raise ValueError("the root Gumbel draws come from a CPU generator")
    u = torch.rand((batch, k), generator=generator)
    return (-torch.log(-torch.log(u.clamp(min=1e-20)))).to(device)


def _top(scores: torch.Tensor, width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``width`` largest scores per row, equal
    scores in ascending index order (``jax.lax.top_k``'s and a stable
    ``argsort``'s order)."""
    v, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    return v[:, :width], i[:, :width]


@P.spanned("search.run")
def run_gumbel_mcts(
    eval_fn: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
    roots: E.EnvState,
    cfg: GumbelConfig,
    logits_eval: bool = False,
    generator: Optional[torch.Generator] = None,
    shard: Optional[M.Shard] = None,
) -> GumbelResult:
    """Gumbel root search over a batch of root states. ``eval_fn`` is as
    for ``run_mcts``; the root draws come from the CPU ``generator``
    (``shard`` as for ``run_mcts``)."""
    batch = roots.board.shape[0]
    dev = roots.board.device
    k = cfg.max_children
    # clamp m to the budget: every candidate must receive at least one
    # phase-0 visit, else the final argmax could act a move the search
    # never simulated (unvisited candidates are scored by v_mix alone)
    m = max(1, min(cfg.max_considered, k, max(cfg.num_simulations, 1)))
    segs = halving_schedule(cfg.num_simulations, m)
    slot_priors = make_slot_priors(logits_eval, k)
    tree = init_tree(batch, MCTSConfig(cfg.num_simulations, max_children=k), dev)
    # each node's value from its own mover's side
    node_val = torch.zeros((batch, cfg.num_simulations + 1), device=dev)
    bidx = torch.arange(batch, device=dev)

    # ---- root eval, Gumbel sample, top-m candidates ----------------------
    with P.span("search.root"):
        probs, root_value = M.evaluate(eval_fn, E.features(roots.board, roots.side))
        root_value = root_value.float()
        slot_a, valid, p_raw = slot_priors(roots.board, roots.side, roots.legal, probs)
        p_slot = M._mask_normalize(p_raw, valid)
        logits = _log_priors(p_slot, valid)
        with P.span("draw.root_noise"):
            g = M.own_rows(_root_gumbel(M.global_shape((batch,), shard)[0], k, generator, dev),
                           shard)
        base = torch.where(valid, g + logits, -torch.inf)           # g + logits
        cand_base, cand_slot = _top(base, m)                        # [B, m], -inf pads
    # games with fewer legal moves than m keep -inf pad columns; the
    # round-robin rank is clamped per game so a pad slot is never forced
    # (the halving's sort keeps finite scores ahead of -inf, so this count
    # holds across it)
    n_cand = torch.isfinite(cand_base).sum(dim=-1).clamp(min=1)

    has_any = valid.any(dim=-1)
    tree.actions[:, 0] = slot_a
    tree.priors[:, 0] = p_slot
    tree.expanded[:, 0] = has_any
    node_val[:, 0] = root_value

    def cand_scores(width: int) -> torch.Tensor:
        """g + logits + sigma(q) of the candidate columns; columns at rank
        >= width (eliminated in an earlier halving) are -inf."""
        n_root = tree.ew[:, 0, 0]
        cq = _completed_q(n_root, tree.ew[:, 1, 0], tree.priors[:, 0], valid, root_value)
        sig = _sigma(cq, n_root.max(dim=-1, keepdim=True).values, cfg)
        alive = torch.arange(m, device=dev)[None, :] < width
        return torch.where(alive, cand_base + sig.gather(1, cand_slot), -torch.inf)

    # >= 1 so that a search of budget 0 is well formed (it runs no
    # simulation); unlike PUCT's, this cap can bind on a deep chain
    max_depth = max(1, cfg.num_simulations)
    lo = 0
    for si, (m_p, cnt) in enumerate(segs):
        eff = n_cand.clamp(max=m_p)
        for i in range(lo, lo + cnt):
            P.count("search.simulations")
            forced = cand_slot[bidx, (i - lo) % eff]
            mode, sel_parent, sel_slot, leaf, core, pnode, pslot, depth = M._descend(
                tree, roots, max_depth, gumbel_rule(node_val, forced, cfg))
            leaf_env, value = M._expand_and_backup(
                tree, eval_fn, slot_priors, i + 1, mode, sel_parent, sel_slot, leaf,
                core, pnode, pslot, depth)
            t_val = torch.where(leaf_env.winner != 0, 1.0, 0.0)
            # the node's value from its own mover's side (t_val is from the
            # side of the player who moved into a terminal node)
            node_val[:, i + 1] = torch.where(leaf_env.done, -t_val, value)
        lo += cnt
        if si + 1 < len(segs):
            # halving: re-sort the survivors by g + logits + sigma(q) so the
            # next segment's round-robin over ranks < m_next visits exactly
            # the kept half
            with P.span("search.halving"):
                order = _top(cand_scores(m_p), m)[1]
                cand_slot = cand_slot.gather(1, order)
                cand_base = cand_base.gather(1, order)

    # ---- final selection + improved policy -------------------------------
    win = cand_scores(segs[-1][0]).argmax(dim=-1)
    win_slot = cand_slot[bidx, win]
    root_packed = tree.actions[:, 0]
    actions = unpack_actions(root_packed)
    chosen = torch.where(has_any, actions[bidx, win_slot], -1)

    n_root = tree.ew[:, 0, 0]
    cq = _completed_q(n_root, tree.ew[:, 1, 0], tree.priors[:, 0], valid, root_value)
    sig = _sigma(cq, n_root.max(dim=-1, keepdim=True).values, cfg)
    pi2 = _softmax(torch.where(valid, logits + sig, -torch.inf))
    return GumbelResult(
        actions=actions,
        visits=n_root.to(torch.int32),
        valid=valid,
        chosen=chosen,
        pi_improved=torch.where(valid, pi2, 0.0),
        root_value=root_value,
        order=root_packed,
    )
