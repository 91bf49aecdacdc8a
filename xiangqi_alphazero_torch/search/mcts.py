"""Batched AlphaZero PUCT search over the batched env, in PyTorch.

Port of ``xiangqi_alphazero_tpu.search.mcts``. The whole batch of games
searches in lockstep: each simulation descends every game's tree, evaluates
ALL leaves in one network call, then expands and backs up. The semantics,
and the root visit counts, are the JAX package's exactly:

- PUCT select Q(child) + c_puct * P * sqrt(N_parent) / (1 + N_child),
  Q = W/N (0 when unvisited), with exact UCB ties broken by the reference's
  move-generation order: each slot stores its action PACKED above its
  movegen precedence (``_PACK``), and the tie-break is an argmin over it;
- root priors masked to the legal slots and renormalized (uniform when the
  legal mass is zero); optional Dirichlet root noise;
- terminal leaf value +1 for any decisive result, 0 for a draw; the network
  value is negated once before backup and the sign alternates up the path.

Layout: edge statistics live at the parent row, ``ew[B, 2, N, K]`` (visit
counts, value sums); simulation i creates node i+1, so expansion writes one
node row per simulation. Legal moves are compacted into K=128 per-piece
slots (``_legal_slots_priors``) with gathers and ``cumsum``, which are exact
like the JAX package's one-hot products.

Differences from the JAX package, none of which changes a result:

- The tree is allocated at its full size (``num_simulations + 1`` nodes)
  from the start. The JAX package's staged node budget
  (``_stage_plan``/``_grow_tree``) is a static-shape device of XLA and never
  runs at serving's batch sizes (it starts at batch 64).
- The descent is a Python loop over depth that ends when every game has
  stopped (the JAX package vmaps a ``while_loop``); the backup adds each
  path edge's count and signed value directly into ``ew`` (every path
  touches each edge once, so this equals the one-hot contraction).
- Random draws come from an explicit ``torch.Generator`` and are made on
  its device (``_gamma``, ``_gumbel``): with a CPU generator the card and
  the CPU search alike. JAX and torch streams differ, so tests compare with
  the noise off or with injected draws. A batch that is one rank's block
  of a global batch (``Shard``) draws the global block and keeps its rows.

Under ``utils/profiling.py``'s ``recording()`` a search records the spans
``search.run``, ``search.root`` (with ``draw.root_noise``), one
``search.descend`` and one ``search.expand`` a simulation, ``env.evaluate``
(``engine/env.py``) and ``net.forward`` around every evaluation, and counts
``search.simulations``, ``search.descent_levels`` and ``net.positions``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..engine import env as E
from ..utils import profiling as P

ACTION_SPACE = E.ACTION_SPACE


class MCTSConfig(NamedTuple):
    num_simulations: int = 200
    c_puct: float = 1.5
    dirichlet_alpha: float = 0.3
    noise_frac: float = 0.25
    max_children: int = 128


@dataclasses.dataclass
class Tree:
    """Per-game search trees, batched on the leading axis."""

    expanded: torch.Tensor    # bool[B, N]
    terminal: torch.Tensor    # bool[B, N]
    term_value: torch.Tensor  # f32[B, N] (parent-perspective value at terminals)
    actions: torch.Tensor     # i32[B, N, K] packed slot actions, -1 = empty
    child: torch.Tensor       # i32[B, N, K], 0 = not yet created
    priors: torch.Tensor      # f32[B, N, K]
    ew: torch.Tensor          # f32[B, 2, N, K]: [:, 0] visits, [:, 1] value sums
    root_n: torch.Tensor      # i32[B]


class SearchResult(NamedTuple):
    actions: torch.Tensor     # i32[B, K] root actions (-1 pad)
    visits: torch.Tensor      # i32[B, K] root visit counts
    valid: torch.Tensor       # bool[B, K]
    root_value: torch.Tensor  # f32[B] mean root value (diagnostics)
    # movegen-precedence key per slot (packed; -1 pad): ascending order is
    # the reference's child enumeration order
    order: torch.Tensor       # i32[B, K]


def _mask_normalize(p_slots: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Priors over child slots: mask to legal, renormalize; uniform fallback
    when the legal probability mass is zero (reference: mcts.py:176-188)."""
    p = torch.where(valid, p_slots, 0.0)
    psum = p.sum(dim=-1, keepdim=True)
    n_valid = valid.sum(dim=-1, keepdim=True).clamp(min=1)
    uniform = valid.float() / n_valid
    return torch.where(psum > 0, p / torch.where(psum > 0, psum, 1.0), uniform)


# Per-piece-instance slot layout: each of the side-to-move's <=16 pieces gets
# a fixed budget of destination slots bounding its legal-move count (rook and
# cannon <=17, horse 8, elephant/advisor/king 4, pawn 3). Total 123 <= K=128.
_SLOT_KINDS = (5, 5, 6, 6, 4, 4, 3, 3, 2, 2, 1, 7, 7, 7, 7, 7)
_SLOT_BUDGET = {5: 18, 6: 18, 4: 8, 3: 4, 2: 4, 1: 4, 7: 3}
_MAX_BUDGET = max(_SLOT_BUDGET.values())

# Movegen-precedence packing (see the JAX package's mcts._PACK):
#   packed = (from_sq * 64 + rank) * _PACK + action,   action = packed % _PACK
# where ``rank`` is the move's index within its piece's generator order.
# Ascending packed order == the reference's enumeration order.
_PACK = 8192


def _movegen_rank(kind: torch.Tensor, dr: torch.Tensor, dc: torch.Tensor) -> torch.Tensor:
    """Within-piece enumeration rank of a (dr, dc) displacement."""
    dir4 = torch.where(dc == 0, torch.where(dr < 0, 0, 1), torch.where(dc < 0, 2, 3))
    dist = torch.maximum(dr.abs(), dc.abs())
    quad = (dr > 0).long() * 2 + (dc > 0).long()
    horse = torch.where(dr.abs() == 2, 0, 4) + quad
    pawn = torch.where(dc == 0, 0, torch.where(dc < 0, 1, 2))
    return torch.where(
        kind == 1, dir4,
        torch.where((kind == 2) | (kind == 3), quad,
                    torch.where(kind == 4, horse,
                                torch.where(kind == 7, pawn, dir4 * 16 + dist))),
    )


def unpack_actions(packed: torch.Tensor) -> torch.Tensor:
    """Packed slot values -> plain actions (-1 pads preserved)."""
    return torch.where(packed >= 0, packed % _PACK, -1)


def movegen_precedence(action: int, kind: int) -> int:
    """Host-side reference-order key for one action: the same (from, rank)
    prefix the slot packing uses."""
    f, t = divmod(int(action), 90)
    dr, dc = t // 9 - f // 9, t % 9 - f % 9
    if kind == 1:
        rank = {(-1, 0): 0, (1, 0): 1, (0, -1): 2, (0, 1): 3}[(dr, dc)]
    elif kind in (2, 3):
        rank = (dr > 0) * 2 + (dc > 0)
    elif kind == 4:
        rank = (0 if abs(dr) == 2 else 4) + (dr > 0) * 2 + (dc > 0)
    elif kind == 7:
        rank = 0 if dc == 0 else (1 if dc < 0 else 2)
    else:  # rook / cannon: direction order, then outward step
        d = 0 if (dc == 0 and dr < 0) else 1 if dc == 0 else 2 if dc < 0 else 3
        rank = d * 16 + max(abs(dr), abs(dc))
    return f * 64 + rank


def _slot_columns(device) -> torch.Tensor:
    """Flat [16 * _MAX_BUDGET] positions of each piece row's budgeted slots."""
    return torch.tensor(
        [p * _MAX_BUDGET + j for p, kind in enumerate(_SLOT_KINDS)
         for j in range(_SLOT_BUDGET[kind])],
        device=device,
    )


def _legal_slots_priors(
    board: torch.Tensor, side: torch.Tensor, legal: torch.Tensor,
    probs: torch.Tensor, k: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compact legal mask + policy into per-piece slots.

    board int8[B, 90], side int8[B], legal bool[B, 8100], probs f32[B, 8100]
    -> (packed i32[B, K] (-1 pad), valid bool[B, K], priors f32[B, K]).
    Bit-identical to the JAX package: slot priors are the exact policy
    values at the slot's action, 0 at empty slots."""
    n_slots = sum(_SLOT_BUDGET[kind] for kind in _SLOT_KINDS)
    assert k >= n_slots
    bsz = board.shape[0]
    dev = board.device
    sq = torch.arange(90, device=dev)

    # the p-th piece row: the (inst+1)-th own piece of its kind, by square
    own = board.long() * side.long()[:, None]
    kinds_v = torch.tensor(_SLOT_KINDS, device=dev)
    inst, seen = [], {}
    for kind in _SLOT_KINDS:
        inst.append(seen.get(kind, 0))
        seen[kind] = seen.get(kind, 0) + 1
    inst_v = torch.tensor(inst, device=dev)
    is_kind = own[:, None, :] == kinds_v[None, :, None]          # [B, 16, 90]
    oh = is_kind & (is_kind.cumsum(dim=-1) == inst_v[None, :, None] + 1)
    present = oh.any(dim=-1)                                     # [B, 16]
    f_p = oh.to(torch.uint8).argmax(dim=-1)                      # 0 if absent

    # each row's legal destinations, ascending
    rows = f_p[:, :, None].expand(bsz, 16, 90)
    m_rows = legal.reshape(bsz, 90, 90).gather(1, rows) & present[:, :, None]
    cnt = m_rows.sum(dim=-1)
    key = torch.where(m_rows, sq, sq + 90)
    ti = key.sort(dim=-1).values[:, :, :_MAX_BUDGET]             # [B, 16, J]
    valid = torch.arange(_MAX_BUDGET, device=dev) < cnt[:, :, None]
    ti = torch.where(valid, ti, 0)

    fi = f_p[:, :, None]
    action = fi * 90 + ti
    rank = _movegen_rank(kinds_v[None, :, None], ti // 9 - fi // 9, ti % 9 - fi % 9)
    packed = (fi * 64 + rank) * _PACK + action
    prio = torch.where(valid, probs.gather(1, action.reshape(bsz, -1)).reshape(action.shape), 0.0)

    cols = _slot_columns(dev)
    packed = packed.reshape(bsz, -1)[:, cols]
    valid = valid.reshape(bsz, -1)[:, cols]
    prio = prio.reshape(bsz, -1)[:, cols]
    pad = k - n_slots
    if pad:
        packed = torch.nn.functional.pad(packed, (0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
        prio = torch.nn.functional.pad(prio, (0, pad))
    return torch.where(valid, packed, -1).to(torch.int32), valid, prio


def init_tree(batch: int, cfg: MCTSConfig, device="cpu") -> Tree:
    n, k = cfg.num_simulations + 1, cfg.max_children
    return Tree(
        expanded=torch.zeros((batch, n), dtype=torch.bool, device=device),
        terminal=torch.zeros((batch, n), dtype=torch.bool, device=device),
        term_value=torch.zeros((batch, n), device=device),
        actions=torch.full((batch, n, k), -1, dtype=torch.int32, device=device),
        child=torch.zeros((batch, n, k), dtype=torch.int32, device=device),
        priors=torch.zeros((batch, n, k), device=device),
        ew=torch.zeros((batch, 2, n, k), device=device),
        root_n=torch.zeros(batch, dtype=torch.int32, device=device),
    )


def make_slot_priors(logits_eval: bool, k: int) -> Callable:
    """(board, side, legal, scores) -> (slot actions, valid, prior values);
    with ``logits_eval`` the softmax is computed only at the legal slots."""

    def slot_priors(board, side, legal, scores):
        s32 = scores.float()
        sa, va, picked = _legal_slots_priors(board, side, legal, s32, k)
        if logits_eval:
            m = s32.max(dim=-1, keepdim=True).values
            z = torch.exp(s32 - m).sum(dim=-1, keepdim=True)
            picked = torch.exp(picked - m) / z
        return sa, va, picked

    return slot_priors


# --------------------------------------------------------------- descent ---

_MODE_CREATE, _MODE_REVISIT, _MODE_NOOP = 0, 1, 2
_CORE_FIELDS = ("board", "side", "ply", "quiet", "hist")


def _select_core(mask: torch.Tensor, new: E.EnvState, old: E.EnvState) -> E.EnvState:
    """``new``'s core fields where ``mask`` (per game), else ``old``'s."""
    out = {}
    for name in _CORE_FIELDS:
        n, o = getattr(new, name), getattr(old, name)
        out[name] = torch.where(mask.reshape((-1,) + (1,) * (n.dim() - 1)), n, o)
    return old.replace(**out)


def tie_break(score: torch.Tensor, valid: torch.Tensor, acts: torch.Tensor) -> torch.Tensor:
    """Lexicographic argmax on (score, movegen precedence): the slot of the
    best valid score, exact ties going to the earliest move in generator
    order (the least packed key)."""
    tied = valid & (score == score.max(dim=-1, keepdim=True).values)
    return torch.where(tied, acts, 2**30).argmin(dim=-1)


def puct_rule(c_puct: float) -> Callable:
    """The PUCT select: Q + c_puct * P * sqrt(N_parent) / (1 + N_child)."""

    def select(cur, depth, node_n, e_n, e_w, pr, acts, valid):
        q = torch.where(e_n > 0, e_w / e_n.clamp(min=1.0), 0.0)
        u = c_puct * pr * torch.sqrt(node_n)[:, None] / (1.0 + e_n)
        return tie_break(torch.where(valid, q + u, -torch.inf), valid, acts)

    return select


@P.spanned("search.descend")
def _descend(tree: Tree, root: E.EnvState, max_depth: int, select: Callable):
    """Select down every game's tree to a leaf, taking at each node the slot
    ``select(cur, depth, node_n, e_n, e_w, priors, acts, valid)`` names
    (node_n: the visits of the edge into ``cur``, the root's count at the
    root). Returns (mode, sel_parent, sel_slot, leaf, leaf core state,
    path_node[B, D], path_slot[B, D], depth): path_node[:, d]/path_slot[:, d]
    is the edge taken at depth d (valid for d < depth). The leaf state's
    legal/done/winner are stale. Each level of the loop reads ``stop``
    back to the host, and is counted in ``search.descent_levels``."""
    bsz = tree.root_n.shape[0]
    dev = tree.ew.device
    bidx = torch.arange(bsz, device=dev)
    zero = torch.zeros(bsz, dtype=torch.long, device=dev)
    root_has_children = tree.expanded[:, 0]
    cur, leaf, depth = zero, zero, zero
    node_n = tree.root_n.float()
    core = root
    stop = ~root_has_children
    mode = torch.where(root_has_children, _MODE_CREATE, _MODE_NOOP)
    path_node, path_slot = [], []
    while not bool(stop.all()):
        P.count("search.descent_levels")
        act = ~stop
        e_n = tree.ew[bidx, 0, cur]
        e_w = tree.ew[bidx, 1, cur]
        pr = tree.priors[bidx, cur]
        acts = tree.actions[bidx, cur]
        slot = select(cur, depth, node_n, e_n, e_w, pr, acts, acts >= 0)
        packed = acts[bidx, slot]
        a = torch.where(act & (packed >= 0), packed % _PACK, 0)
        core2 = E.step_core(core, a)
        ch = tree.child[bidx, cur, slot].long()
        is_new = ch == 0
        ch_unexpanded = ~is_new & ~tree.expanded[bidx, ch]
        too_deep = depth + 1 >= max_depth

        path_node.append(torch.where(act, cur, 0))
        path_slot.append(torch.where(act, slot, 0))
        new_mode = torch.where(
            is_new, _MODE_CREATE,
            torch.where(ch_unexpanded | too_deep, _MODE_REVISIT, mode),
        )
        down = act & ~is_new
        cur = torch.where(down, ch, cur)
        leaf = torch.where(down, ch, leaf)
        node_n = torch.where(act, e_n[bidx, slot], node_n)
        core = _select_core(act, core2, core)
        mode = torch.where(act, new_mode, mode)
        depth = torch.where(act, depth + 1, depth)
        stop = stop | (act & (is_new | ch_unexpanded | too_deep))
    if path_node:
        pnode, pslot = torch.stack(path_node, 1), torch.stack(path_slot, 1)
    else:
        pnode = pslot = torch.zeros((bsz, 1), dtype=torch.long, device=dev)
    last = (depth - 1).clamp(min=0)
    return (
        mode, pnode[bidx, last], pslot[bidx, last], leaf, core, pnode, pslot,
        depth,
    )


def _backup(tree: Tree, pnode, pslot, depth, v) -> None:
    """Add each path edge's visit and signed value into ``tree.ew``: the
    edge at depth d leads to the node at depth d+1; the deepest edge
    (d = depth-1) gets v, signs alternating upward (reference:
    mcts.py:66-73). A path touches each edge once, so the only repeated
    index is the padding, which adds exact zeros."""
    bsz, d = pnode.shape
    di = torch.arange(d, device=pnode.device)
    validp = di[None, :] < depth[:, None]
    odd = ((depth[:, None] - 1 - di) % 2) != 0
    sign = torch.where(odd, -1.0, 1.0)
    b_ix = torch.arange(bsz, device=pnode.device)[:, None].expand(bsz, d)
    plane = torch.zeros_like(pnode)
    tree.ew.index_put_((b_ix, plane, pnode, pslot), validp.float(), accumulate=True)
    tree.ew.index_put_(
        (b_ix, plane + 1, pnode, pslot),
        torch.where(validp, sign * v[:, None], 0.0),
        accumulate=True,
    )


@P.spanned("search.expand")
def _expand_and_backup(
    tree: Tree, eval_fn: Callable, slot_priors: Callable, new_idx: int, mode,
    sel_parent, sel_slot, leaf, core, pnode, pslot, depth,
) -> Tuple[E.EnvState, torch.Tensor]:
    """One simulation's second half, for every game: evaluate the leaves
    (one legal-mask launch and one net call for the batch), write node
    ``new_idx`` (simulation i creates node i+1; garbage and unreachable for
    games that did not create: no child pointer), point the selected edge
    at it where the descent created it, and back the value up the path.
    Returns the evaluated leaf states and the net's values."""
    bidx = torch.arange(tree.root_n.shape[0], device=tree.ew.device)
    leaf_env = E.evaluate_batch(core)
    probs, value = evaluate(eval_fn, E.features(leaf_env.board, leaf_env.side))
    value = value.float()
    is_create = mode == _MODE_CREATE
    t_val = torch.where(leaf_env.winner != 0, 1.0, 0.0)   # mcts.py:138-140
    sa, va, p_raw = slot_priors(leaf_env.board, leaf_env.side, leaf_env.legal, probs)
    tree.expanded[:, new_idx] = ~leaf_env.done
    tree.terminal[:, new_idx] = leaf_env.done
    tree.term_value[:, new_idx] = t_val
    tree.actions[:, new_idx] = sa
    tree.priors[:, new_idx] = _mask_normalize(p_raw, va)
    old = tree.child[bidx, sel_parent, sel_slot]
    tree.child[bidx, sel_parent, sel_slot] = torch.where(
        is_create, torch.full_like(old, new_idx), old
    )
    # value to back up, from the parent's perspective at the leaf
    v_create = torch.where(leaf_env.done, t_val, -value)   # mcts.py:138-150
    v = torch.where(is_create, v_create, tree.term_value[bidx, leaf])
    _backup(tree, pnode, pslot, depth, v)
    tree.root_n += (mode != _MODE_NOOP).to(torch.int32)
    return leaf_env, value


def evaluate(eval_fn: Callable, feats: torch.Tensor):
    """``eval_fn(feats)`` as the span ``net.forward``, its rows counted in
    ``net.positions``."""
    with P.span("net.forward"):
        out = eval_fn(feats)
    P.count("net.positions", feats.shape[0])
    return out


class Shard(NamedTuple):
    """A batch that is rows [offset, offset + size) of a global batch of
    ``total`` games, split over ranks (``parallel/sharding.py``). Every
    random draw is made at the global batch's shape and each shard keeps
    its own rows, so a game's draws do not depend on the split. ``any``
    reduces a flag over all shards (the loops run until every shard's
    games have ended, so the generators stay in step)."""

    offset: int
    size: int
    total: int
    any: Callable[[bool], bool] = bool


def global_shape(shape, shard: Optional[Shard]) -> tuple:
    """The shape to draw for a batch of ``shape`` (dim 0 the batch)."""
    return tuple(shape) if shard is None else (shard.total, *tuple(shape)[1:])


def own_rows(x: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    """This shard's rows of a draw made at ``global_shape``."""
    return x if shard is None else x[shard.offset: shard.offset + shard.size]


def _draw_device(generator: Optional[torch.Generator], device) -> torch.device:
    """Draws are made where ``generator`` lives (a CPU generator gives the
    card and the CPU the same draws), else on ``device``."""
    return torch.device(device) if generator is None else generator.device


def _gamma(alpha: float, shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Gamma(alpha, 1) draws for the Dirichlet root noise, on ``device``."""
    conc = torch.full(shape, alpha, dtype=torch.float32,
                      device=_draw_device(generator, device))
    return torch._standard_gamma(conc, generator=generator).to(device)


def _gumbel(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Standard Gumbel draws for action sampling, on ``device``."""
    u = torch.rand(shape, generator=generator, device=_draw_device(generator, device))
    return (-torch.log(-torch.log(u.clamp(min=1e-20)))).to(device)


@P.spanned("search.run")
def run_mcts(
    eval_fn: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
    roots: E.EnvState,
    cfg: MCTSConfig,
    add_noise: bool = True,
    logits_eval: bool = False,
    sim_budget: Optional[torch.Tensor] = None,
    noise_mask: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    shard: Optional[Shard] = None,
) -> SearchResult:
    """Full search over a batch of root states.

    eval_fn(features[B,10,9,15]) -> (policy[B,8100], value[B]): softmaxed
    policy by default, RAW LOGITS with ``logits_eval=True`` (the softmax is
    then computed only at the legal slots). ``sim_budget`` (int[B]): game b
    runs only its first sim_budget[b] simulations, so its result equals a
    search with exactly that budget. ``noise_mask`` (bool[B]): with
    ``add_noise``, apply the Dirichlet root noise only to these games,
    drawn from ``generator``. ``shard``: the batch is that block of a
    global batch, whose draws it takes its rows of."""
    batch = roots.board.shape[0]
    dev = roots.board.device
    k = cfg.max_children
    slot_priors = make_slot_priors(logits_eval, k)
    tree = init_tree(batch, cfg, dev)

    # Root priors (+ optional Dirichlet noise), reference mcts.py:107-123.
    with P.span("search.root"):
        probs, _ = evaluate(eval_fn, E.features(roots.board, roots.side))
        slot_a, valid, p_raw = slot_priors(roots.board, roots.side, roots.legal, probs)
        p_slot = _mask_normalize(p_raw, valid)
        if add_noise:
            with P.span("draw.root_noise"):
                gam = _gamma(cfg.dirichlet_alpha, global_shape((batch, k), shard), generator,
                             dev)
            g = torch.where(valid, own_rows(gam, shard), 0.0)
            noise = g / g.sum(dim=-1, keepdim=True).clamp(min=1e-30)
            p_noised = torch.where(
                valid, (1.0 - cfg.noise_frac) * p_slot + cfg.noise_frac * noise, 0.0
            )
            p_slot = p_noised if noise_mask is None else torch.where(
                noise_mask[:, None], p_noised, p_slot
            )
        tree.actions[:, 0] = slot_a
        tree.priors[:, 0] = p_slot
        tree.expanded[:, 0] = valid.any(dim=-1)

    max_depth = cfg.num_simulations + 2   # depth <= i + 1: never binds
    select = puct_rule(cfg.c_puct)
    for i in range(cfg.num_simulations):
        P.count("search.simulations")
        mode, sel_parent, sel_slot, leaf, core, pnode, pslot, depth = _descend(
            tree, roots, max_depth, select
        )
        if sim_budget is not None:
            # simulations past a game's budget are no-ops: no create, no
            # child pointer, no root_n, an empty backup
            active = i < sim_budget
            mode = torch.where(active, mode, _MODE_NOOP)
            depth = torch.where(active, depth, 0)
        _expand_and_backup(tree, eval_fn, slot_priors, i + 1, mode, sel_parent,
                           sel_slot, leaf, core, pnode, pslot, depth)

    visits_f = tree.ew[:, 0, 0, :]
    w_root = tree.ew[:, 1, 0, :]
    total = visits_f.sum(dim=-1).clamp(min=1.0)
    root_packed = tree.actions[:, 0, :]
    return SearchResult(
        actions=unpack_actions(root_packed),
        visits=visits_f.to(torch.int32),
        valid=root_packed >= 0,
        root_value=w_root.sum(dim=-1) / total,
        order=root_packed,
    )


# ----------------------------------------------------- pi and sampling ----


def greedy_slots(result: SearchResult) -> torch.Tensor:
    """Most-visited root slot per game, ties resolved to the earliest move
    in the reference's generation order (mcts.py:198)."""
    counts = torch.where(result.valid, result.visits, -1)
    return tie_break(counts, result.valid, result.order)


def _temperature(temperature, counts: torch.Tensor) -> torch.Tensor:
    t = torch.as_tensor(temperature, dtype=torch.float32, device=counts.device)
    return t.expand(counts.shape[:1])


def action_probs_slots(result: SearchResult, temperature) -> torch.Tensor:
    """pi over child slots [B, K] (mcts.py:190-206): temp==0 -> one-hot
    argmax of visits (first max in movegen order), else visits**(1/temp)
    normalized. Rows with no valid slots are all zero."""
    counts = result.visits.float()
    t = _temperature(temperature, counts)[:, None]
    t_safe = torch.where(t > 0.0, t, 1.0)
    powed = torch.where(result.valid, counts ** (1.0 / t_safe), 0.0)
    denom = powed.sum(dim=-1, keepdim=True)
    soft = torch.where(denom > 0, powed / torch.where(denom > 0, denom, 1.0), 0.0)
    hard = torch.nn.functional.one_hot(greedy_slots(result), counts.shape[-1]).float()
    hard = torch.where(result.valid.any(dim=-1, keepdim=True), hard, 0.0)
    return torch.where(t == 0.0, hard, soft)


def action_probs_dense(result: SearchResult, temperature) -> torch.Tensor:
    """Dense pi[B, 8100] (see action_probs_slots)."""
    pi = torch.where(result.valid, action_probs_slots(result, temperature), 0.0)
    idx = torch.where(result.valid, result.actions, 0).long()
    dense = torch.zeros((pi.shape[0], ACTION_SPACE), device=pi.device)
    dense.scatter_add_(1, idx, pi)
    return torch.where(result.valid.any(dim=-1, keepdim=True), dense, 0.0)


def sample_actions(
    result: SearchResult, temperature, generator: Optional[torch.Generator] = None,
    shard: Optional[Shard] = None,
) -> torch.Tensor:
    """Per-game action: argmax of visits at temp==0 (greedy_slots), else a
    sample from visits**(1/temp) (Gumbel-max with draws from ``generator``;
    ``shard`` as for ``run_mcts``)."""
    counts = result.visits.float()
    t = _temperature(temperature, counts)
    t_safe = torch.where(t > 0.0, t, 1.0)
    logw = torch.where(
        result.valid & (counts > 0),
        torch.log(counts.clamp(min=1e-30)) / t_safe[:, None],
        -torch.inf,
    )
    with P.span("draw.sample"):
        gumbel = own_rows(_gumbel(global_shape(counts.shape, shard), generator, counts.device),
                          shard)
    slot = torch.where(t == 0.0, greedy_slots(result), (logw + gumbel).argmax(dim=-1))
    return result.actions.gather(1, slot[:, None])[:, 0]
