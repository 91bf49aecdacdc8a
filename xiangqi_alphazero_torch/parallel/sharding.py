"""Data and tensor parallelism over ``torch.distributed`` ranks.

Port of ``xiangqi_alphazero_tpu.parallel.sharding``. Where the JAX package
shards arrays over a device mesh and lets XLA insert the collectives, the
port runs one process per rank (``distributed.py``) and writes each
collective out:

- self-play and eval: the game batch is split over the ``data`` axis, one
  contiguous block of games a rank, with no collective on the search's hot
  path. Every random draw is made at the global batch's shape and each rank
  keeps its own rows (``search/mcts.py::Shard``), so a game's draws do not
  depend on the split; the ply loop runs until every rank's games have
  ended (one host ``all_reduce`` a ply), so the generators stay in step.
  The records are gathered back in global game order, and every rank holds
  the same replay ring, as every JAX process does;
- learner: the batch columns are split over ``data``; the losses are
  normalised by the global batch's weights (each rank has the whole plan);
  batch norm normalises by the mean and variance of the global batch
  (``global_batch_norm``); the gradients are summed over ``data`` in one
  ``all_reduce``, then clipped by their global norm;
- tensor parallelism of the heads on a ``(world / mp) x mp`` grid
  (Megatron): the policy FC and the value FC1 are column-parallel, the
  value FC2 row-parallel; the loss's softmax over the sharded logits
  reduces its max and its sum over ``model``. Checkpoints hold the
  replicated layout (``tp_full_state``), so a run resumes at any mesh shape.

Device collectives are ``all_reduce`` and ``broadcast`` only, the two that
gloo implements for CUDA tensors: a gather is an ``all_reduce`` of a
zero-filled full buffer into which each rank has written its slice. Host
data (records, outcomes, flags) goes over the gloo host group as CPU
tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from .. import distributed as D
from ..search.mcts import Shard

# Dimensions the TP specs shard: policy FC out (8100) and value hidden FC
# out (128) — models/resnet.py. gcd = 4, so model_parallel must be 2 or 4.
_TP_SHARDED_DIMS = (8100, 128)

# state-dict tensors of the head Dense layers and the dim each is sharded
# on under TP, the JAX package's ``tp_param_shardings`` (torch's Linear
# weight is [out, in]): the JAX specs' Dense_0/Dense_1 kernels
# P(None, 'model') and biases P('model'), Dense_2's kernel P('model',
# None); everything else is replicated
_TP_SPECS = {
    "policy_head.4.weight": 0, "policy_head.4.bias": 0,
    "value_head.4.weight": 0, "value_head.4.bias": 0,
    "value_head.6.weight": 1,
}


# ------------------------------------------------------------ collectives


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over ``group`` (a no-op for None, a group of one
    rank)."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


# ------------------------------------------------------------------- mesh


@dataclasses.dataclass
class Mesh:
    """A ``(n_data, n_model)`` grid of the world's ranks, the model axis
    the fast one (rank = data_index * n_model + model_index), as
    ``make_tp_mesh`` reshapes the JAX devices. ``data_group`` holds the
    ranks of this rank's model index (the batch is split over them),
    ``model_group`` the ranks of its data index; a group of one rank is
    None."""

    rank: int
    world: int
    n_data: int
    n_model: int
    data_group: object
    model_group: object
    host_group: object

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _check_tp(n_model: int, world: int) -> None:
    bad = [d for d in _TP_SHARDED_DIMS if d % n_model]
    if bad:
        raise ValueError(
            f"model_parallel={n_model} must divide the sharded head dims "
            f"{_TP_SHARDED_DIMS} (valid values: 2 or 4)")
    if world % n_model:
        raise ValueError(f"{world} ranks not divisible by model_parallel={n_model}")


def make_tp_mesh(n_model: int) -> Mesh:
    """The ``(world / n_model, n_model)`` grid: batch over ``data``, heads
    over ``model``. Needs ``distributed_init`` (or a world of one)."""
    _check_tp(n_model, _world())
    return _build_mesh(n_model)


def make_mesh() -> Mesh:
    """The data-parallel mesh over every rank (the port has one data axis,
    whatever ``mesh_axis`` names it)."""
    return _build_mesh(1)


def _build_mesh(n_model: int) -> Mesh:
    ctx = D.context()
    if ctx is None:
        raise RuntimeError("a mesh needs distributed_init (--coordinator/--num-processes)")
    n_data = ctx.world // n_model
    # every rank creates every group, in the same order
    model_groups = [dist.new_group([d * n_model + m for m in range(n_model)])
                    for d in range(n_data)] if n_model > 1 else [None] * n_data
    if n_model == 1:
        data_groups = [dist.group.WORLD]
    else:
        data_groups = [dist.new_group([d * n_model + m for d in range(n_data)])
                       for m in range(n_model)]
    mesh = Mesh(ctx.rank, ctx.world, n_data, n_model, None, None, ctx.host_group)
    mesh.model_group = model_groups[mesh.data_index]
    mesh.data_group = data_groups[mesh.model_index] if n_data > 1 else None
    return mesh


# ------------------------------------------------------------ host data


def host_flags(mesh: Mesh, flag: bool) -> tuple:
    """(on some rank, on every rank) for a host flag (a host ``all_reduce``)."""
    t = torch.tensor([int(flag)], dtype=torch.int32)
    dist.all_reduce(t, group=mesh.host_group)
    return t.item() > 0, t.item() == mesh.world


def batch_shard(mesh: Mesh, total: int) -> Shard:
    """This rank's block of a global batch of ``total`` games (a multiple
    of the data axis)."""
    if total % mesh.n_data:
        raise ValueError(f"batch {total} is not a multiple of the data axis {mesh.n_data}")
    size = total // mesh.n_data
    return Shard(mesh.data_index * size, size, total, lambda f: host_flags(mesh, f)[0])


def batch_sharded(mesh: Mesh, x, axis: int = 0):
    """This rank's block of ``x`` along ``axis`` (the JAX batch sharding)."""
    n = x.shape[axis] // mesh.n_data
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(mesh.data_index * n, (mesh.data_index + 1) * n)
    return x[tuple(idx)]


def host_local_batch(mesh: Mesh, arrays: Sequence[np.ndarray], axis: int = 0) -> List[np.ndarray]:
    """Every data rank's rows of each array concatenated along ``axis`` in
    data order: the global batch, on every rank (the JAX package assembles
    it from each host's rows). Each array has the same shape and dtype on
    every rank; it travels as bytes over the host group."""
    out = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        t = torch.from_numpy(a.reshape(-1).view(np.uint8))
        parts = [torch.empty_like(t) for _ in range(mesh.world)]
        dist.all_gather(parts, t, group=mesh.host_group)
        keep = [parts[d * mesh.n_model].numpy().view(a.dtype).reshape(a.shape)
                for d in range(mesh.n_data)]
        out.append(np.concatenate(keep, axis=axis))
    return out


# ------------------------------------------------------- global batch norm


class _GlobalBatchNorm(torch.autograd.Function):
    """Batch norm over the batch of every rank of ``group``. The forward
    takes each rank's count, channel means and centred sums of squares
    (two passes over its own rows), gathers them (an ``all_reduce`` of a
    zero-filled row a rank) and combines them by Chan's formula, which
    keeps a one-pass variance's cancellation out; the backward reduces the
    two channel sums of the input gradient. The weight and bias gradients
    stay local: the gradient ``all_reduce`` sums them."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        c = x.shape[1]
        xf = x.float()
        mean = xf.mean((0, 2, 3))
        m2 = ((xf - mean.view(1, c, 1, 1)) ** 2).sum((0, 2, 3))
        n = torch.full((1,), x.numel() // c, dtype=torch.float32, device=x.device)
        if group is not None:
            rows = torch.zeros((dist.get_world_size(group), 2 * c + 1), device=x.device)
            rows[dist.get_rank(group)] = torch.cat([mean, m2, n])
            rows = _all_reduce(rows, group)
            counts, means = rows[:, -1:], rows[:, :c]
            n = counts.sum().reshape(1)
            mean = (counts * means).sum(0) / n
            m2 = rows[:, c:2 * c].sum(0) + (counts * (means - mean) ** 2).sum(0)
        var = m2 / n
        invstd = torch.rsqrt(var + eps)
        xhat = (xf - mean.view(1, c, 1, 1)) * invstd.view(1, c, 1, 1)
        y = xhat * weight.view(1, c, 1, 1) + bias.view(1, c, 1, 1)
        ctx.save_for_backward(xhat, weight, invstd, n)
        ctx.group, ctx.dtype = group, x.dtype
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        xhat, weight, invstd, n = ctx.saved_tensors
        c = xhat.shape[1]
        dyf = dy.float()
        s_dy = dyf.sum((0, 2, 3))
        s_dyx = (dyf * xhat).sum((0, 2, 3))
        g = _all_reduce(torch.cat([s_dy, s_dyx]), ctx.group)
        dx = (weight * invstd).view(1, c, 1, 1) * (
            dyf - (g[:c] / n).view(1, c, 1, 1) - xhat * (g[c:] / n).view(1, c, 1, 1))
        return dx.to(ctx.dtype), s_dyx, s_dy, None, None


def global_batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """``bn``'s training-mode forward over the global batch of its process
    group, with flax's running statistics (the biased variance)."""
    y, mean, var = _GlobalBatchNorm.apply(x, bn.weight, bn.bias, bn.eps, bn.process_group)
    with torch.no_grad():
        bn.running_mean.lerp_(mean, bn.momentum)
        bn.running_var.lerp_(var, bn.momentum)
    return y


def set_bn_group(net: nn.Module, group) -> None:
    """Normalise every batch-norm layer of ``net`` over ``group``'s batch
    in training mode (None: the local batch)."""
    for m in net.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.process_group = group


# ------------------------------------------------------ tensor parallelism


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over ``model``
    (the input of a column-parallel layer)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Sum over ``model`` forward; identity backward (every model rank then
    computes the same loss from the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_from_model(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    return _ReduceFromModel.apply(x, mesh.model_group)


def replicated(mesh: Mesh, shard: torch.Tensor, dim: int) -> torch.Tensor:
    """The full tensor of a ``model``-sharded one, on every model rank: an
    ``all_reduce`` of a zero-filled full buffer holding this rank's slice."""
    size = list(shard.shape)
    size[dim] *= mesh.n_model
    full = torch.zeros(size, dtype=shard.dtype, device=shard.device)
    full.narrow(dim, mesh.model_index * shard.shape[dim], shard.shape[dim]).copy_(shard)
    return _all_reduce(full, mesh.model_group)


def _slice(mesh: Mesh, full: torch.Tensor, dim: int) -> torch.Tensor:
    s = full.shape[dim] // mesh.n_model
    return full.narrow(dim, mesh.model_index * s, s).clone()


class ColumnParallelLinear(nn.Module):
    """A Linear whose output features are split over ``model``: it returns
    this rank's block of the outputs."""

    def __init__(self, full: nn.Linear, mesh: Mesh):
        super().__init__()
        self.group = mesh.model_group
        self.weight = nn.Parameter(_slice(mesh, full.weight.detach(), 0))
        self.bias = nn.Parameter(_slice(mesh, full.bias.detach(), 0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(_CopyToModel.apply(x, self.group), self.weight, self.bias)


class RowParallelLinear(nn.Module):
    """A Linear whose input features are split over ``model``: the partial
    products are summed over ``model`` and the (replicated) bias added
    once."""

    def __init__(self, full: nn.Linear, mesh: Mesh):
        super().__init__()
        self.group = mesh.model_group
        self.weight = nn.Parameter(_slice(mesh, full.weight.detach(), 1))
        self.bias = nn.Parameter(full.bias.detach().clone())

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        partial = F.linear(h, self.weight).float()
        return _ReduceFromModel.apply(partial, self.group) + self.bias


def tp_place(mesh: Mesh, net: nn.Module) -> nn.Module:
    """Put ``net`` (replicated, identical on every rank) in its TP layout,
    in place: the policy FC and value FC1 column-parallel, the value FC2
    row-parallel. The state-dict names stay; their tensors are shards."""
    net.policy_head[4] = ColumnParallelLinear(net.policy_head[4], mesh)
    net.value_head[4] = ColumnParallelLinear(net.value_head[4], mesh)
    net.value_head[6] = RowParallelLinear(net.value_head[6], mesh)
    for name, p in net.named_parameters():
        p.tp_dim = _TP_SPECS.get(name)
    return net


def tp_full_state(mesh: Mesh, state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A TP net's state dict in the replicated layout."""
    return {k: replicated(mesh, v, _TP_SPECS[k]) if k in _TP_SPECS else v
            for k, v in state.items()}


def tp_local_state(mesh: Mesh, state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """This rank's TP shards of a replicated state dict."""
    return {k: _slice(mesh, v, _TP_SPECS[k]) if k in _TP_SPECS else v
            for k, v in state.items()}


def _map_opt_state(net: nn.Module, opt_state: dict, fn) -> dict:
    """``opt_state`` (a torch Adam state dict, keyed by parameter index)
    with ``fn(moment, dim)`` applied to the moments of sharded params."""
    dims = [_TP_SPECS.get(n) for n, _ in net.named_parameters()]
    state = {}
    for i, s in opt_state["state"].items():
        d = dims[int(i)]
        state[i] = {k: fn(v, d) if d is not None and k.startswith("exp_avg") else v
                    for k, v in s.items()}
    return {"state": state, "param_groups": opt_state["param_groups"]}


def tp_full_optimizer(mesh: Mesh, net: nn.Module, opt_state: dict) -> dict:
    """A TP learner's Adam state with its moments in the replicated layout."""
    return _map_opt_state(net, opt_state, lambda v, d: replicated(mesh, v, d))


def tp_local_optimizer(mesh: Mesh, net: nn.Module, opt_state: dict) -> dict:
    """This rank's shards of a replicated Adam state."""
    return _map_opt_state(net, opt_state, lambda v, d: _slice(mesh, v, d))


def tp_log_softmax_at(mesh: Mesh, logits: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """log_softmax of the full logits at ``actions`` [B, K] (>= 0), from
    this rank's block of the logits [B, A / n_model]: the max over
    ``model`` (a gather by ``all_reduce``), the sum of exponentials over
    ``model``, and a masked local gather summed over ``model``."""
    shard = logits.shape[1]
    maxes = torch.zeros((mesh.n_model, logits.shape[0]), device=logits.device)
    maxes[mesh.model_index] = logits.detach().max(dim=-1).values
    gmax = _all_reduce(maxes, mesh.model_group).max(dim=0).values
    sumexp = reduce_from_model(mesh, (logits - gmax[:, None]).exp().sum(dim=-1))
    lse = gmax + sumexp.log()
    local = actions - mesh.model_index * shard
    mine = (local >= 0) & (local < shard)
    z = torch.where(mine, logits.gather(1, local.clamp(0, shard - 1)), 0.0)
    return reduce_from_model(mesh, z) - lse[:, None]


# ------------------------------------------------------------- learner


def reduce_gradients(mesh: Mesh, params: Sequence[nn.Parameter],
                     extra: torch.Tensor) -> torch.Tensor:
    """Sum every gradient, and ``extra`` (the step's loss partials), over
    ``data`` in one ``all_reduce``; returns the summed ``extra``."""
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads] + [extra.float().reshape(-1)])
    _all_reduce(flat, mesh.data_group)
    off = 0
    for g in grads:
        g.copy_(flat[off: off + g.numel()].view_as(g))
        off += g.numel()
    return flat[off:].view_as(extra)


def clip_grad_norm(mesh, params: Sequence[nn.Parameter], max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm``: every gradient times max_norm /
    norm when the global norm is at least max_norm. The squares are summed
    by ``sum``, which the CPU accumulates pairwise (torch's float32
    ``vector_norm`` on the CPU loses ~1e-3 of a 23M-element norm). Under
    tensor parallelism (``mesh.n_model > 1``) the squares of the sharded
    gradients are summed over ``model`` once, those of the replicated ones
    counted once. Returns the norm."""
    tp = mesh is not None and mesh.n_model > 1
    sharded = [p.grad for p in params if tp and getattr(p, "tp_dim", None) is not None]
    repl = [p.grad for p in params if not (tp and getattr(p, "tp_dim", None) is not None)]

    def sq(gs):
        return torch.stack([(g.float() * g.float()).sum() for g in gs]).sum()

    total = sq(repl)
    if sharded:
        total = total + _all_reduce(sq(sharded).reshape(1), mesh.model_group)[0]
    norm = total.sqrt()
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in sharded + repl:
        g.mul_(scale.to(g.dtype))
    return norm


def make_sharded_train_step(mesh: Mesh) -> Callable:
    """The learner step over the ranks: ``step(net, opt, boards, sides,
    pi_actions, pi_probs, z, w)`` on the GLOBAL batch (every rank passes
    the same one); each rank steps on its block of the columns, with the
    losses normalised by the whole batch's weights, and returns the whole
    batch's losses. ``opt`` carries ``mesh``. The same step serves tensor
    parallelism (the JAX package's ``make_tp_train_step``) once
    ``tp_place`` has laid the net out."""
    from ..train.learner import batch_norms, train_step

    def step(net, opt, *batch):
        norm = batch_norms(batch[3], batch[5])
        return train_step(net, opt, *(batch_sharded(mesh, x) for x in batch), norm=norm)

    return step


# ------------------------------------------------------ self-play and eval


def make_sharded_selfplay(batch: int, settings, mesh: Mesh) -> Callable:
    """``run(eval_fn, generator, device, logits_eval)`` -> the global
    ``SelfPlayOut`` of ``batch`` games (on the CPU, in global game order,
    the same on every rank), this rank playing its block of them."""
    from ..train.selfplay import SelfPlayOut, selfplay_games

    shard = batch_shard(mesh, batch)

    def run(eval_fn, generator, device, logits_eval: bool = True) -> SelfPlayOut:
        out = selfplay_games(eval_fn, shard.size, settings, generator, device,
                             logits_eval=logits_eval, shard=shard)
        t_major = ("boards", "sides", "pi_actions", "pi_probs", "values", "rec")
        games = ("winners", "plies", "total_moves")
        parts = host_local_batch(mesh, [getattr(out, f).cpu().numpy() for f in t_major], 1)
        parts += host_local_batch(mesh, [getattr(out, f).cpu().numpy() for f in games], 0)
        return out._replace(**{f: torch.from_numpy(p) for f, p in zip(t_major + games, parts)})

    return run


def make_sharded_eval(batch: int, settings, mesh: Mesh) -> Callable:
    """``run(eval_new, eval_old, device, logits_eval)`` -> the global
    ``EvalOut`` of the ``batch``-game match (on the CPU, the same on every
    rank); the colour halves go by global game index."""
    from ..train.evaluate import EvalOut, evaluate_pair

    shard = batch_shard(mesh, batch)

    def run(eval_new, eval_old, device, logits_eval: bool = True) -> EvalOut:
        out = evaluate_pair(eval_new, eval_old, shard.size, settings, device,
                            logits_eval=logits_eval, shard=shard)
        winners, plies = host_local_batch(
            mesh, [out.winners.cpu().numpy(), out.avg_plies.reshape(1).cpu().numpy()])
        winners = torch.from_numpy(winners)
        new_is_red = torch.arange(batch) < batch // 2
        new_won = ((winners == 1) & new_is_red) | ((winners == -1) & ~new_is_red)
        old_won = ((winners == -1) & new_is_red) | ((winners == 1) & ~new_is_red)
        return EvalOut(
            new_wins=new_won.sum(dtype=torch.int32), old_wins=old_won.sum(dtype=torch.int32),
            draws=(winners == 0).sum(dtype=torch.int32), winners=winners,
            new_is_red=new_is_red, avg_plies=torch.tensor(plies.mean()),
            plies_run=out.plies_run)

    return run
