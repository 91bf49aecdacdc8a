"""Learner: the train step, the epoch loop and the optimizer.

Port of ``xiangqi_alphazero_tpu.train.learner``. Loss and optimization
mirror the reference (training/train.py:376-447): policy CE = -mean(sum(pi *
log_softmax(logits))), value MSE, Adam with L2 weight decay added to the
clipped gradient (torch Adam's coupled ``weight_decay``, as optax's
``add_decayed_weights`` placed before ``scale_by_adam``), global-norm
gradient clip 1.0, and MultiStepLR stepped once per iteration
(``set_learning_rate`` with ``config.lr_at``).

The step takes compact samples (int8 boards, sparse pi slots) and builds the
features on the device; the policy CE gathers log-probs at the slot actions
instead of materializing an 8100-wide target.

The one difference from the JAX package, which changes no number:
``train_epochs`` is a host loop over the plan's real steps (the JAX package
runs one ``lax.scan`` over a padded plan and skips the padding).

With a ``mesh`` (``parallel/sharding.py``) the same maths runs over the
ranks, as the JAX package's sharded steps do: each rank takes its block of
a step's columns, the losses are normalised by the whole batch's weights,
batch norm by the whole batch's statistics (the net's batch-norm layers
carry the data group), the gradients are summed over ``data`` with the
loss partials in one ``all_reduce``, and clipped by the global norm; under
tensor parallelism the policy loss's softmax runs over the sharded logits.
Without a mesh the code path and the numbers are the single-device ones.

Under ``utils/profiling.py``'s ``recording()`` a ``train_epochs`` call
records the spans ``learn.epochs`` (the root), ``learn.upload``, one
``learn.step`` a step (with ``learn.gather``, ``learn.forward_backward`` and
``learn.optimizer``) and ``learn.readback``, and counts ``learn.steps`` and
``learn.rows``.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..engine import env as E
from ..parallel import sharding as SH
from ..utils import profiling as P


class Optimizer:
    """Global-norm clip, then Adam with coupled L2 weight decay: the optax
    chain clip_by_global_norm -> add_decayed_weights -> scale_by_adam ->
    scale_by_learning_rate."""

    def __init__(self, params: Iterable[torch.nn.Parameter], learning_rate: float,
                 weight_decay: float, clip_norm: float = 1.0, mesh=None):
        self.params = list(params)
        self.clip_norm = clip_norm
        self.mesh = mesh
        self.adam = torch.optim.Adam(
            self.params, lr=learning_rate, weight_decay=weight_decay
        )

    @P.spanned("learn.optimizer")
    def step(self, losses: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
        """Clip and step. With a mesh the gradients (and ``losses``, the
        step's loss partials) are first summed over ``data``; returns the
        summed ``losses``."""
        if self.mesh is not None:
            losses = SH.reduce_gradients(self.mesh, self.params, losses)
        SH.clip_grad_norm(self.mesh, self.params, self.clip_norm)
        self.adam.step()
        return losses

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        return self.adam.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state)


def make_optimizer(params, learning_rate: float, weight_decay: float,
                   clip_norm: float = 1.0, mesh=None) -> Optimizer:
    return Optimizer(params, learning_rate, weight_decay, clip_norm, mesh)


def set_learning_rate(opt: Optimizer, lr: float) -> Optimizer:
    """Apply the per-iteration LR schedule."""
    for group in opt.adam.param_groups:
        group["lr"] = lr
    return opt


class TrainMetrics(NamedTuple):
    policy_loss: torch.Tensor
    value_loss: torch.Tensor
    total_loss: torch.Tensor


def compute_loss(
    net: torch.nn.Module,
    boards: torch.Tensor,      # int8[b, 90]
    sides: torch.Tensor,       # int8[b]
    pi_actions: torch.Tensor,  # int32[b, K]
    pi_probs: torch.Tensor,    # f32[b, K]
    z: torch.Tensor,           # f32[b]
    w: torch.Tensor,           # f32[b] sample weights (partial-batch mask)
    norm: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    mesh=None,
) -> TrainMetrics:
    """The loss of learner.py:66-99 on one batch (a forward in the net's
    current mode; in train mode it moves the batch-norm statistics).
    ``norm`` = (wsum, pi_n) of the whole batch when these rows are one
    rank's block of it (else they are this batch's own); under tensor
    parallelism (``mesh.n_model > 1``) the net's logits are this rank's
    block of the 8100."""
    feats = E.features(boards, sides)
    # policy averages over samples that CARRY a policy target (an all-zero
    # pi row is a value-only sample of a playout-capped cheap search)
    wsum, pi_n = batch_norms(pi_probs, w) if norm is None else norm
    logits, value = net(feats)
    actions = pi_actions.long().clamp(min=0)
    if mesh is not None and mesh.n_model > 1:
        gathered = SH.tp_log_softmax_at(mesh, logits, actions)
    else:
        gathered = torch.log_softmax(logits, dim=-1).gather(1, actions)
    ce = -(pi_probs * gathered).sum(dim=-1)
    policy_loss = (w * ce).sum() / pi_n
    value_loss = (w * (value[:, 0] - z) ** 2).sum() / wsum
    return TrainMetrics(policy_loss, value_loss, policy_loss + value_loss)


def batch_norms(pi_probs: torch.Tensor, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(wsum, pi_n): the value loss's and the policy loss's denominators."""
    has_pi = (pi_probs.sum(dim=-1) > 0).float()
    return w.sum().clamp(min=1.0), (w * has_pi).sum().clamp(min=1.0)


def train_step(net: torch.nn.Module, opt: Optimizer, boards, sides, pi_actions,
               pi_probs, z, w, norm=None) -> TrainMetrics:
    """One optimizer step on one batch; ``net`` in train mode. With the
    optimizer's mesh the rows are this rank's block of the batch, ``norm``
    the whole batch's (``batch_norms``), and the losses returned are the
    whole batch's."""
    opt.zero_grad()
    with P.span("learn.forward_backward"):
        m = compute_loss(net, boards, sides, pi_actions, pi_probs, z, w, norm, opt.mesh)
        m.total_loss.backward()
    if opt.mesh is None:
        opt.step()
        return TrainMetrics(*(x.detach() for x in m))
    # every model rank holds the same loss: the data ranks' partials sum to it
    p, v = opt.step(torch.stack([m.policy_loss.detach(), m.value_loss.detach()]))
    return TrainMetrics(p, v, p + v)


@P.spanned("learn.epochs")
def train_epochs(
    net: torch.nn.Module,
    opt: Optimizer,
    arrays,                 # (boards, sides, pi_actions, pi_probs, values), numpy
    perm: np.ndarray,       # int32[S, b] row indices per step
    wmask: np.ndarray,      # f32[S, b] sample weights (0 = padding)
) -> torch.Tensor:
    """All of an iteration's train steps over an ``epoch_plan``. The rows
    the plan reads are uploaded once; every step gathers its batch on the
    device. Returns the per-step (policy, value) losses f32[S, 2] on the
    host. With the optimizer's mesh each rank steps on its block of every
    step's columns (the plan's width a multiple of the data axis)."""
    dev = next(net.parameters()).device
    steps = perm.shape[0]
    if steps == 0:
        return torch.zeros((0, 2))
    with P.span("learn.upload"):
        n = int(perm.max()) + 1
        bufs = [torch.as_tensor(np.ascontiguousarray(a[:n])).to(dev) for a in arrays]
        perm_d = torch.as_tensor(perm).to(dev).long()
        w_d = torch.as_tensor(wmask).to(dev)
    step = train_step if opt.mesh is None else SH.make_sharded_train_step(opt.mesh)
    losses = []
    for i in range(steps):
        with P.span("learn.step"):
            with P.span("learn.gather"):
                idx = perm_d[i]
                rows = [b[idx] for b in bufs]
            m = step(net, opt, *rows, w_d[i])
            losses.append(torch.stack([m.policy_loss, m.value_loss]))
        P.count("learn.steps")
        P.count("learn.rows", perm.shape[1])
    with P.span("learn.readback"):
        return torch.stack(losses).float().cpu()
