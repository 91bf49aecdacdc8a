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

Differences from the JAX package, none of which changes the math beyond
float rounding:

- ``train_epochs`` is a host loop over the plan's real steps (the JAX
  package runs one ``lax.scan`` over a padded plan and skips the padding).
- ``clip_grad_norm_`` divides by the norm plus 1e-6 where optax divides by
  the norm: a relative change of 1e-6 / norm on clipped gradients.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple

import numpy as np
import torch

from ..engine import env as E


class Optimizer:
    """Global-norm clip, then Adam with coupled L2 weight decay: the optax
    chain clip_by_global_norm -> add_decayed_weights -> scale_by_adam ->
    scale_by_learning_rate."""

    def __init__(self, params: Iterable[torch.nn.Parameter], learning_rate: float,
                 weight_decay: float, clip_norm: float = 1.0):
        self.params = list(params)
        self.clip_norm = clip_norm
        self.adam = torch.optim.Adam(
            self.params, lr=learning_rate, weight_decay=weight_decay
        )

    def step(self) -> None:
        torch.nn.utils.clip_grad_norm_(self.params, self.clip_norm)
        self.adam.step()

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        return self.adam.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state)


def make_optimizer(params, learning_rate: float, weight_decay: float,
                   clip_norm: float = 1.0) -> Optimizer:
    return Optimizer(params, learning_rate, weight_decay, clip_norm)


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
) -> TrainMetrics:
    """The loss of learner.py:66-99 on one batch (a forward in the net's
    current mode; in train mode it moves the batch-norm statistics)."""
    feats = E.features(boards, sides)
    wsum = w.sum().clamp(min=1.0)
    logits, value = net(feats)
    logp = torch.log_softmax(logits, dim=-1)
    gathered = logp.gather(1, pi_actions.long().clamp(min=0))
    ce = -(pi_probs * gathered).sum(dim=-1)
    # policy averages over samples that CARRY a policy target (an all-zero
    # pi row is a value-only sample of a playout-capped cheap search)
    has_pi = (pi_probs.sum(dim=-1) > 0).float()
    pi_n = (w * has_pi).sum().clamp(min=1.0)
    policy_loss = (w * ce).sum() / pi_n
    value_loss = (w * (value[:, 0] - z) ** 2).sum() / wsum
    return TrainMetrics(policy_loss, value_loss, policy_loss + value_loss)


def train_step(net: torch.nn.Module, opt: Optimizer, boards, sides, pi_actions,
               pi_probs, z, w) -> TrainMetrics:
    """One optimizer step on one batch; ``net`` in train mode."""
    opt.zero_grad()
    m = compute_loss(net, boards, sides, pi_actions, pi_probs, z, w)
    m.total_loss.backward()
    opt.step()
    return TrainMetrics(*(x.detach() for x in m))


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
    host."""
    dev = next(net.parameters()).device
    steps = perm.shape[0]
    if steps == 0:
        return torch.zeros((0, 2))
    n = int(perm.max()) + 1
    bufs = [torch.as_tensor(np.ascontiguousarray(a[:n])).to(dev) for a in arrays]
    perm_d = torch.as_tensor(perm).to(dev).long()
    w_d = torch.as_tensor(wmask).to(dev)
    losses = []
    for i in range(steps):
        idx = perm_d[i]
        m = train_step(net, opt, *(b[idx] for b in bufs), w_d[i])
        losses.append(torch.stack([m.policy_loss, m.value_loss]))
    return torch.stack(losses).float().cpu()
