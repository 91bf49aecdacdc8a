"""Plain PyTorch training steps of the policy-value net.

The learner of the public reference (wenjunyang/xiangqi-alphazero,
training/train.py:376-447), as the configuration states it: the policy
cross-entropy -sum(pi * log_softmax(logits)) averaged over the rows that
carry a policy target, the value's squared error averaged over the rows,
both weighted by the row weights; the gradient clipped to a global norm;
L2 weight decay added to the clipped gradient; then Adam. Batch norm uses
the batch's own statistics. Nothing here imports the program under test.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from . import resnet, rules


def loss(params: Dict[str, torch.Tensor], rows: Sequence[torch.Tensor],
         quant: Optional[Callable] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(policy loss, value loss) of one batch ``rows`` = (boards int8[b, 90],
    sides int8[b], pi_actions int32[b, K] (-1 unused), pi_probs f32[b, K],
    z f32[b], w f32[b])."""
    boards, sides, acts, probs, z, w = rows
    logits, value = resnet.forward(params, rules.features(boards, sides), True, quant)
    logp = torch.log_softmax(logits, dim=-1).gather(1, acts.long().clamp(min=0))
    ce = -(probs * logp).sum(dim=-1)
    has_pi = (probs.sum(dim=-1) > 0).float()
    policy = (w * ce).sum() / (w * has_pi).sum().clamp(min=1.0)
    value_loss = (w * (value - z) ** 2).sum() / w.sum().clamp(min=1.0)
    return policy, value_loss


class Adam:
    """Global-norm clip, coupled L2 weight decay, Adam (bias-corrected)."""

    def __init__(self, lr: float, weight_decay: float, clip_norm: float,
                 betas: Tuple[float, float], eps: float):
        self.lr, self.wd, self.clip = lr, weight_decay, clip_norm
        self.b1, self.b2 = betas
        self.eps = eps
        self.t = 0
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}

    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        """Update ``params`` in place; returns the gradient Adam took in
        (clipped, with the weight decay added)."""
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        scale = min(1.0, self.clip / float(norm)) if float(norm) > 0 else 1.0
        self.t += 1
        taken = {}
        for k, g in grads.items():
            p = params[k]
            g = g * scale + self.wd * p
            taken[k] = g
            m = self.m.get(k, torch.zeros_like(p)) * self.b1 + (1 - self.b1) * g
            v = self.v.get(k, torch.zeros_like(p)) * self.b2 + (1 - self.b2) * g * g
            self.m[k], self.v[k] = m, v
            mh = m / (1 - self.b1 ** self.t)
            vh = v / (1 - self.b2 ** self.t)
            p.sub_(self.lr * mh / (vh.sqrt() + self.eps))
        return taken


def follow(params: Dict[str, torch.Tensor], trainable: List[str], batches: Sequence,
           opt: Adam, quant: Optional[Callable] = None):
    """Run one step per batch of ``batches`` on ``params`` (updated in
    place). Returns (per-step (policy, value) losses, the first step's
    gradient as Adam took it in, by leaf)."""
    losses, first = [], None
    for rows in batches:
        leaves = {k: params[k].detach().requires_grad_(True) for k in trainable}
        p, v = loss({**params, **leaves}, rows, quant)
        total = p + v
        grads = torch.autograd.grad(total, [leaves[k] for k in trainable])
        with torch.no_grad():
            taken = opt.step(params, dict(zip(trainable, grads)))
        if first is None:
            first = taken
        losses.append((float(p.detach()), float(v.detach())))
        del leaves, grads, taken
    return losses, first
