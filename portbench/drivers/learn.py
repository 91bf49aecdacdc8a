"""The learner: ``train/learner.py::train_epochs`` with ``make_optimizer``.

Set-up makes the weights and a ring of rows from the seed, builds the
program's net and optimizer, and drives them through the traffic's first
``check_steps`` steps by the window's own call (``train_epochs``) on rows
that all differ: one step, then the rest. Those steps warm every shape the
window uses, and their readings (each step's loss, the first gradient as
Adam took it in, read back from its first moment, and the weights' change)
are what the reference follows after the window. The window then calls
``train_epochs`` with one shuffled epoch over the ring at a time, as the
trainer does after each self-play phase.
"""

from __future__ import annotations

import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from .. import inputs, program
from ..reference import float32_exact, resnet
from ..reference import learn as ref_learn


HEAD = "policy_head.4."   # the policy head's dense layer


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], leaves: List[str]) -> float:
    """The worst leaf's gap between two norms, over the reference's norm of
    that leaf or of the median leaf, whichever is larger."""
    med = statistics.median(ref[k] for k in leaves)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in leaves)


class Learn:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.tr, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.names = resnet.trainable_names(cfg["num_channels"], cfg["num_res_blocks"])

    # ------------------------------------------------------------- set-up
    def setup(self) -> None:
        from xiangqi_alphazero_torch.train.learner import make_optimizer, train_epochs

        cfg, tr, dev = self.cfg, self.tr, self.device
        self.train_epochs = train_epochs
        w = inputs.net_weights(cfg["num_channels"], cfg["num_res_blocks"], self.seed, dev)
        self.w0 = {k: v.cpu() for k, v in w.items()}
        self.net = program.build_net(cfg, w, dev).train()
        del w
        self.opt = make_optimizer(self.net.parameters(), cfg["learning_rate"],
                                  cfg["weight_decay"], cfg["clip_norm"])
        self.batch = tr["batch"]
        self.ring = self.batch * tr["ring_batches"]
        self.arrays = inputs.learner_rows(self.ring, cfg["max_children"], self.seed, dev)
        self.rng = np.random.default_rng(self.seed)
        self.ones = np.ones((tr["ring_batches"], self.batch), np.float32)

        n = tr["check_steps"]
        self.check_perm = self._plan()[:n]
        first = self.train_epochs(self.net, self.opt, self.arrays, self.check_perm[:1],
                                  self.ones[:1])
        b1 = cfg["adam_betas"][0]
        state = self.opt.state_dict()["state"]
        # the gradient Adam took in, from its first moment (none: no gradient)
        self.prog_grad = {name: state[i]["exp_avg"].cpu() / (1 - b1) if i in state
                          else torch.zeros_like(p, device="cpu")
                          for i, (name, p) in enumerate(self.net.named_parameters())}
        rest = self.train_epochs(self.net, self.opt, self.arrays, self.check_perm[1:n],
                                 self.ones[1:n])
        self.prog_loss = [tuple(map(float, x)) for x in torch.cat([first, rest])]
        with torch.no_grad():
            self.prog_change = {name: float((p - self.w0[name].to(dev)).norm())
                                for name, p in self.net.named_parameters()}
        program.sync(dev)

    def _plan(self) -> np.ndarray:
        """One shuffled epoch over the ring: row indices int32[batches, batch]."""
        return self.rng.permutation(self.ring).astype(np.int32).reshape(-1, self.batch)

    # ------------------------------------------------------------ windows
    def window(self, seconds: float):
        steps = 0
        program.sync(self.device)
        t0 = time.perf_counter()
        while True:
            plan = self._plan()
            self.train_epochs(self.net, self.opt, self.arrays, plan, self.ones)
            steps += plan.shape[0]
            elapsed = time.perf_counter() - t0   # train_epochs ends by reading its losses
            if elapsed >= seconds:
                break
        rows = steps * self.batch
        return ({"learner_samples_per_s": rows / elapsed},
                {"rows": rows, "attempted": steps, "window_s": elapsed})

    def traced(self):
        from .. import tracing

        plan = self._plan()[: self.tr["trace_steps"]]
        window = tracing.Window(lambda: program.sync(self.device))
        window.start()
        self.train_epochs(self.net, self.opt, self.arrays, plan, self.ones[: plan.shape[0]])
        return window.stop(), {"rows": plan.size, "attempted": plan.shape[0]}

    def release(self) -> None:
        del self.net, self.opt
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -------------------------------------------------------------- check
    def _reference(self, quant=None, half_batch: bool = False):
        """(losses, first gradient, change norms) of the reference's steps
        over the check rows, from the seed's weights. ``quant``: the
        control's rounding; ``half_batch``: the fault that leaves the second
        half of each batch out."""
        cfg, dev = self.cfg, self.device
        params = {k: v.to(dev, copy=True) for k, v in self.w0.items()}
        batches = []
        for idx in self.check_perm:
            rows = [torch.as_tensor(a[idx]).to(dev) for a in self.arrays]
            w = torch.ones(len(idx), device=dev)
            if half_batch:
                w[len(idx) // 2:] = 0.0
            batches.append((*rows, w))
        opt = ref_learn.Adam(cfg["learning_rate"], cfg["weight_decay"], cfg["clip_norm"],
                             tuple(cfg["adam_betas"]), cfg["adam_eps"])
        losses, first = ref_learn.follow(params, self.names, batches, opt, quant)
        grad = {k: first[k].cpu() for k in self.names}
        change = {k: float((params[k] - self.w0[k].to(dev)).norm()) for k in self.names}
        return losses, grad, change

    @staticmethod
    def compare(prog, ref) -> Dict[str, float]:
        """The numbers of one side against the reference: the worst step's
        relative loss gap; the worst leaf's gap between the norms of the
        first gradient, and of the weights' change; and the policy head's
        first-gradient error, the norm of its difference from the
        reference's over the reference's norm. Leaves whose reference
        gradient is under a thousandth of the median leaf's are left out of
        the change (Adam moves them by round-off alone).

        The head's gradient is the one first gradient that no ReLU's
        backward reaches (the dense layer's inputs are the forward's
        features, its output gradient the loss's): the tower's gradients
        carry whole-element differences wherever rounding moves an
        activation across zero, which swamps the precision they were
        computed in."""
        p_loss, p_grad, p_change = prog
        r_loss, r_grad, r_change = ref
        leaves = list(r_grad)
        p_norm = {k: float(p_grad[k].norm()) for k in leaves}
        r_norm = {k: float(r_grad[k].norm()) for k in leaves}
        med = statistics.median(r_norm.values())
        moved = [k for k in leaves if r_norm[k] >= 1e-3 * med]
        head = [k for k in leaves if k.startswith(HEAD)]
        diff = sum(float((p_grad[k].double() - r_grad[k].double()).square().sum())
                   for k in head)
        return {
            "loss_gap": max(abs(sum(a) - sum(b)) / abs(sum(b))
                            for a, b in zip(p_loss, r_loss)),
            "grad_gap": leaf_gap(p_norm, r_norm, leaves),
            "head_grad_err": (diff / sum(r_norm[k] ** 2 for k in head)) ** 0.5,
            "change_gap": leaf_gap(p_change, r_change, moved),
        }

    def check(self) -> Dict[str, float]:
        with float32_exact():
            ref = self._reference()
        return self.compare((self.prog_loss, self.prog_grad, self.prog_change), ref)

    def calibrate(self) -> Dict[str, Dict[str, float]]:
        """The readings that set the limits: the program's, the control's
        (the reference in float8 in the program's place) and the fault's
        (half of each batch left out)."""
        with float32_exact():
            ref = self._reference()
            return {
                "program": self.compare((self.prog_loss, self.prog_grad, self.prog_change), ref),
                "control": self.compare(self._reference(quant=resnet.fp8_round), ref),
                "half_batch": self.compare(self._reference(half_batch=True), ref),
            }


Driver = Learn
