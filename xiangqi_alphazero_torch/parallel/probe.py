"""Multi-rank probes: pieces of the sharded paths on given inputs, run
over N ranks, for holding them against one rank (or against the JAX
package's sharded functions, which is what ``tests/test_torch_parallel.py``
does on the CPU, and ``chip_smoke.py`` phase 10 on the card).

    python -m xiangqi_alphazero_torch.parallel.probe DIR \
        --coordinator HOST:PORT --num-processes N --process-id I \
        [--model-parallel M] [--device cpu]

``DIR`` holds ``jobs.json`` (a list of modes) and ``in{i}.npz``, the
inputs of job i; rank 0 writes ``out{i}.npz``. ``launch(jobs, n)`` starts
the N processes and returns rank 0's outputs of each job and every rank's
printed text (its backend and legal-mask launches); ``run(mode,
inputs, mesh, device)`` is one rank's part of one job (with ``mesh=None``,
the single-device reference). Modes, and the keys of their inputs and
outputs (numpy arrays; a net's state dict under ``sd/``, a second net's
under ``sd2/``, the topology in ``channels``/``blocks``):

- ``step``: one learner step of the net on the batch ``boards, sides,
  pi_actions, pi_probs, z, w`` at ``lr``/``wd`` -> ``losses`` (policy,
  value, total), the updated state dict and Adam's first moment after the
  step (``mu/`` by parameter name), both in the replicated layout. The
  moment is (1 - beta1) times the reduced, clipped, decayed gradient, so
  it holds the gradient to float rounding where the parameters after
  Adam's first step cannot;
- ``steps``: the trainer's learner path, ``train_epochs`` over the plan
  ``perm``/``wmask`` on the rows ``boards, sides, pi_actions, pi_probs,
  z`` -> ``losses`` [S, 2] and the state dict after the plan;
- ``step_profile``: the inputs of ``step``; one warm step, then
  ``torch.profiler`` over ``steps`` steps -> ``ranks``, a row per rank: ms
  a step, ms a step in the gradient all-reduce, ms a step in the other
  collectives (batch norm, TP), all from the trace (gloo's collective
  events on the host; NCCL's kernels on the card, not split);
- ``forward``: the net in eval mode on ``feats`` -> ``logits``, ``value``
  (under TP, the logits gathered from the shards);
- ``selfplay``: ``games`` games of self-play with ``settings`` (JSON of
  ``SelfPlaySettings``) and the draws of a generator seeded ``seed`` ->
  every ``SelfPlayOut`` record;
- ``eval``: the gated match of ``games`` games with ``settings`` (JSON of
  ``EvalSettings``) -> ``winners``, ``new_is_red``, ``plies_run``;
- ``profile``: the inputs of ``selfplay``; one warm ply of the sharded
  fleet, then (the ranks starting together) ``torch.profiler`` over one
  ply -> ``ranks``, a row per data rank: device busy seconds, wall
  seconds, device kernels, simulations (of the rank's games).

Self-play and eval take the net, or with ``evaluator`` = ``dyadic`` the
exact mock networks (float32 sums exact in any order): self-play uniform
priors, eval peaked priors with multipliers 37 (candidate) and 53. A rank
runs with TF32 off, and prints its legal-mask kernel launches when it is
done.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..distributed import free_port
from ..engine import env as E
from ..models import XiangqiNet, policy_logits_fn
from ..ops import legal_mask as LM
from . import sharding as SH


def dyadic_eval(feats: torch.Tensor):
    """Uniform 1/64 priors and value (own - opp) / 8: exact in float32 in
    any summation order."""
    own = feats[..., :7].sum(dim=(1, 2, 3))
    opp = feats[..., 7:14].sum(dim=(1, 2, 3))
    probs = torch.full((feats.shape[0], E.ACTION_SPACE), 1.0 / 64.0, device=feats.device)
    return probs, (own - opp) / 8.0


def peaked_dyadic_eval(mult: int):
    """An exact mock network with peaked priors: the prior of action a is
    ((a * mult) % 64 + 1) / 1024, the value (own - opp) / 8. Two
    multipliers make two nets that choose different moves."""
    table = torch.tensor([((a * mult) % 64 + 1) / 1024.0 for a in range(E.ACTION_SPACE)])

    def f(feats):
        _, value = dyadic_eval(feats)
        return table.to(feats.device).expand(feats.shape[0], -1), value

    return f


def _net(inputs: Dict[str, np.ndarray], prefix: str, device) -> XiangqiNet:
    net = XiangqiNet(int(inputs["channels"]), int(inputs["blocks"]))
    net.load_state_dict({k[len(prefix):]: torch.from_numpy(v) for k, v in inputs.items()
                         if k.startswith(prefix)})
    return net.to(device)


def _state(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {f"sd/{k}": v.detach().cpu().numpy() for k, v in state.items()}


def run(mode: str, inputs: Dict[str, np.ndarray], mesh: Optional[SH.Mesh],
        device) -> Dict[str, np.ndarray]:
    """One rank's part of ``mode`` (see the module doc); with ``mesh=None``
    the single-device path."""
    from ..train.evaluate import EvalSettings, evaluate_pair
    from ..train.learner import make_optimizer, train_epochs, train_step
    from ..train.selfplay import SelfPlaySettings, selfplay_games

    device = torch.device(device)
    tp = mesh is not None and mesh.n_model > 1
    if mode in ("step", "steps", "step_profile", "forward"):
        net = _net(inputs, "sd/", device)
        if mesh is not None:
            SH.set_bn_group(net, mesh.data_group)
        if tp:
            SH.tp_place(mesh, net)
    if mode in ("step", "steps", "step_profile"):
        net.train()
        opt = make_optimizer(net.parameters(), float(inputs["lr"]), float(inputs["wd"]),
                             mesh=mesh)
    if mode == "steps":
        rows = [inputs[k] for k in ("boards", "sides", "pi_actions", "pi_probs", "z")]
        losses = train_epochs(net, opt, rows, inputs["perm"], inputs["wmask"])
        state = SH.tp_full_state(mesh, net.state_dict()) if tp else net.state_dict()
        return {"losses": losses.numpy(), **_state(state)}
    if mode in ("step", "step_profile"):
        batch = [torch.from_numpy(inputs[k]).to(device)
                 for k in ("boards", "sides", "pi_actions", "pi_probs", "z", "w")]
        step = train_step if mesh is None else SH.make_sharded_train_step(mesh)
        m = step(net, opt, *batch)
        if mode == "step_profile":
            return _profile_steps(lambda: step(net, opt, *batch), int(inputs["steps"]), mesh,
                                  device)
        state = SH.tp_full_state(mesh, net.state_dict()) if tp else net.state_dict()
        moments = opt.state_dict()
        if tp:
            moments = SH.tp_full_optimizer(mesh, net, moments)
        names = [n for n, _ in net.named_parameters()]
        out = {"losses": torch.stack(list(m)).cpu().numpy(), **_state(state)}
        for i, s in moments["state"].items():
            out[f"mu/{names[int(i)]}"] = s["exp_avg"].cpu().numpy()
        return out
    if mode == "forward":
        with torch.no_grad():
            logits, value = net.eval()(torch.from_numpy(inputs["feats"]).to(device))
            if tp:
                logits = SH.replicated(mesh, logits, 1)
        return {"logits": logits.cpu().numpy(), "value": value.cpu().numpy()}

    dyadic = str(inputs["evaluator"]) == "dyadic"
    games = int(inputs["games"])
    settings = json.loads(str(inputs["settings"]))
    with torch.inference_mode():
        if mode in ("selfplay", "profile"):
            ev = dyadic_eval if dyadic else policy_logits_fn(_net(inputs, "sd/", device).eval())
            gen = torch.Generator().manual_seed(int(inputs["seed"]))
            s = SelfPlaySettings(**settings)
            if mode == "profile":
                return _profile_ply(ev, games, s, gen, mesh, device, not dyadic)
            if mesh is None:
                out = selfplay_games(ev, games, s, gen, device, logits_eval=not dyadic)
            else:
                out = SH.make_sharded_selfplay(games, s, mesh)(ev, gen, device,
                                                               logits_eval=not dyadic)
            return {k: v.cpu().numpy() for k, v in out._asdict().items()
                    if isinstance(v, torch.Tensor)}
        assert mode == "eval", mode
        if dyadic:
            ev_new, ev_old = peaked_dyadic_eval(37), peaked_dyadic_eval(53)
        else:
            ev_new = policy_logits_fn(_net(inputs, "sd/", device).eval())
            ev_old = policy_logits_fn(_net(inputs, "sd2/", device).eval())
        s = EvalSettings(**settings)
        if mesh is None:
            out = evaluate_pair(ev_new, ev_old, games, s, device, logits_eval=not dyadic)
        else:
            out = SH.make_sharded_eval(games, s, mesh)(ev_new, ev_old, device,
                                                       logits_eval=not dyadic)
        return {"winners": out.winners.cpu().numpy(),
                "new_is_red": out.new_is_red.cpu().numpy(),
                "plies_run": np.array(out.plies_run)}


# the directory that holds the package, from which ``-m`` finds it
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _profile_ply(ev, games: int, s, gen, mesh, device, logits_eval: bool) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from ..train import selfplay as TS

    shard = None if mesh is None else SH.batch_shard(mesh, games)
    size = games if shard is None else shard.size
    carry = TS._init_carry(size, s, gen, device, shard)
    body = TS._make_body(ev, size, s, logits_eval, gen, shard)
    body(carry)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    if mesh is not None:
        torch.distributed.barrier(group=mesh.host_group)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        sims = body(carry)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    row = np.array([[sum(e.self_device_time_total for e in kernels) / 1e6, wall,
                     sum(e.count for e in kernels), sims * size]])
    return {"ranks": row if mesh is None else SH.host_local_batch(mesh, [row])[0]}


def _profile_steps(step, steps: int, mesh, device) -> dict:
    """``steps`` learner steps under ``torch.profiler``; the collectives'
    time is read from the trace: gloo's ``gloo:all_reduce`` events span a
    collective on the host (the gradient's is the one over every
    parameter), NCCL's run as kernels on the card."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    if mesh is not None:
        torch.distributed.barrier(group=mesh.host_group)
    with profile(activities=activities, record_shapes=True) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    grad = other = 0.0
    for e in prof.events():
        if e.name.startswith("gloo:all_reduce"):
            numel = int(np.prod(e.input_shapes[0])) if e.input_shapes and e.input_shapes[0] else 0
            if numel > 1_000_000:
                grad += e.cpu_time_total
            else:
                other += e.cpu_time_total
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and "nccl" in e.key.lower():
            other += e.self_device_time_total
    row = np.array([[1e3 * wall, grad / 1e3, other / 1e3]]) / steps
    return {"ranks": row if mesh is None else SH.host_local_batch(mesh, [row])[0]}


def launch(jobs: Sequence[Tuple[str, Dict[str, np.ndarray]]], n: int,
           model_parallel: int = 1, *, device: str, timeout: float = 300.0,
           env: Optional[Dict[str, str]] = None, command: Optional[List[str]] = None,
           ) -> Tuple[List[Dict[str, np.ndarray]], List[str]]:
    """Run ``jobs`` ((mode, inputs) pairs, in order) over ``n`` fresh rank
    processes on ``device`` (``cuda`` or ``cpu``): rank 0's outputs of
    each, and every rank's printed text. ``env`` is added to each rank's
    environment; ``command`` replaces ``python -m`` of this module (the
    arguments follow it). A failing rank raises with every rank's text; a
    rank that outlives ``timeout`` is killed."""
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "jobs.json"), "w") as f:
            json.dump([mode for mode, _ in jobs], f)
        for i, (_, inputs) in enumerate(jobs):
            np.savez(os.path.join(tmp, f"in{i}.npz"), **inputs)
        port = free_port()
        env = dict(os.environ, OMP_NUM_THREADS=os.environ.get("OMP_NUM_THREADS", "1"),
                   **(env or {}))
        command = command or [sys.executable, "-m", "xiangqi_alphazero_torch.parallel.probe"]
        procs = [subprocess.Popen(
            [*command, tmp,
             "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(n),
             "--process-id", str(i), "--model-parallel", str(model_parallel),
             "--device", device],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=_ROOT)
            for i in range(n)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode for p in procs):
            raise RuntimeError("probe ranks failed:\n" + "\n".join(
                f"--- rank {i} (rc {p.returncode}):\n{out[-3000:]}"
                for i, (p, out) in enumerate(zip(procs, logs))))
        outputs = []
        for i in range(len(jobs)):
            with np.load(os.path.join(tmp, f"out{i}.npz")) as z:
                outputs.append({k: z[k] for k in z.files})
        return outputs, logs


def main(argv=None) -> int:
    from ..distributed import distributed_init, shutdown

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("dir", help="holds jobs.json and in{i}.npz; rank 0 writes out{i}.npz")
    p.add_argument("--coordinator", required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--model-parallel", type=int, default=1)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    # float32 comparisons: no TF32 in the card's convolutions and products
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ctx = distributed_init(args.coordinator, args.num_processes, args.process_id,
                           args.device)
    mesh = (SH.make_tp_mesh(args.model_parallel) if args.model_parallel > 1
            else SH.make_mesh())
    with open(os.path.join(args.dir, "jobs.json")) as f:
        modes = json.load(f)
    for i, mode in enumerate(modes):
        with np.load(os.path.join(args.dir, f"in{i}.npz")) as z:
            inputs = {k: z[k] for k in z.files}
        out = run(mode, inputs, mesh, ctx.device)
        if ctx.rank == 0:
            np.savez(os.path.join(args.dir, f"out{i}.npz"), **out)
    print(f"[p{ctx.rank}] backend {ctx.backend}; legal_mask launches: "
          f"{LM.legal_mask_cuda.launches}", flush=True)
    shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
