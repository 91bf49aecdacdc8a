"""Search/engine profiling harness (CLI).

Port of ``xiangqi_alphazero_tpu.utils.benchmark``: it times each subsystem
on its own (env stepping, the legal mask, feature extraction, the network
forward, a full MCTS search, search + play, and optionally a Gumbel
search) and prints per-phase throughput in the reference's summary style
(reference: training/benchmark.py). Each call is timed on the host clock
and ends in ``torch.cuda.synchronize`` on the card.

``--trace DIR`` writes a ``torch.profiler`` chrome trace of one more call
of each row, taken after the timed calls so that the profiler's own cost
stays out of the table (the JAX harness traces the timed calls; a trace of
all of them here would hold millions of kernels). Read it with
``python -m xiangqi_alphazero_torch.utils.trace_tools DIR``.

Usage:  python -m xiangqi_alphazero_torch.utils.benchmark \\
            [--batch 256] [--sims 64] [--channels 64] [--blocks 3] [--device cuda]
        (two preset profiles mirror reference benchmark.py:282-285:
         --profile quick = 64ch/3res/80sims, --profile standard =
         128ch/6res/200sims)
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List

import torch

from ..engine import env as E
from ..models import init_net, policy_value_fn
from ..search import GumbelConfig, MCTSConfig, run_gumbel_mcts, run_mcts, sample_actions
from ..serve.predictor import resolve_device
from .profiling import phase_profile

OPENING_ACTION = 44   # every board steps with action 44 (square 0 -> 44), as the JAX harness


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time(fn: Callable, device: torch.device, iters: int = 10, warmup: int = 2) -> float:
    """Seconds per call over ``iters`` calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / iters


def main(argv=None) -> Dict:
    """Run the harness, print its table; returns the rows (name, seconds per
    call, throughput, unit, calls, legal-mask launches per call), the
    launches made before the rows (the reset's mask) and the settings."""
    p = argparse.ArgumentParser(prog="xiangqi_alphazero_torch.utils.benchmark")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--sims", type=int, default=64)
    p.add_argument("--channels", type=int, default=64)
    p.add_argument("--blocks", type=int, default=3)
    p.add_argument("--profile", choices=["quick", "standard"], default=None)
    p.add_argument("--trace", type=str, default=None)
    p.add_argument("--gumbel-sims", type=int, default=0,
                   help="also time a gumbel full-move search at this "
                        "budget (moves/s — the strength-per-wall-clock "
                        "comparison against the PUCT rows)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' for the CPU)")
    args = p.parse_args(argv)

    if args.profile == "quick":
        args.channels, args.blocks, args.sims = 64, 3, 80
    elif args.profile == "standard":
        args.channels, args.blocks, args.sims = 128, 6, 200

    dev = resolve_device(args.device)
    B = args.batch
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev.type} ({kind}), batch={B}, "
          f"net={args.channels}ch/{args.blocks}res, sims={args.sims}")

    net = init_net(torch.Generator().manual_seed(0), channels=args.channels,
                   blocks=args.blocks, dtype=torch.bfloat16, device=dev).eval()
    eval_fn = policy_value_fn(net)
    states = E.reset_batch(B, device=dev)
    acts = torch.full((B,), OPENING_ACTION, dtype=torch.int32, device=dev)
    feats = E.features(states.board, states.side)
    cfg = MCTSConfig(num_simulations=args.sims)
    gen = torch.Generator().manual_seed(1)

    def search():
        return run_mcts(eval_fn, states, cfg, add_noise=True, generator=gen)

    def move():
        res = run_mcts(eval_fn, states, cfg, add_noise=True, generator=gen)
        return E.step_batch(states, sample_actions(res, 1.0, gen))

    # (name, fn, unit, items per call, kernel launches per call, iters, warmup)
    jobs: List[tuple] = [
        ("env.step (incl. legal mask)", lambda: E.step_batch(states, acts),
         "boards/s", B, 1, 10, 2),
        ("legal_mask alone", lambda: E.legal_mask_batch(states.board, states.side),
         "boards/s", B, 1, 10, 2),
        ("features", lambda: E.features(states.board, states.side), "boards/s", B, 0, 10, 2),
        ("network forward", lambda: eval_fn(feats), "evals/s", B, 0, 10, 2),
        ("MCTS search (full move)", search, "sims/s", B * args.sims, args.sims, 3, 1),
        ("search + play", move, "sims/s", B * args.sims, args.sims + 1, 3, 1),
    ]
    if args.gumbel_sims:
        gcfg = GumbelConfig(num_simulations=args.gumbel_sims)
        jobs.append((
            f"gumbel search ({args.gumbel_sims} sims, full move)",
            lambda: run_gumbel_mcts(eval_fn, states, gcfg, generator=gen),
            "moves/s", B, args.gumbel_sims, 3, 1,
        ))

    rows = []
    with torch.inference_mode():
        for name, fn, unit, items, launches, iters, warmup in jobs:
            t = _time(fn, dev, iters=iters, warmup=warmup)
            rows.append({"name": name, "s": t, "throughput": items / t, "unit": unit,
                         "calls": iters + warmup, "launches_per_call": launches})
        if args.trace:
            with phase_profile(args.trace):
                for (_, fn, *_), row in zip(jobs, rows):
                    fn()
                    row["calls"] += 1

    width = max(len(r["name"]) for r in rows)
    print(f"\n{'phase':<{width}}  {'ms/call':>10}  {'throughput':>14}")
    for r in rows:
        print(f"{r['name']:<{width}}  {r['s'] * 1e3:>10.3f}  {r['throughput']:>14,.0f} {r['unit']}")
    per_sim = rows[4]["s"] / args.sims * 1e3
    print(f"\nper-simulation latency: {per_sim:.3f} ms "
          f"(batch-amortized: {per_sim / B * 1e3:.2f} us/game-sim)")
    return {"device": kind, "batch": B, "channels": args.channels, "blocks": args.blocks,
            "sims": args.sims, "setup_launches": 1, "rows": rows}


if __name__ == "__main__":
    main()
