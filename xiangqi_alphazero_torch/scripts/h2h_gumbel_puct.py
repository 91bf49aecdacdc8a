"""Gumbel-32 against PUCT-200: a training head-to-head at matched wall clock.

Port of the repo's ``scripts/h2h_gumbel_puct.py``, which measures the
Gumbel mode's claim: sequential halving at 32 simulations a move trains at
a fraction of PUCT-200's self-play cost for comparable strength per wall
clock.

1. Train two ``tpu``-preset models (128 channels, 6 blocks) from the same
   seed, one arm per search, with iteration counts sized for the same wall
   clock (no gated eval in either arm: every second goes to self-play and
   the learner). Each arm trains under the trainer's ``--auto-restart``
   supervisor with a checkpoint every iteration, so a crash costs one
   iteration; an arm whose last checkpoint exists is not trained again
   (its wall comes from its ``training_stats.json``).
2. Play the two products in the neutral arena over their current
   parameters (``arena_current``: PUCT-40 both sides, temperature 0.2,
   alternating colours).
3. Print a markdown row and one JSON line, and write ``<out>/result.json``.

    python -m xiangqi_alphazero_torch.scripts.h2h_gumbel_puct [--gumbel-iters 12] \\
        [--puct-iters 6] [--games 64] [--seed 11] [--out runs/torch/h2h] [--skip-train] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

from . import arena_current as AC

DEFAULT_OUT = "runs/torch/h2h"


def _train(out_dir: str, algo: str, sims: int, iters: int, seed: int,
           device: str = "cuda") -> float:
    cmd = [
        sys.executable, "-m", "xiangqi_alphazero_torch.train",
        "--mode", "tpu",
        "--search-algo", algo,
        "--simulations", str(sims),
        "--games-per-iter", "256",
        "--iterations", str(iters),
        "--eval-interval", "100000",
        # a checkpoint every iteration and the crash supervisor: a failure
        # costs at most the current iteration, never the arm
        "--save-interval", "1",
        "--auto-restart", "5",
        "--checkpoint-replay", "0",
        "--seed", str(seed),
        "--checkpoint-dir", out_dir,
        "--device", device,
    ]
    t0 = time.perf_counter()
    subprocess.run(cmd, check=True)
    return time.perf_counter() - t0


def _stats_walls(out_dir: str, iters: int):
    """(total_wall_s, steady_s_per_iter) from an arm's training_stats.json.
    The steady state leaves out iteration 1, which carries the first
    call's one-time costs (kernel build, cuDNN's algorithm search)."""
    path = os.path.join(out_dir, "training_stats.json")
    if not os.path.exists(path):
        return None, None
    with open(path) as f:
        stats = json.load(f)
    times = [e["time"] for e in stats[:iters]]
    if not times:
        return None, None
    steady = sum(times[1:]) / max(1, len(times) - 1) if len(times) > 1 else times[0]
    return round(sum(times), 1), round(steady, 1)


def _arm_complete(out_dir: str, iters: int) -> bool:
    return os.path.exists(os.path.join(out_dir, f"checkpoint_iter{iters}"))


def _load(ckpt_dir: str, it: int, device: str):
    path = os.path.join(ckpt_dir, f"checkpoint_iter{it}")
    if not os.path.exists(path):
        have = sorted(
            int(m.group(1)) for m in (re.fullmatch(r"checkpoint_iter(\d+)", n)
                                      for n in os.listdir(ckpt_dir)) if m
        ) if os.path.isdir(ckpt_dir) else []
        sys.exit(f"h2h: {path} missing (completed iterations: {have}) "
                 f"— rerun without --skip-train to finish the arm")
    return AC.load_current(path, device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Gumbel-32 against PUCT-200 at matched wall clock")
    p.add_argument("--gumbel-iters", type=int, default=12)
    p.add_argument("--puct-iters", type=int, default=6)
    p.add_argument("--games", type=int, default=64)
    p.add_argument("--arena-sims", type=int, default=40)
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--skip-train", action="store_true",
                   help="reuse existing checkpoints, only re-run the arena")
    p.add_argument("--device", default="cuda",
                   help="torch device to train and play on (default cuda; 'cpu' for the CPU)")
    args = p.parse_args(argv)

    g_dir = os.path.join(args.out, "gumbel")
    p_dir = os.path.join(args.out, "puct")
    walls = {}
    arms = [("gumbel", g_dir, "gumbel", 32, args.gumbel_iters),
            ("puct", p_dir, "puct", 200, args.puct_iters)]
    for name, out_dir, algo, sims, iters in arms:
        if args.skip_train or _arm_complete(out_dir, iters):
            total, steady = _stats_walls(out_dir, iters)
            if args.skip_train and not _arm_complete(out_dir, iters):
                sys.exit(
                    f"h2h: --skip-train but {out_dir}/checkpoint_iter{iters} "
                    f"is missing — train the {name} arm first (drop "
                    f"--skip-train or lower --{name}-iters)")
            print(f"[h2h] {name} arm complete ({out_dir}/checkpoint_iter"
                  f"{iters}); wall from stats: {total}s", flush=True)
            walls[f"{name}_s"] = total
            walls[f"{name}_steady_s_per_iter"] = steady
        else:
            _train(out_dir, algo, sims, iters, args.seed, args.device)
            # the per-iteration stats are authoritative: a resumed arm's
            # subprocess wall covers only the remaining iterations
            walls[f"{name}_s"], walls[f"{name}_steady_s_per_iter"] = (
                _stats_walls(out_dir, iters))

    # the arena over the CURRENT parameters of the last checkpoints (gated
    # eval is off in both arms, so their best parameters are the initial net)
    net_g = _load(g_dir, args.gumbel_iters, args.device)
    net_p = _load(p_dir, args.puct_iters, args.device)
    res = AC.current_arena(net_g, net_p, args.games, args.arena_sims, 0.2, args.seed)
    batch = res["games"]

    out = {
        "gumbel": {"iters": args.gumbel_iters, "sims": 32,
                   "wall_s": walls.get("gumbel_s"),
                   "steady_s_per_iter": walls.get("gumbel_steady_s_per_iter")},
        "puct": {"iters": args.puct_iters, "sims": 200,
                 "wall_s": walls.get("puct_s"),
                 "steady_s_per_iter": walls.get("puct_steady_s_per_iter")},
        "arena": res,
        "arena_protocol": {"sims": args.arena_sims, "algo": "puct both",
                           "temperature": 0.2, "games": batch},
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "result.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(f"| gumbel-32 x{args.gumbel_iters} it | puct-200 x{args.puct_iters} it "
          f"| {res['a_wins']}-{res['b_wins']}-{res['draws']} "
          f"(gumbel score {res['a_score']:.2f}) |")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
