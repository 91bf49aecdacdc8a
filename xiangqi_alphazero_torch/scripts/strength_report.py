"""Strength run summary: the Elo ladder against the training dynamics.

Port of the repo's ``scripts/strength_report.py`` (pure JSON, no device).
Joins a run's ``training_stats.json`` (the port trainer's carries every
field read here; the fields it adds, such as ``sims_per_ply``, are
ignored) with a ladder JSON (the output of ``python -m
xiangqi_alphazero_torch.train.elo``) and prints a markdown table of
iteration -> Elo, policy and value loss, average game length and draw
rate.

    python -m xiangqi_alphazero_torch.scripts.strength_report \\
        --run runs/torch/flagship --ladder runs/torch/ladder.json [--window 5]
"""

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Elo by training dynamics")
    p.add_argument("--run", default="runs/torch/flagship")
    p.add_argument("--ladder", default=None)
    p.add_argument("--window", type=int, default=5,
                   help="average training metrics over the last N "
                        "iterations up to each snapshot")
    args = p.parse_args(argv)

    with open(os.path.join(args.run, "training_stats.json")) as f:
        stats = json.load(f)
    by_iter = {e["iteration"]: e for e in stats}

    ratings = {}
    if args.ladder and os.path.exists(args.ladder):
        with open(args.ladder) as f:
            ladder = json.load(f)
        for path, elo in ladder["ratings"].items():
            base = os.path.basename(path.rstrip("/"))
            if base.startswith("checkpoint_iter"):
                ratings[int(base[len("checkpoint_iter"):])] = elo
            elif "iter0" in path:
                ratings[0] = elo

    snaps = sorted(ratings) if ratings else sorted(
        i for i in by_iter if i % 20 == 0
    )

    def window_avg(it, key_path):
        vals = []
        for j in range(max(1, it - args.window + 1), it + 1):
            e = by_iter.get(j)
            if e is None:
                continue
            d = e
            for k in key_path:
                d = d.get(k, {})
            if isinstance(d, (int, float)):
                vals.append(d)
        return sum(vals) / len(vals) if vals else None

    print("| iteration | Elo | policy loss | value loss | avg plies | "
          "draw rate |")
    print("|---|---|---|---|---|---|")
    for it in snaps:
        elo = f"{ratings[it]:.0f}" if it in ratings else "-"
        if it == 0:
            print(f"| 0 | {elo} | - | - | - | - |")
            continue
        pl = window_avg(it, ("training", "policy_loss"))
        vl = window_avg(it, ("training", "value_loss"))
        plies = window_avg(it, ("self_play", "avg_steps"))
        e = by_iter.get(it, {})
        sp = e.get("self_play", {})
        games = sp.get("games", 0)
        dr = sp.get("draws", 0) / games if games else None
        row = [
            str(it), elo,
            f"{pl:.3f}" if pl is not None else "-",
            f"{vl:.3f}" if vl is not None else "-",
            f"{plies:.0f}" if plies is not None else "-",
            f"{dr:.2f}" if dr is not None else "-",
        ]
        print("| " + " | ".join(row) + " |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
