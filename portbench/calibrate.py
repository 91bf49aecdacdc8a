"""The readings that set a cell's limits: the program's, the control's, and
the faults', for many seeds in one process.

    python3 -m portbench.calibrate --workload <name> --seeds 11,12,13 [--out FILE]

Per seed: the cell's set-up and, for self-play, one timed call (the run's
own window at its shortest), then the driver's ``calibrate()``: the program
against the reference, the control (the reference in float8 in the
program's place) against the reference, and for the learner the fault that
leaves half of each batch out. One JSON line per seed on standard output
(and appended to ``--out``); the largest program reading and the smallest
control and fault readings of each number last.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from . import run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--out", type=Path)
    p.add_argument("--device", default="cuda")
    p.add_argument("--bench", type=Path, default=run.ROOT / "BENCHMARK.json")
    args = p.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = run.load_cell(args.workload, args.bench)
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        driver = run.make_driver(cell, seed, args.device)
        driver.setup()
        setup_s = time.perf_counter() - t0
        values, _ = driver.window(0.0)
        driver.release()
        line = {"workload": cell.name, "seed": seed, "setup_s": setup_s, **values,
                "readings": driver.calibrate(), "seconds": time.perf_counter() - t0}
        lines.append(line)
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        del driver
    summary = {}
    for side in lines[0]["readings"]:
        for name in lines[0]["readings"][side]:
            vals = [ln["readings"][side][name] for ln in lines]
            summary[f"{side}.{name}"] = max(vals) if side == "program" else min(vals)
    print(json.dumps({"workload": cell.name, "seeds": len(lines), "summary": summary}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
