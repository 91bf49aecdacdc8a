"""Device-trace aggregation: where a program's time goes on the card.

    python -m xiangqi_alphazero_torch.utils.benchmark --profile standard --trace /tmp/t
    python -m xiangqi_alphazero_torch.utils.trace_tools /tmp/t --top 25

Port of ``xiangqi_alphazero_tpu.utils.trace_tools`` for the chrome traces
that ``torch.profiler`` writes (``utils/profiling.py::phase_profile``).
Two parts of the JAX reader do not carry over:

- device events are found by their category, not by a process named
  "TPU"/"GPU": kernels carry ``cat: "kernel"``, copies and fills
  ``"gpu_memcpy"`` and ``"gpu_memset"``;
- XLA's ops nest, so the JAX reader takes the largest single event as the
  total. CUDA events do not nest, but events on two streams can overlap, so
  the device's busy time here is the union of the device events'
  intervals (an overlap counts once), printed beside the traced wall (the
  first event's start to the last event's end), which it cannot exceed.
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
from typing import List, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def load_trace_events(trace_dir: str) -> List[dict]:
    """The events of the newest chrome trace (``*.json`` or
    ``*.json.gz``) under ``trace_dir``."""
    paths = [p for pat in ("*.json", "*.json.gz")
             for p in glob.glob(os.path.join(trace_dir, pat))]
    if not paths:
        raise FileNotFoundError(f"no *.json or *.json.gz trace under {trace_dir}")
    path = max(paths, key=os.path.getmtime)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)["traceEvents"]


def aggregate_device_ops(events: List[dict]) -> List[Tuple[str, float, int]]:
    """[(op name, total_ms, count)] over the device events (kernels,
    copies, fills), sorted by total duration descending."""
    dur: collections.Counter = collections.Counter()
    cnt: collections.Counter = collections.Counter()
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES:
            dur[e.get("name", "")] += e.get("dur", 0)
            cnt[e.get("name", "")] += 1
    return [(n, d / 1e3, cnt[n]) for n, d in dur.most_common()]


def device_busy_ms(events: List[dict]) -> float:
    """Milliseconds in which at least one device event ran: the union of
    the device events' intervals."""
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES)
    busy, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy / 1e3


def traced_wall_ms(events: List[dict]) -> float:
    """From the first complete event's start to the last one's end, ms."""
    spans = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
             if e.get("ph") == "X" and "ts" in e]
    if not spans:
        return 0.0
    return (max(end for _, end in spans) - min(start for start, _ in spans)) / 1e3


def report(events: List[dict], top: int = 25) -> List[str]:
    """The summary lines the CLI prints: the device's busy time beside the
    traced wall, then the ``top`` device ops with their shares of the
    summed device time; empty when there are no device events."""
    rows = aggregate_device_ops(events)
    if not rows:
        return []
    total = sum(ms for _, ms, _ in rows) or 1e-9
    lines = [f"device busy (union of kernels, copies, fills): {device_busy_ms(events):.3f} ms "
             f"over a traced wall of {traced_wall_ms(events):.3f} ms, "
             f"{sum(n for _, _, n in rows)} events"]
    for name, ms, n in rows[:top]:
        lines.append(f"{ms:9.3f} ms {100 * ms / total:5.1f}% x{n:<6d} {name[:90]}")
    return lines


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="aggregate a torch.profiler trace")
    p.add_argument("trace_dir")
    p.add_argument("--top", type=int, default=25)
    args = p.parse_args(argv)

    lines = report(load_trace_events(args.trace_dir), args.top)
    print("\n".join(lines) if lines else "no device events found")
    return 0 if lines else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
