"""The device trace of one window, and what is read from it.

``Window`` runs ``torch.profiler`` from ``start()`` to ``stop()`` with the
CUDA activity only (kernels, copies, fills, and the runtime calls that
launch them; no host operator events, which would slow the host and double
the trace; the CPU activity where there is no card, whose trace holds no
device event), writes the chrome trace under a scratch directory, and reads
it back. A driver may start the window inside a call (self-play starts it
at the call's first evaluation, after the openings).

The arithmetic follows the port's trace reader (device events found by
category, summed by name), with one change: the device's busy time is the
union of the device events' intervals, so that events overlapping on two
streams count once.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import shutil
import tempfile
import time
from typing import Callable, List, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class DeviceTrace:
    """Device events of a traced window: (name, start us, duration us)."""

    events: List[Tuple[str, float, float]]
    window_s: float    # the window's length on the host clock

    def busy_s(self) -> float:
        """Seconds in which at least one device event ran."""
        busy, end = 0.0, float("-inf")
        for _, start, dur in sorted(self.events, key=lambda e: e[1]):
            stop = start + dur
            if stop > end:
                busy += stop - max(start, end)
                end = stop
        return busy / 1e6

    def ops(self, name_has: str = "") -> Tuple[int, float]:
        """(count, summed seconds) of the events whose name holds ``name_has``."""
        sel = [d for n, _, d in self.events if name_has in n]
        return len(sel), sum(sel) / 1e6

    def top_ops(self, n: int = 10) -> List[List]:
        """The ``n`` event names with the most summed device seconds."""
        dur: collections.Counter = collections.Counter()
        for name, _, d in self.events:
            dur[name] += d / 1e6
        return [[name, s] for name, s in dur.most_common(n)]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """Idle time between device events, summed by the event that ends
        the gap (the host was running the code that leads to its launch):
        the ``n`` largest sums, as ``host_before:<event>``."""
        gaps: collections.Counter = collections.Counter()
        end = None
        for name, start, dur in sorted(self.events, key=lambda e: e[1]):
            if end is not None and start > end:
                gaps[f"host_before:{name}"] += (start - end) / 1e6
            end = start + dur if end is None else max(end, start + dur)
        return [[name, s] for name, s in gaps.most_common(n)]


def _device_events(path: str) -> List[Tuple[str, float, float]]:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e.get("name", ""), float(e["ts"]), float(e.get("dur", 0))) for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]


class Window:
    """One traced window; ``sync`` waits for the device."""

    def __init__(self, sync: Callable[[], None]):
        self.sync = sync
        self.prof = None

    def start(self) -> None:
        """Open the window (once; later calls do nothing)."""
        import torch

        if self.prof is not None:
            return
        act = (torch.profiler.ProfilerActivity.CUDA if torch.cuda.is_available()
               else torch.profiler.ProfilerActivity.CPU)
        self.prof = torch.profiler.profile(activities=[act])
        self.sync()
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> DeviceTrace:
        """Close the window and read its trace. The trace goes to a scratch
        directory under the temporary directory, removed once read."""
        self.sync()
        window_s = time.perf_counter() - self.t0
        time.sleep(0.2)   # idle padding: the profiler drops records at a window's edge
        self.prof.stop()
        scratch = tempfile.mkdtemp(prefix="portbench_trace_")
        try:
            path = os.path.join(scratch, "trace.json")
            self.prof.export_chrome_trace(path)
            return DeviceTrace(_device_events(path), window_s)
        finally:
            shutil.rmtree(scratch, ignore_errors=True)
