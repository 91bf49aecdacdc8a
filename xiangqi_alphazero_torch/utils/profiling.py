"""Profiling utilities: phase timers + a ``torch.profiler`` trace helper.

Port of ``xiangqi_alphazero_tpu.utils.profiling``. ``Timer`` times phases
on the host clock and, given a CUDA tensor, waits for the card with
``torch.cuda.synchronize`` before it stops the clock (PyTorch returns
before the device finishes). ``phase_profile`` wraps a region in a
``torch.profiler`` capture and writes its chrome trace into a directory,
where ``utils/trace_tools.py`` reads it.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


class Timer:
    """Accumulating phase timer; call .phase(name) around device work."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync: Optional[torch.Tensor] = None):
        """Time the block; with ``sync`` on the card, wait for the card
        first."""
        t0 = time.perf_counter()
        yield
        if sync is not None and sync.is_cuda:
            torch.cuda.synchronize(sync.device)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        total = sum(self.totals.values()) or 1e-9
        lines = []
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            pct = 100.0 * t / total
            bar = "#" * int(pct / 2.5)
            lines.append(
                f"{name:<28s} {t:9.3f}s {pct:5.1f}% x{self.counts[name]:<6d} {bar}"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def phase_profile(trace_dir: Optional[str] = None):
    """Wrap a region in a ``torch.profiler`` capture when ``trace_dir`` is
    given, and write its chrome trace there as ``trace_<ns>.json``.

    On the card the capture records the CUDA activity alone (kernels,
    copies, fills and the runtime calls that launch them), not the host's
    operator events: a multi-phase capture holds hundreds of thousands of
    kernels, and the host events would double it (the JAX helper's
    ``device_only`` default, with no switch). Without a card it records
    the CPU activity."""
    if not trace_dir:
        yield
        return
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CUDA if cuda else torch.profiler.ProfilerActivity.CPU]
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(trace_dir, f"trace_{time.time_ns()}.json"))
