"""Profiling utilities: the span and counter recorder, and a
``torch.profiler`` trace helper.

The recorder: ``span(name)`` marks a phase of the host code (a context
manager), ``count(name, n)`` adds to a counter, and ``recording()`` makes
one ``Recording`` active for a block and yields it. A span keeps its name,
its start and end on ``time.perf_counter_ns()``, its parent (the span open
when it began) and its root (the outermost span open then, whose id every
span under it shares). Spans stay in memory, to be read once the block
ends. With no recording active, ``span`` returns one shared no-op context
manager and ``count`` returns at once: nothing allocates, and nothing
touches the device either way, so recording changes no result and never
waits for the card. A recording takes the spans of the thread that opened
it; other threads record nothing. One recording is active at a time in a
process (a nested one replaces it for its block).

``phase_profile`` wraps a region in a ``torch.profiler`` capture and writes
its chrome trace into a directory, where ``utils/trace_tools.py`` reads it.
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional

import torch


class Recording:
    """The spans (in the order they began) and counters of one
    ``recording()`` block."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self.thread = threading.get_ident()
        self._open: List[int] = []

    def totals_ns(self) -> Dict[str, int]:
        """Summed duration of the closed spans, by name."""
        out: Dict[str, int] = {}
        for s in self.spans:
            if s.end_ns is not None:
                out[s.name] = out.get(s.name, 0) + s.end_ns - s.start_ns
        return out


class Span:
    """One span of a ``Recording``: ``parent`` and ``root`` are indices
    into its ``spans`` (``parent`` -1 for a root span, whose ``root`` is
    its own index); ``end_ns`` is None while it is open."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "root", "_rec")

    def __init__(self, rec: Recording, name: str):
        self._rec, self.name = rec, name
        self.start_ns = self.end_ns = None

    def __enter__(self) -> "Span":
        rec = self._rec
        i = len(rec.spans)
        self.parent = rec._open[-1] if rec._open else -1
        self.root = rec.spans[self.parent].root if rec._open else i
        rec.spans.append(self)
        rec._open.append(i)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        self._rec._open.pop()
        return False


_OFF = contextlib.nullcontext()
_active: Optional[Recording] = None


def _recording() -> Optional[Recording]:
    rec = _active
    if rec is None or rec.thread != threading.get_ident():
        return None
    return rec


def span(name: str):
    """A context manager that records the block as the span ``name`` in
    the active recording; the shared no-op one when none is active."""
    rec = _recording()
    return _OFF if rec is None else Span(rec, name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` (a host integer) to the counter ``name`` of the active
    recording, if any."""
    rec = _recording()
    if rec is not None:
        rec.counters[name] = rec.counters.get(name, 0) + n


def spanned(name: str) -> Callable:
    """Decorator: every call of the function is the span ``name``."""

    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Make a new ``Recording`` active for the block (in the calling
    thread) and yield it; the one active before is restored after."""
    global _active
    prev, rec = _active, Recording()
    _active = rec
    try:
        yield rec
    finally:
        _active = prev


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
