"""The program's spans on the device trace's clock, and what is read from
them.

    python3 -m portbench.spans --workload <name> --seed <n>

runs a cell's traced call as ``run.py --trace 1`` does (the same set-up, the
same call under the same CUDA-only profiler, the same check against the
reference), with the program's recorder
(``xiangqi_alphazero_torch.utils.profiling.recording``) active for the
traced call, and prints one line: the cell's per-layer metrics, the metrics
read from the program's spans and counters (``SPAN_METRICS``), a breakdown
with idle time and device time by span, the clock alignment's checks, and
the recorder's own cost. The program records nothing unless a recording is
active, so ``run.py``'s runs are untouched by it.

The clock: ``SpanWindow`` is ``tracing.Window`` with a
``torch.cuda.synchronize()`` bracketed by ``time.perf_counter_ns()`` right
after the profiler starts and one at its end. Each gives one
``cudaDeviceSynchronize`` runtime event in the trace and launches no device
work; the line through the two (the end of each event against the end of its
host bracket) maps the host clock of the spans onto the trace's. On the card
(torch 2.11, CUDA 12.8) the profiler's callback takes ~200 us of the host's
bracket before the event's start and ~12 us after its end, so the ends pair
within ~10 us, and the first call after the profiler starts pays ~1 ms more:
the window synchronizes once before its start anchor, and starts after
it.

The attributions (``Attribution``):

- idle by span: each stretch of device idle time inside the window (the
  complement of the union of the device events) is charged to the innermost
  span the host was in at that moment, by that span's self time (its
  interval less its children's); idle time outside every span is
  ``(no span)``;
- device time by span: each device event is charged to the innermost span
  open when the runtime or driver call that launched it began, matched by
  the trace's correlation id (``(no launch)`` where the trace holds no such
  call).
"""

from __future__ import annotations

import argparse
import bisect
import collections
import contextlib
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from portbench import run, tracing

ANCHOR = "cudaDeviceSynchronize"
NO_SPAN, NO_LAUNCH = "(no span)", "(no launch)"
# the metrics read from the program's spans and counters, by the driver of
# the cells that report them
SPAN_METRICS = {
    "selfplay": ["descent_levels_per_sim.selfplay", "descent_idle.selfplay",
                 "draw_idle.selfplay"],
    "learn": ["optimizer_share.learn"],
}
# (device events whose name holds the first, spans any of whose names must
# hold their launch), by driver: the clock alignment's checks
ALIGNMENT = {
    "selfplay": {"legal_mask": ("legal_mask_by_piece", ("env.evaluate", "selfplay.env_step")),
                 "conv_fprop": ("fprop", ("net.forward",))},
    "learn": {"adam": ("multi_tensor_apply", ("learn.optimizer",))},
}


@dataclasses.dataclass
class SpanTrace(tracing.DeviceTrace):
    """A device trace that also keeps, for each device event, its
    correlation id (-1 where it has none), the start of each launching call
    by correlation id, and the clock anchors: (trace us, host ns) pairs,
    each the midpoint of one anchor's runtime event and of its host
    bracket."""

    corr: List[int] = dataclasses.field(default_factory=list)
    launches: Dict[int, float] = dataclasses.field(default_factory=dict)
    anchors: List[Tuple[float, float]] = dataclasses.field(default_factory=list)
    host_t0_ns: float = 0.0   # the window's start on the host clock

    @classmethod
    def from_chrome(cls, events: Sequence[dict], window_s: float,
                    brackets: Sequence[Tuple[int, int]], host_t0_ns: float) -> "SpanTrace":
        """Read ``torch.profiler``'s chrome trace events. ``brackets``: the
        host clock (ns) before and after each synchronize of the window, in
        order. All but the last are paired in order with the trace's first
        anchor events, the last with the later event nearest to where it
        falls at the host clock's rate (the profiler's own stop synchronizes
        too, after the window's padding). The last two pairs are the
        anchors."""
        dev, corr, launches, syncs = [], [], {}, []
        for e in events:
            if e.get("ph") != "X":
                continue
            args = e.get("args") or {}
            c = args.get("correlation", -1)
            if e.get("cat") in tracing.DEVICE_CATEGORIES:
                dev.append((e.get("name", ""), float(e["ts"]), float(e.get("dur", 0))))
                corr.append(int(c))
                continue
            if e.get("name") == ANCHOR:
                syncs.append(float(e["ts"]) + float(e.get("dur", 0)))
            if c != -1:
                launches[int(c)] = float(e["ts"])
        syncs.sort()
        ends = [b for _, b in brackets]
        lead = max(0, min(len(ends) - 1, len(syncs)))
        pairs = list(zip(syncs[:lead], ends[:lead]))
        if lead and len(syncs) > lead:
            t, h = pairs[-1]
            want = t + (ends[-1] - h) / 1e3
            pairs.append((min(syncs[lead:], key=lambda x: abs(x - want)), ends[-1]))
        return cls(dev, window_s, corr, launches, pairs[-2:], host_t0_ns)

    def to_trace_us(self, host_ns: float) -> float:
        """A host ``perf_counter_ns`` instant on the trace's clock (us)."""
        (t1, h1) = self.anchors[0]
        rate = 1e-3
        if len(self.anchors) > 1 and self.anchors[-1][1] != h1:
            t2, h2 = self.anchors[-1]
            rate = (t2 - t1) / (h2 - h1)
        return t1 + (host_ns - h1) * rate


class SpanWindow(tracing.Window):
    """``tracing.Window`` with the clock anchors, returning a
    ``SpanTrace``."""

    def start(self) -> None:
        if self.prof is not None:
            return
        super().start()
        self.brackets = []
        for _ in range(2):   # the first pays the profiler's set-up
            a = time.perf_counter_ns()
            self.sync()
            self.brackets.append((a, time.perf_counter_ns()))
        self.t0 = self.brackets[-1][1] / 1e9

    def stop(self) -> SpanTrace:
        a = time.perf_counter_ns()
        self.sync()
        b = time.perf_counter_ns()
        self.brackets.append((a, b))
        window_s = b / 1e9 - self.t0
        time.sleep(0.2)   # idle padding: the profiler drops records at a window's edge
        self.prof.stop()
        scratch = tempfile.mkdtemp(prefix="portbench_spans_")
        try:
            path = os.path.join(scratch, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            shutil.rmtree(scratch, ignore_errors=True)
        return SpanTrace.from_chrome(events, window_s, self.brackets, self.t0 * 1e9)


def innermost_segments(spans, to_us) -> List[Tuple[float, float, int]]:
    """The host timeline cut into (start us, end us, span index) pieces,
    each owned by the innermost span open over it; time outside every span
    is left out. ``spans`` are properly nested intervals with ``name``,
    ``start_ns``, ``end_ns`` and ``parent``; open ones are skipped."""
    points = []
    for i, s in enumerate(spans):
        if s.end_ns is None or s.end_ns <= s.start_ns:
            continue
        points.append((to_us(s.start_ns), 1, i))
        points.append((to_us(s.end_ns), 0, -i))   # at one instant: ends first, inner first
    points.sort()
    segs, stack, prev = [], [], None
    for t, opens, key in points:
        if stack and t > prev:
            segs.append((prev, t, stack[-1]))
        if opens:
            stack.append(key)
        else:
            stack.remove(-key)
        prev = t
    return segs


def idle_stretches(events, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] (us) in which no device event ran."""
    out, at = [], lo
    for _, start, dur in sorted(events, key=lambda e: e[1]):
        if start > at:
            out.append((at, min(start, hi)))
        at = max(at, start + dur)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


class Attribution:
    """Idle and device seconds of one ``SpanTrace`` by the program's spans
    (by name), and the span each device event was launched in."""

    def __init__(self, trace: SpanTrace, spans):
        self.spans = spans
        self.names = {s.name for s in spans}
        segs = innermost_segments(spans, trace.to_trace_us)
        starts = [a for a, _, _ in segs]
        lo = trace.to_trace_us(trace.host_t0_ns)
        hi = trace.to_trace_us(trace.host_t0_ns + trace.window_s * 1e9)

        self.idle_s: Dict[str, float] = collections.defaultdict(float)
        for a, b in idle_stretches(trace.events, lo, hi):
            covered = 0.0
            j = max(0, bisect.bisect_right(starts, a) - 1)
            while j < len(segs) and segs[j][0] < b:
                s0, s1, owner = segs[j]
                part = min(b, s1) - max(a, s0)
                if part > 0:
                    self.idle_s[spans[owner].name] += part / 1e6
                    covered += part
                j += 1
            self.idle_s[NO_SPAN] += (b - a - covered) / 1e6

        self.owner: List[Optional[int]] = []
        self.device_s: Dict[str, float] = collections.defaultdict(float)
        for (_, _, dur), c in zip(trace.events, trace.corr):
            t = trace.launches.get(c)
            owner = None
            if t is not None:
                k = bisect.bisect_right(starts, t) - 1
                if k >= 0 and segs[k][0] <= t < segs[k][1]:
                    owner = segs[k][2]
            self.owner.append(owner)
            name = spans[owner].name if owner is not None else (NO_SPAN if t is not None
                                                                 else NO_LAUNCH)
            self.device_s[name] += dur / 1e6

    def within(self, i: Optional[int], names) -> bool:
        """Whether span ``i`` or one of its ancestors is named in ``names``."""
        while i is not None and i >= 0:
            if self.spans[i].name in names:
                return True
            i = self.spans[i].parent
        return False

    def launched_within(self, trace: SpanTrace, kernel_has: str, names) -> Tuple[int, int]:
        """(launched within ``names``, all) of the device events whose name
        holds ``kernel_has``."""
        sel = [o for (n, _, _), o in zip(trace.events, self.owner) if kernel_has in n]
        return sum(self.within(o, names) for o in sel), len(sel)


def read_spans(ctx) -> Optional[Attribution]:
    """The attribution of ``ctx``'s trace to its spans (made once per
    trace), or None where ``ctx`` holds no spans (a harness that does not
    record them) or its trace no clock anchor (no card)."""
    spans, trace = getattr(ctx, "spans", None), ctx.trace
    if not spans or not getattr(trace, "anchors", None):
        return None
    if getattr(trace, "attribution", None) is None:
        trace.attribution = Attribution(trace, spans)
    return trace.attribution


@dataclasses.dataclass
class SpanContext(run.ReadContext):
    """``run.ReadContext`` with the program's spans and counters of the
    traced call."""

    spans: Optional[list] = None
    program_counters: Optional[Dict[str, int]] = None


@contextlib.contextmanager
def span_windows() -> Iterator[None]:
    """Drivers open a ``SpanWindow`` where they open a ``tracing.Window``."""
    plain = tracing.Window
    tracing.Window = SpanWindow
    try:
        yield
    finally:
        tracing.Window = plain


def recorder_cost_ns(n: int = 200_000) -> Dict[str, float]:
    """Host ns a span and a count take with a recording active, and a span
    with none (the recorder as the program calls it)."""
    from xiangqi_alphazero_torch.utils import profiling as P

    def per_call(fn) -> float:
        t = time.perf_counter_ns()
        for _ in range(n):
            fn()
        return (time.perf_counter_ns() - t) / n

    def one_span():
        with P.span("x"):
            pass

    off = per_call(one_span)
    with P.recording():
        on = per_call(one_span)
        cnt = per_call(lambda: P.count("x"))
    return {"span_on_ns": on, "count_on_ns": cnt, "span_off_ns": off}


def run_spans(cell: run.Cell, seed: int, device) -> dict:
    """The cell's traced call with the program's recorder on; the result
    line's dict."""
    from xiangqi_alphazero_torch.utils import profiling as P

    driver = run.make_driver(cell, seed, device)
    driver.setup()
    with span_windows(), P.recording() as rec:
        tr, counters = driver.traced()
    kind = cell.traffic["driver"]
    peaks = run._load_json(run.HERE / "peaks.json").get(run.device_info(device, 1)["kind"])
    ctx = SpanContext(tr, counters, cell.cfg, cell.traffic, peaks, rec.spans, dict(rec.counters))
    names = [m["name"] for m in cell.per_layer()] + SPAN_METRICS[kind]
    metrics = {name: run.read_metric(name, ctx, cell.base) for name in names}
    att = read_spans(ctx)

    def top(by_name: Dict[str, float]) -> List[List]:
        return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]

    cost = recorder_cost_ns()
    calls = {"spans": len(rec.spans),
             "counts": rec.counters.get("search.descent_levels", 0)
             + rec.counters.get("search.simulations", 0)
             + sum(s.name == "net.forward" for s in rec.spans)
             + rec.counters.get("learn.steps", 0) * 2}
    host_s = (calls["spans"] * cost["span_on_ns"] + calls["counts"] * cost["count_on_ns"]) / 1e9
    out = {
        "metrics": metrics,
        "device": {**run.device_info(device, 1), "busy_s": tr.busy_s(), "window_s": tr.window_s,
                   "power": run.power_limit()},
        "breakdown": {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_gaps(10),
                      "idle_spans": top(att.idle_s) if att else None,
                      "device_spans": top(att.device_s) if att else None},
        "alignment": ({k: att.launched_within(tr, has, names)
                       for k, (has, names) in ALIGNMENT[kind].items()} if att else None),
        "clock": {"anchors": len(tr.anchors),
                  "rate": (tr.anchors[-1][0] - tr.anchors[0][0])
                  / ((tr.anchors[-1][1] - tr.anchors[0][1]) / 1e3)
                  if len(tr.anchors) > 1 else None,
                  "launch_matched": sum(c in tr.launches for c in tr.corr),
                  "device_events": len(tr.events)},
        "recorder": {**calls, **cost, "host_s": host_s,
                     "host_share": host_s / tr.window_s if tr.window_s else None,
                     "counters": dict(rec.counters),
                     "host_s_by_span": {k: v / 1e9 for k, v in rec.totals_ns().items()}},
    }
    driver.release()
    numbers = driver.check()
    compared = {k: {"value": v, "limit": cell.limits[k]["limit"]}
                for k, v in numbers.items() if k in cell.limits}
    out["correct"] = all(c["value"] <= c["limit"] for c in compared.values())
    out["compared"] = compared
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)

    os.environ["TORCH_EXTENSIONS_DIR"] = str(run.CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(run.CACHE / "triton")
    import torch

    cell = run.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench.spans: needs a CUDA device", file=sys.stderr)
        return 2
    out = run_spans(cell, args.seed, "cuda")
    print(json.dumps({"workload": cell.name, "seed": args.seed, **out}), flush=True)
    return 0


if __name__ == "__main__":   # run as portbench.spans, the module the readers import
    from portbench.spans import main as _main

    sys.exit(_main())
