"""The attribution of ``portbench/spans.py`` on a synthetic chrome trace in
``torch.profiler``'s layout (device events, the runtime calls that launch
them with their correlation ids, the two ``cudaDeviceSynchronize`` anchors)
and host spans on another clock; the readers of the metrics that read spans
and counters; and a whole traced call with the program's recorder on the
CPU, where no trace holds an anchor."""

from __future__ import annotations

import collections

import pytest

from portbench import run, spans, tracing
from portbench.tests.test_portbench_harness import SEED

HostSpan = collections.namedtuple("HostSpan", "name start_ns end_ns parent")
READERS = ["descent_levels_per_sim.selfplay", "descent_idle.selfplay", "draw_idle.selfplay",
           "optimizer_share.learn"]


def _read(name, ctx):
    return run.read_metric(name, ctx, run.HERE)


def _trace(offset_us: float = 5000.0, rate: float = 1.0, anchors: bool = True):
    """A 1 ms window from host 0 ns: three kernels and a fill, a warm-up
    synchronize, the two anchors at the window's edges (each event ending
    where its host bracket ends) and the profiler's own synchronize 200 us
    after it; the trace's clock is the host's (us) times ``rate`` plus
    ``offset_us``.

    Host spans (us): a ply [0, 1000) holding a descent [100, 400) with a
    forward [200, 300) inside, a draw [500, 600) and an optimizer step
    [800, 900). Kernels (host us): K1 [0, 150) launched at 50 (the ply),
    K2 [350, 450) launched at 250 (the forward), K3 [700, 1000) launched at
    550 (the draw); a fill [800, 810) with no launching call. Idle: [150,
    350) (descent 50 + forward 100 + descent 50) and [450, 700) (ply 50 +
    draw 100 + ply 100)."""
    at = lambda host_us: offset_us + rate * host_us  # noqa: E731
    ev = [
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize", "pid": 1,
         "ts": at(-60), "dur": 5 * rate, "args": {"correlation": 0}},   # the warm-up
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize", "pid": 1,
         "ts": at(-1), "dur": 1 * rate, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize", "pid": 1,
         "ts": at(998), "dur": 2 * rate, "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize", "pid": 1,
         "ts": at(1200), "dur": 2 * rate, "args": {"correlation": 3}},   # the profiler's stop
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1,
         "ts": at(50), "dur": 5, "args": {"correlation": 11}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1,
         "ts": at(250), "dur": 5, "args": {"correlation": 12}},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernelEx", "pid": 1,
         "ts": at(550), "dur": 5, "args": {"correlation": 13}},
        {"ph": "X", "cat": "kernel", "name": "k1", "pid": 0, "ts": at(0), "dur": 150 * rate,
         "args": {"correlation": 11}},
        {"ph": "X", "cat": "kernel", "name": "legal_mask_by_piece", "pid": 0, "ts": at(350),
         "dur": 100 * rate, "args": {"correlation": 12}},
        {"ph": "X", "cat": "kernel", "name": "k3", "pid": 0, "ts": at(700), "dur": 300 * rate,
         "args": {"correlation": 13}},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "pid": 0, "ts": at(800),
         "dur": 10 * rate},
        {"ph": "f", "cat": "ac2g", "name": "flow", "pid": 0, "ts": at(50)},
    ]
    brackets = [(-80_000, -50_000), (-2_000, 0), (996_000, 1_000_000)] if anchors else []
    return spans.SpanTrace.from_chrome(ev, 0.001, brackets, 0.0)


SPANS = [HostSpan("selfplay.ply", 0, 1_000_000, -1),
         HostSpan("search.descend", 100_000, 400_000, 0),
         HostSpan("net.forward", 200_000, 300_000, 1),
         HostSpan("draw.sample", 500_000, 600_000, 0),
         HostSpan("learn.optimizer", 800_000, 900_000, 0)]


def _ctx(trace, span_list=SPANS, counters=None):
    return spans.SpanContext(trace, {}, {}, {}, None, span_list, counters)


def test_idle_goes_to_the_innermost_span_by_its_self_time():
    att = spans.Attribution(_trace(), SPANS)
    got = {k: round(v * 1e6, 6) for k, v in att.idle_s.items() if v}
    assert got == {"search.descend": 100.0, "net.forward": 100.0, "selfplay.ply": 150.0,
                   "draw.sample": 100.0}
    assert sum(att.idle_s.values()) == pytest.approx(1e-3 - _trace().busy_s())


def test_idle_outside_every_span_is_kept_apart():
    att = spans.Attribution(_trace(), SPANS[1:])
    assert att.idle_s[spans.NO_SPAN] == pytest.approx(150e-6)   # [450, 500) and [600, 700)


def test_a_device_event_goes_to_the_span_that_launched_it():
    tr = _trace()
    att = spans.Attribution(tr, SPANS)
    got = {k: round(v * 1e6, 6) for k, v in att.device_s.items()}
    assert got == {"selfplay.ply": 150.0, "net.forward": 100.0, "draw.sample": 300.0,
                   spans.NO_LAUNCH: 10.0}
    assert att.launched_within(tr, "legal_mask", ("net.forward",)) == (1, 1)
    assert att.launched_within(tr, "legal_mask", ("search.descend",)) == (1, 1)   # an ancestor
    assert att.launched_within(tr, "legal_mask", ("draw.sample",)) == (0, 1)
    assert att.launched_within(tr, "", ("selfplay.ply",)) == (3, 4)   # the fill: no launch


@pytest.mark.parametrize("offset_us,rate", [(5000.0, 1.0), (-123456.5, 1.0), (77.0, 1.0005)])
def test_the_anchors_map_the_host_clock_onto_the_trace(offset_us, rate):
    tr = _trace(offset_us, rate)
    assert [t for t, _ in tr.anchors] == pytest.approx([offset_us, offset_us + 1000 * rate])
    assert tr.to_trace_us(0) == pytest.approx(offset_us)
    assert tr.to_trace_us(1_000_000) == pytest.approx(offset_us + 1000 * rate)
    att = spans.Attribution(tr, SPANS)
    assert att.idle_s["search.descend"] * 1e6 == pytest.approx(100.0 * rate)
    assert att.device_s["draw.sample"] * 1e6 == pytest.approx(300.0 * rate)


def test_an_offset_off_by_200_us_moves_the_charges():
    """The same trace read with the clocks' offset 200 us short: the spans
    and the window land 200 us early on the trace, and the idle time is
    charged to other spans (descent 150 us, draw 50 us, the optimizer
    step 100 us)."""
    tr = _trace()
    tr.anchors = [(t - 200.0, h) for t, h in tr.anchors]
    att = spans.Attribution(tr, SPANS)
    assert att.idle_s["search.descend"] * 1e6 == pytest.approx(150.0)
    assert att.idle_s["draw.sample"] * 1e6 == pytest.approx(50.0)
    assert att.idle_s["learn.optimizer"] * 1e6 == pytest.approx(100.0)


def test_the_readers():
    ctx = _ctx(_trace(), counters={"search.descent_levels": 30, "search.simulations": 8})
    assert _read("descent_levels_per_sim.selfplay", ctx) == 3.75
    assert _read("descent_idle.selfplay", ctx) == pytest.approx(10.0)
    assert _read("draw_idle.selfplay", ctx) == pytest.approx(10.0)
    assert _read("optimizer_share.learn", ctx) == pytest.approx(0.0)
    # descent and draws are parts of the device's idle share
    idle = _read("device_idle.selfplay", ctx)
    assert idle == pytest.approx(45.0) and 20.0 <= idle


@pytest.mark.parametrize("case", ["plain_context", "plain_trace", "no_anchor", "no_spans",
                                  "other_spans"])
@pytest.mark.parametrize("name", READERS)
def test_the_readers_find_nothing_to_read(name, case):
    """None, not an error, where the harness records no spans (as the
    parent's does), where the trace has no anchor (no card), or where the
    call opened none of the spans a reader reads."""
    ctx = {
        "plain_context": run.ReadContext(_trace(), {}, {}, {}, None),
        "plain_trace": _ctx(tracing.DeviceTrace(_trace().events, 0.001)),
        "no_anchor": _ctx(_trace(anchors=False), counters={}),
        "no_spans": _ctx(_trace(), [], {"search.simulations": 0}),
        "other_spans": _ctx(_trace(), [HostSpan("selfplay.ply", 0, 1_000_000, -1)], {}),
    }[case]
    assert _read(name, ctx) is None


@pytest.mark.parametrize("workload", ["learn.full256x10", "selfplay.full256x10"])
def test_run_spans_on_the_cpu(tiny_bench, workload):
    """The whole traced call with the recorder on: the program's counters
    reach the readers, the check passes, and with no card (no anchor) the
    readers of spans find nothing."""
    cell = run.load_cell(workload, tiny_bench)
    out = spans.run_spans(cell, SEED, "cpu")
    assert out["correct"] is True, out["compared"]
    rec = out["recorder"]
    assert rec["spans"] > 0 and rec["span_on_ns"] > 0 and rec["host_s"] > 0
    if workload.startswith("learn"):
        steps = cell.traffic["trace_steps"]
        assert rec["counters"] == {"learn.steps": steps,
                                   "learn.rows": steps * cell.traffic["batch"]}
        assert out["metrics"]["optimizer_share.learn"] is None
    else:
        c = rec["counters"]
        assert c["search.simulations"] > 0 and c["net.positions"] > 0
        assert out["metrics"]["descent_levels_per_sim.selfplay"] == pytest.approx(
            c["search.descent_levels"] / c["search.simulations"])
        assert out["metrics"]["descent_idle.selfplay"] is None
    assert out["alignment"] is None and out["clock"]["anchors"] == 0
