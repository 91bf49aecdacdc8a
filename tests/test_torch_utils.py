"""The port's profiling tools on the CPU: ``utils/profiling.py::phase_profile``,
``utils/trace_tools.py`` on a small synthetic chrome trace in
``torch.profiler``'s layout (kernels, copies, fills, runtime calls and host
operators), and ``utils/benchmark.py::main`` on ``--device cpu`` at 32
channels x 1 block, batch 4, 4 simulations, with a trace. (The harness's
fixed action 44 is held against JAX ``v_step`` in
``tests/test_torch_engine.py``.)"""

import gzip
import json
import os

import numpy as np
import pytest
import torch

from xiangqi_alphazero_torch.utils import benchmark as B
from xiangqi_alphazero_torch.utils import trace_tools as TT
from xiangqi_alphazero_torch.utils.profiling import phase_profile


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread, so parallel test workers
    do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _synthetic_trace() -> dict:
    """Events as torch.profiler's chrome trace writes them (us)."""
    ev = [
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "pid": 1, "ts": 0, "dur": 900},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "ts": 5, "dur": 8},
        {"ph": "X", "cat": "kernel", "name": "legal_mask_by_piece", "pid": 0, "ts": 100, "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "legal_mask_by_piece", "pid": 0, "ts": 200, "dur": 7},
        {"ph": "X", "cat": "kernel", "name": "sm90_xmma_gemm", "pid": 0, "ts": 300, "dur": 40},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pageable)", "pid": 0,
         "ts": 400, "dur": 3},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "pid": 0, "ts": 500, "dur": 1},
        {"ph": "f", "cat": "ac2g", "name": "flow", "pid": 0, "ts": 100},
    ]
    return {"traceEvents": ev}


def test_aggregate_device_ops_reads_torch_categories():
    events = _synthetic_trace()["traceEvents"]
    rows = TT.aggregate_device_ops(events)
    assert rows == [("sm90_xmma_gemm", 0.04, 1), ("legal_mask_by_piece", 0.012, 2),
                    ("Memcpy DtoH (Device -> Pageable)", 0.003, 1), ("Memset (Device)", 0.001, 1)]
    assert TT.traced_wall_ms(events) == pytest.approx(0.9)   # the host op spans 0..900 us
    assert TT.device_busy_ms(events) == pytest.approx(sum(ms for _, ms, _ in rows))
    assert TT.device_busy_ms(events) <= TT.traced_wall_ms(events)


def test_device_busy_counts_overlapping_streams_once():
    """Two kernels on two streams overlapping by 30 us, and one inside
    another: busy is the union of their intervals, not the sum."""
    events = [
        {"ph": "X", "cat": "kernel", "name": "a", "pid": 0, "tid": 7, "ts": 100, "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "b", "pid": 0, "tid": 8, "ts": 120, "dur": 50},
        {"ph": "X", "cat": "gpu_memcpy", "name": "c", "pid": 0, "tid": 9, "ts": 130, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "d", "pid": 0, "tid": 7, "ts": 300, "dur": 20},
    ]
    assert sum(ms for _, ms, _ in TT.aggregate_device_ops(events)) == pytest.approx(0.13)
    assert TT.device_busy_ms(events) == pytest.approx(0.09)   # 100..170 and 300..320
    assert TT.report(events)[0].startswith("device busy (union of kernels, copies, fills): "
                                           "0.090 ms over a traced wall of 0.220 ms")


def test_trace_cli_reads_the_newest_trace(tmp_path, capsys):
    old = tmp_path / "old.json"
    old.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0, "dur": 1}]}))
    assert TT.main([str(tmp_path)]) == 1
    assert "no device events" in capsys.readouterr().out
    new = tmp_path / "new.json.gz"
    with gzip.open(new, "wt") as f:
        json.dump(_synthetic_trace(), f)
    os.utime(old, (1, 1))
    assert TT.main([str(tmp_path), "--top", "2"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("device busy (union of kernels, copies, fills): 0.056 ms")
    assert "traced wall of 0.900 ms" in out[0] and len(out) == 3
    assert "sm90_xmma_gemm" in out[1] and "x2" in out[2]
    with pytest.raises(FileNotFoundError):
        TT.load_trace_events(str(tmp_path / "none"))


def test_phase_profile_writes_a_trace(tmp_path):
    with phase_profile(str(tmp_path)):
        torch.ones(8).add_(1)
    assert TT.load_trace_events(str(tmp_path))
    with phase_profile(None):
        pass
    assert len(os.listdir(tmp_path)) == 1


def test_benchmark_main_on_cpu(tmp_path, capsys):
    out = B.main(["--device", "cpu", "--channels", "32", "--blocks", "1", "--batch", "4",
                  "--sims", "4", "--gumbel-sims", "4", "--trace", str(tmp_path)])
    names = [r["name"] for r in out["rows"]]
    assert names == ["env.step (incl. legal mask)", "legal_mask alone", "features",
                     "network forward", "MCTS search (full move)", "search + play",
                     "gumbel search (4 sims, full move)"]
    assert [r["calls"] for r in out["rows"]] == [13, 13, 13, 13, 5, 5, 5]
    assert [r["launches_per_call"] for r in out["rows"]] == [1, 1, 0, 0, 4, 5, 4]
    assert all(r["s"] > 0 and np.isfinite(r["throughput"]) for r in out["rows"])
    assert (out["device"], out["batch"], out["sims"]) == ("cpu", 4, 4)
    printed = capsys.readouterr().out
    assert "per-simulation latency" in printed and "MCTS search (full move)" in printed
    assert TT.load_trace_events(str(tmp_path))   # one traced call of each row
