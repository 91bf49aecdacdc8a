"""The harness on the CPU: the result line, the counts, the data-driven
look-up, and that nothing it runs loads JAX. The CPU runs go through
``run.run_cell`` past the look for a card (``run.main`` exits without one)."""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import flops, run

PB = run.HERE
SEED = 2**31 + 12345   # more than 32 signed bits hold, as the driver's seeds
REQUIRED = ("correct", "attempted", "failed", "metrics", "device")


def _cells(bench: Path):
    return [w["name"] for w in json.loads(bench.read_text())["workloads"]]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", _cells(run.ROOT / "BENCHMARK.json"))
def test_result_line(tiny_bench, workload, trace):
    cell = run.load_cell(workload, tiny_bench)
    out = run.run_cell(cell, SEED, 0.0, bool(trace), "cpu")
    keys = list(out)
    assert keys[: len(REQUIRED)] == list(REQUIRED)
    assert keys[-1] == "compared"
    assert set(keys) - set(REQUIRED) <= {"breakdown", "compared"}
    assert out["correct"] is True, out["compared"]
    assert out["failed"] == 0 and out["attempted"] > 0
    for c in out["compared"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    want = {m["name"] for m in (cell.per_layer() if trace else cell.end_to_end())}
    if trace:   # a CPU trace holds no device events: the readers find nothing
        assert set(out["metrics"]) <= want and "breakdown" in out
    else:
        assert set(out["metrics"]) == want and out["metrics"]["setup_s"]["value"] > 0
    json.dumps(out)


def test_no_result_without_a_card():
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                           "learn.full256x10", "--seed", "1", "--seconds", "1"],
                          cwd=run.ROOT, capture_output=True, text=True,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_no_result_without_the_program(tmp_path):
    """In a directory with only BENCHMARK.json and portbench/, a run fails
    at the program's import, before it prints anything."""
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PB, tmp_path / PB.name, ignore=shutil.ignore_patterns("__pycache__"))
    code = ("from portbench import run; "
            "print(run.run_cell(run.load_cell('learn.full256x10'), 1, 0.0, False, 'cpu'))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "No module named 'xiangqi_alphazero_torch'" in proc.stderr


@pytest.mark.parametrize("channels,blocks,want", [
    # input conv + tower + policy head (1x1 conv, dense) + value head (1x1, dense, dense)
    (128, 6, 2 * 90 * (9 * 15 * 128 + 6 * 2 * 9 * 128 * 128 + 128 * 36)
     + 2 * (2880 * 8100 + 360 * 128 + 128)),
    (256, 10, 2 * 90 * (9 * 15 * 256 + 10 * 2 * 9 * 256 * 256 + 256 * 36)
     + 2 * (2880 * 8100 + 360 * 128 + 128)),
])
def test_flop_counts(channels, blocks, want):
    assert flops.forward_flops(channels, blocks) == want
    assert flops.train_flops(channels, blocks) == 3 * want
    # 128x6: ~0.369 GFLOP a position; 256x10: ~2.18 GFLOP
    assert abs(want / 1e9 - {128: 0.3692, 256: 2.1780}[channels]) < 1e-3


@pytest.mark.parametrize("rows", [1, 4096, 16384])
def test_legal_mask_bytes(rows):
    assert flops.legal_mask_bytes(rows) == rows * (90 + 1 + 8100)


def test_new_cell_config_and_metric_are_data(tiny_bench, tmp_path):
    """A cell, a configuration, a traffic mix and a per-layer metric added as
    files and entries are found by name, with no file of the harness edited."""
    root = tmp_path / "root"
    shutil.copytree(tiny_bench.parent, root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    base = root / PB.name
    cfg = json.loads((base / "configs" / "std128x6.json").read_text())
    cfg.update(num_channels=8, search_algo="gumbel", num_simulations=4, c_visit=50.0, c_scale=0.1)
    (base / "configs" / "extra8x1.json").write_text(json.dumps(cfg))
    tr = json.loads((base / "traffic" / "selfplay_b4096.json").read_text())
    (base / "traffic" / "selfplay_b8.json").write_text(json.dumps(dict(tr, games=8)))
    (base / "limits" / "selfplay.extra8x1.json").write_text(
        (base / "limits" / "selfplay.std128x6.json").read_text())
    (base / "metrics" / "games_seen.selfplay.py").write_text(
        "def read(ctx):\n    return float(ctx.counters['attempted'])\n")
    bench["configs"].append({"name": "extra8x1", "source": "test", "reduced": [],
                             "file": f"{PB.name}/configs/extra8x1.json", "why": "test"})
    bench["workloads"].append({"name": "selfplay.extra8x1", "config": "extra8x1",
                               "traffic": "selfplay_b8", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "selfplay_sims_per_s":
            m["workloads"].append("selfplay.extra8x1")
    bench["per_layer"].append({"name": "games_seen.selfplay", "unit": "games",
                               "better": "higher", "source": "program_counter",
                               "layer": "test", "moves": "selfplay_sims_per_s",
                               "workloads": ["selfplay.extra8x1"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = run.load_cell("selfplay.extra8x1", root / "BENCHMARK.json")
    assert cell.cfg["num_channels"] == 8 and cell.traffic["games"] == 8
    out = run.run_cell(cell, SEED, 0.0, True, "cpu")
    assert out["metrics"]["games_seen.selfplay"]["value"] == 8.0
    assert out["correct"] is True, out["compared"]
    out = run.run_cell(cell, SEED, 0.0, False, "cpu")
    assert set(out["metrics"]) == {"selfplay_sims_per_s", "setup_s"}


def test_per_layer_metric_names_its_workloads(tiny_bench, tmp_path):
    """A per-layer metric without its list of cells is refused: no rule
    guesses where it applies."""
    bench = json.loads(tiny_bench.read_text())
    bench["per_layer"][0].pop("workloads")
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    with pytest.raises(SystemExit, match="without their workloads"):
        run.load_cell("learn.full256x10", path)


FORBIDDEN = set(run.FORBIDDEN)


def _imported_tops(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(p.relative_to(PB).as_posix() for p in PB.rglob("*.py")))
def test_no_jax_import(path):
    """Whole top-level names: the port's name begins with the JAX package's."""
    tops = set(_imported_tops(PB / path))
    assert not tops & FORBIDDEN, tops & FORBIDDEN


@pytest.mark.parametrize("path", sorted(p.name for p in (PB / "reference").glob("*.py")))
def test_reference_imports_nothing_of_the_program(path):
    tops = set(_imported_tops(PB / "reference" / path))
    assert tops <= {"__future__", "contextlib", "dataclasses", "math", "typing", "numpy",
                    "torch"}, tops


def test_program_loads_no_jax():
    """What the drivers load of the port, in a fresh interpreter, loads no
    JAX module (the check ``run.main`` makes once the window closes)."""
    code = ("import sys, portbench.run as r, portbench.drivers.learn, portbench.drivers.selfplay, "
            "portbench.tracing, portbench.calibrate, "
            "xiangqi_alphazero_torch.train.learner, xiangqi_alphazero_torch.train.selfplay, "
            "xiangqi_alphazero_torch.models.resnet; print(r.forbidden_modules())")
    proc = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                          text=True)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", _cells(run.ROOT / "BENCHMARK.json"))
def test_cell_on_the_card(workload):
    """One short run of each cell at its own size, on the card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", workload,
                           "--seed", str(SEED), "--seconds", "1"], cwd=run.ROOT,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"] is True
