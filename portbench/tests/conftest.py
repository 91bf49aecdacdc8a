"""Fixtures of the harness's CPU tests: a tiny copy of the benchmark (the
real BENCHMARK.json with every net cut to 16 channels and one block in
float32, and small fleets and batches) in a temporary root, so that a whole
run of any cell, its check included, fits a test.

Run from the repository root, without the repository's own conftest (which
loads JAX):

    python3 -m pytest --confcutdir=portbench -q portbench/tests
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from portbench import run

TINY_CFG = {"num_channels": 16, "num_res_blocks": 1, "max_game_length": 4, "dtype": "float32",
            "random_opening_moves": 2}
TINY_SIMS = {"gumbel": 4, "puct": 8}
TINY_TRAFFIC = {
    "learn": {"batch": 64, "ring_batches": 4, "trace_steps": 2},
    "selfplay": {"games": 16, "evals_per_call": 4, "eval_rows": 4, "positions_per_call": 16,
                 "search_lanes": 6, "search_roots_per_call": 4},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (skips on a host without one)")


def make_tiny_root(root: Path) -> Path:
    """A tiny copy of the benchmark under ``root``; returns its BENCHMARK.json."""
    src = run.ROOT
    shutil.copy(src / "BENCHMARK.json", root / "BENCHMARK.json")
    base = root / run.HERE.name
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(run.HERE / sub, base / sub)
    for path in (base / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg.update(TINY_CFG, num_simulations=TINY_SIMS[cfg["search_algo"]])
        path.write_text(json.dumps(cfg))
    for path in (base / "traffic").glob("*.json"):
        tr = json.loads(path.read_text())
        tr.update(TINY_TRAFFIC[tr["driver"]])
        path.write_text(json.dumps(tr))
    return root / "BENCHMARK.json"


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))

