"""The PyTorch port stands alone: importing every one of its modules loads
no JAX, flax, optax, orbax or ``xiangqi_alphazero_tpu`` module, its sources and
``chip_smoke.py`` import none of them, and its entry points refuse to fall
back to the CPU when CUDA is missing and the caller did not ask for the
CPU."""

import ast
import json
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import xiangqi_alphazero_torch
from xiangqi_alphazero_torch.models import XiangqiNet
from xiangqi_alphazero_torch.serve import __main__ as cli
from xiangqi_alphazero_torch.serve import api as TA
from xiangqi_alphazero_torch.serve import predictor as TP

_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "xiangqi_alphazero_tpu")
_PKG_DIR = os.path.dirname(xiangqi_alphazero_torch.__file__)
_REPO = os.path.dirname(_PKG_DIR)


def _module_names():
    return ["xiangqi_alphazero_torch"] + [
        m.name for m in pkgutil.walk_packages([_PKG_DIR], "xiangqi_alphazero_torch.")
    ]


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in _FORBIDDEN


def test_importing_every_module_loads_no_jax():
    names = _module_names()
    assert "xiangqi_alphazero_torch.ops.legal_mask" in names
    # the training package, its trainer, the Gumbel search, the arena and
    # the Elo ladder, imported by name as well
    names += ["xiangqi_alphazero_torch.train", "xiangqi_alphazero_torch.train.trainer",
              "xiangqi_alphazero_torch.search.gumbel", "xiangqi_alphazero_torch.train.arena",
              "xiangqi_alphazero_torch.train.elo"]
    # the export, int8, profiling and native modules, by name as well
    names += ["xiangqi_alphazero_torch.serve.export", "xiangqi_alphazero_torch.serve.onnx_lite",
              "xiangqi_alphazero_torch.models.quant", "xiangqi_alphazero_torch.utils.profiling",
              "xiangqi_alphazero_torch.utils.trace_tools", "xiangqi_alphazero_torch.utils.benchmark",
              "xiangqi_alphazero_torch.engine.native"]
    # the multi-device layer, the probes and the CLI with its supervisor
    names += ["xiangqi_alphazero_torch.distributed", "xiangqi_alphazero_torch.parallel",
              "xiangqi_alphazero_torch.parallel.sharding", "xiangqi_alphazero_torch.parallel.probe",
              "xiangqi_alphazero_torch.train.__main__"]
    code = (
        "import importlib, json, sys\n"
        f"for n in {names!r}: importlib.import_module(n)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=_REPO, capture_output=True, text=True,
        timeout=120, check=True,
    )
    loaded = [m for m in json.loads(out.stdout.strip().splitlines()[-1]) if _forbidden(m)]
    assert loaded == []


def test_sources_import_no_jax():
    paths = [os.path.join(_REPO, "chip_smoke.py")]
    for root, _, files in os.walk(_PKG_DIR):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) > 10
    for path in paths:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            assert not any(_forbidden(n) for n in names), (path, names)


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = XiangqiNet(8, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        TP.Predictor(net)
    with pytest.raises(RuntimeError, match="CUDA"):
        TA.GameService(model_dirs=[])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["api", "--port", "0", "--model-dirs"])
    with pytest.raises(RuntimeError, match="CUDA"):
        TP.Predictor(net, algo="gumbel")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["api", "--port", "0", "--search", "gumbel", "--model-dirs"])
    # the CPU is taken only when it is asked for
    assert TP.Predictor(net, device="cpu").device.type == "cpu"
    assert TP.Predictor(net, algo="gumbel", device="cpu").device.type == "cpu"
    assert TA.GameService(model_dirs=[], device="cpu").models()[1]["device"] == "cpu"


def test_arena_and_elo_raise_without_cuda(monkeypatch, tmp_path):
    """The arena and Elo CLIs load their models on CUDA unless given
    ``--device cpu``."""
    from xiangqi_alphazero_torch.train import arena, elo

    path = str(tmp_path / "m.pt")
    torch.save({"model_state_dict": XiangqiNet(8, 1).state_dict(),
                "config": {"num_channels": 8, "num_res_blocks": 1}}, path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        arena.main(["--a", path, "--b", path])
    with pytest.raises(RuntimeError, match="CUDA"):
        elo.main(["--models", path, path])
    assert arena.main(["--a", path, "--b", path, "--games", "2", "--sims", "2",
                       "--max-game-length", "2", "--algo-a", "gumbel", "--device", "cpu"]) == 0


def test_export_and_benchmark_raise_without_cuda(monkeypatch, tmp_path, capsys):
    """``serve export`` and ``utils.benchmark`` run on CUDA unless given
    ``--device cpu``."""
    from xiangqi_alphazero_torch.serve.export import export_torch_checkpoint
    from xiangqi_alphazero_torch.utils import benchmark

    src = str(tmp_path / "m.pt")
    export_torch_checkpoint(src, XiangqiNet(8, 1))
    out = str(tmp_path / "o.pt")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["export", "--checkpoint", src, "--output", out])
    with pytest.raises(RuntimeError, match="CUDA"):
        benchmark.main(["--batch", "2", "--sims", "2", "--channels", "8", "--blocks", "1"])
    assert cli.main(["export", "--checkpoint", src, "--output", out, "--device", "cpu"]) == 0
    assert "verified" in capsys.readouterr().out


def test_multirank_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """A rank joins on CUDA unless given ``device="cpu"``: the training
    CLI's ranks and the probes' raise without a card, before they wait for
    any peer."""
    from xiangqi_alphazero_torch import distributed
    from xiangqi_alphazero_torch.parallel import probe
    from xiangqi_alphazero_torch.train.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["--coordinator", "127.0.0.1:1", "--num-processes", "2", "--process-id", "1"]
    with pytest.raises(RuntimeError, match="CUDA"):
        distributed.distributed_init("127.0.0.1:1", 2, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--mode", "quick", "--checkpoint-dir", str(tmp_path), *args])
    with pytest.raises(RuntimeError, match="CUDA"):
        probe.main([".", *args])
    assert distributed.context() is None
