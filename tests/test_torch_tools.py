"""The port's tools (``xiangqi_alphazero_torch/scripts/`` and the Streamlit
demo) against the repo's JAX scripts, on the CPU.

The JAX scripts are loaded from ``scripts/`` by path, as
``tests/test_h2h_script.py`` loads them. The anchor's match protocol gives
the JAX script's dict exactly with one scripted predictor; the strength
report prints the same table on the repo's own run and ladders; the
head-to-head's helpers, the latency grid's positions and the flagship
recipe's config equal the JAX ones; the anchor, the latency grid, the arena
over current parameters and the head-to-head run end to end on the CPU
with tiny nets; and every tool refuses to fall back to the CPU."""

import contextlib
import dataclasses
import functools
import importlib.util
import json
import os
import re
import shlex
import sys
import types

import numpy as np
import pytest
import torch

from xiangqi_alphazero_torch.engine import native as TN
from xiangqi_alphazero_torch.models import XiangqiNet
from xiangqi_alphazero_torch.scripts import arena_current as TAC
from xiangqi_alphazero_torch.scripts import h2h_gumbel_puct as TH
from xiangqi_alphazero_torch.scripts import minimax_anchor as TM
from xiangqi_alphazero_torch.scripts import serve_latency as TL
from xiangqi_alphazero_torch.scripts import strength_report as TR
from xiangqi_alphazero_torch.serve import streamlit_app as TS
from xiangqi_alphazero_torch.train import checkpoint as TCK
from xiangqi_alphazero_torch.train import config as TC
from xiangqi_alphazero_tpu.engine import native as JN
from xiangqi_alphazero_tpu.train import config as JC

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PORT_SCRIPTS = os.path.join(_REPO, "xiangqi_alphazero_torch", "scripts")


def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(_REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread, so parallel test workers
    do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _net(channels: int = 8, seed: int = 0) -> XiangqiNet:
    """A 1-block net of torch's default initialisation, seeded (``init_net``'s
    flax draws take seconds for the 23M-weight policy head)."""
    with torch.random.fork_rng():
        torch.manual_seed(seed)
        return XiangqiNet(channels, 1)


@pytest.fixture(scope="module")
def pt(tmp_path_factory) -> str:
    """A reference-layout .pt of a random 16-channel, 1-block net (~93 MB:
    the policy head's width does not depend on the tower's)."""
    path = str(tmp_path_factory.mktemp("pt") / "m.pt")
    net = _net(16, seed=0)
    torch.save({"model_state_dict": net.state_dict(),
                "config": {"num_channels": 16, "num_res_blocks": 1}}, path)
    return path


def _write_stats(run_dir: str, times) -> None:
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "training_stats.json"), "w") as f:
        json.dump([{"iteration": i + 1, "time": t} for i, t in enumerate(times)], f)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory) -> tuple:
    """A trainer's checkpoint_iter3 whose current and best nets (8 channels,
    1 block) differ: (path, current net, best net)."""
    current, best = _net(seed=1), _net(seed=2)
    path = TCK.save_checkpoint(str(tmp_path_factory.mktemp("ckpt")), 3, {
        "iteration": 3, "params": current.state_dict(), "best_params": best.state_dict(),
        "config": {"num_channels": 8, "num_res_blocks": 1}})
    return path, current, best


# ------------------------------------------------------------ minimax anchor


class _ScriptedPredictor:
    """A ``search_batch`` fake: every legal move is a slot, its visits a
    fixed function of the move and the ply (with ties, so the movegen-order
    tie-break decides), its order the movegen index."""

    def search_batch(self, positions, pad_to=None):
        out = []
        for p in positions:
            acts = np.asarray(p.legal_actions(), np.int32)
            visits = ((acts * 7 + p.ply) % 5).astype(np.int32)
            out.append((acts, visits, np.arange(len(acts), dtype=np.int32)))
        return out


@pytest.mark.skipif(not (TN.available() and JN.available()),
                    reason="the native core did not build (no C++ compiler)")
@pytest.mark.parametrize("depth,epsilon", [(0, 0.0), (0, 0.5), (1, 0.0), (1, 0.5)])
def test_play_match_matches_jax_script(depth, epsilon):
    jax_anchor = _jax_script("minimax_anchor")
    got = TM.play_match(_ScriptedPredictor(), depth, 2, epsilon=epsilon)
    want = jax_anchor.play_match(_ScriptedPredictor(), depth, 2, epsilon=epsilon)
    assert got == want
    assert got["net_wins"] + got["draws"] + got["net_losses"] == 2


@pytest.mark.skipif(not TN.available(), reason="the native core did not build")
def test_anchor_runs_end_to_end_on_cpu(pt, tmp_path, capsys):
    """At the default depth (3), where the minimax ends a random net's games
    in a few dozen plies."""
    out = str(tmp_path / "anchor" / "a.json")
    assert TM.main(["--models", pt, "--games", "2", "--sims", "4", "--device", "cpu",
                    "--out", out]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["net_wins"] + line["draws"] + line["net_losses"] == 2
    assert (line["model"], line["sims"], line["depth"], line["games"]) == (pt, 4, 3, 2)
    with open(out) as f:
        table = json.load(f)
    assert table["results"] == [line]
    assert table["protocol"] == TM.protocol(3, 4, "puct", 0.0)
    assert table["protocol"]["net_search"] == "puct-4 temp 0 greedy"


# ------------------------------------------------------------ strength report


@pytest.mark.parametrize("ladder", ["models/elo_ladder_r04.json", "models/elo_ladder_r03.json",
                                    None])
def test_strength_report_prints_the_jax_table(ladder, monkeypatch, capsys):
    argv = ["--run", os.path.join(_REPO, "models", "elo_run")]
    if ladder:
        argv += ["--ladder", os.path.join(_REPO, ladder)]
    assert TR.main(argv) == 0
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["strength_report"] + argv)
    assert _jax_script("strength_report").main() == 0
    want = capsys.readouterr().out
    assert got == want
    assert len(got.splitlines()) > 3


# ------------------------------------------------------------ head-to-head


@pytest.mark.parametrize("times,iters", [
    ([800.0, 100.0, 120.0, 110.0], 4),   # the steady state leaves out iteration 1
    ([800.0, 100.0, 120.0, 110.0], 2),   # truncated to the iterations asked for
    ([42.0], 1),
    ([], 3),
    (None, 3),                           # no training_stats.json
])
def test_stats_walls_match_jax(times, iters, tmp_path):
    d = str(tmp_path / "arm")
    if times is not None:
        _write_stats(d, times)
    jax_h2h = _jax_script("h2h_gumbel_puct")
    assert TH._stats_walls(d, iters) == jax_h2h._stats_walls(d, iters)


@pytest.mark.parametrize("iters", [5, 6])
def test_arm_complete_matches_jax(iters, tmp_path):
    d = str(tmp_path / "arm")
    os.makedirs(os.path.join(d, "checkpoint_iter5"))
    jax_h2h = _jax_script("h2h_gumbel_puct")
    assert TH._arm_complete(d, iters) == jax_h2h._arm_complete(d, iters) == (iters == 5)
    # the port's checkpoints are files
    open(os.path.join(d, "checkpoint_iter6"), "w").close()
    assert TH._arm_complete(d, 6)


def test_skip_train_fails_early_like_jax(tmp_path, monkeypatch):
    g = tmp_path / "out" / "gumbel"
    os.makedirs(g / "checkpoint_iter3")
    argv = ["--skip-train", "--gumbel-iters", "3", "--puct-iters", "5",
            "--out", str(tmp_path / "out")]
    with pytest.raises(SystemExit) as got:
        TH.main(argv)
    monkeypatch.setattr(sys, "argv", ["h2h"] + argv)
    with pytest.raises(SystemExit) as want:
        _jax_script("h2h_gumbel_puct").main()
    assert str(got.value) == str(want.value)
    assert "checkpoint_iter5" in str(got.value)


def test_train_command_names_the_port_cli_and_the_recipe(monkeypatch):
    jax_h2h = _jax_script("h2h_gumbel_puct")
    cmds = []
    for mod in (TH, jax_h2h):
        monkeypatch.setattr(mod.subprocess, "run", lambda cmd, check: cmds.append(cmd))
    TH._train("out/g", "gumbel", 32, 12, 11, "cpu")
    jax_h2h._train("out/g", "gumbel", 32, 12, 11)
    port, jax = cmds
    assert port[1:3] == ["-m", "xiangqi_alphazero_torch.train"]
    assert jax[1:3] == ["-m", "xiangqi_alphazero_tpu.train"]
    assert port[3:] == jax[3:] + ["--device", "cpu"]
    assert "--auto-restart" in port and "--train-segment" not in port


def _short_arena(monkeypatch):
    """The arena's games capped at 4 plies (its default is 300), so a CPU
    match of random nets stays short."""
    monkeypatch.setattr(TAC, "ArenaSettings",
                        functools.partial(TAC.ArenaSettings, max_game_length=4))


def test_h2h_skip_train_arena_over_current_parameters(ckpt, tmp_path, capsys, monkeypatch):
    """The head-to-head over two finished arms on the CPU: the arena plays
    the arms' current nets and writes the JAX script's result keys."""
    _short_arena(monkeypatch)
    out = tmp_path / "h2h"
    _write_stats(str(out / "gumbel"), [9.0, 3.0])
    _write_stats(str(out / "puct"), [7.0])
    os.symlink(ckpt[0], out / "gumbel" / "checkpoint_iter2")   # ~93 MB a net: link one file
    os.symlink(ckpt[0], out / "puct" / "checkpoint_iter1")
    assert TH.main(["--skip-train", "--gumbel-iters", "2", "--puct-iters", "1",
                    "--games", "2", "--arena-sims", "2",
                    "--out", str(out), "--device", "cpu"]) == 0
    with open(out / "result.json") as f:
        res = json.load(f)
    assert sorted(res) == ["arena", "arena_protocol", "gumbel", "puct"]
    assert res["gumbel"] == {"iters": 2, "sims": 32, "wall_s": 12.0, "steady_s_per_iter": 3.0}
    assert res["puct"]["wall_s"] == 7.0
    a = res["arena"]
    assert a["a_wins"] + a["b_wins"] + a["draws"] == a["games"] == 2
    assert res["arena_protocol"] == {"sims": 2, "algo": "puct both", "temperature": 0.2,
                                     "games": 2}
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res


# ------------------------------------------------------------ arena over current params


def test_arena_current_loads_current_not_best_parameters(ckpt, capsys, monkeypatch):
    _short_arena(monkeypatch)
    path, current, best = ckpt
    net = TAC.load_current(path, "cpu")
    for (k, x), y in zip(net.state_dict().items(), current.state_dict().values()):
        assert torch.equal(x, y), k
    assert not torch.equal(net.state_dict()["input_conv.0.weight"],
                           best.state_dict()["input_conv.0.weight"])
    assert not net.training
    assert TAC.main(["--a", path, "--b", path, "--games", "2", "--sims", "2",
                     "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["a_wins"] + line["b_wins"] + line["draws"] == line["games"] == 2
    assert (line["a"], line["sims"]) == (path, 2)


# ------------------------------------------------------------ latency grid


def test_midgame_positions_match_jax():
    jax_lat = _jax_script("serve_latency")
    got, want = TL._midgame_positions(32), jax_lat._midgame_positions(32)
    assert len(got) == len(want) == 32
    for p, q in zip(got, want):
        assert (p.board, p.side, p.ply, p.quiet, p.history) == (q.board, q.side, q.ply,
                                                                  q.quiet, q.history)


def test_latency_grid_runs_on_cpu(pt, capsys):
    assert TL.main(["--model", pt, "--sims", "4", "--conc", "1,2", "--requests", "2",
                    "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    assert line["ok"] and line["algo"] == "puct"
    assert sorted(line["cells"]) == ["s4_c1", "s4_c2"]
    for cell in line["cells"].values():
        assert 0 < cell["p50_ms"] <= cell["p95_ms"] <= cell["max_ms"]
        assert cell["requests"] == 2
        assert cell["moves_per_s"] > 0 and 1 <= cell["mean_batch"] <= 2
    assert sum(r.startswith("| 4 |") for r in out) == 2


@pytest.mark.parametrize("cap,widths", [(1, [1]), (4, [1, 2, 4]), (6, [1, 2, 4, 6])])
def test_searcher_warmup_covers_every_width(cap, widths):
    """``BatchedSearcher.warmup``'s default runs every width a batch can
    take, the cap too where it is not a power of 2 (the latency grid warms
    through it)."""
    from xiangqi_alphazero_torch.serve.sessions import BatchedSearcher, _bucket

    seen = []

    class Fake:
        def search_batch(self, positions, pad_to=None):
            seen.append(("search", pad_to))

        def raw_predict_batch(self, positions, pad_to=None):
            seen.append(("raw", pad_to))

    searcher = BatchedSearcher(Fake(), max_batch=cap)
    try:
        searcher.warmup()
    finally:
        searcher.stop()
    assert seen == [(k, w) for w in widths for k in ("search", "raw")]
    assert sorted({_bucket(n, cap) for n in range(1, cap + 1)}) == widths


# ------------------------------------------------------------ flagship recipe


def _script_flags(path: str, module: str) -> list:
    """The flags a shell script passes to ``python -m <module>``, with
    ``"$ITERS"`` at its default and ``"$@"`` empty."""
    with open(path) as f:
        text = f.read().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines() if f"-m {module}" in ln)
    words = shlex.split(line.replace('"$ITERS"', "200").replace('"$@"', ""))
    return words[words.index(module) + 1:]


def test_flagship_config_matches_jax_recipe():
    port = _script_flags(os.path.join(_PORT_SCRIPTS, "flagship_run.sh"),
                         "xiangqi_alphazero_torch.train")
    jax = _script_flags(os.path.join(_REPO, "scripts", "flagship_run.sh"),
                        "xiangqi_alphazero_tpu.train")
    port_args = TC.build_argparser().parse_args(port)
    got, _ = TC.config_from_args(port_args)
    want, _ = JC.config_from_args(JC.build_argparser().parse_args(jax))
    got, want = dataclasses.asdict(got), dataclasses.asdict(want)
    # train_segment bounds a TPU program (the port refuses it), and the port
    # writes under runs/torch/, not into the repo's models/
    assert (want.pop("train_segment_batches"), got.pop("train_segment_batches")) == (384, 0)
    assert (want.pop("checkpoint_dir"), got.pop("checkpoint_dir")) == (
        "models/flagship", "runs/torch/flagship")
    assert got == want
    assert (got["num_channels"], got["num_res_blocks"], got["search_algo"]) == (256, 10, "gumbel")
    assert port_args.auto_restart == 60 and port_args.device == "cuda"


# ------------------------------------------------------------ Streamlit demo


class _State(dict):
    __getattr__ = dict.__getitem__
    __setattr__ = dict.__setitem__


class _StubStreamlit:
    """Enough of ``streamlit`` for one render: no button is pressed, every
    input keeps its default, and each DataFrame shown is kept."""

    def __init__(self):
        self.frames = []
        self.session_state = _State()
        self.sidebar = contextlib.nullcontext()

    def __getattr__(self, name):   # set_page_config, title, write, header, ...
        return lambda *a, **k: None

    def selectbox(self, label, options):
        return options[0]

    def slider(self, label, lo, hi, value):
        return value

    def button(self, label):
        return False

    def number_input(self, label, lo, hi, value):
        return value

    def columns(self, n):
        return [self] * n

    def dataframe(self, df, **kw):
        self.frames.append(df)


def test_streamlit_app_exits_naming_streamlit(monkeypatch):
    monkeypatch.setitem(sys.modules, "streamlit", None)
    with pytest.raises(SystemExit, match="missing: (streamlit|pandas)"):
        TS.main(device="cpu")


def test_streamlit_app_renders_the_jax_board(monkeypatch, tmp_path):
    """The opening's board table. No model is loaded, so the JAX app's
    predictor module (seconds of flax imports) is stubbed, with no models
    found, as the port's ``find_models`` finds none under ``tmp_path``."""
    pytest.importorskip("pandas")
    from xiangqi_alphazero_tpu.serve import streamlit_app as JS

    monkeypatch.setitem(sys.modules, "xiangqi_alphazero_tpu.serve.predictor",
                        types.SimpleNamespace(Predictor=None, find_models=lambda dirs: []))
    monkeypatch.chdir(tmp_path)   # find_models looks under ./models
    frames = []
    for app in (TS, JS):
        st = _StubStreamlit()
        monkeypatch.setitem(sys.modules, "streamlit", st)
        app.main()
        assert len(st.frames) == 1 and st.session_state.predictor is None
        frames.append(st.frames[0])
    got, want = frames
    assert got.equals(want) and list(got.index) == list(want.index)
    assert got.shape == (10, 9) and got.iloc[0, 4] == want.iloc[0, 4] != got.iloc[5, 4]


# ------------------------------------------------------------ defaults, CUDA


def test_no_default_output_names_an_existing_file():
    flagship = _script_flags(os.path.join(_PORT_SCRIPTS, "flagship_run.sh"),
                             "xiangqi_alphazero_torch.train")
    defaults = [TM.DEFAULT_OUT, TH.DEFAULT_OUT, os.path.join(TH.DEFAULT_OUT, "result.json"),
                os.path.join(TH.DEFAULT_OUT, "gumbel"), os.path.join(TH.DEFAULT_OUT, "puct"),
                flagship[flagship.index("--checkpoint-dir") + 1]]
    for path in defaults:
        assert path.startswith("runs/torch/"), path
        assert not os.path.exists(os.path.join(_REPO, path)), path
    with open(os.path.join(_REPO, ".gitignore")) as f:
        assert re.search(r"^/?runs/$", f.read(), re.M)


def test_tools_raise_without_cuda(pt, monkeypatch, tmp_path):
    # the checkpoints' device is resolved before they are read
    for arm in ("gumbel", "puct"):
        os.makedirs(tmp_path / "h2h" / arm)
        open(tmp_path / "h2h" / arm / "checkpoint_iter1", "w").close()
    ck = str(tmp_path / "h2h" / "puct" / "checkpoint_iter1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: TM.main(["--models", pt, "--games", "2", "--out", str(tmp_path / "a.json")]),
        lambda: TL.main(["--model", pt, "--sims", "2", "--conc", "1"]),
        lambda: TAC.main(["--a", ck, "--b", ck]),
        lambda: TH.main(["--skip-train", "--gumbel-iters", "1", "--puct-iters", "1",
                         "--out", str(tmp_path / "h2h")]),
        lambda: TS.Predictor.load(pt),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert not os.path.exists(tmp_path / "a.json")
