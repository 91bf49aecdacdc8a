"""The recorder of ``utils/profiling.py`` and the spans and counters the
port records with it, on the CPU at a tiny size (an 8-channel, 1-block net,
4 games, 8 simulations, 3 plies): recording changes no result of self-play
or of the learner; the span tree of a self-play call and of a learner call
has the right names, parents and nesting; the counters equal what the code
did, counted from outside; and with no recording active the recorder does
nothing."""

import copy
import sys
import threading

import numpy as np
import pytest
import torch

from xiangqi_alphazero_torch.engine import env as E
from xiangqi_alphazero_torch.models.resnet import XiangqiNet, policy_logits_fn
from xiangqi_alphazero_torch.train import learner as L
from xiangqi_alphazero_torch.train import selfplay as S
from xiangqi_alphazero_torch.utils import profiling as P

GAMES = 4
ALGOS = ["puct", "gumbel"]

# the span each span of a self-play call may open under
SELFPLAY_PARENTS = {
    "selfplay.call": {None},
    "selfplay.openings": {"selfplay.call"},
    "draw.opening": {"selfplay.openings"},
    "selfplay.alive_check": {"selfplay.call"},
    "selfplay.ply": {"selfplay.call"},
    "search.run": {"selfplay.ply"},
    "search.root": {"search.run"},
    "draw.root_noise": {"search.root"},
    "search.descend": {"search.run"},
    "search.expand": {"search.run"},
    "search.halving": {"search.run"},
    "net.forward": {"search.root", "search.expand", "selfplay.resign"},
    "env.evaluate": {"selfplay.openings", "search.expand", "selfplay.env_step"},
    "selfplay.act": {"selfplay.ply"},
    "draw.sample": {"selfplay.act"},
    "selfplay.record": {"selfplay.ply"},
    "selfplay.env_step": {"selfplay.ply"},
    "selfplay.resign": {"selfplay.ply"},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread, so parallel test workers
    do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _net(train: bool = False) -> XiangqiNet:
    torch.manual_seed(3)
    net = XiangqiNet(8, 1)
    return net.train(train)


def _settings(algo: str) -> S.SelfPlaySettings:
    return S.SelfPlaySettings(num_simulations=8, max_game_length=3, random_opening_moves=2,
                              search_algo=algo, max_considered=4)


def _selfplay(algo: str, eval_fn=None) -> S.SelfPlayOut:
    eval_fn = eval_fn or policy_logits_fn(_net())
    with torch.inference_mode():
        return S.selfplay_games(eval_fn, GAMES, _settings(algo), torch.Generator().manual_seed(11),
                                "cpu", logits_eval=True)


@pytest.mark.parametrize("algo", ALGOS)
def test_selfplay_is_bit_identical_with_recording(algo):
    off = _selfplay(algo)
    with P.recording() as rec:
        on = _selfplay(algo)
    assert rec.spans and rec.counters
    assert off.sims_per_ply == on.sims_per_ply
    for name in S.SelfPlayOut._fields[:-1]:
        a, b = getattr(off, name), getattr(on, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.parametrize("algo", ALGOS)
def test_selfplay_span_tree(algo):
    with P.recording() as rec:
        out = _selfplay(algo)
    spans = rec.spans
    names = [s.name for s in spans]
    assert names[0] == "selfplay.call" and names.count("selfplay.call") == 1
    for i, s in enumerate(spans):
        parent = spans[s.parent] if s.parent >= 0 else None
        assert (parent.name if parent else None) in SELFPLAY_PARENTS[s.name], (s.name, parent)
        assert s.root == 0 and s.start_ns <= s.end_ns
        if parent is not None:   # nested inside its parent, and begun after it
            assert s.parent < i and parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    sims = sum(out.sims_per_ply)
    plies = len(out.sims_per_ply)
    assert names.count("search.descend") == names.count("search.expand") == sims
    assert names.count("selfplay.ply") == names.count("search.run") == plies
    for name in ("search.root", "selfplay.act", "selfplay.record", "selfplay.env_step",
                 "selfplay.resign"):
        assert names.count(name) == plies, name
    assert names.count("selfplay.alive_check") in (plies, plies + 1)
    assert names.count("selfplay.openings") == 1
    assert names.count("draw.opening") == 1 + _settings(algo).random_opening_moves
    # root, each simulation's leaves, each ply's resign check
    assert names.count("net.forward") == plies + sims + plies
    assert names.count("draw.root_noise") == plies
    if algo == "gumbel":   # 8 simulations over 4 candidates: one halving a search
        assert "draw.sample" not in names and names.count("search.halving") == plies
    else:
        assert names.count("draw.sample") == plies and "search.halving" not in names


@pytest.mark.parametrize("algo", ALGOS)
def test_descent_levels_count_the_descent_loop(monkeypatch, algo):
    """``search.descent_levels`` is one per iteration of ``_descend``'s
    loop, each of which steps the games' core state once."""
    levels = []
    step_core = E.step_core

    def counting(state, action):
        if sys._getframe(1).f_code.co_name == "_descend":
            levels.append(1)
        return step_core(state, action)

    monkeypatch.setattr(E, "step_core", counting)
    with P.recording() as rec:
        out = _selfplay(algo)
    assert len(levels) >= sum(out.sims_per_ply) > 0
    assert rec.counters["search.descent_levels"] == len(levels)


@pytest.mark.parametrize("algo", ALGOS)
def test_positions_and_simulations_counts(algo):
    rows = []
    net_fn = policy_logits_fn(_net())

    def counting(feats):
        rows.append(feats.shape[0])
        return net_fn(feats)

    with P.recording() as rec:
        out = _selfplay(algo, counting)
    assert rec.counters["net.positions"] == sum(rows) == GAMES * len(rows)
    assert rec.counters["search.simulations"] == sum(out.sims_per_ply)
    assert set(rec.counters) == {"net.positions", "search.simulations",
                                 "search.descent_levels"}


def _rows(n: int, seed: int = 5):
    rng = np.random.default_rng(seed)
    board = E.reset_batch(1).board[0].numpy()
    pi_actions = rng.integers(0, E.ACTION_SPACE, size=(n, 128)).astype(np.int32)
    pi_probs = rng.random((n, 128)).astype(np.float32)
    pi_probs /= pi_probs.sum(1, keepdims=True)
    return (np.repeat(board[None], n, 0), rng.choice([-1, 1], n).astype(np.int8), pi_actions,
            pi_probs, rng.uniform(-1, 1, n).astype(np.float32))


def test_learner_is_identical_with_recording_and_records_its_phases():
    steps, batch = 3, 6
    arrays = _rows(steps * batch)
    perm = np.random.default_rng(1).permutation(steps * batch).astype(np.int32)
    perm = perm.reshape(steps, batch)
    wmask = np.ones((steps, batch), np.float32)
    nets = [_net(train=True), None]
    nets[1] = copy.deepcopy(nets[0])
    opts = [L.make_optimizer(n.parameters(), 1e-3, 1e-4) for n in nets]
    off = L.train_epochs(nets[0], opts[0], arrays, perm, wmask)
    with P.recording() as rec:
        on = L.train_epochs(nets[1], opts[1], arrays, perm, wmask)
    assert torch.equal(off, on)
    for a, b in zip(nets[0].state_dict().values(), nets[1].state_dict().values()):
        assert torch.equal(a, b)

    names = [s.name for s in rec.spans]
    parent = {s.name: rec.spans[s.parent].name if s.parent >= 0 else None for s in rec.spans}
    assert names[0] == "learn.epochs" and all(s.root == 0 for s in rec.spans)
    assert parent == {"learn.epochs": None, "learn.upload": "learn.epochs",
                      "learn.step": "learn.epochs", "learn.gather": "learn.step",
                      "learn.forward_backward": "learn.step", "learn.optimizer": "learn.step",
                      "learn.readback": "learn.epochs"}
    for name in ("learn.step", "learn.gather", "learn.forward_backward", "learn.optimizer"):
        assert names.count(name) == steps, name
    assert names.count("learn.upload") == names.count("learn.readback") == 1
    assert rec.counters == {"learn.steps": steps, "learn.rows": steps * batch}
    assert set(rec.totals_ns()) == set(names)


def test_without_a_recording_nothing_is_recorded():
    assert P.span("a") is P.span("b") is P._OFF
    with P.span("a") as s:
        P.count("c", 3)
    assert s is None
    with P.recording() as rec:
        with P.span("a") as s:
            P.count("c", 3)
        assert isinstance(s, P.Span)
    assert P.span("a") is P._OFF
    P.count("c")
    assert [x.name for x in rec.spans] == ["a"] and rec.counters == {"c": 3}


def test_nested_recordings_and_a_span_left_by_an_exception():
    with P.recording() as outer:
        with P.recording() as inner:
            with pytest.raises(ValueError):
                with P.span("fails"):
                    raise ValueError
            with P.span("after"):
                pass
        with P.span("outer"):
            P.count("n")
    assert [(s.name, s.parent) for s in inner.spans] == [("fails", -1), ("after", -1)]
    assert inner.spans[0].end_ns is not None and inner.counters == {}
    assert [s.name for s in outer.spans] == ["outer"] and outer.counters == {"n": 1}


def test_a_recording_takes_only_its_own_thread():
    seen = []

    def other():
        with P.span("other") as s:
            P.count("other")
        seen.append(s)

    with P.recording() as rec:
        with P.span("main"):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive() and seen == [None]
    assert [s.name for s in rec.spans] == ["main"] and rec.counters == {}
