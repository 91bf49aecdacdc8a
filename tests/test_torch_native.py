"""The port's native rules core (``xiangqi_alphazero_torch/engine/native``)
against the port's Python movegen and the JAX package's native core, on
random playouts and the hand-made edge boards: legal moves, check, attack
and king queries exactly equal; ``minimax_move`` equal to the JAX core's at
depths 1 and 2 on a few boards. The oracle takes the native path when the
core is built, and the Python path when forced."""

import random

import numpy as np
import pytest

from xiangqi_alphazero_torch.engine import native
from xiangqi_alphazero_torch.engine import oracle as TO
from xiangqi_alphazero_torch.engine.edge_boards import edge_boards
from xiangqi_alphazero_tpu.engine import native as jax_native


@pytest.fixture
def python_rules():
    """The oracle side of each diff is the pure-Python movegen."""
    TO.use_python_rules(True)
    yield
    TO.use_python_rules(False)


def _playout_positions(seed: int, plies: int = 120):
    rng = random.Random(seed)
    p = TO.Position()
    for _ in range(plies):
        yield p
        acts = p.legal_actions()
        if p.result()[0] or not acts:
            return
        p.apply(rng.choice(acts))


def test_core_builds_into_the_ignored_build_dir():
    assert native.available(), "no C++ compiler found"
    path = native.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "xiangqi_alphazero_torch"


@pytest.mark.parametrize("seed", range(3))
def test_gen_legal_matches_python_movegen_and_jax_core(seed, python_rules):
    for ply, p in enumerate(_playout_positions(seed)):
        b = p.board_array()
        py = p.legal_actions()
        got = native.gen_legal(b, p.side)
        assert got == py, f"seed {seed} ply {ply}\n{p.render()}"
        assert got == jax_native.gen_legal(b, p.side)
        assert native.has_legal(b, p.side) == bool(py)
        for side in (1, -1):
            assert native.is_in_check(b, side) == p.in_check(side)
            assert native.find_king(b, side) == p.find_king(side)
        for sq in range(0, 90, 7):
            for by in (1, -1):
                assert native.is_attacked(b, sq, by) == p.attacked(sq, by)


def test_edge_boards_match_python_movegen(python_rules):
    for name, (board, side) in edge_boards().items():
        p = TO.Position()
        p.board, p.side = [int(x) for x in board], int(side)
        assert native.gen_legal(board, side) == p.legal_actions(), name
        assert native.has_legal(board, side) == bool(p.legal_actions()), name


def test_oracle_takes_the_native_path_unless_forced(monkeypatch):
    calls = []
    gen = native.gen_legal
    monkeypatch.setattr(native, "gen_legal", lambda b, s: calls.append(1) or gen(b, s))
    assert TO.Position().legal_actions() == gen(TO.Position().board_array(), 1)
    assert calls == [1]
    TO.use_python_rules(True)
    try:
        assert len(TO.Position().legal_actions()) == 44
    finally:
        TO.use_python_rules(False)
    assert calls == [1]


@pytest.mark.parametrize("depth", [1, 2])
def test_minimax_move_matches_jax_core(depth):
    cases = [(p.board_array().copy(), p.side)
             for i, p in enumerate(_playout_positions(7, 41)) if i % 10 == 0]
    cases += list(edge_boards().values())[:3]
    for i, (b, side) in enumerate(cases):
        for seed in (1, 9):
            got = native.minimax_move(b, side, depth, seed=seed)
            assert got == jax_native.minimax_move(b, side, depth, seed=seed), (i, seed)
            assert got is None or got in native.gen_legal(b, side)


def test_bad_board_is_refused():
    with pytest.raises(ValueError, match="90"):
        native.gen_legal(np.zeros(89, np.int8), 1)
