"""The port's Gumbel search against the JAX package's ``run_gumbel_mcts``,
on the CPU, with JAX's own root draws injected into the port.

The mock networks are exact in float32: priors ((a * 37) % 64 + 1) / 1024
(or, for ``logits_eval``, logits ((a * 37) % 64) / 16) and value
(own - opp) / 8 of the piece counts, so both frameworks feed the search the
same bits. Visits, actions, valid, order and chosen must be exactly equal;
pi_improved and root_value within atol 1e-6. Then the port's counterparts
of the JAX tests' invariants (tests/test_gumbel.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_mcts import _advance_random
from xiangqi_alphazero_torch.engine import env as TE
from xiangqi_alphazero_torch.engine.oracle import Position
from xiangqi_alphazero_torch.search import gumbel as TG
from xiangqi_alphazero_tpu.engine import env as JE
from xiangqi_alphazero_tpu.search import gumbel as JG

K = 128
_TABLE = ((np.arange(8100) * 37) % 64).astype(np.float32)
_PROBS = (_TABLE + 1) / 1024
_LOGITS = _TABLE / 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread, so parallel test workers
    do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_eval(table):
    def f(feats):
        own = jnp.sum(feats[..., :7], axis=(1, 2, 3))
        opp = jnp.sum(feats[..., 7:14], axis=(1, 2, 3))
        return jnp.broadcast_to(jnp.asarray(table), (feats.shape[0], 8100)), (own - opp) / 8.0
    return f


def _port_eval(table):
    def f(feats):
        own = feats[..., :7].sum(dim=(1, 2, 3))
        opp = feats[..., 7:14].sum(dim=(1, 2, 3))
        return torch.from_numpy(table).expand(feats.shape[0], -1), (own - opp) / 8.0
    return f


def _roots(cases):
    j = [JE.state_from_numpy(np.asarray(p.board, np.int8), p.side) for p in cases]
    t = [TE.state_from_numpy(np.asarray(p.board, np.int8), p.side) for p in cases]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *j), TE.cat_states(t)


def _jax_root_draws(key, batch):
    """JAX's own root draws: one row per split key (gumbel.py:262-264)."""
    return np.array(jax.vmap(lambda kk: jax.random.gumbel(kk, (K,), jnp.float32))(
        jax.random.split(key, batch)))


def _inject(monkeypatch, draws):
    monkeypatch.setattr(TG, "_root_gumbel",
                        lambda batch, k, gen, dev: torch.from_numpy(draws[:batch]).to(dev))


_CASES = [(0, 0), (9, 2), (23, 4), (40, 5)]   # the opening and three midgames


def test_halving_schedule_matches_jax():
    for budget in range(65):
        for m in range(1, 17):
            assert TG.halving_schedule(budget, m) == JG.halving_schedule(budget, m)


@pytest.mark.parametrize("logits_eval, m", [(False, 8), (True, 8), (False, 2)])
def test_run_gumbel_mcts_matches_jax(monkeypatch, logits_eval, m):
    """m = 8 spreads 16 simulations over the halving's phases; m = 2 puts
    them on two root children, so the interior rule runs deeper."""
    table = _LOGITS if logits_eval else _PROBS
    cfg = dict(num_simulations=16, max_considered=m)
    jroots, troots = _roots([_advance_random(p, s) for p, s in _CASES])
    key = jax.random.key(3)
    want = jax.jit(lambda r, k: JG.run_gumbel_mcts(
        _jax_eval(table), r, k, JG.GumbelConfig(**cfg), logits_eval=logits_eval))(jroots, key)
    _inject(monkeypatch, _jax_root_draws(key, 4))
    got = TG.run_gumbel_mcts(_port_eval(table), troots, TG.GumbelConfig(**cfg),
                             logits_eval=logits_eval)
    for f in ("visits", "actions", "valid", "order", "chosen"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and np.array_equal(g, w), f
    for f in ("pi_improved", "root_value"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=0, atol=1e-6, err_msg=f)
    assert got.visits.sum(dim=1).tolist() == [16] * 4
    # the halving ran: every lane's visits lie on at most m root slots, and
    # the chosen move was visited
    for i in range(4):
        assert 1 <= int((got.visits[i] > 0).sum()) <= m
        assert int(got.visits[i][got.actions[i] == got.chosen[i]].sum()) > 0


def _search(roots, sims, m, seed=0, table=_PROBS):
    return TG.run_gumbel_mcts(_port_eval(table), roots,
                              TG.GumbelConfig(num_simulations=sims, max_considered=m),
                              generator=torch.Generator().manual_seed(seed))


def _opening(n=1):
    return TE.reset_batch(n)


def test_m_clamped_to_budget_and_zero_budget():
    """sims < m: m clamps to the budget, every candidate gets a visit and
    the acted move is visited; a budget of 0 acts the g + logits argmax
    with no visit."""
    res = _search(_opening(), 6, 16)
    visits = res.visits[0]
    assert int(visits.sum()) == 6 and int((visits > 0).sum()) == 6
    assert int(visits[res.actions[0] == res.chosen[0]].sum()) > 0
    assert TG.halving_schedule(0, 8) == [(8, 0)]
    zero = _search(_opening(), 0, 8)
    assert int(zero.visits.sum()) == 0
    assert int(zero.chosen[0]) in set(Position().legal_actions())
    # m = 1: every simulation visits the one candidate
    one = _search(_opening(), 10, 1)
    assert int(one.visits.sum()) == 10 and int((one.visits > 0).sum()) == 1


def test_terminal_root_is_noop():
    board = np.zeros(90, np.int8)
    board[4] = 1   # lone red king: black (to move) has no king, the game is over
    roots = TE.state_from_numpy(board, -1)
    res = _search(roots, 8, 4)
    assert int(res.visits.sum()) == 0 and int(res.chosen[0]) == -1
    assert not res.pi_improved.any()


def test_lane_noise_is_batch_width_independent_and_lanes_independent():
    """Lane 0 gets the same search at widths 1 and 4 (the property
    coalesced serving relies on); what rides in lane 1 does not change
    lane 0; pi_improved is a distribution over the legal slots."""
    w1 = _search(_opening(1), 12, 8, seed=6)
    w4 = _search(_opening(4), 12, 8, seed=6)
    assert torch.equal(w1.visits[0], w4.visits[0]) and int(w1.chosen[0]) == int(w4.chosen[0])
    p = _advance_random(6, 4)
    mid = TE.state_from_numpy(np.asarray(p.board, np.int8), p.side)
    both = _search(TE.cat_states([_opening(1), mid]), 12, 8, seed=6)
    two = _search(_opening(2), 12, 8, seed=6)
    assert torch.equal(both.visits[0], two.visits[0])
    assert int(both.visits[1].sum()) == 12
    pi = w4.pi_improved
    assert torch.allclose(pi.sum(dim=1), torch.ones(4), atol=1e-5)
    assert not pi[~w4.valid].any()
