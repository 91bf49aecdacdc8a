"""The PyTorch port's PUCT search against the JAX package, exactly: slot
compaction bit for bit, and root visits/actions/order/valid equal under the
mock network of tests/test_mcts.py with the noise off (and with injected
Dirichlet draws), per-game simulation budgets, and the pi functions."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_mcts import _FIXED_PROBS, _advance_random, _jax_eval
from xiangqi_alphazero_torch.engine import env as TE
from xiangqi_alphazero_torch.models import XiangqiNet, policy_logits_fn, policy_value_fn
from xiangqi_alphazero_torch.search import mcts as TM
from xiangqi_alphazero_tpu.engine import env as JE
from xiangqi_alphazero_tpu.search import mcts as JM

# tests/test_mcts.py's mock value is tanh((own - opp) / 8) of piece counts;
# the port evaluates it from a table of the JAX values, so both searches see
# the same float32 bits
_TANH = np.asarray(jax.jit(lambda n: jnp.tanh(n / 8.0))(jnp.arange(-32.0, 33.0)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread, so parallel test workers
    do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_eval(feats):
    own = feats[..., :7].sum(dim=(1, 2, 3))
    opp = feats[..., 7:14].sum(dim=(1, 2, 3))
    value = torch.from_numpy(_TANH.copy()).to(feats.device)[(own - opp).long() + 32]
    probs = torch.from_numpy(_FIXED_PROBS.astype(np.float32)).to(feats.device)
    return probs.expand(feats.shape[0], -1), value


def _roots(cases):
    """The same batch of root positions for both packages."""
    j = [JE.state_from_numpy(np.asarray(p.board, np.int8), p.side) for p in cases]
    t = [TE.state_from_numpy(np.asarray(p.board, np.int8), p.side) for p in cases]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *j), TE.cat_states(t)


_OPENING_AND_MIDGAMES = [(0, 0), (9, 2), (23, 4), (40, 5)]


def _to_jax_result(res: TM.SearchResult) -> JM.SearchResult:
    return JM.SearchResult(*(jnp.asarray(x.numpy()) for x in res))


def _assert_same_result(jr, tr):
    for f in ("visits", "actions", "order", "valid"):
        assert np.array_equal(getattr(tr, f).numpy(), np.asarray(getattr(jr, f))), f
    np.testing.assert_allclose(tr.root_value.numpy(), np.asarray(jr.root_value), atol=1e-6)


def test_slot_compaction_bit_identical():
    from tests.test_torch_engine import playout_states

    rng = np.random.default_rng(1)
    slots = jax.jit(lambda *a: JM._legal_slots_priors(*a, 128))
    for _, ts in playout_states(games=8, plies=24, seed=5):
        board, side, legal = ts.board, ts.side, ts.legal
        probs = rng.random((8, 8100), dtype=np.float32)
        want = slots(
            jnp.asarray(board.numpy()), jnp.asarray(side.numpy()),
            jnp.asarray(legal.numpy()), jnp.asarray(probs),
        )
        got = TM._legal_slots_priors(board, side, legal, torch.from_numpy(probs), 128)
        for w, g in zip(want, got):
            assert g.numpy().dtype == np.asarray(w).dtype
            assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("sims", [16, 32])
def test_run_mcts_visits_exact(sims):
    cases = [_advance_random(p, s) for p, s in _OPENING_AND_MIDGAMES]
    jroots, troots = _roots(cases)
    jr = jax.jit(
        lambda r, k: JM.run_mcts(_jax_eval, r, k, JM.MCTSConfig(sims), add_noise=False)
    )(jroots, jax.random.key(0))
    tr = TM.run_mcts(_port_eval, troots, TM.MCTSConfig(sims), add_noise=False)
    _assert_same_result(jr, tr)
    assert tr.visits.sum(dim=1).tolist() == [sims] * 4


def test_run_mcts_with_injected_noise(monkeypatch):
    """Dirichlet noise on two of four roots, the gamma draws injected into
    both searches (the two frameworks' random streams differ)."""
    draws = np.random.default_rng(9).gamma(0.3, size=(4, 128)).astype(np.float32)
    monkeypatch.setattr(jax.random, "gamma", lambda *a, **k: jnp.asarray(draws))
    monkeypatch.setattr(TM, "_gamma", lambda *a, **k: torch.from_numpy(draws))
    mask = np.array([True, False, True, False])
    cases = [_advance_random(p, s) for p, s in _OPENING_AND_MIDGAMES]
    jroots, troots = _roots(cases)
    jr = jax.jit(
        lambda r, k: JM.run_mcts(
            _jax_eval, r, k, JM.MCTSConfig(24), noise_mask=jnp.asarray(mask)
        )
    )(jroots, jax.random.key(0))
    tr = TM.run_mcts(
        _port_eval, troots, TM.MCTSConfig(24), noise_mask=torch.from_numpy(mask)
    )
    _assert_same_result(jr, tr)


def test_sim_budget_equals_exact_budget_search():
    cases = [_advance_random(p, s) for p, s in _OPENING_AND_MIDGAMES]
    jroots, troots = _roots(cases)
    budget = [20, 7, 0, 13]
    tr = TM.run_mcts(
        _port_eval, troots, TM.MCTSConfig(20), add_noise=False,
        sim_budget=torch.tensor(budget),
    )
    jr = jax.jit(
        lambda r, k, b: JM.run_mcts(
            _jax_eval, r, k, JM.MCTSConfig(20), add_noise=False, sim_budget=b
        )
    )(jroots, jax.random.key(0), jnp.asarray(budget, jnp.int32))
    _assert_same_result(jr, tr)
    for i, n in enumerate(budget):
        solo = TM.run_mcts(
            _port_eval, TE.cat_states([troots]), TM.MCTSConfig(n), add_noise=False
        )
        assert torch.equal(tr.visits[i], solo.visits[i])
        assert torch.equal(tr.order[i], solo.order[i])


def test_pi_functions_match_jax():
    cases = [_advance_random(p, s) for p, s in _OPENING_AND_MIDGAMES]
    _, troots = _roots(cases)
    tr = TM.run_mcts(_port_eval, troots, TM.MCTSConfig(24), add_noise=False)
    jr = _to_jax_result(tr)
    assert np.array_equal(TM.greedy_slots(tr).numpy(), np.asarray(JM.greedy_slots(jr)))
    for temp in (0.0, 1.0):
        t = np.full(4, temp, np.float32)
        assert np.array_equal(
            TM.action_probs_slots(tr, torch.from_numpy(t)).numpy(),
            np.asarray(JM.action_probs_slots(jr, jnp.asarray(t))),
        )
        assert np.array_equal(
            TM.action_probs_dense(tr, torch.from_numpy(t)).numpy(),
            np.asarray(JM.action_probs_dense(jr, jnp.asarray(t))),
        )
    t = np.array([0.5, 1.5, 0.25, 2.0], np.float32)
    np.testing.assert_allclose(
        TM.action_probs_slots(tr, torch.from_numpy(t)).numpy(),
        np.asarray(JM.action_probs_slots(jr, jnp.asarray(t))),
        rtol=1e-6, atol=1e-7,
    )
    greedy = tr.actions.gather(1, TM.greedy_slots(tr)[:, None])[:, 0]
    assert torch.equal(TM.sample_actions(tr, 0.0), greedy)
    g = torch.Generator().manual_seed(0)
    sampled = TM.sample_actions(tr, 1.0, g)
    for i, a in enumerate(sampled.tolist()):
        assert int(tr.visits[i][tr.actions[i] == a].sum()) > 0


def test_movegen_precedence_matches_jax():
    for pos in (_advance_random(p, s) for p, s in _OPENING_AND_MIDGAMES):
        for a in pos.legal_actions():
            kind = abs(pos.board[a // 90])
            assert TM.movegen_precedence(a, kind) == JM.movegen_precedence(a, kind)


@torch.no_grad()
def test_logits_eval_matches_probs_eval():
    torch.manual_seed(3)
    net = XiangqiNet(16, 2).eval()
    roots = TE.reset_batch(4)
    a = TM.run_mcts(policy_value_fn(net), roots, TM.MCTSConfig(30), add_noise=False)
    b = TM.run_mcts(
        policy_logits_fn(net), roots, TM.MCTSConfig(30), add_noise=False,
        logits_eval=True,
    )
    assert torch.equal(a.actions, b.actions)
    assert torch.equal(a.visits, b.visits)
    np.testing.assert_allclose(a.root_value.numpy(), b.root_value.numpy(), atol=1e-6)

