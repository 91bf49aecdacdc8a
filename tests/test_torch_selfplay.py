"""The port's lockstep self-play against the JAX package's ``selfplay_games``
(selfplay.py:456), exactly, with the same draws injected into both.

Under ``jit`` the JAX loop body is traced once, so a patched draw is a
constant: the same array at every ply and, inside ``vmap``, in every lane.
The port's draw functions are patched to return the same arrays at the same
call sites: the opening lengths, one Gumbel row for every opening round and
every game, the playout-cap coin, the Dirichlet gamma and the sampling
Gumbels, and for the Gumbel search its root row. The mock network is
tests/test_mcts.py's (fixed priors, value tanh of the piece balance),
evaluated by the port from a table of the JAX values. Tolerances: every
array exactly equal, except ``pi_probs`` at atol 1e-6 (``visits ** (1 / T)``
goes through two libraries' ``pow``; Gumbel's improved policy through their
``exp``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_mcts import _jax_eval
from tests.test_torch_search import _port_eval
from xiangqi_alphazero_torch.search import gumbel as TG
from xiangqi_alphazero_torch.search import mcts as TM
from xiangqi_alphazero_torch.train import selfplay as TS
from xiangqi_alphazero_tpu.train import selfplay as JS

B, K = 4, 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread, so parallel test workers
    do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draws(seed: int, coin):
    rng = np.random.default_rng(seed)
    return {
        "n_rand": rng.integers(0, 5, size=B).astype(np.int32),
        "g_open": rng.gumbel(size=8100).astype(np.float32),
        "g_samp": rng.gumbel(size=(B, K)).astype(np.float32),
        "gamma": rng.gamma(0.3, size=(B, K)).astype(np.float32),
        "coin": np.asarray(coin),
    }


def _inject(monkeypatch, d):
    """The same draws at the same call sites of both packages."""
    monkeypatch.setattr(jax.random, "randint", lambda *a, **k: jnp.asarray(d["n_rand"]))
    monkeypatch.setattr(
        jax.random, "gumbel",
        lambda key, shape=(), *a, **k: jnp.asarray(
            d["g_open"] if tuple(shape) == (8100,) else d["g_samp"]),
    )
    monkeypatch.setattr(jax.random, "bernoulli", lambda *a, **k: jnp.asarray(d["coin"]))
    monkeypatch.setattr(jax.random, "gamma", lambda *a, **k: jnp.asarray(d["gamma"]))

    monkeypatch.setattr(TS, "_draw_opening_counts",
                        lambda batch, n, gen: torch.from_numpy(d["n_rand"]))
    monkeypatch.setattr(
        TS, "_draw_opening_gumbel",
        lambda batch, gen: torch.from_numpy(np.broadcast_to(d["g_open"], (batch, 8100)).copy()),
    )
    monkeypatch.setattr(TS, "_draw_coin", lambda p, shape, gen: torch.from_numpy(d["coin"]))
    monkeypatch.setattr(TM, "_gamma", lambda *a, **k: torch.from_numpy(d["gamma"]))
    monkeypatch.setattr(TM, "_gumbel", lambda *a, **k: torch.from_numpy(d["g_samp"]))


def _run_both(monkeypatch, settings: dict, coin=True, seed=0):
    d = _draws(seed, coin)
    d["n_rand"] = np.minimum(d["n_rand"], settings.get("random_opening_moves", 4))
    _inject(monkeypatch, d)
    js = JS.SelfPlaySettings(**settings)
    want = jax.jit(lambda r: JS.selfplay_games(_jax_eval, B, r, js))(jax.random.key(0))
    got = TS.selfplay_games(_port_eval, B, TS.SelfPlaySettings(**settings),
                            torch.Generator(), "cpu")
    return jax.tree.map(np.asarray, want), got


def _assert_same(want, got):
    for f in ("boards", "sides", "pi_actions", "values", "rec", "winners", "plies",
              "total_moves"):
        g, w = getattr(got, f).numpy(), getattr(want, f)
        assert g.dtype == w.dtype and np.array_equal(g, w), f
    np.testing.assert_allclose(got.pi_probs.numpy(), want.pi_probs, rtol=0, atol=1e-6)
    # the loop ran as long as JAX's while_loop (its last recorded ply)
    assert len(got.sims_per_ply) >= int(np.flatnonzero(want.rec.any(axis=1)).max()) + 1


_BASE = dict(num_simulations=6, max_game_length=16, temperature_threshold=6,
             resign_threshold=0.05, resign_check_steps=2)


@pytest.mark.parametrize("name, settings, coin", [
    # binary schedule, 4-move openings, resign at n_rec > 10 and adjudication
    # at the 16-move cap
    ("binary_openings_resign", dict(_BASE, random_opening_moves=4), True),
    # anneal schedule (recorded-step clock, draw at the cap), no openings,
    # per-ply coin off: every ply a cheap noiseless 2-simulation search
    ("anneal_no_openings_cap_per_ply", dict(
        _BASE, temperature_schedule="anneal", random_opening_moves=0,
        temperature_threshold=3, playout_cap_prob=0.5, playout_cap_sims=2), False),
    # per-game coins: full and cheap budgets in one search, noise on the
    # full games only
    ("binary_cap_per_game", dict(
        _BASE, random_opening_moves=2, playout_cap_prob=0.5, playout_cap_sims=2,
        playout_cap_per_game=True), [True, False, False, True]),
])
def test_selfplay_matches_jax(monkeypatch, name, settings, coin):
    want, got = _run_both(monkeypatch, settings, coin)
    _assert_same(want, got)
    assert want.rec.any()
    if name == "binary_openings_resign":
        # some game resigned or was adjudicated: its winner is forced
        assert (want.total_moves >= 16).any() or (want.winners != 0).any()
    if name == "anneal_no_openings_cap_per_ply":
        assert not want.pi_probs.any()   # value-only samples throughout
        assert set(got.sims_per_ply) == {2}
    if name == "binary_cap_per_game":
        full = np.asarray(coin)
        rows = want.pi_probs.sum(axis=-1)[want.rec.any(axis=1)]
        assert (rows[:, full] > 0).all() and not rows[:, ~full].any()


def test_temperature_at_matches_jax():
    t = np.arange(0, 40, dtype=np.int32)
    for sched in ("binary", "anneal"):
        s = TS.SelfPlaySettings(temperature_threshold=15, temperature_schedule=sched)
        js = JS.SelfPlaySettings(temperature_threshold=15, temperature_schedule=sched)
        assert np.array_equal(TS.temperature_at(torch.from_numpy(t), s).numpy(),
                              np.asarray(JS.temperature_at(jnp.asarray(t), js)))


def test_adjudicate_and_uniform_action_match_jax():
    from tests.test_torch_engine import playout_states

    g = np.random.default_rng(2).gumbel(size=(8, 8100)).astype(np.float32)
    for _, ts in playout_states(games=8, plies=24, seed=3):
        want = jax.vmap(JS._adjudicate)(jnp.asarray(ts.board.numpy()))
        assert np.array_equal(TS._adjudicate(ts.board).numpy(), np.asarray(want))
        act = jax.vmap(lambda legal, gg: jnp.argmax(jnp.where(legal, gg, -jnp.inf)))(
            jnp.asarray(ts.legal.numpy()), jnp.asarray(g))
        assert np.array_equal(
            TS._uniform_legal_action(ts.legal, torch.from_numpy(g)).numpy(), np.asarray(act))


def test_draws_are_made_on_the_cpu_generator():
    """Without injection, every draw comes from the one CPU generator: the
    same seed plays the same games, another seed other games."""
    s = TS.SelfPlaySettings(num_simulations=4, max_game_length=6, random_opening_moves=3)

    def play(seed):
        return TS.selfplay_games(_port_eval, 4, s, torch.Generator().manual_seed(seed), "cpu")

    a, b, c = play(1), play(1), play(2)
    assert torch.equal(a.boards, b.boards) and torch.equal(a.pi_probs, b.pi_probs)
    assert not torch.equal(a.boards, c.boards)
    # the Gumbel search's root draws come from the same generator
    g = s._replace(search_algo="gumbel", max_considered=4)
    a, b = (TS.selfplay_games(_port_eval, 4, g, torch.Generator().manual_seed(1), "cpu")
            for _ in range(2))
    assert torch.equal(a.boards, b.boards) and torch.equal(a.pi_probs, b.pi_probs)
    rows = a.pi_probs.sum(dim=-1)[a.rec]
    assert torch.allclose(rows, torch.ones_like(rows), atol=1e-5)


_GB = 8   # games in the Gumbel fleet


def _run_both_gumbel(monkeypatch, settings: dict, coin):
    """Gumbel self-play of both packages with one constant per draw site:
    under ``jit`` JAX's root draw (one ``(K,)`` row per lane under ``vmap``)
    is the same row in every lane and at every ply, and so is the port's."""
    rng = np.random.default_rng(5)
    n_rand = rng.integers(0, settings["random_opening_moves"] + 1, size=_GB).astype(np.int32)
    g_open = rng.gumbel(size=8100).astype(np.float32)
    g_root = rng.gumbel(size=K).astype(np.float32)
    coin = np.asarray(coin)

    monkeypatch.setattr(jax.random, "randint", lambda *a, **k: jnp.asarray(n_rand))
    monkeypatch.setattr(
        jax.random, "gumbel",
        lambda key, shape=(), *a, **k: jnp.asarray(g_open if tuple(shape) == (8100,) else g_root))
    monkeypatch.setattr(jax.random, "bernoulli", lambda *a, **k: jnp.asarray(coin))
    monkeypatch.setattr(TS, "_draw_opening_counts", lambda batch, n, gen: torch.from_numpy(n_rand))
    monkeypatch.setattr(
        TS, "_draw_opening_gumbel",
        lambda batch, gen: torch.from_numpy(np.broadcast_to(g_open, (batch, 8100)).copy()))
    monkeypatch.setattr(TS, "_draw_coin", lambda p, shape, gen: torch.from_numpy(coin))
    monkeypatch.setattr(
        TG, "_root_gumbel",
        lambda batch, k, gen, dev: torch.from_numpy(np.broadcast_to(g_root, (batch, k)).copy()))

    js = JS.SelfPlaySettings(**settings)
    want = jax.jit(lambda r: JS.selfplay_games(_jax_eval, _GB, r, js))(jax.random.key(0))
    got = TS.selfplay_games(_port_eval, _GB, TS.SelfPlaySettings(**settings),
                            torch.Generator(), "cpu")
    return jax.tree.map(np.asarray, want), got


_GUMBEL = dict(search_algo="gumbel", max_considered=4, num_simulations=8,
               max_game_length=20, random_opening_moves=2, resign_threshold=0.05,
               resign_check_steps=2)


@pytest.mark.parametrize("name, settings, coin", [
    # the anneal schedule leaves Gumbel on the parallel loop's semantics
    # (adjudication at the cap, resign after 10 recorded plies)
    ("gumbel_anneal", dict(_GUMBEL, temperature_schedule="anneal"), True),
    # the batch-global cap coin: every ply a cheap 2-simulation search
    ("gumbel_cap_per_ply", dict(_GUMBEL, playout_cap_prob=0.5, playout_cap_sims=2), False),
])
def test_gumbel_selfplay_matches_jax(monkeypatch, name, settings, coin):
    want, got = _run_both_gumbel(monkeypatch, settings, coin)
    _assert_same(want, got)
    assert want.rec.any() and (want.plies >= 16).any()
    if name == "gumbel_anneal":
        assert not TS._is_serial(TS.SelfPlaySettings(**settings))
        rows = want.pi_probs.sum(axis=-1)[want.rec]
        np.testing.assert_allclose(rows, 1.0, atol=1e-5)   # pi_improved rows
    else:
        assert not want.pi_probs.any() and set(got.sims_per_ply) == {2}


def test_gumbel_refuses_per_game_caps():
    s = TS.SelfPlaySettings(search_algo="gumbel", playout_cap_prob=0.5, playout_cap_sims=2,
                            playout_cap_per_game=True, num_simulations=4, max_game_length=4)
    with pytest.raises(ValueError, match="playout_cap_per_game"):
        TS.selfplay_games(_port_eval, 2, s, torch.Generator(), "cpu")


def test_evaluate_pair_matches_jax():
    """The color-halved gated match of two different random nets (8
    channels, 1 block; float32, weights carried across): winners,
    new_is_red and avg_plies exactly equal, and every move (the final boards
    and repetition rings). The policy kernels are scaled by 30: at flax's
    initial scale the priors are near uniform, both nets pick the same
    moves, and the match could not tell which net moved."""
    from xiangqi_alphazero_torch.models import XiangqiNet, policy_logits_fn, state_dict_from_jax
    from xiangqi_alphazero_torch.train import evaluate as TV
    from xiangqi_alphazero_tpu.models import XiangqiNet as JaxNet
    from xiangqi_alphazero_tpu.models import policy_logits_fn as jax_logits_fn
    from xiangqi_alphazero_tpu.train import evaluate as JV

    jnet = JaxNet(channels=8, blocks=1)
    init = jax.jit(lambda k: jnet.init(k, jnp.zeros((1, 10, 9, 15)), train=False))
    jvars = [jax.tree.map(np.array, init(jax.random.key(s))) for s in (11, 12)]
    for v in jvars:
        v["params"]["Dense_0"]["kernel"] *= 30.0
    tnets = []
    for v in jvars:
        net = XiangqiNet(8, 1)
        net.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"], 1))
        tnets.append(net.eval())

    s = dict(num_simulations=4, max_game_length=14)

    @jax.jit
    def jax_match(a, b, r):
        # evaluate_pair's own loop (evaluate.py:154-170), keeping the final
        # boards as well
        body = JV._make_body(jax_logits_fn(jnet, a), jax_logits_fn(jnet, b), 4,
                             JV.EvalSettings(**s), True)
        out = jax.lax.while_loop(
            lambda c: (c.t < s["max_game_length"]) & jnp.any(~c.states.done), body,
            JV._init_carry(4, r))
        return JV._finalize(out, 4), out.states.hist, out.states.board

    want, want_hist, want_board = jax_match(jvars[0], jvars[1], jax.random.key(0))
    assert np.array_equal(
        np.asarray(jax.jit(lambda a, b, r: JV.evaluate_pair(
            jax_logits_fn(jnet, a), jax_logits_fn(jnet, b), 4, r, JV.EvalSettings(**s),
            logits_eval=True).winners)(jvars[0], jvars[1], jax.random.key(0))),
        np.asarray(want.winners))
    final = []
    finalize = TV._finalize
    with torch.inference_mode(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(TV, "_finalize", lambda st, *a: final.append(st) or finalize(st, *a))
        got = TV.evaluate_pair(policy_logits_fn(tnets[0]), policy_logits_fn(tnets[1]), 4,
                               TV.EvalSettings(**s), "cpu", logits_eval=True)
    for f in ("winners", "new_is_red", "avg_plies", "new_wins", "old_wins", "draws"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and np.array_equal(g, w), f
    # every move of the match was the same: the final boards and their
    # repetition rings agree
    assert np.array_equal(final[0].board.numpy(), np.asarray(want_board))
    assert np.array_equal(final[0].hist.numpy(), np.asarray(want_hist))
    assert 1 <= got.plies_run <= 14
    # the test can tell which net moved: swapped nets play other games
    with torch.inference_mode(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(TV, "_finalize", lambda st, *a: final.append(st) or finalize(st, *a))
        TV.evaluate_pair(policy_logits_fn(tnets[1]), policy_logits_fn(tnets[0]), 4,
                         TV.EvalSettings(**s), "cpu", logits_eval=True)
    assert not torch.equal(final[1].board, final[0].board)
    with pytest.raises(ValueError, match="even"):
        TV.evaluate_pair(policy_logits_fn(tnets[0]), policy_logits_fn(tnets[1]), 3,
                         TV.EvalSettings(**s), "cpu")
