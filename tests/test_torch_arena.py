"""The port's arena and Elo ladder against the JAX package's, on the CPU.

At temperature 0 with the Gumbel side's root draws injected (one constant
row per draw site, as a patched draw is under ``jit``), a PUCT-against-
Gumbel match of two tiny nets (8 channels, 1 block; float32, the JAX
weights carried across) gives exactly JAX ``make_hosted_arena``'s counts,
winners, mean length and final boards. Counts stay consistent, games diverge under
temperature, the Elo fit equals JAX's within 1e-9, and the round robin runs
over three ``.pt`` files."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xiangqi_alphazero_torch.engine import env as TE
from xiangqi_alphazero_torch.models import XiangqiNet, state_dict_from_jax
from xiangqi_alphazero_torch.search import gumbel as TG
from xiangqi_alphazero_torch.train import arena as TA
from xiangqi_alphazero_torch.train import elo as TELO
from xiangqi_alphazero_torch.train import evaluate as TV
from xiangqi_alphazero_tpu.models import XiangqiNet as JaxNet
from xiangqi_alphazero_tpu.train import arena as JA
from xiangqi_alphazero_tpu.train import elo as JELO
from xiangqi_alphazero_tpu.train import evaluate as JV

K = 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread, so parallel test workers
    do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nets():
    """Two random JAX nets and their port copies. The policy kernels are
    scaled by 30 so that the priors are far from uniform and the two nets
    choose different moves (see tests/test_torch_selfplay.py)."""
    jnet = JaxNet(channels=8, blocks=1)
    init = jax.jit(lambda k: jnet.init(k, jnp.zeros((1, 10, 9, 15)), train=False))
    jvars = [jax.tree.map(np.array, init(jax.random.key(s))) for s in (21, 22)]
    tnets = []
    for v in jvars:
        v["params"]["Dense_0"]["kernel"] *= 30.0
        net = XiangqiNet(8, 1)
        net.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"], 1))
        tnets.append(net.eval())
    return jnet, jvars, tnets


def test_arena_matches_jax_at_temperature_zero(nets, monkeypatch):
    jnet, jvars, tnets = nets
    g_root = np.random.default_rng(4).gumbel(size=K).astype(np.float32)
    monkeypatch.setattr(
        jax.random, "gumbel",
        lambda key, shape=(), *a, **k: jnp.asarray(g_root) if tuple(shape) == (K,)
        else jnp.zeros(shape, jnp.float32))
    monkeypatch.setattr(TG, "_root_gumbel", lambda b, k, gen, dev: torch.from_numpy(
        np.broadcast_to(g_root, (b, k)).copy()))
    # keep each package's winners and final boards beside the arena's counts
    outs = {}
    jfin, tfin = JV._finalize, TV._finalize
    monkeypatch.setattr(JV, "_finalize", lambda out, batch: (jfin(out, batch), out.states.board))
    hosted = JA.make_hosted_eval

    def jax_spy(*a, **k):
        run = hosted(*a, **k)

        def spied(*r):
            outs["jax"] = run(*r)
            return outs["jax"][0]
        return spied

    monkeypatch.setattr(JA, "make_hosted_eval", jax_spy)
    monkeypatch.setattr(TV, "_finalize",
                        lambda st, *a: outs.setdefault("port", (tfin(st, *a), st.board))[0])

    kw = dict(num_simulations=4, max_game_length=12, temperature=0.0, algo_a="puct",
              algo_b="gumbel", sims_b=8, max_considered=4)
    want = JA.make_hosted_arena(jnet, jnet, 8, JA.ArenaSettings(**kw))(
        jvars[0], jvars[1], jax.random.key(0))
    got = TA.make_hosted_arena(tnets[0], tnets[1], 8, TA.ArenaSettings(**kw), "cpu")(
        torch.Generator())
    assert {k: got[k] for k in want} == want
    assert got["a_wins"] + got["b_wins"] + got["draws"] == 8 and got["avg_plies"] > 1
    (jout, jboard), (tout, tboard) = outs["jax"], outs["port"]
    assert np.array_equal(tout.winners.numpy(), np.asarray(jout.winners))
    # every move of the match was the same
    assert np.array_equal(tboard.numpy(), np.asarray(jboard))
    assert not torch.equal(tboard, TE.reset_batch(8).board)


def test_arena_counts_consistent_and_games_diverge(nets, monkeypatch):
    _, _, tnets = nets
    finals = []
    finalize = TV._finalize
    monkeypatch.setattr(TV, "_finalize", lambda st, *a: finals.append(st) or finalize(st, *a))
    s = TA.ArenaSettings(num_simulations=4, max_game_length=8, temperature=1.0,
                         algo_a="gumbel", sims_a=6, max_considered=4)
    out = TA.make_hosted_arena(tnets[0], tnets[1], 8, s, "cpu")(torch.Generator().manual_seed(1))
    assert out["games"] == 8 and out["a_wins"] + out["b_wins"] + out["draws"] == 8
    assert 0.0 <= out["a_score"] <= 1.0 and out["avg_plies"] > 0
    boards = finals[-1].board
    assert not all(torch.equal(boards[0], boards[i]) for i in range(1, 4)), \
        "games in the red half did not diverge"
    again = TA.make_hosted_arena(tnets[0], tnets[1], 8, s, "cpu")(torch.Generator().manual_seed(1))
    assert again == out and torch.equal(finals[-1].board, boards)   # same seed, same match
    with pytest.raises(ValueError, match="even"):
        TA.make_hosted_arena(tnets[0], tnets[1], 3, s, "cpu")


def test_fit_elo_and_expected_score_match_jax():
    rng = np.random.default_rng(0)
    true = [0.0, 120.0, 260.0, -80.0]
    results = []
    for i in range(4):
        for j in range(i + 1, 4):
            p = JELO.expected_score(true[i], true[j])
            results.append((i, j, float(rng.binomial(200, p)) + 0.5 * (i == 0), 200))
    np.testing.assert_allclose(TELO.fit_elo(results, 4), JELO.fit_elo(results, 4),
                               rtol=0, atol=1e-9)
    sweep = [(0, 1, 32.0, 32), (1, 2, 16.0, 32)]
    np.testing.assert_allclose(TELO.fit_elo(sweep, 3), JELO.fit_elo(sweep, 3), rtol=0, atol=1e-9)
    for a, b in [(0, 0), (400, 0), (0, 400), (-35.5, 212.25)]:
        assert abs(TELO.expected_score(a, b) - JELO.expected_score(a, b)) <= 1e-9


def test_round_robin_ladder_runs(tmp_path):
    """Three tiny ``.pt`` models through the port's arena on the CPU: every
    pair, consistent counts, a rating for each, the first at 0."""
    paths = []
    for i in range(3):
        torch.manual_seed(i)
        path = str(tmp_path / f"m{i}.pt")
        torch.save({"model_state_dict": XiangqiNet(8, 1).state_dict(),
                    "config": {"num_channels": 8, "num_res_blocks": 1}}, path)
        paths.append(path)
    out = TELO.round_robin(paths, games=4, sims=2, max_game_length=8, seed=1, device="cpu")
    assert len(out["pairs"]) == 3 and out["games_per_pair"] == 4
    for pr in out["pairs"]:
        assert pr["a_wins"] + pr["b_wins"] + pr["draws"] == 4
    assert set(out["ratings"]) == set(paths) and out["ratings"][paths[0]] == 0.0
