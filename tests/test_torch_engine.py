"""The PyTorch port's engine against the JAX package, bit for bit: the
tables, the oracle, the batched env over random playouts, and the legal
mask (the plain version against the JAX XLA path and the Pallas kernel in
interpret mode). The card-only checks are in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xiangqi_alphazero_torch.engine import env as TE
from xiangqi_alphazero_torch.engine import oracle as TO
from xiangqi_alphazero_torch.engine import tables as TT
from xiangqi_alphazero_torch.engine.edge_boards import edge_boards
from xiangqi_alphazero_torch.ops import legal_mask as TL
from xiangqi_alphazero_tpu.engine import env as JE
from xiangqi_alphazero_tpu.engine import oracle as JO
from xiangqi_alphazero_tpu.engine import tables as JT
from xiangqi_alphazero_tpu.ops.legal_mask import legal_mask_pallas

_ENV_FIELDS = ("board", "side", "ply", "quiet", "hist", "legal", "done", "winner")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread, so parallel test workers
    do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def playout_states(games: int = 8, plies: int = 40, seed: int = 0):
    """Seeded random playouts stepped in lockstep by the JAX env and the
    port: yields (jax state, port state) after every ply, actions chosen
    by numpy among the legal ones."""
    rng = np.random.default_rng(seed)
    js = JE.reset_batch_jit(games)
    ts = TE.reset_batch(games)
    step = jax.jit(JE.v_step)
    yield js, ts
    for _ in range(plies):
        legal = np.asarray(js.legal)
        acts = np.array(
            [rng.choice(np.flatnonzero(r)) if r.any() else 0 for r in legal]
        )
        js = step(js, jnp.asarray(acts, jnp.int32))
        ts = TE.step_batch(ts, torch.from_numpy(acts))
        yield js, ts


@pytest.fixture(scope="module")
def boards():
    """(int8[N, 90], int8[N]) from playouts, then the edge boards."""
    bs, ss = [], []
    for js, _ in playout_states(games=8, plies=30, seed=3):
        bs.append(np.asarray(js.board))
        ss.append(np.asarray(js.side))
    for b, s in edge_boards().values():
        bs.append(b[None])
        ss.append(np.asarray([s], np.int8))
    return np.concatenate(bs), np.concatenate(ss)


def test_tables_equal_jax_tables():
    a, b = JT.tables(), TT.tables()
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("seed", range(3))
def test_oracle_matches_jax_oracle(seed):
    rng = np.random.default_rng(seed)
    pj, pt = JO.Position(), TO.Position()
    for _ in range(100):
        assert pt.legal_actions() == pj.legal_actions()
        assert pt.result() == pj.result()
        assert pt.in_check(pt.side) == pj.in_check(pj.side)
        assert np.array_equal(pt.features(), pj.features())
        if pj.result()[0]:
            break
        a = int(rng.choice(pj.legal_actions()))
        pj.apply(a)
        pt.apply(a)


def test_step_batch_matches_jax_step():
    """8 games x 40 plies: every env field equal after every ply."""
    for ply, (js, ts) in enumerate(playout_states()):
        for f in _ENV_FIELDS:
            want = np.asarray(getattr(js, f))
            got = getattr(ts, f).numpy()
            assert got.dtype == want.dtype, f
            assert np.array_equal(got, want), f"{f} differs at ply {ply}"


def test_features_check_material_mirror(boards):
    b_np, s_np = boards
    b, s = torch.from_numpy(b_np), torch.from_numpy(s_np)
    jb, js = jnp.asarray(b_np), jnp.asarray(s_np)
    assert np.array_equal(TE.features(b, s).numpy(), np.asarray(JE.v_features(jb, js)))
    assert np.array_equal(
        TE.is_in_check(b, s).numpy(), np.asarray(jax.jit(JE.v_is_in_check)(jb, js))
    )
    for side in (1, -1):
        assert np.array_equal(
            TE.material(b, side).numpy(),
            np.asarray(jax.jit(JE.v_material)(jb, jnp.int8(side))),
        )
    mirrored = TE.mirror_board(b)
    assert np.array_equal(mirrored.numpy(), np.asarray(jax.vmap(JE.mirror_board)(jb)))
    perm = TE.mirror_actions(torch.arange(TE.ACTION_SPACE))
    assert np.array_equal(perm.numpy(), np.asarray(JE.mirror_actions(jnp.arange(8100))))
    # mirrored mask == mask of the mirrored board
    assert torch.equal(TE.legal_mask(b, s)[:, perm], TE.legal_mask(mirrored, s))


def test_plain_mask_matches_jax_xla(boards):
    b_np, s_np = boards
    want = np.asarray(jax.jit(jax.vmap(JE.legal_mask))(jnp.asarray(b_np), jnp.asarray(s_np)))
    got = TE.legal_mask(torch.from_numpy(b_np), torch.from_numpy(s_np)).numpy()
    assert np.array_equal(got, want)


def test_plain_mask_matches_pallas_interpret(boards):
    b_np, s_np = boards
    idx = np.r_[np.arange(0, len(b_np) - 9, 5)[:55], np.arange(len(b_np) - 9, len(b_np))]
    b_np, s_np = b_np[idx], s_np[idx]
    want = np.asarray(
        legal_mask_pallas(jnp.asarray(b_np), jnp.asarray(s_np), interpret=True)
    )
    got = TE.legal_mask(torch.from_numpy(b_np), torch.from_numpy(s_np)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", sorted(edge_boards()))
def test_edge_board_mask_matches_oracle(name):
    board, side = edge_boards()[name]
    pos = TO.Position()
    pos.board, pos.side = [int(x) for x in board], side
    got = TE.legal_mask(torch.from_numpy(board)[None], torch.tensor([side], dtype=torch.int8))
    assert set(torch.nonzero(got[0])[:, 0].tolist()) == set(pos.legal_actions())


def test_state_from_numpy_and_reset():
    pos = TO.Position()
    rng = np.random.default_rng(4)
    for _ in range(12):
        pos.apply(int(rng.choice(pos.legal_actions())))
    hist = np.zeros((TE.HIST_LEN, 90), np.int8)
    for i, h in enumerate(pos.history[-TE.HIST_LEN:]):
        hist[(pos.ply - min(len(pos.history), TE.HIST_LEN) + i) % TE.HIST_LEN] = (
            np.frombuffer(h, np.uint8).astype(np.int8)
        )
    t = TE.state_from_numpy(pos.board_array(), pos.side, pos.ply, pos.quiet, hist)
    j = JE.state_from_numpy(pos.board_array(), pos.side, pos.ply, pos.quiet, hist)
    for f in _ENV_FIELDS:
        assert np.array_equal(getattr(t, f).numpy()[0], np.asarray(getattr(j, f))), f
    r = TE.reset_batch(3)
    assert r.board.shape == (3, 90) and int(r.legal.sum()) == 3 * 44


def test_kernel_constants_rebuild_the_tables():
    flags, nblock, block = TL.action_constants()
    t = TT.tables()
    rebuilt = np.zeros((90, TE.ACTION_SPACE), np.int8)
    for a in range(TE.ACTION_SPACE):
        rebuilt[block[a, : nblock[a]], a] = 1
    assert np.array_equal(rebuilt, t["BLOCK"])
    assert np.array_equal((flags >> 8) & 1, t["HORSE_A"])
    assert np.array_equal((flags >> 9) & 1, t["ALIGNED_A"])
    assert np.array_equal((flags >> 1) & 1, t["KING_A"][1])


def test_kernel_wrapper_dispatch_on_cpu(boards):
    b, s = (torch.from_numpy(x) for x in boards)
    # a CPU tensor takes the plain version; the kernel itself refuses it
    assert torch.equal(TE.legal_mask_batch(b, s), TE.legal_mask(b, s))
    with pytest.raises(ValueError, match="CUDA"):
        TL.legal_mask_cuda(b, s)
