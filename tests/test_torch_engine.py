"""The PyTorch port's engine against the JAX package, bit for bit: the
tables, the oracle, the batched env over random playouts, and the legal
mask (the plain version against the JAX XLA path and the Pallas kernel in
interpret mode, also on wild boards no game reaches). The CUDA kernel's
candidate tables and launch plan are checked here, and its candidate walk
is emulated in numpy against the plain version; the card-only checks are
in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xiangqi_alphazero_torch.engine import env as TE
from xiangqi_alphazero_torch.engine import oracle as TO
from xiangqi_alphazero_torch.engine import tables as TT
from xiangqi_alphazero_torch.engine.edge_boards import edge_boards, wild_boards
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


def test_opening_action_44_steps_as_jax():
    """The profiling harness (``utils/benchmark.py``) steps every board of
    the opening with action 44 (square 0 -> 44: the red rook to an empty
    square it cannot reach), as the JAX harness does: JAX ``v_step`` applies
    it without a check, and so does the port."""
    want = jax.jit(JE.v_step)(JE.reset_batch_jit(8), jnp.full((8,), 44, jnp.int32))
    got = TE.step_batch(TE.reset_batch(8), torch.full((8,), 44, dtype=torch.int32))
    for f in _ENV_FIELDS:
        assert np.array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f))), f
    assert got.board[0, 44] == 5 and got.board[0, 0] == 0 and (got.side == -1).all()


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


# ---------------------------------------------------------------------------
# The kernel's candidate tables, launch plan and candidate walk, on the CPU
# ---------------------------------------------------------------------------

_FM_SQ = np.array([(q % 10) * 9 + q // 10 for q in range(90)])   # file-major -> square


def _decode(e):
    """(destination, blocker squares) of one candidate-table entry."""
    e = int(e)
    lo, hi = (e >> 8) & 127, (e >> 16) & 127
    idx = np.arange(lo, hi)
    return e & 127, (_FM_SQ[idx] if (e >> 24) & 1 else idx)


@pytest.mark.parametrize("c", range(len(TL.CLASSES)))
def test_kernel_constants_rebuild_the_tables(c):
    """Class c's candidate lists give exactly its geometry table's actions,
    each once, with exactly that action's BLOCK column as blockers."""
    key, side = TL.CLASSES[c]
    t = TT.tables()
    table = TL.action_constants()[c]
    geom = np.zeros(TE.ACTION_SPACE, bool)
    block = np.zeros((90, TE.ACTION_SPACE), np.int8)
    for f in range(90):
        used = table[f] != TL.EMPTY
        assert not used[used.argmin():].any() or used.all()   # entries first, then EMPTY
        for e in table[f][used]:
            to, squares = _decode(e)
            a = f * 90 + to
            assert not geom[a], a
            geom[a] = True
            block[squares, a] = 1
    want = t[key] if side is None else t[key][side]
    assert np.array_equal(geom, want)
    assert np.array_equal(block[:, want], t["BLOCK"][:, want])
    assert not block[:, ~want].any()


@pytest.mark.parametrize("batch", [1, 2, 3, 4, 5, 7, 8, 9, 127, 128, 129, 2048, 16384])
def test_launch_plan_covers_every_action_once(batch):
    """The default plan, and every split the wrapper accepts, give each
    (board, action) to exactly one block, in 16-byte-aligned chunks."""
    plans = [TL.launch_plan(batch)] + [TL.launch_plan(batch, s) for s in (1, 2, 4, 8, 16, 32, 64)]
    for plan in plans:
        board, lo, hi = TL.block_ranges(batch, plan)
        assert len(board) == plan.grid(batch) and plan.chunk % 16 == 0
        order = np.lexsort((lo, board))
        board, lo, hi = board[order], lo[order], hi[order]
        assert np.array_equal(np.unique(board), np.arange(batch))
        first = np.r_[True, board[1:] != board[:-1]]
        last = np.r_[board[1:] != board[:-1], True]
        assert (lo[first] == 0).all() and (hi[last] == TE.ACTION_SPACE).all()
        assert np.array_equal(lo[~first], hi[np.flatnonzero(~first) - 1])
        assert (hi - lo >= 16).all() and (lo % 16 == 0).all()
        assert int((hi - lo).sum()) == batch * TE.ACTION_SPACE
    with pytest.raises(ValueError):
        TL.launch_plan(batch, 3)


def _kernel_walk(board: np.ndarray, side: int) -> np.ndarray:
    """csrc/legal_mask.cu's algorithm restated in numpy for one board: the
    flat list of the candidate-table entries of the side to move's pieces,
    blocker counts from the entries' bit ranges (prefix sums standing in for
    the popcounts), and king safety from the fixed enemy slots (the first 2
    rooks, 2 cannons, the king, 2 horses and 5 pawns, in square order) as
    the kernel's per-square bits: for a king move, the palace square
    attacked once the king has left; for any other move, each slot's screen
    count against where it stands and the move's effect on it."""
    t = TT.tables()
    s, si = int(side), int(side < 0)
    out = np.zeros(TE.ACTION_SPACE, bool)
    kings = np.flatnonzero(board == s)
    if not len(kings):
        return out
    k = kings[0]
    occ = board != 0
    prefix = (np.r_[0, np.cumsum(occ)], np.r_[0, np.cumsum(occ[_FM_SQ])])
    own = np.flatnonzero(board * s > 0)
    kind = board[own] * s
    cls = np.select([kind == 1, kind == 2, kind == 3, kind == 7, kind == 4],
                    [si, 2 + si, 4 + si, 6 + si, 8], 9)
    e = TL.action_constants()[cls, own].astype(np.int64)
    f = np.repeat(own, TL.CAP)[e.ravel() != TL.EMPTY]
    e = e.ravel()[e.ravel() != TL.EMPTY]
    to, lo, hi, fm = e & 127, (e >> 8) & 127, (e >> 16) & 127, (e >> 24) & 1
    nb = np.where(fm == 1, prefix[1][hi] - prefix[1][lo], prefix[0][hi] - prefix[0][lo])
    pt = board[to].astype(np.int64)
    cannon = board[f] * s == 6
    pseudo = (pt * s <= 0) & np.where(
        cannon, ((nb == 0) & (pt == 0)) | ((nb == 1) & (pt * s < 0)), nb == 0)
    f, to, pt = f[pseudo], to[pseudo], pt[pseudo]

    # per-square bits and per-slot flags, as the kernel's phase B builds them
    between = np.zeros((5, 90), bool)      # strictly between ray slot j and k
    leg = np.zeros((2, 90), bool)          # leg of horse slot h toward k
    held = np.full(90, -1)                 # slot on each square
    ray_pre, screens, want = np.zeros(5, bool), np.zeros(5, int), np.array([0, 0, 1, 1, 0])
    horse_geom, leg_empty, pawn_pre = np.zeros(2, bool), np.zeros(2, bool), np.zeros(5, bool)
    palace_unsafe = np.zeros(90, bool)
    slots = [(code, j) for code, n in ((5, 2), (6, 2), (1, 1), (4, 2), (7, 5)) for j in range(n)]
    for i, (code, j) in enumerate(slots):
        found = np.flatnonzero(board == -code * s)
        if j >= len(found):
            continue
        x = found[j]
        held[x] = i
        if i < 5 and t["ALIGNED_SQ"][x, k]:
            ray_pre[i], between[i] = True, t["BTW"][x, k] == 1
            screens[i] = occ[between[i]].sum()
        elif 5 <= i < 7 and t["HORSE_PAIR"][x, k]:
            horse_geom[i - 5] = True
            leg[i - 5, t["KLEG"][x, k]] = True
            leg_empty[i - 5] = not occ[t["KLEG"][x, k]]
        elif i >= 7:
            pawn_pre[i - 7] = t["PAWN_ATK"][1 - si, x, k]
        for pj in t["PALACE_SQ"][si]:          # the king steps to pj
            if pj == x:
                continue
            after = occ.copy()
            after[k], after[pj] = False, True
            if i < 5:
                hit = t["ALIGNED_SQ"][x, pj] and after[t["BTW"][x, pj] == 1].sum() == want[i]
            elif i < 7:
                hit = t["HORSE_PAIR"][x, pj] and not after[t["KLEG"][x, pj]]
            else:
                hit = t["PAWN_ATK"][1 - si, x, pj]
            palace_unsafe[pj] |= hit
    bf = between[:, f]                                   # [5, m]
    bt = between[:, to] & (pt == 0)
    alive = held[to][None, :] != np.arange(12)[:, None]  # [12, m]: slot not captured
    delta = bt.astype(int) - bf.astype(int)
    rays = (ray_pre[:, None] & alive[:5] & (screens[:, None] + delta == want[:, None])).any(axis=0)
    horses = (horse_geom[:, None] & alive[5:7] & ~leg[:, to]
              & (leg[:, f] | leg_empty[:, None])).any(axis=0)
    pawns = (pawn_pre[:, None] & alive[7:]).any(axis=0)
    safe = np.where(f == k, ~palace_unsafe[to], ~(rays | horses | pawns))
    out[(f * 90 + to)[safe]] = True
    return out


@pytest.mark.parametrize("which", ["playout_and_edge", "wild"])
def test_kernel_walk_matches_plain(boards, which):
    b_np, s_np = boards if which == "playout_and_edge" else wild_boards()
    want = TE.legal_mask(torch.from_numpy(b_np), torch.from_numpy(s_np)).numpy()
    got = np.stack([_kernel_walk(b, s) for b, s in zip(b_np, s_np)])
    assert np.array_equal(got, want) and want.any()


def test_wild_boards_plain_mask_matches_jax_xla():
    """Piece sets no game reaches: the plain mask keeps the JAX package's
    slot truncation exactly (one compile of the vmapped JAX mask)."""
    b_np, s_np = wild_boards()
    s = s_np.astype(np.int64)[:, None]
    assert ((b_np == -5 * s).sum(axis=1) >= 3).any() and ((b_np == -7 * s).sum(axis=1) >= 3).any()
    kings = (b_np == s).sum(axis=1)
    assert (kings == 0).any() and (kings >= 2).any()
    want = np.asarray(jax.jit(jax.vmap(JE.legal_mask))(jnp.asarray(b_np), jnp.asarray(s_np)))
    got = TE.legal_mask(torch.from_numpy(b_np), torch.from_numpy(s_np)).numpy()
    assert np.array_equal(got, want) and want.sum() > 100


def test_kernel_wrapper_dispatch_on_cpu(boards):
    b, s = (torch.from_numpy(x) for x in boards)
    # a CPU tensor takes the plain version; the kernel itself refuses it
    assert torch.equal(TE.legal_mask_batch(b, s), TE.legal_mask(b, s))
    with pytest.raises(ValueError, match="CUDA"):
        TL.legal_mask_cuda(b, s)


def test_long_horizon_terminal_rules_match_jax():
    """The quiet >= 120 draw (and a capture resetting the count), the
    ply >= 200 material adjudication (red, black, draw), the 3-in-12
    repetition draw and its window expiry, on the boards of
    ``tests/test_terminal_rules.py``: one batch stepped by the port and by
    JAX ``v_step``, every field equal after every ply. Lanes past their
    script play their first legal move."""
    def sq(r, c):
        return r * 9 + c

    def act(f, t):
        return f * 90 + t

    def kings(*extra):
        b = np.zeros(90, np.int8)
        b[sq(0, 3)], b[sq(9, 5)] = 1, -1
        for s, piece in extra:
            b[s] = piece
        return b

    init = np.asarray(JE.reset_jit().board)
    shuttle = [act(sq(0, 0), sq(1, 0)), act(sq(9, 0), sq(8, 0)),
               act(sq(1, 0), sq(0, 0)), act(sq(8, 0), sq(9, 0))]
    other = [act(sq(0, 8), sq(1, 8)), act(sq(9, 8), sq(8, 8)), act(sq(1, 8), sq(2, 8)),
             act(sq(8, 8), sq(7, 8)), act(sq(2, 8), sq(1, 8)), act(sq(7, 8), sq(8, 8))]
    lanes = [  # (board, ply, quiet, script)
        (kings((sq(4, 0), 5), (sq(5, 8), -5)), 150, 119, [act(sq(4, 0), sq(4, 1))]),
        (kings((sq(4, 0), 5), (sq(4, 8), -5)), 150, 119, [act(sq(4, 0), sq(4, 8))]),
        (kings((sq(4, 0), 5)), 199, 10, []),
        (kings((sq(5, 8), -5)), 199, 10, []),
        (kings(), 199, 10, []),
        (init, 0, 0, shuttle * 3),
        (init, 0, 0, shuttle * 2 + other),
    ]
    js = jax.tree.map(lambda *x: jnp.stack(x),
                      *[JE.state_from_numpy(b, 1, p, q) for b, p, q, _ in lanes])
    ts = TE.cat_states([TE.state_from_numpy(b, 1, p, q) for b, p, q, _ in lanes])
    step = jax.jit(JE.v_step)
    done_at = []
    for ply in range(15):
        for f in _ENV_FIELDS:
            assert np.array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f))), \
                f"{f} differs at ply {ply}"
        done_at.append(ts.done.numpy().copy())
        legal = np.asarray(js.legal)
        acts = [script[ply] if ply < len(script) else
                (int(np.flatnonzero(legal[i])[0]) if legal[i].any() else 0)
                for i, (_, _, _, script) in enumerate(lanes)]
        js = step(js, jnp.asarray(acts, jnp.int32))
        ts = TE.step_batch(ts, torch.tensor(acts))
    done_at = np.array(done_at)   # [ply, lane]: done before that ply's move
    assert done_at[1].tolist() == [True, False, True, True, True, False, False]
    assert ts.winner[[0, 2, 3, 4]].tolist() == [0, 1, -1, 0]   # frozen since ply 1
    assert done_at[:, 5].tolist() == [False] * 12 + [True] * 3   # the draw at ply 12
    assert not done_at[:, 6].any()                              # the window expired
