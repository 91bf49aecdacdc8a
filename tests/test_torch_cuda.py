"""Card-only checks of the PyTorch port, marked ``cuda``: the legal-mask
kernel against its plain version, the net, the search and the int8 twin
on the card against the CPU, and the serving path through the kernel. Each test asks
the ``cuda`` fixture whether a card is present, and skips without one.

This file imports no JAX, so it also runs where only the port is installed
(the root conftest imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from xiangqi_alphazero_torch.engine import env as E
from xiangqi_alphazero_torch.engine.edge_boards import edge_boards, wild_boards
from xiangqi_alphazero_torch.engine.oracle import Position
from xiangqi_alphazero_torch.models import XiangqiNet
from xiangqi_alphazero_torch.models import quant as Q
from xiangqi_alphazero_torch.ops import legal_mask as LM
from xiangqi_alphazero_torch.search import MCTSConfig, run_mcts
from xiangqi_alphazero_torch.serve import api as A
from xiangqi_alphazero_torch.serve import predictor as P

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _boards(dev, games: int = 64, plies: int = 30, seed: int = 0):
    """Boards of seeded random playouts every 5 plies, then the edge
    boards."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    st = E.reset_batch(games, device=dev)
    boards, sides = [], []
    for ply in range(plies):
        scores = torch.rand((games, E.ACTION_SPACE), generator=gen, device=dev)
        st = E.step_batch(st, torch.where(st.legal, scores, -1.0).argmax(dim=1))
        if ply % 5 == 4:
            boards.append(st.board)
            sides.append(st.side)
    edges = edge_boards().values()
    boards.append(torch.tensor(np.stack([b for b, _ in edges]), device=dev))
    sides.append(torch.tensor([s for _, s in edges], dtype=torch.int8, device=dev))
    return torch.cat(boards[::-1]), torch.cat(sides[::-1])


def _advance_random(plies: int, seed: int) -> Position:
    rng = np.random.default_rng(seed)
    pos = Position()
    for _ in range(plies):
        acts = pos.legal_actions()
        if pos.result()[0] or not acts:
            break
        pos.apply(int(rng.choice(acts)))
    fresh = Position()
    fresh.board, fresh.side = list(pos.board), pos.side
    return fresh


def test_kernel_matches_plain_on_card(cuda):
    """Bit-exact against the plain version on playout, edge and wild
    boards, at ragged batches around every boundary of the grid, with every
    split of a row over blocks, and at B = 16384 in one call; ~200 boards
    against the oracle. Each call moves the launch counter by one."""
    boards, sides = _boards(cuda)
    wild_b, wild_s = (torch.from_numpy(x).to(cuda) for x in wild_boards())
    mix_b, mix_s = torch.cat([wild_b, boards]), torch.cat([wild_s, sides])
    kern = LM.legal_mask_cuda

    def check(b, s, **kw):
        before = kern.launches
        got = kern(b.contiguous(), s.contiguous(), **kw)
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        for i in range(0, len(b), 2048):
            assert torch.equal(got[i:i + 2048], E.legal_mask(b[i:i + 2048], s[i:i + 2048])), (len(b), i, kw)
        return got

    for n in (1, 2, 3, 4, 5, 7, 8, 9, 15, 16, 17, 127, 128, 129, 2048):
        check(mix_b[:n], mix_s[:n])
    for split in (1, 2, 4, 8, 16, 32, 64):
        for n in (1, 9, 40):
            check(mix_b[:n], mix_s[:n], blocks_per_board=split)
    big = torch.arange(16384, device=cuda) % len(mix_b)
    check(mix_b[big], mix_s[big])
    idx = torch.linspace(0, len(boards) - 1, 200, device=cuda).long()
    got = check(boards[idx], sides[idx]).cpu()
    for row, i in enumerate(idx.tolist()):
        pos = Position()
        pos.board, pos.side = [int(x) for x in boards[i].tolist()], int(sides[i])
        assert set(torch.nonzero(got[row])[:, 0].tolist()) == set(pos.legal_actions()), i
    # the env on the card dispatches to the kernel
    before = kern.launches
    st = E.step_batch(E.reset_batch(4, device=cuda), torch.tensor([0, 1, 2, 3], device=cuda))
    assert st.legal.is_cuda and kern.launches == before + 2


@torch.no_grad()
def test_card_forward_matches_cpu(cuda):
    torch.manual_seed(6)
    net = XiangqiNet(32, 2).eval()
    x = torch.rand((8, 10, 9, 15), generator=torch.Generator().manual_seed(6))
    want_l, want_v = net(x)
    got_l, got_v = net.to(cuda)(x.to(cuda))
    # float32 on both sides, TF32 off; the sums run in other orders
    torch.testing.assert_close(got_l.cpu(), want_l, rtol=0, atol=1e-4)
    torch.testing.assert_close(got_v.cpu(), want_v, rtol=0, atol=1e-4)


def _dyadic_eval(feats):
    """Uniform 1/64 priors and value (own - opp) / 8: exact in float32 in
    any summation order, so the card and the CPU must choose alike."""
    own = feats[..., :7].sum(dim=(1, 2, 3))
    opp = feats[..., 7:14].sum(dim=(1, 2, 3))
    probs = torch.full((feats.shape[0], E.ACTION_SPACE), 1.0 / 64.0, device=feats.device)
    return probs, (own - opp) / 8.0


def test_card_search_equals_cpu(cuda):
    cases = [_advance_random(p, s) for p, s in [(0, 0), (9, 2), (23, 4), (40, 5)]]
    roots = E.cat_states([
        E.state_from_numpy(np.asarray(p.board, np.int8), p.side) for p in cases
    ])
    cfg = MCTSConfig(48)
    cpu = run_mcts(_dyadic_eval, roots, cfg, add_noise=False)
    card = run_mcts(_dyadic_eval, roots.to(cuda), cfg, add_noise=False)
    for f in ("visits", "actions", "order", "valid"):
        assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), f


def test_serving_path_on_card(cuda):
    sims = 12
    torch.manual_seed(0)
    pred = P.Predictor(XiangqiNet(16, 2).eval(), num_simulations=sims, device=cuda)
    assert all(p.is_cuda for p in pred.net.parameters())
    pos = Position()
    before = LM.legal_mask_cuda.launches
    out = pred.ai_move(pos.copy())
    assert LM.legal_mask_cuda.launches - before == 1 + sims
    assert out["ai_move"]["action"] in pos.legal_actions()
    svc = A.GameService(model_dirs=[], device=cuda)
    assert svc.models()[1]["device"] == torch.cuda.get_device_name(cuda)


@torch.no_grad()
@pytest.mark.parametrize("batch", [8, 40])
def test_int8_on_card_matches_cpu(cuda, batch):
    """The int8 twin through ``torch._int_mm`` on the card (M, K and N
    padded) against the same twin on the CPU: the first layer's int8
    activations and every int32 product exactly, logits within 1e-4 (both
    devices dequantize with the same elementwise float ops; the value
    head's small float denses sum in other orders)."""
    torch.manual_seed(7)
    net = XiangqiNet(32, 2).eval()
    boards, sides = _boards(cuda, games=batch, plies=10, seed=batch)
    feats = E.features(boards[-batch:], sides[-batch:])
    qc, qg = Q.quantize_net(net, device="cpu"), Q.quantize_net(net, device=cuda)
    pc = Q._im2col(feats.cpu()).reshape(batch * 90, -1)
    pg = Q._im2col(feats).reshape(batch * 90, -1)
    (ac, sc), (ag, sg) = Q._quant_act(pc), Q._quant_act(pg)
    assert torch.equal(ag.cpu(), ac) and torch.equal(sg.cpu(), sc)
    n = qc.stem.w_q.shape[1]
    assert torch.equal(Q._int8_matmul(ag, qg.stem.w_mm, n).cpu(), Q._int8_matmul(ac, qc.stem.w_mm, n))
    lc, vc = Q.int8_forward(qc, feats.cpu())
    lg, vg = Q.int8_forward(qg, feats)
    torch.testing.assert_close(lg.cpu(), lc, rtol=0, atol=1e-4)
    torch.testing.assert_close(vg.cpu(), vc, rtol=0, atol=1e-4)


@pytest.mark.parametrize("model_parallel", [1, 2])
def test_two_rank_step_on_card_matches_cpu(cuda, model_parallel):
    """Two ranks on one card (gloo, by the backend rule; pinned to one card
    where there are several), data-parallel or
    ``--model-parallel 2``: the global batch-norm Function and, under TP,
    the sharded loss and its all-reduces run on CUDA tensors. One step
    against the same 2-rank step on the CPU: losses within rtol 1e-5;
    Adam's first moment (0.1 x the reduced, clipped gradient) within 1e-4
    of each element plus 1e-4 of the largest, the measure that
    ``chip_smoke.py`` holds the card's float32 gradients to; parameters
    within 2 lr with at most 0.1% beyond 0.05 lr (Adam's first step moves
    each by about lr whatever its gradient); running statistics within
    atol 1e-6 + rtol 1e-5."""
    from xiangqi_alphazero_torch.models import init_net
    from xiangqi_alphazero_torch.parallel import probe

    net = init_net(torch.Generator().manual_seed(3), 16, 2)
    rng = np.random.default_rng(3)
    b = 32
    probs = rng.random((b, 8)).astype(np.float32)
    inputs = {"channels": np.array(16), "blocks": np.array(2),
              **{f"sd/{k}": v.numpy() for k, v in net.state_dict().items()},
              "boards": _boards(torch.device("cpu"), games=b, plies=20)[0][-b:].numpy(),
              "sides": np.where(rng.random(b) < 0.5, 1, -1).astype(np.int8),
              "pi_actions": rng.integers(0, 8100, (b, 8), dtype=np.int32),
              "pi_probs": probs / probs.sum(1, keepdims=True),
              "z": rng.choice(np.array([-1.0, 0.0, 1.0], np.float32), b),
              "w": np.ones(b, np.float32), "lr": np.array(1e-3), "wd": np.array(1e-4)}
    one_card = {"CUDA_VISIBLE_DEVICES": os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]}
    (card,), logs = probe.launch([("step", inputs)], 2, model_parallel, device="cuda",
                                 env=one_card)
    assert all("backend gloo" in log for log in logs), logs
    (cpu,), _ = probe.launch([("step", inputs)], 2, model_parallel, device="cpu")
    np.testing.assert_allclose(card["losses"], cpu["losses"], rtol=1e-5)
    far = total = 0
    scale = max(np.abs(w).max() for k, w in cpu.items() if k.startswith("mu/"))
    for k, w in cpu.items():
        if k.startswith("mu/"):
            np.testing.assert_allclose(card[k], w, rtol=1e-4, atol=1e-4 * scale, err_msg=k)
        elif "running" in k:
            np.testing.assert_allclose(card[k], w, atol=1e-6, rtol=1e-5, err_msg=k)
        elif k.startswith("sd/") and "num_batches" not in k:
            d = np.abs(card[k] - w)
            assert d.max() <= 2e-3, k
            far, total = far + int((d > 5e-5).sum()), total + d.size
    assert far <= 1e-3 * total, (far, total)
