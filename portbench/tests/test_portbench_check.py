"""The check that decides ``correct``, on the CPU.

Its reference agrees with the program's own plain paths where they are
sound, and a run with the timed path broken underneath reads ``correct``
false: a step that returns its state unchanged, half of the batch left out,
a legal move or a policy target altered where it is produced. (The cells run
on one card, so no exchange between cards can be left out.)"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import inputs, program, run
from portbench.reference import resnet, rules

SEED = 2**31 + 777


def _random_positions(games: int, plies: int, seed: int):
    """Boards and sides of random playouts of the program's env, every ply."""
    from xiangqi_alphazero_torch.engine import env as E

    g = torch.Generator().manual_seed(seed)
    s = E.reset_batch(games)
    out = []
    for _ in range(plies):
        out.append((s.board.clone(), s.side.clone(), s.legal.clone()))
        u = torch.rand(s.legal.shape, generator=g)
        act = torch.where(s.legal, u, -1.0).argmax(dim=1)
        s = E.step_batch(s, act)
    return out


def test_rules_match_the_programs_plain_movegen():
    from xiangqi_alphazero_torch.engine import env as E

    for board, side, legal in _random_positions(24, 60, 5):
        for i in range(len(board)):
            want = torch.nonzero(legal[i])[:, 0].tolist()
            assert rules.legal_actions(board[i].tolist(), int(side[i])) == want
        feats = rules.features(board, side)
        assert torch.equal(feats, E.features(board, side))
        b, s = rules.decode_features(feats.numpy())
        assert np.array_equal(b, board.numpy()) and np.array_equal(s, side.numpy())


@pytest.mark.parametrize("train", [False, True])
def test_reference_net_matches_the_programs_in_float32(train):
    cfg = {"num_channels": 16, "num_res_blocks": 2, "dtype": "float32"}
    w = inputs.net_weights(16, 2, SEED, "cpu")
    net = program.build_net(cfg, w, "cpu").train(train)
    feats = rules.features(*_random_positions(32, 12, 9)[-1][:2])
    with torch.no_grad():
        logits, value = net(feats)
        r_logits, r_value = resnet.forward(w, feats, train)
    torch.testing.assert_close(logits, r_logits, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(value[:, 0], r_value, rtol=1e-5, atol=1e-5)


def _run(bench, workload):
    return run.run_cell(run.load_cell(workload, bench), SEED, 0.0, False, "cpu")


def _failed(out):
    return {k for k, c in out["compared"].items() if not c["value"] <= c["limit"]}


def test_learner_step_left_unchanged_fails(tiny_bench, monkeypatch):
    from xiangqi_alphazero_torch.train import learner

    def no_step(net, opt, *rows, norm=None):
        opt.zero_grad()
        m = learner.compute_loss(net, *rows, norm)
        return learner.TrainMetrics(*(x.detach() for x in m))

    monkeypatch.setattr(learner, "train_step", no_step)
    out = _run(tiny_bench, "learn.full256x10")
    assert out["correct"] is False
    assert out["compared"]["change_gap"]["value"] == pytest.approx(1.0)


def test_learner_half_batch_fails(tiny_bench, monkeypatch):
    from xiangqi_alphazero_torch.train import learner

    full = learner.compute_loss

    def half(net, boards, sides, acts, probs, z, w, norm=None, mesh=None):
        w = w.clone()
        w[len(w) // 2:] = 0.0
        return full(net, boards, sides, acts, probs, z, w, norm, mesh)

    monkeypatch.setattr(learner, "compute_loss", half)
    out = _run(tiny_bench, "learn.full256x10")
    assert out["correct"] is False and "head_grad_err" in _failed(out)


@pytest.mark.parametrize("workload", ["selfplay.full256x10", "selfplay.std128x6"])
def test_selfplay_step_left_unchanged_fails(tiny_bench, monkeypatch, workload):
    from xiangqi_alphazero_torch.engine import env as E

    monkeypatch.setattr(E, "step_batch", lambda state, action: state)
    out = _run(tiny_bench, workload)
    assert out["correct"] is False and "step_mismatch" in _failed(out)


@pytest.mark.parametrize("workload", ["selfplay.full256x10", "selfplay.std128x6"])
def test_selfplay_half_batch_fails(tiny_bench, monkeypatch, workload):
    """The net evaluates the first half of the batch and hands its outputs
    to the second half too."""
    from xiangqi_alphazero_torch.models import resnet as R

    full = R.XiangqiNet.forward

    def half(self, x):
        n = x.shape[0] // 2
        logits, value = full(self, x[:n])
        return logits.repeat(2, 1)[: x.shape[0]], value.repeat(2, 1)[: x.shape[0]]

    monkeypatch.setattr(R.XiangqiNet, "forward", half)
    out = _run(tiny_bench, workload)
    assert out["correct"] is False and {"policy_gap", "value_gap"} & _failed(out)


@pytest.mark.parametrize("workload", ["selfplay.full256x10", "selfplay.std128x6"])
def test_selfplay_legal_move_altered_fails(tiny_bench, monkeypatch, workload):
    """The legal mask drops each position's first legal move."""
    from xiangqi_alphazero_torch.ops import legal_mask as lm

    full = lm.legal_mask

    def drop_first(board, side):
        m = full(board, side).clone()
        first = m.to(torch.uint8).argmax(dim=1)
        m[torch.arange(len(m)), first] = False
        return m

    monkeypatch.setattr(lm, "legal_mask", drop_first)
    out = _run(tiny_bench, workload)
    assert out["correct"] is False and "legal_mismatch" in _failed(out)


def test_selfplay_policy_target_altered_fails(tiny_bench, monkeypatch):
    """PUCT's policy target moves a hundredth of its mass to its first slot."""
    from xiangqi_alphazero_torch.search import mcts as M

    full = M.action_probs_slots

    def altered(result, temperature):
        pi = full(result, temperature).clone()
        pi[:, 0] += 0.01
        return pi

    monkeypatch.setattr(M, "action_probs_slots", altered)
    out = _run(tiny_bench, "selfplay.std128x6")
    assert out["correct"] is False and "pi_mismatch" in _failed(out)


def _moved_one_legal_slot_on(x, valid):
    """Each row's values at its valid slots, each moved to the next valid slot."""
    out = x.clone()
    for b in range(len(x)):
        idx = torch.nonzero(valid[b])[:, 0]
        out[b, idx] = x[b, idx.roll(1)]
    return out


@pytest.mark.parametrize("workload", ["selfplay.full256x10", "selfplay.std128x6"])
def test_selfplay_search_target_moved_fails(tiny_bench, monkeypatch, workload):
    """The search's target stays a distribution over the legal slots, but
    of other moves: PUCT's visit counts and Gumbel's improved policy moved
    one legal slot on. Only the replay of the search sees it."""
    from xiangqi_alphazero_torch.search import gumbel as G
    from xiangqi_alphazero_torch.search import mcts as M

    run_mcts, run_gumbel = M.run_mcts, G.run_gumbel_mcts

    def puct(*args, **kw):
        r = run_mcts(*args, **kw)
        return r._replace(visits=_moved_one_legal_slot_on(r.visits, r.valid))

    def gumbel(*args, **kw):
        r = run_gumbel(*args, **kw)
        return r._replace(pi_improved=_moved_one_legal_slot_on(r.pi_improved, r.valid))

    monkeypatch.setattr(M, "run_mcts", puct)
    monkeypatch.setattr(G, "run_gumbel_mcts", gumbel)
    out = _run(tiny_bench, workload)
    assert out["correct"] is False and _failed(out) == {"search_mismatch"}


@pytest.mark.parametrize("workload", ["selfplay.full256x10", "selfplay.std128x6"])
def test_selfplay_backup_sign_flipped_fails(tiny_bench, monkeypatch, workload):
    """The backup adds each value with the wrong sign."""
    from xiangqi_alphazero_torch.search import mcts as M

    backup = M._backup
    monkeypatch.setattr(M, "_backup", lambda tree, pnode, pslot, depth, v:
                        backup(tree, pnode, pslot, depth, -v))
    out = _run(tiny_bench, workload)
    assert out["correct"] is False and _failed(out) == {"search_mismatch"}


def test_gumbel_search_ignoring_q_fails(tiny_bench, monkeypatch):
    """The Gumbel search reads every completed Q as 0: its halving, its
    interior rule and its improved policy follow the priors alone."""
    from xiangqi_alphazero_torch.search import gumbel as G

    monkeypatch.setattr(G, "_completed_q", lambda n, w, prior, valid, raw_value:
                        torch.zeros_like(w))
    out = _run(tiny_bench, "selfplay.full256x10")
    assert out["correct"] is False and _failed(out) == {"search_mismatch"}
