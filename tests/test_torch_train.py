"""The port's training layer against the JAX package's, on the CPU, at 8
channels x 1 block: config presets field for field, the replay ring
exactly, the learner within stated tolerances, and the port's trainer on
its own (two iterations, a bit-identical resume, the CLI in process, the
trained ``best_model.pt`` served by the port's ``Predictor``).

Learner tolerances (float32 on the CPU, sums taken in other orders by XLA
and torch):
- losses: rtol 1e-5 at the first step; rtol 1e-4 at the later steps of a
  plan, whose parameters already differ within the bound below;
- gradients: atol 1e-6 + rtol 1e-4 of each element (the largest are ~1e-1);
- batch-norm running statistics: atol 1e-6 + rtol 1e-5 (a few float32
  ulps of values near 1, after five steps);
- parameters after Adam steps: every element within atol lr, and all but
  0.1% of them within 0.05 x lr. Adam's first steps move a parameter by up
  to lr whatever its gradient's size: where the gradient (weight decay
  included) is near Adam's eps = 1e-8, as it is for most of the policy
  head's rows of untargeted actions, a difference in its low bits moves
  the parameter by a visible fraction of lr. A step of the wrong sign or
  size on a real gradient breaks the second bound.
- the clip divides by the global norm, as optax's does, and sums the
  squares pairwise (torch's float32 ``vector_norm`` on the CPU reads the
  23M-element policy head's norm ~1e-3 low).
"""

import dataclasses
import functools
import json
import os
import shutil

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from xiangqi_alphazero_torch.models import (
    XiangqiNet,
    init_net,
    state_dict_from_jax,
)
from xiangqi_alphazero_torch.train import config as TC
from xiangqi_alphazero_torch.train import learner as TL
from xiangqi_alphazero_torch.train import replay as TR
from xiangqi_alphazero_tpu.models import XiangqiNet as JaxNet
from xiangqi_alphazero_tpu.train import config as JC
from xiangqi_alphazero_tpu.train import learner as JL
from xiangqi_alphazero_tpu.train import replay as JR

CH, BL, K = 8, 1, 128
LR, WD = 2e-3, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread, so parallel test workers
    do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ config


@pytest.mark.parametrize("mode", sorted(JC.PRESETS))
def test_presets_equal_field_for_field(mode):
    assert dataclasses.asdict(TC.PRESETS[mode]()) == dataclasses.asdict(JC.PRESETS[mode]())
    cfg = TC.PRESETS[mode]()
    for it in (0, 49, 50, 79, 80, 200):
        assert cfg.lr_at(it) == JC.PRESETS[mode]().lr_at(it)


def test_cli_overrides_and_unported_flags_raise():
    argv = ["--mode", "quick", "--iterations", "3", "--channels", "16", "--epochs", "2",
            "--temp-schedule", "anneal", "--playout-cap-prob", "0.5"]
    got, _ = TC.config_from_args(TC.build_argparser().parse_args(argv + ["--device", "cpu"]))
    want, _ = JC.config_from_args(JC.build_argparser().parse_args(argv))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert TC.build_argparser().parse_args([]).device == "cuda"
    # the Gumbel search's flags take effect, as in the JAX CLI
    flags = ["--search-algo", "gumbel", "--max-considered", "4"]
    got, _ = TC.config_from_args(TC.build_argparser().parse_args(argv + flags))
    want, _ = JC.config_from_args(JC.build_argparser().parse_args(argv + flags))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.search_algo, got.max_considered) == ("gumbel", 4)
    # the multi-device and supervisor flags set the JAX CLI's fields
    flags = ["--auto-restart", "2", "--model-parallel", "2", "--num-processes", "2",
             "--coordinator", "localhost:1234", "--process-id", "1", "--mesh-mode", "off"]
    got, _ = TC.config_from_args(TC.build_argparser().parse_args(argv + flags))
    want, _ = JC.config_from_args(JC.build_argparser().parse_args(argv + flags))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.model_parallel, got.num_processes, got.coordinator_address,
            got.process_id) == (2, 2, "localhost:1234", 1)
    # the one option without a counterpart still raises
    with pytest.raises(SystemExit):   # no counterpart: the flag is not offered
        TC.build_argparser().parse_args(["--train-segment", "4"])
    cfg = TC.quick_config()
    cfg.train_segment_batches = 4
    with pytest.raises(NotImplementedError, match="TPU program"):
        TC.check_supported(cfg)
    TC.check_supported(TC.quick_config())


# ------------------------------------------------------------ replay


def _samples(n: int, seed: int, value_only=()):
    """Seeded compact samples: boards of random pieces, 1-6 pi slots per
    row (the rest -1), and all-zero pi rows at ``value_only``."""
    rng = np.random.default_rng(seed)
    boards = rng.integers(-7, 8, (n, 90)).astype(np.int8)
    sides = rng.choice(np.array([-1, 1], np.int8), n)
    acts = np.full((n, K), -1, np.int32)
    probs = np.zeros((n, K), np.float32)
    for i in range(n):
        m = int(rng.integers(1, 7))
        acts[i, :m] = rng.choice(8100, m, replace=False)
        if i not in value_only:
            p = rng.random(m).astype(np.float32)
            probs[i, :m] = p / p.sum()
    z = rng.choice(np.array([-1.0, 0.0, 1.0], np.float32), n)
    return boards, sides, acts, probs, z


def test_replay_add_plan_and_state_match_jax():
    data = _samples(40, seed=1)
    tb, jb = TR.ReplayBuffer(64, K), JR.ReplayBuffer(64, K)
    for lo, hi in ((0, 25), (25, 40)):   # 80 rows with mirrors: the ring wraps
        assert tb.add_games(*(x[lo:hi] for x in data)) == jb.add_games(*(x[lo:hi] for x in data))
    assert (len(tb), tb._pos) == (len(jb), jb._pos) == (64, 16)
    for a, b in zip(tb.arrays(), jb.arrays()):
        assert np.array_equal(a, b)
    for bs, epochs in ((16, 2), (24, 1), (64, 3)):
        tp, tw, ts = tb.epoch_plan(bs, epochs, np.random.default_rng(5))
        jp, jw, js = jb.epoch_plan(bs, epochs, np.random.default_rng(5))
        assert ts == js == tp.shape[0]
        assert np.array_equal(tp, jp[:ts]) and np.array_equal(tw, jw[:ts])
        assert not jw[ts:].any()   # JAX's extra steps are all padding
    for t, j in zip(tb.epoch_batches(24, np.random.default_rng(6)),
                    jb.epoch_batches(24, np.random.default_rng(6))):
        for a, b in zip(t, j):
            assert np.array_equal(a, b)
    # state dicts cross over both ways, and into smaller rings
    for cap in (64, 20):
        t2, j2 = TR.ReplayBuffer(cap, K), JR.ReplayBuffer(cap, K)
        t2.load_state(jb.state_dict())
        j2.load_state(tb.state_dict())
        for a, b in zip(t2.arrays(), j2.arrays()):
            assert np.array_equal(a, b)
        assert {k: np.asarray(v).tolist() for k, v in t2.state_dict().items()} == \
               {k: np.asarray(v).tolist() for k, v in j2.state_dict().items()}


# ------------------------------------------------------------ net and learner


@functools.lru_cache(maxsize=None)
def _jax_init(seed: int):
    """``init_net``'s variables, initialized under one jit (eager flax init
    compiles each initializer alone)."""
    net = JaxNet(channels=CH, blocks=BL)
    variables = jax.jit(lambda k: net.init(k, jnp.zeros((1, 10, 9, 15)), train=False))(
        jax.random.key(seed))
    return net, jax.tree.map(np.asarray, variables)


def _jax_vars(seed: int):
    """init_net's net and (a fresh copy of) its variables as numpy."""
    net, variables = _jax_init(seed)
    return net, jax.tree.map(np.copy, variables)


def _port_net(variables) -> XiangqiNet:
    net = XiangqiNet(CH, BL)
    net.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"], BL))
    return net.train()


def _port_dict(params, batch_stats):
    """A flax (params, batch_stats) pair in the port's state-dict layout."""
    return {k: v.numpy() for k, v in state_dict_from_jax(
        jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, batch_stats), BL
    ).items() if not k.endswith("num_batches_tracked")}


def _assert_params_close(net, want: dict, atol: float, rtol: float = 0.0):
    got = net.state_dict()
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, rtol=rtol, atol=atol, err_msg=k)


def _assert_stepped_params_close(net, want: dict):
    """Parameters after Adam steps (see the module doc); batch-norm running
    statistics at atol 1e-6 + rtol 1e-5."""
    _assert_params_close(net, {k: v for k, v in want.items() if "running" in k}, 1e-6, 1e-5)
    params = {k: v for k, v in want.items() if "running" not in k}
    _assert_params_close(net, params, LR)
    got = net.state_dict()
    far = sum(int((np.abs(got[k].numpy() - w) > 0.05 * LR).sum()) for k, w in params.items())
    total = sum(w.size for w in params.values())
    assert far <= 1e-3 * total, (far, total)


def test_batchnorm_running_stats_equal_flax():
    """One train-mode forward moves the running mean and variance exactly
    as flax does (biased batch variance), not as torch's own layer would."""
    jnet, variables = _jax_vars(0)
    x = np.random.default_rng(0).random((6, 10, 9, 15)).astype(np.float32)
    _, mut = jax.jit(lambda v, x: jnet.apply(v, x, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    net = _port_net(variables)
    net(torch.from_numpy(x))
    want = _port_dict(variables["params"], mut["batch_stats"])
    got = net.state_dict()
    for k in want:
        if "running" in k:
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    # torch's own layer would have moved the variance n / (n - 1) further
    plain = torch.nn.BatchNorm2d(CH, momentum=0.1).train()
    y = net.input_conv[0](torch.from_numpy(x).permute(0, 3, 1, 2)).detach()
    plain(y)
    assert not torch.allclose(plain.running_var, got["input_conv.1.running_var"], atol=1e-6)


def _capture_grads():
    """An optax transform that returns zero updates and keeps the incoming
    gradients as its state: the JAX step's own gradients, read back."""
    zeros = lambda t: jax.tree.map(jnp.zeros_like, t)  # noqa: E731
    return optax.GradientTransformation(zeros, lambda g, s, p=None: (zeros(g), g))


def test_train_step_matches_jax():
    jnet, variables = _jax_vars(0)
    batch = _samples(24, seed=2, value_only=(3, 7))
    w = np.ones(24, np.float32)
    w[20:] = 0.0   # a padded partial batch
    jbatch = [jnp.asarray(x) for x in (*batch, w)]
    tbatch = [torch.from_numpy(x) for x in (*batch, w)]
    step = jax.jit(JL.train_step_impl, static_argnums=(0, 1))

    cap = _capture_grads()
    _, _, jgrads, _ = step(jnet, cap, variables["params"], variables["batch_stats"],
                           cap.init(variables["params"]), *jbatch)
    tx = JL.make_optimizer(LR, WD)
    params, stats, _, metrics = step(jnet, tx, variables["params"], variables["batch_stats"],
                                     tx.init(variables["params"]), *jbatch)

    net = _port_net(variables)
    m = TL.compute_loss(net, *tbatch)
    m.total_loss.backward()
    np.testing.assert_allclose(
        [m.policy_loss.item(), m.value_loss.item(), m.total_loss.item()],
        [float(metrics.policy_loss), float(metrics.value_loss), float(metrics.total_loss)],
        rtol=1e-5,
    )
    want_g = _port_dict(jgrads, variables["batch_stats"])
    for k, p in net.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[k], rtol=1e-4, atol=1e-6, err_msg=k)

    net = _port_net(variables)
    opt = TL.make_optimizer(net.parameters(), LR, WD)
    TL.train_step(net, opt, *tbatch)
    want = _port_dict(params, stats)
    _assert_stepped_params_close(net, want)


def test_train_epochs_plan_matches_jax():
    """A 5-step plan: 72 rows at batch 16 (the fifth batch padded from 8),
    value-only rows among them, after a learning-rate change."""
    jnet, variables = _jax_vars(0)
    data = _samples(36, seed=3, value_only=(0, 5, 11, 30))
    tb, jb = TR.ReplayBuffer(80, K), JR.ReplayBuffer(80, K)
    tb.add_games(*data)
    jb.add_games(*data)
    perm, wmask, steps = tb.epoch_plan(16, 1, np.random.default_rng(7))
    jperm, jwmask, jsteps = jb.epoch_plan(16, 1, np.random.default_rng(7))
    assert steps == jsteps == 5 and wmask[4].sum() == 8

    tx = JL.make_optimizer(LR, WD)
    opt_state = JL.set_learning_rate(tx.init(variables["params"]), LR / 2)
    params, stats, _, jlosses = JL.make_train_epochs(jnet, tx)(
        variables["params"], variables["batch_stats"], opt_state,
        *(jnp.asarray(x) for x in jb.arrays()), jnp.asarray(jperm), jnp.asarray(jwmask))

    net = _port_net(variables)
    opt = TL.set_learning_rate(TL.make_optimizer(net.parameters(), LR, WD), LR / 2)
    losses = TL.train_epochs(net, opt, tb.arrays(), perm, wmask)
    jlosses = np.asarray(jlosses)
    np.testing.assert_allclose(losses.numpy()[0], jlosses[0], rtol=1e-5)
    np.testing.assert_allclose(losses.numpy(), jlosses[:steps], rtol=1e-4)
    want = _port_dict(params, stats)
    _assert_stepped_params_close(net, want)


def test_init_net_has_flax_distributions():
    before = torch.random.get_rng_state()
    net = init_net(torch.Generator().manual_seed(0), CH, BL)
    again = init_net(torch.Generator().manual_seed(0), CH, BL)
    assert torch.equal(torch.random.get_rng_state(), before)   # the global RNG is untouched
    assert all(torch.equal(a, b) for a, b in zip(net.state_dict().values(),
                                                 again.state_dict().values()))
    _, variables = _jax_vars(0)
    want = state_dict_from_jax(variables["params"], variables["batch_stats"], BL)
    for k, v in net.state_dict().items():
        w = want[k]
        assert v.shape == w.shape, k
        if k.endswith("weight") and v.dim() > 1:
            # truncated at 2 standard deviations of the untruncated normal
            bound = 2 * np.sqrt(1 / v[0].numel()) / 0.87962566103423978
            assert v.abs().max() <= bound * (1 + 1e-6), k
            if v.numel() >= 1000:   # the std matches flax's within sampling error
                np.testing.assert_allclose(v.std().item(), w.std().item(), rtol=0.1, err_msg=k)
        else:   # biases, batch-norm scales, statistics: flax's constants
            assert torch.equal(v.float(), w.float()), k


# ------------------------------------------------------------ the trainer


def _tiny_cfg(ckpt_dir, **kw) -> TC.TrainingConfig:
    cfg = TC.TrainingConfig(
        num_channels=CH, num_res_blocks=BL, num_simulations=4, num_games_per_iter=2,
        max_game_length=8, temperature_threshold=4, random_opening_moves=2,
        resign_threshold=-0.95, num_iterations=2, batch_size=32, num_epochs=1,
        min_buffer_size=8, eval_games=2, eval_simulations=4, eval_interval=2,
        save_interval=1, checkpoint_dir=str(ckpt_dir), dtype="float32",
        max_buffer_size=256, seed=3,
    )
    return dataclasses.replace(cfg, **kw)


def _state(trainer):
    return {
        "params": {k: v.clone() for k, v in trainer.net.state_dict().items()},
        "best": {k: v.clone() for k, v in trainer.best_net.state_dict().items()},
        "opt": trainer.opt.state_dict(),
        "replay": {k: np.array(v) for k, v in trainer.buffer.state_dict().items()},
        "rng": trainer.rng.get_state(),
        "np_rng": trainer.np_rng.bit_generator.state,
    }


def _assert_tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}/{i}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    elif isinstance(a, np.ndarray):
        assert np.array_equal(a, b), path
    else:
        assert a == b, path


def _without_times(stats):
    if isinstance(stats, dict):
        return {k: _without_times(v) for k, v in stats.items() if k != "time"}
    if isinstance(stats, list):
        return [_without_times(s) for s in stats]
    return stats


@pytest.fixture(scope="module")
def two_iterations(tmp_path_factory):
    """(trainer, its checkpoint directory) after a two-iteration CPU run."""
    from xiangqi_alphazero_torch.train.trainer import AlphaZeroTrainer

    d = tmp_path_factory.mktemp("two_iterations") / "full"
    full = AlphaZeroTrainer(_tiny_cfg(d), device="cpu")
    full.train()
    return full, d


def test_trainer_two_iterations_and_bit_identical_resume(two_iterations, tmp_path):
    from xiangqi_alphazero_torch.train.trainer import AlphaZeroTrainer

    full, src = two_iterations
    stats = json.load(open(src / "training_stats.json"))
    assert [s["iteration"] for s in stats] == [1, 2]
    assert stats[0]["training"]["batches"] >= 1 and stats[1]["evaluation"]["plies"] >= 1
    assert full.total_games == 4
    assert os.path.exists(src / "checkpoint_iter1.replay.npz")

    # a fresh trainer resumes iteration 1's checkpoint and plays iteration 2
    dst = tmp_path / "resumed"
    dst.mkdir()
    for name in ("checkpoint_iter1", "checkpoint_iter1.replay.npz", "training_stats.json"):
        shutil.copy(src / name, dst / name)
    resumed = AlphaZeroTrainer(_tiny_cfg(dst), device="cpu")
    resumed.restore(str(dst / "checkpoint_iter1"))
    assert resumed.iteration == 1 and len(resumed.training_stats) == 1
    resumed.train()
    _assert_tree_equal(_state(resumed), _state(full))
    assert resumed.total_games == full.total_games
    assert _without_times(resumed.training_stats) == _without_times(full.training_stats)


def test_training_checkpoint_serves_as_its_best_model(two_iterations, tmp_path):
    """``Predictor.load`` serves a port ``checkpoint_iter{N}`` (its best net,
    with its topology): the checkpoint of the two-iteration CPU run gives
    the same searches and AI moves as its ``best_model.pt``, and ``serve
    export`` writes it to the same ``.pt``."""
    from xiangqi_alphazero_torch.engine.oracle import Position
    from xiangqi_alphazero_torch.serve.__main__ import main as serve_main
    from xiangqi_alphazero_torch.serve.predictor import Predictor

    _, d = two_iterations
    ckpt, best = str(d / "checkpoint_iter2"), str(d / "best_model.pt")
    a = Predictor.load(ckpt, num_simulations=8, device="cpu")
    b = Predictor.load(best, num_simulations=8, device="cpu")
    assert (a.net.channels, a.net.blocks) == (CH, BL)
    for (k, x), y in zip(a.net.state_dict().items(), b.net.state_dict().values()):
        assert torch.equal(x, y), k
    pa, pb = Position(), Position()
    for _ in range(3):
        for x, y in zip(a.search_position(pa), b.search_position(pb)):
            np.testing.assert_array_equal(x, y)
        assert a.ai_move(pa)["ai_move"] == b.ai_move(pb)["ai_move"]
    assert pa.board == pb.board

    out = str(tmp_path / "exported.pt")
    assert serve_main(["export", "--checkpoint", ckpt, "--format", "torch", "--output", out,
                       "--device", "cpu"]) == 0
    got = torch.load(out, weights_only=True)
    want = torch.load(best, weights_only=True)
    assert got["config"] == want["config"]
    for k, v in want["model_state_dict"].items():
        assert torch.equal(got["model_state_dict"][k], v), k


def test_find_models_lists_training_checkpoints_and_api_serves_one(two_iterations):
    """``find_models`` lists a training directory's ``best_model.pt`` and
    each ``checkpoint_iter{N}`` (not their ``.replay.npz`` rings), as the
    JAX ``find_models`` lists ``best_model`` and ``checkpoint_iter*``; the
    API loads a checkpoint by its name and answers a move with it."""
    from xiangqi_alphazero_torch.engine.oracle import Position
    from xiangqi_alphazero_torch.serve import api as TA
    from xiangqi_alphazero_torch.serve.predictor import find_models

    _, d = two_iterations
    found = find_models([str(d)])
    assert [(m["name"], m["format"]) for m in found] == [
        ("best_model.pt", "torch"), ("checkpoint_iter1", "checkpoint"),
        ("checkpoint_iter2", "checkpoint")]
    svc = TA.GameService(model_dirs=[str(d)], device="cpu")
    assert [m["name"] for m in svc.models()[1]["models"]] == [m["name"] for m in found]
    status, out = svc.load_model({"model_name": "checkpoint_iter2", "num_simulations": 10})
    assert status == 200, out
    assert svc.models()[1]["current"] == "checkpoint_iter2"
    status, out = svc.new_game({"human_side": "black", "num_simulations": 10})
    assert status == 200, out
    assert out["ai_move"]["action"] in Position().legal_actions()


def test_gumbel_trainer_learns_and_resumes_bit_identically(tmp_path):
    """A Gumbel run: self-play trains on improved-policy rows, the losses
    are finite, the gated eval (PUCT, as in the JAX trainer) runs, and a
    checkpoint of iteration 1 resumes bit-identically."""
    from xiangqi_alphazero_torch.train.trainer import AlphaZeroTrainer

    kw = dict(search_algo="gumbel", max_considered=4, num_simulations=6)
    full = AlphaZeroTrainer(_tiny_cfg(tmp_path / "full", **kw), device="cpu")
    full.train()
    st = full.training_stats
    assert st[0]["self_play"]["new_samples"] > 0 and st[0]["self_play"]["simulations"] > 0
    assert all(np.isfinite(x["training"][k]) for x in st for k in ("policy_loss", "value_loss"))
    assert st[1]["evaluation"]["plies"] >= 1
    n = len(full.buffer)
    rows = full.buffer.pi_probs[:n].sum(axis=1)
    assert (np.abs(rows - 1) <= 1e-5).all()   # every row a pi_improved distribution
    dst = tmp_path / "resumed"
    dst.mkdir()
    for name in ("checkpoint_iter1", "checkpoint_iter1.replay.npz", "training_stats.json"):
        shutil.copy(tmp_path / "full" / name, dst / name)
    resumed = AlphaZeroTrainer(_tiny_cfg(dst, **kw), device="cpu")
    resumed.restore(str(dst / "checkpoint_iter1"))
    resumed.train()
    _assert_tree_equal(_state(resumed), _state(full))
    assert _without_times(resumed.training_stats) == _without_times(full.training_stats)


def test_cli_in_process_and_best_model_serves(tmp_path):
    from xiangqi_alphazero_torch.engine.oracle import Position
    from xiangqi_alphazero_torch.serve.predictor import Predictor
    from xiangqi_alphazero_torch.train.__main__ import main

    d = tmp_path / "cli"
    rc = main(["--mode", "quick", "--iterations", "1", "--device", "cpu", "--channels", "8",
               "--res-blocks", "1", "--games-per-iter", "2", "--simulations", "4",
               "--max-game-length", "6", "--eval-games", "2", "--save-interval", "1",
               "--epochs", "1", "--min-buffer", "4", "--batch-size", "16",
               "--dtype", "float32", "--checkpoint-dir", str(d), "--seed", "1"])
    assert rc == 0
    assert json.load(open(d / "best_model_config.json")) == {"num_channels": 8,
                                                             "num_res_blocks": 1}
    pred = Predictor.load(str(d / "best_model.pt"), num_simulations=8, device="cpu")
    pos = Position()
    move = pred.ai_move(pos)["ai_move"]["action"]
    assert move in Position().legal_actions()

    # a warm start reads that best_model; an orbax directory is refused
    from xiangqi_alphazero_torch.train.trainer import AlphaZeroTrainer

    t = AlphaZeroTrainer(_tiny_cfg(tmp_path / "warm"), device="cpu")
    t.warm_start(str(d / "best_model.pt"))
    want = torch.load(d / "best_model.pt", weights_only=True)["model_state_dict"]
    _assert_tree_equal(dict(t.best_net.state_dict()), dict(want))
    with pytest.raises(ValueError, match="serve export"):
        t.warm_start(str(tmp_path))


def test_trainer_raises_without_cuda(monkeypatch, tmp_path):
    from xiangqi_alphazero_torch.train.__main__ import main
    from xiangqi_alphazero_torch.train.trainer import AlphaZeroTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        AlphaZeroTrainer(_tiny_cfg(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--mode", "quick", "--checkpoint-dir", str(tmp_path)])
    assert AlphaZeroTrainer(_tiny_cfg(tmp_path), device="cpu").device.type == "cpu"
