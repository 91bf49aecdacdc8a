"""The port's parallel layer on the CPU, over gloo: its 2-rank learner steps
against the JAX package's sharded steps on the suite's 8 CPU devices, the
tensor-parallel forward, sharded self-play and eval against one rank, the
global batch-norm Function against plain batch norm, the mesh's
validation and the backend rule.

The port's ranks are ``xiangqi_alphazero_torch.parallel.probe`` processes
(they import no JAX); the same numpy inputs and weights
(``state_dict_from_jax``) go through both packages. Tolerances: the total
loss within rtol 1e-5 (``test_sharding.py``); Adam's moments after the
step (its first moment, 0.1 x the reduced, clipped, decayed gradient)
within rtol 1e-4 + atol 1e-7 (``tests/test_torch_train.py`` holds one
rank's gradients to rtol 1e-4 + atol 1e-6);
the updated parameters within 2 lr = 2e-3 (``test_sharding.py``'s atol)
with at most 0.1% of them beyond 0.05 lr, and the batch-norm running
statistics within atol 1e-6 + rtol 1e-5. The parameters alone cannot
hold a step: Adam's first step moves each by about lr whatever its
gradient. Two planted faults (rank 0 keeps its local gradients; batch
norm over the local batch) must fail these checks. The TP forward's
logits within 1e-4 and values within 1e-5 (``test_tensor_parallel.py``).
Self-play and eval with the exact mock networks equal one rank's exactly.
"""

import functools
import json
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xiangqi_alphazero_torch import distributed as TD
from xiangqi_alphazero_torch.models import resnet as TR
from xiangqi_alphazero_torch.models import state_dict_from_jax
from xiangqi_alphazero_torch.parallel import probe as TP
from xiangqi_alphazero_torch.parallel import sharding as TS
from xiangqi_alphazero_torch.train import config as TC
from xiangqi_alphazero_tpu.models import init_net as jax_init_net
from xiangqi_alphazero_tpu.parallel import (
    batch_sharded,
    make_mesh,
    make_sharded_train_step,
    make_tp_mesh,
    make_tp_train_step,
    tp_place,
)
from xiangqi_alphazero_tpu.train.learner import make_optimizer, set_learning_rate

CH, BL = 8, 1
LR = 1e-3

# a rank process with a planted fault in the sharded learner, chosen by the
# job's ``plant`` input: ``own_grads`` (rank 0 takes part in the gradient
# all-reduce but keeps its local gradients) or ``local_bn`` (batch norm
# over each rank's own columns)
_PLANTED = """
import sys
from xiangqi_alphazero_torch.parallel import probe, sharding as SH

reduce_gradients, set_bn_group, run = SH.reduce_gradients, SH.set_bn_group, probe.run


def own_grads(mesh, params, extra):
    local = [p.grad.clone() for p in params]
    out = reduce_gradients(mesh, params, extra)
    if mesh.rank == 0:
        for p, g in zip(params, local):
            p.grad.copy_(g)
    return out


def planted(mode, inputs, mesh, device):
    plant = str(inputs.get("plant", ""))
    SH.reduce_gradients = own_grads if plant == "own_grads" else reduce_gradients
    SH.set_bn_group = (lambda net, group: None) if plant == "local_bn" else set_bn_group
    return run(mode, inputs, mesh, device)


probe.run = planted
sys.exit(probe.main(sys.argv[1:]))
"""
_PLANTS = ("own_grads", "local_bn")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_net(seed: int = 0):
    net, variables = jax_init_net(jax.random.key(seed), channels=CH, blocks=BL)
    return net, jax.tree.map(np.asarray, variables)


def _inputs(variables) -> dict:
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"], BL)
    return {"channels": np.array(CH), "blocks": np.array(BL),
            **{f"sd/{k}": v.numpy() for k, v in sd.items()}}


def _params_sd(params, batch_stats) -> dict:
    return {f"sd/{k}": v.numpy() for k, v in state_dict_from_jax(
        jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, batch_stats), BL).items()
        if not k.endswith("num_batches_tracked")}


def _fake_batch(rng, b):   # test_sharding.py's batch
    boards = np.zeros((b, 90), np.int8)
    boards[:, :20] = rng.integers(-7, 8, (b, 20), dtype=np.int8)
    sides = np.where(rng.random(b) < 0.5, 1, -1).astype(np.int8)
    acts = rng.integers(0, 8100, (b, 8), dtype=np.int32)
    probs = rng.random((b, 8)).astype(np.float32)
    probs /= probs.sum(1, keepdims=True)
    z = np.where(rng.random(b) < 0.5, 1.0, -1.0).astype(np.float32)
    return boards, sides, acts, probs, z, np.ones(b, np.float32)


def _tp_batch(b):   # test_tensor_parallel.py's batch
    rng = np.random.default_rng(0)
    boards = np.zeros((b, 90), np.int8)
    boards[:, :16] = rng.integers(-7, 8, (b, 16), dtype=np.int8)
    return (boards, np.ones(b, np.int8), rng.integers(0, 8100, (b, 8), dtype=np.int32),
            np.full((b, 8), 1.0 / 8, np.float32), np.zeros(b, np.float32),
            np.ones(b, np.float32))


_BATCH_KEYS = ("boards", "sides", "pi_actions", "pi_probs", "z", "w")
_SP = dict(num_simulations=4, max_game_length=12, random_opening_moves=2,
           enable_resign=True, resign_threshold=-0.1, resign_check_steps=2,
           temperature_threshold=4)
_SHARDED = [   # (mode, settings) run sharded over 2 ranks and on one
    ("selfplay", _SP),
    ("selfplay", dict(_SP, search_algo="gumbel", max_considered=4)),
    ("eval", dict(num_simulations=4, max_game_length=12)),
]


def _step_inputs(variables, batch) -> dict:
    return {**_inputs(variables), **dict(zip(_BATCH_KEYS, batch)),
            "lr": np.array(LR), "wd": np.array(1e-4)}


def _sharded_inputs(settings) -> dict:
    return {"settings": np.array(json.dumps(settings)), "seed": np.array(5),
            "games": np.array(8), "evaluator": np.array("dyadic")}


@pytest.fixture(scope="module")
def pods():
    """The port's 2-rank jobs, two launches in all: data-parallel (the
    step, the sharded self-play and eval, and the step with each planted
    fault, in rank processes that plant a fault only where a job asks)
    and ``--model-parallel 2`` (the step and the forward)."""
    _, variables = _jax_net(0)
    x = np.random.default_rng(1).normal(size=(8, 10, 9, 15)).astype(np.float32)
    dp_in = _step_inputs(variables, _fake_batch(np.random.default_rng(0), 16))
    n = len(_SHARDED)
    dp, _ = TP.launch([("step", dp_in)] + [(m, _sharded_inputs(s)) for m, s in _SHARDED]
                      + [("step", dict(dp_in, plant=np.array(p))) for p in _PLANTS], 2,
                      device="cpu", command=[sys.executable, "-c", _PLANTED])
    tp, _ = TP.launch([("step", _step_inputs(variables, _tp_batch(16))),
                       ("forward", {**_inputs(variables), "feats": x})], 2, model_parallel=2,
                      device="cpu")
    return {"dp_step": dp[0], "sharded": dp[1:1 + n], "tp_step": tp[0], "tp_forward": tp[1],
            "feats": x, "planted": dict(zip(_PLANTS, dp[1 + n:]))}


@functools.lru_cache(maxsize=None)
def _jax_step(model_parallel: int):
    """The JAX sharded step (``make_sharded_train_step`` over 8 devices, or
    ``make_tp_train_step`` on its (4, 2) mesh) on the tests' batch: the
    state dict after it, Adam's first moment by name, and the metrics."""
    assert len(jax.devices()) >= 8
    net, variables = _jax_net(0)
    tx = make_optimizer(LR, 1e-4)
    params, stats = variables["params"], variables["batch_stats"]
    opt = set_learning_rate(tx.init(params), LR)
    if model_parallel == 1:
        mesh = make_mesh(8)
        step = make_sharded_train_step(net, tx, mesh)
        args = [jax.device_put(jnp.asarray(x), batch_sharded(mesh))
                for x in _fake_batch(np.random.default_rng(0), 16)]
    else:
        mesh = make_tp_mesh(2)
        step = make_tp_train_step(net, tx, mesh)
        params = tp_place(mesh, params)
        args = [jnp.asarray(x) for x in _tp_batch(16)]
    p2, s2, opt2, m = step(jax.tree.map(jnp.copy, params), stats, opt, *args)
    mu = next(s for s in opt2.inner_state if hasattr(s, "mu")).mu
    moments = {f"mu/{k[3:]}": v for k, v in _params_sd(mu, s2).items() if "running" not in k}
    return _params_sd(p2, s2), moments, m


def _check_step(got: dict, want_sd: dict, want_moments: dict, m) -> None:
    """The port's step against the JAX step, to the tolerances of the
    module doc."""
    np.testing.assert_allclose(got["losses"][2], float(m.total_loss), rtol=1e-5)
    np.testing.assert_allclose(got["losses"][:2], [float(m.policy_loss), float(m.value_loss)],
                               rtol=1e-5)
    for k, w in want_moments.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-7, err_msg=k)
    far = total = 0
    for k, w in want_sd.items():
        if "running" in k:
            np.testing.assert_allclose(got[k], w, atol=1e-6, rtol=1e-5, err_msg=k)
            continue
        np.testing.assert_allclose(got[k], w, atol=2 * LR, err_msg=k)
        d = np.abs(got[k] - w)
        far, total = far + int((d > 0.05 * LR).sum()), total + d.size
    assert far <= 1e-3 * total, f"{far} of {total} parameters beyond 0.05 lr"


@pytest.mark.parametrize("model_parallel", [1, 2])
def test_two_rank_step_matches_jax_sharded_step(pods, model_parallel):
    """The port's 2-rank step, data-parallel or ``--model-parallel 2``,
    against the JAX ``make_sharded_train_step`` over 8 devices or
    ``make_tp_train_step`` on its (4, 2) mesh: losses, Adam's first
    moment, parameters and running statistics."""
    _check_step(pods["dp_step" if model_parallel == 1 else "tp_step"], *_jax_step(model_parallel))


@pytest.mark.parametrize("plant", _PLANTS)
def test_planted_faults_fail_the_step_check(pods, plant):
    """A 2-rank step with a planted fault fails the check that the sound
    step passes; the losses alone would not show the gradient fault."""
    want = _jax_step(1)
    got = pods["planted"][plant]
    if plant == "own_grads":   # every rank's loss partials are still summed
        np.testing.assert_allclose(got["losses"][2], float(want[2].total_loss), rtol=1e-5)
    with pytest.raises(AssertionError):
        _check_step(got, *want)


def test_tp_forward_matches_jax_and_replicated(pods):
    """The 2-rank TP forward (logits gathered from the shards) against the
    JAX net's and the port's replicated forward."""
    net, variables = _jax_net(0)
    x = pods["feats"]
    want_logits, want_value = net.apply(variables, jnp.asarray(x), train=False)
    repl = TP.run("forward", {**_inputs(variables), "feats": x}, None, "cpu")
    got = pods["tp_forward"]
    for ref_logits, ref_value in ((np.asarray(want_logits), np.asarray(want_value)),
                                  (repl["logits"], repl["value"])):
        np.testing.assert_allclose(got["logits"], ref_logits, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(got["value"], ref_value, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("case", range(len(_SHARDED)), ids=["puct", "gumbel", "eval"])
def test_sharded_selfplay_and_eval_equal_one_rank(pods, case):
    """8 games split over 2 ranks with the exact mock networks: every
    record (or the match's winners and plies) equals one rank's. The
    openings, the Dirichlet noise, the sampling and the root Gumbels are
    drawn at the global batch's shape."""
    mode, settings = _SHARDED[case]
    want = TP.run(mode, _sharded_inputs(settings), None, "cpu")
    got = pods["sharded"][case]
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if mode == "selfplay":
        assert want["rec"].sum() > 8   # games were played


@pytest.mark.parametrize("offset", [0.5, 30.0])
def test_global_batch_norm_matches_plain_batch_norm(offset):
    """The global batch-norm Function over no group (a world of one rank)
    equals the port's BatchNorm2d in training mode: output, input and
    parameter gradients, and flax's running statistics; also for a batch
    whose mean lies 15 standard deviations from the running mean, where a
    one-pass variance about the running mean cancels."""
    torch.manual_seed(0)
    x = torch.randn(6, 4, 10, 9) * 2 + offset
    plain = TR.BatchNorm2d(4, eps=1e-5, momentum=0.1).train()
    with torch.no_grad():
        plain.weight.uniform_(0.5, 1.5)
        plain.bias.uniform_(-0.5, 0.5)
        plain.running_mean.fill_(0.3)
    glob = TR.BatchNorm2d(4, eps=1e-5, momentum=0.1).train()
    glob.load_state_dict(plain.state_dict())
    dy = torch.randn_like(x)
    xs = [x.clone().requires_grad_(True) for _ in range(2)]
    ys = [plain(xs[0]), TS.global_batch_norm(glob, xs[1])]
    for y in ys:
        y.backward(dy)
    torch.testing.assert_close(ys[1], ys[0], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(xs[1].grad, xs[0].grad, atol=1e-5, rtol=1e-5)
    for name in ("weight", "bias"):
        torch.testing.assert_close(getattr(glob, name).grad, getattr(plain, name).grad,
                                   atol=1e-4, rtol=1e-5)
    for name in ("running_mean", "running_var"):
        torch.testing.assert_close(getattr(glob, name), getattr(plain, name),
                                   atol=1e-6, rtol=1e-5)


def test_mesh_validation_errors(tmp_path):
    with pytest.raises(ValueError, match="must divide"):
        TS.make_tp_mesh(8)
    with pytest.raises(ValueError, match="must divide"):
        TS.make_tp_mesh(3)   # divides 8100 but not 128
    with pytest.raises(ValueError, match="not divisible by model_parallel=2"):
        TS.make_tp_mesh(2)   # a world of one rank
    from xiangqi_alphazero_torch.train.trainer import AlphaZeroTrainer

    for mode in ("off", "auto"):
        cfg = TC.TrainingConfig(num_channels=8, num_res_blocks=1, mesh_mode=mode,
                                model_parallel=2, checkpoint_dir=str(tmp_path / mode))
        with pytest.raises(ValueError, match="model_parallel"):
            AlphaZeroTrainer(cfg, device="cpu")


def test_backend_rule():
    cpu = {"host": "a", "cards": 0}
    assert TD.backend_rule([cpu, cpu]) == "gloo"
    one = {"host": "a", "cards": 1}
    assert TD.backend_rule([one, one]) == "gloo"   # two ranks on one card
    four = {"host": "a", "cards": 4}
    assert TD.backend_rule([four] * 4) == "nccl"
    assert TD.backend_rule([four] * 5) == "gloo"
    assert TD.backend_rule([{"host": "a", "cards": 1}, {"host": "b", "cards": 1}]) == "nccl"
