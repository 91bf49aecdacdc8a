"""The port's int8 (w8a8) inference twin (``xiangqi_alphazero_torch/models/
quant.py``) against the JAX package's ``models/quant.py`` on the same
weights and boards, on the CPU:

- random weights (16 channels x 2 blocks, perturbed batch-norm
  statistics), 8 boards: the int8 weights, their scales and the folded
  biases of every layer, and the first layer's int8 activations, scales
  and int32 products, exactly; the logits and values within atol 1e-5 (the
  matmuls are exact int32 sums and the rounding is the same half-to-even
  division, so the two can differ only by float rounding in the value
  head's float denses and tanh);
- the shipped ``models/pretrained`` net (128 x 6, read through JAX) on the
  JAX test's own 32 mid-game boards (``tests/test_quant.py``: seed 0, 12
  plies): its envelope against the float forward (legal-argmax agreement
  >= 0.7, value correlation >= 0.9), and the port's int8 logits and values
  against JAX's int8 within atol 1e-3 (float rounding over 13 layers could
  move an activation across a rounding boundary, one int8 step).

JAX's int8 forward runs eagerly, as ``tests/test_quant.py`` runs it; under
``jax.jit`` XLA fuses the dequantize and quantize passes and rounds some
activations the other way (max |dlogits| 0.30 on the shipped net).
``torch._int_mm``'s zero padding is held against a numpy int64 product at
the shapes that break its CUDA rules.

The boards are played by the port's env, which equals the JAX env exactly
(``tests/test_torch_engine.py``), with the JAX test's own Gumbel draws, so
they are the JAX test's boards without compiling its step."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xiangqi_alphazero_torch.engine import env as E
from xiangqi_alphazero_torch.models import (
    XiangqiNet,
    init_net,
    jax_from_state_dict,
    state_dict_from_jax,
)
from xiangqi_alphazero_torch.models import quant as Q
from xiangqi_alphazero_tpu.models import quant as JQ

_PRETRAINED = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "models", "pretrained", "best_model",
)
RANDOM_ATOL = 1e-5
PRETRAINED_ATOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread, so parallel test workers
    do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def random_pair():
    """(flax variables, the port's net) of the same random 16 x 2 weights,
    with perturbed batch-norm statistics."""
    net = init_net(torch.Generator().manual_seed(1), channels=16, blocks=2)
    variables = jax_from_state_dict(net.state_dict(), 2)
    rng = np.random.default_rng(1)

    def perturb(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v)
            elif k in ("mean", "bias"):
                tree[k] = (v + rng.normal(0, 0.1, v.shape)).astype(np.float32)
            elif k in ("var", "scale"):
                tree[k] = (v * rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)

    perturb(variables)
    return variables, _port_net(variables, 16, 2)


def _port_net(variables: dict, channels: int, blocks: int) -> XiangqiNet:
    net = XiangqiNet(channels, blocks)
    net.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"], blocks))
    return net.eval()


def _midgame(batch: int, plies: int, seed: int):
    """Features (NHWC) and legal masks after ``plies`` random moves, drawn
    as ``tests/test_quant.py::_midgame_feats`` draws them."""
    states = E.reset_batch(batch)
    k = jax.random.key(seed)
    for _ in range(plies):
        k, k2 = jax.random.split(k)
        g = np.asarray(jax.random.gumbel(k2, (batch, E.ACTION_SPACE)))
        act = np.argmax(np.where(states.legal.numpy(), g, -np.inf), -1)
        states = E.step_batch(states, torch.from_numpy(act))
    return E.features(states.board, states.side), states.legal.numpy()


def _layers(qn):
    yield "stem", qn.stem
    for i, (c1, c2) in enumerate(qn.blocks):
        yield f"block{i}.conv1", c1
        yield f"block{i}.conv2", c2
    yield "policy_conv", qn.policy_conv
    yield "policy_dense", qn.policy_dense
    yield "value_conv", qn.value_conv


def test_quantized_weights_equal_jax(random_pair):
    variables, net = random_pair
    jq = JQ.quantize_net(variables)
    tq = Q.quantize_net(net)
    for (name, j), (_, t) in zip(_layers(jq), _layers(tq)):
        assert t.w_q.dtype == torch.int8, name
        for field in ("w_q", "w_scale", "bias"):
            np.testing.assert_array_equal(getattr(t, field).numpy(), np.asarray(getattr(j, field)),
                                          err_msg=f"{name}.{field}")
        k, n = t.w_q.shape
        assert t.w_mm.shape == (-(-n // 8) * 8, -(-k // 8) * 8), name
        assert torch.equal(t.w_mm[:n, :k], t.w_q.t()) and not t.w_mm[n:].any()
        assert not t.w_mm[:, k:].any(), name
    for j, t in ((jq.value_d1, tq.value_d1), (jq.value_d2, tq.value_d2)):
        for a, b in zip(j, t):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # the state dict quantizes as the module does
    sd = net.state_dict()
    assert torch.equal(Q.quantize_net(sd).policy_dense.w_q, tq.policy_dense.w_q)


@pytest.mark.parametrize("m, k, n", [(1, 135, 8), (16, 136, 4), (17, 2880, 8100),
                                     (40, 128, 4), (720, 135, 16)])
def test_int8_matmul_pads_exactly(m, k, n):
    """M <= 16, K and N not multiples of 8: the padded product equals the
    exact one."""
    rng = np.random.default_rng(m + k + n)
    x = rng.integers(-127, 128, (m, k), dtype=np.int8)
    w = rng.integers(-127, 128, (k, n), dtype=np.int8)
    got = Q._int8_matmul(torch.from_numpy(x), Q._mm_weight(w, "cpu"), n)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), x.astype(np.int64) @ w.astype(np.int64))


def test_int8_forward_matches_jax(random_pair):
    """8 boards: the policy dense's M is padded to 17, the stem's K to 136."""
    variables, net = random_pair
    batch = 8
    jq = JQ.quantize_net(variables)
    tq = Q.quantize_net(net)
    x, _ = _midgame(batch, 6, seed=3)
    feats = x.numpy()

    jp = JQ._im2col(jnp.asarray(feats)).reshape(batch * 90, -1)
    tp = Q._im2col(x).reshape(batch * 90, -1)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    jqa, js = JQ._quant_act(jp)
    tqa, ts = Q._quant_act(tp)
    np.testing.assert_array_equal(tqa.numpy(), np.asarray(jqa))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(Q._int8_matmul(tqa, tq.stem.w_mm, tq.stem.w_q.shape[1]).numpy(),
                                  np.asarray(JQ._int8_matmul(jqa, jq.stem.w_q)))

    jl, jv = JQ.int8_forward(jq, jnp.asarray(feats))
    tl, tv = Q.int8_forward(tq, x)
    assert tl.shape == (batch, 8100) and tv.shape == (batch, 1)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=RANDOM_ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=RANDOM_ATOL)
    fl, fv = Q.int8_logits_fn(tq)(x)
    assert torch.equal(fl, tl) and torch.equal(fv, tv[:, 0])


@torch.no_grad()
def test_int8_envelope_on_shipped_model():
    """On the tracked pretrained net and the JAX test's 32 boards: >= 70%
    legal-argmax agreement with the float forward and value correlation
    >= 0.9 (the JAX test's envelope), and the port's int8 equal to JAX's
    int8 within PRETRAINED_ATOL."""
    from xiangqi_alphazero_tpu.train.checkpoint import load_checkpoint

    restored = load_checkpoint(_PRETRAINED)
    variables = jax.tree.map(
        np.asarray, {"params": restored["params"], "batch_stats": restored["batch_stats"]})
    net = _port_net(variables, 128, 6)
    x, legal = _midgame(32, 12, seed=0)
    ref_logits, ref_value = net(x)
    tq = Q.quantize_net(net)
    q_logits, q_value = Q.int8_forward(tq, x)
    rl, ql = ref_logits.numpy(), q_logits.numpy()
    agree = 0
    for i in range(rl.shape[0]):
        la = np.flatnonzero(legal[i])
        agree += la[np.argmax(rl[i][la])] == la[np.argmax(ql[i][la])]
    assert agree >= int(0.7 * rl.shape[0]), f"argmax agreement {agree}"
    assert np.corrcoef(ref_value.numpy().ravel(), q_value.numpy().ravel())[0, 1] >= 0.9

    jl, jv = JQ.int8_forward(JQ.quantize_net(variables), jnp.asarray(x.numpy()))
    np.testing.assert_allclose(ql, np.asarray(jl), rtol=0, atol=PRETRAINED_ATOL)
    np.testing.assert_allclose(q_value.numpy(), np.asarray(jv), rtol=0, atol=PRETRAINED_ATOL)
