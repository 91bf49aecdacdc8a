"""The PyTorch port's net against the JAX net on the same weights: random
weights through ``state_dict_from_jax`` (atol 1e-4: float32 on the CPU, the
two frameworks sum in different orders), the shipped ``models/pretrained``
net (atol 2e-3 on logits, the tolerance of the JAX package's own export
check), and a ``.pt`` written by the JAX package's exporter."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xiangqi_alphazero_torch.models import (
    XiangqiNet,
    load_reference_pt,
    policy_logits_fn,
    policy_value_fn,
    state_dict_from_jax,
)
from xiangqi_alphazero_tpu.engine.oracle import Position
from xiangqi_alphazero_tpu.models import init_net
from xiangqi_alphazero_tpu.models import policy_value_fn as jax_policy_value_fn
from xiangqi_alphazero_tpu.serve.export import export_torch_checkpoint

_PRETRAINED = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "models", "pretrained", "best_model",
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread, so parallel test workers
    do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(n: int = 8, seed: int = 0) -> np.ndarray:
    """Seeded NHWC inputs: half random floats, half real position planes."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, 10, 9, 15)).astype(np.float32)
    for i in range(n // 2):
        pos = Position()
        for _ in range(5 * i):
            pos.apply(int(rng.choice(pos.legal_actions())))
        x[i] = pos.features().transpose(1, 2, 0)
    return x


def _random_variables(channels: int, blocks: int, seed: int):
    """init_net weights with seeded non-trivial batch-norm statistics."""
    _, variables = init_net(jax.random.key(seed), channels=channels, blocks=blocks)
    variables = jax.tree.map(np.asarray, variables)
    rng = np.random.default_rng(seed)

    def perturb(tree, key):
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v, k)
            elif k in ("mean", "bias"):
                tree[k] = (v + rng.normal(0, 0.1, v.shape)).astype(np.float32)
            elif k in ("var", "scale"):
                tree[k] = (v * rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)

    perturb(variables, "")
    return variables


def _jax_forward(channels, blocks, variables, x):
    from xiangqi_alphazero_tpu.models import XiangqiNet as JaxNet

    net = JaxNet(channels=channels, blocks=blocks)
    with jax.default_matmul_precision("highest"):
        logits, value = jax.jit(lambda v, x: net.apply(v, x, train=False))(
            variables, jnp.asarray(x)
        )
    return np.asarray(logits), np.asarray(value)


def _port_net(channels, blocks, variables) -> XiangqiNet:
    net = XiangqiNet(channels, blocks)
    net.load_state_dict(
        state_dict_from_jax(variables["params"], variables["batch_stats"], blocks)
    )
    return net.eval()


@torch.no_grad()
def test_random_weights_match_jax_forward():
    variables = _random_variables(16, 2, seed=1)
    x = _inputs()
    want_l, want_v = _jax_forward(16, 2, variables, x)
    got_l, got_v = _port_net(16, 2, variables)(torch.from_numpy(x))
    assert got_l.dtype == torch.float32 and got_l.shape == (8, 8100)
    np.testing.assert_allclose(got_l.numpy(), want_l, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_v.numpy(), want_v, rtol=0, atol=1e-4)


@torch.no_grad()
def test_policy_fns_match_jax():
    variables = _random_variables(16, 2, seed=2)
    x = _inputs(seed=2)
    from xiangqi_alphazero_tpu.models import XiangqiNet as JaxNet

    jp, jv = jax_policy_value_fn(JaxNet(16, 2), variables)(jnp.asarray(x))
    net = _port_net(16, 2, variables)
    tp, tv = policy_value_fn(net)(torch.from_numpy(x))
    tl, tv2 = policy_logits_fn(net)(torch.from_numpy(x))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4)
    assert torch.equal(tv, tv2)
    np.testing.assert_allclose(torch.softmax(tl, -1).numpy(), tp.numpy(), atol=1e-7)


@torch.no_grad()
def test_pretrained_matches_jax_forward():
    from xiangqi_alphazero_tpu.train.checkpoint import load_checkpoint

    restored = load_checkpoint(_PRETRAINED)
    variables = jax.tree.map(
        np.asarray,
        {"params": restored["params"], "batch_stats": restored["batch_stats"]},
    )
    x = _inputs(seed=3)
    want_l, want_v = _jax_forward(128, 6, variables, x)
    got_l, got_v = _port_net(128, 6, variables)(torch.from_numpy(x))
    np.testing.assert_allclose(got_l.numpy(), want_l, rtol=0, atol=2e-3)
    np.testing.assert_allclose(got_v.numpy(), want_v, rtol=0, atol=2e-3)


@torch.no_grad()
def test_reference_pt_from_jax_exporter_loads(tmp_path):
    variables = _random_variables(8, 1, seed=4)
    path = str(tmp_path / "tiny.pt")
    export_torch_checkpoint(
        path, variables["params"], variables["batch_stats"],
        {"num_channels": 8, "num_res_blocks": 1},
    )
    net = load_reference_pt(path)
    assert (net.channels, net.blocks) == (8, 1)
    direct = _port_net(8, 1, variables).state_dict()
    for k, v in net.state_dict().items():
        assert torch.equal(v, direct[k]), k
    x = _inputs(seed=4)
    want_l, want_v = _jax_forward(8, 1, variables, x)
    got_l, got_v = net(torch.from_numpy(x))
    np.testing.assert_allclose(got_l.numpy(), want_l, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_v.numpy(), want_v, rtol=0, atol=1e-4)


@torch.no_grad()
def test_bf16_compute_keeps_f32_outputs():
    variables = _random_variables(16, 2, seed=5)
    x = torch.from_numpy(_inputs(seed=5))
    f32 = _port_net(16, 2, variables)
    bf16 = XiangqiNet(16, 2, dtype=torch.bfloat16)
    bf16.load_state_dict(f32.state_dict())
    bf16.eval()
    (l32, v32), (l16, v16) = f32(x), bf16(x)
    assert l16.dtype == torch.float32 and v16.dtype == torch.float32
    assert next(bf16.parameters()).dtype == torch.float32
    # bf16 keeps ~3 significant digits
    np.testing.assert_allclose(l16.numpy(), l32.numpy(), atol=0.1)
    np.testing.assert_allclose(v16.numpy(), v32.numpy(), atol=0.05)
