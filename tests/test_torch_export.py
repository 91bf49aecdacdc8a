"""The port's exporters (``xiangqi_alphazero_torch/serve/export.py``, the
``serve export`` CLI) against the JAX package's on the same weights, on the
CPU at 16 channels x 2 blocks:

- npz: the same keys and arrays, exactly, and the same manifest JSON text;
- ``.pt``: the same state dict, config and iteration, exactly;
- ONNX: the same bytes (both write through ``onnx_lite``, since the
  ``onnx`` package is absent);
- the JAX package's ``verify_export`` accepts the port's npz, ``.pt`` and
  ONNX files, and the port's ``verify_export`` rejects each format with a
  corrupted bias;
- ``jax_from_state_dict`` equals JAX ``convert_state_dict``.

The port's files are written by the CLI on ``--device cpu``, which
verifies each against the net's float32 forward. The JAX npz export is
written uncompressed (``np.savez`` for ``np.savez_compressed``, patched
for the duration of the call): the comparison reads arrays, which
compression does not change, and it saves five seconds of zlib."""

import json
import os

import numpy as np
import pytest
import torch

import jax

from xiangqi_alphazero_torch.models import (
    XiangqiNet,
    init_net,
    jax_from_state_dict,
    state_dict_from_jax,
)
from xiangqi_alphazero_torch.serve import __main__ as cli
from xiangqi_alphazero_torch.serve import export as TX
from xiangqi_alphazero_torch.serve import onnx_lite
from xiangqi_alphazero_tpu.models.torch_import import convert_state_dict
from xiangqi_alphazero_tpu.serve import export as JX

MC = {"num_channels": 16, "num_res_blocks": 2}
FORMATS = {"npz": "m.npz", "torch": "m.pt", "torchscript": "m.ts", "onnx": "m.onnx"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread, so parallel test workers
    do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """(flax variables, the port's net) of the same random weights, with
    perturbed batch-norm statistics."""
    net = init_net(torch.Generator().manual_seed(5), channels=16, blocks=2)
    variables = jax_from_state_dict(net.state_dict(), 2)
    rng = np.random.default_rng(5)
    for tree in variables["batch_stats"].values():
        for stats in ([tree] if "mean" in tree else tree.values()):
            stats["mean"] = (stats["mean"] + rng.normal(0, 0.1, stats["mean"].shape)).astype(
                np.float32)
            stats["var"] = (stats["var"] * rng.uniform(0.5, 1.5, stats["var"].shape)).astype(
                np.float32)
    net = XiangqiNet(16, 2)
    net.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"], 2))
    return variables, net.eval()


@pytest.fixture(scope="module")
def port_files(weights, tmp_path_factory):
    """Each format written by the port's CLI from a ``.pt`` of the weights."""
    _, net = weights
    d = tmp_path_factory.mktemp("port")
    src = str(d / "source.pt")
    TX.export_torch_checkpoint(src, net)
    for fmt, name in FORMATS.items():
        assert cli.main(["export", "--checkpoint", src, "--format", fmt,
                         "--output", str(d / name), "--device", "cpu"]) == 0
    return d


@pytest.fixture(scope="module")
def jax_files(weights, tmp_path_factory):
    variables, _ = weights
    p, s = variables["params"], variables["batch_stats"]
    d = tmp_path_factory.mktemp("jax")
    compressed = np.savez_compressed
    np.savez_compressed = np.savez
    try:
        JX.export_npz(str(d / "m.npz"), p, s, MC)
    finally:
        np.savez_compressed = compressed
    JX.export_torch_checkpoint(str(d / "m.pt"), p, s, MC)
    JX.export_onnx(str(d / "m.onnx"), p, s, MC)
    return d


def test_npz_equals_jax_exporter(port_files, jax_files):
    with np.load(port_files / "m.npz") as got, np.load(jax_files / "m.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    manifest = (port_files / "m.manifest.json").read_text()
    assert manifest == (jax_files / "m.manifest.json").read_text()
    assert json.loads(manifest)["format"] == TX.NPZ_FORMAT


def test_pt_equals_jax_exporter(port_files, jax_files):
    got = torch.load(port_files / "m.pt", weights_only=True)
    want = torch.load(jax_files / "m.pt", weights_only=True)
    assert got["config"] == want["config"] == MC
    assert got["iteration"] == want["iteration"]
    assert sorted(got["model_state_dict"]) == sorted(want["model_state_dict"])
    for k, v in want["model_state_dict"].items():
        g = got["model_state_dict"][k]
        assert g.dtype == v.dtype and torch.equal(g, v), k


def test_onnx_bytes_equal_jax_exporter(port_files, jax_files):
    assert (port_files / "m.onnx").read_bytes() == (jax_files / "m.onnx").read_bytes()
    g = onnx_lite.load_model(str(port_files / "m.onnx"))
    assert g["inputs"] == ["state"] and g["outputs"] == ["policy", "value"]


@pytest.mark.parametrize("fmt", ["npz", "onnx", "torch"])
def test_jax_verify_accepts_port_files(weights, port_files, fmt):
    variables, _ = weights
    diffs = JX.verify_export(fmt, str(port_files / FORMATS[fmt]), variables["params"],
                             variables["batch_stats"], MC)
    assert diffs["max_abs_dlogits"] < 2e-3 and diffs["max_abs_dvalue"] < 2e-3


def _corrupt(fmt: str, src: str, dst: str) -> None:
    """A copy of the artifact at ``src`` with the policy bias moved by 1."""
    if fmt == "torch":
        ck = torch.load(src, weights_only=True)
        ck["model_state_dict"]["policy_head.4.bias"] += 1.0
        torch.save(ck, dst)
    elif fmt == "npz":
        with np.load(src) as z:
            arrays = {k: z[k] for k in z.files}
        arrays["params/Dense_0/bias"] = arrays["params/Dense_0/bias"] + 1.0
        np.savez(dst, **arrays)
    elif fmt == "torchscript":
        module = torch.jit.load(src)
        with torch.no_grad():
            getattr(module.policy_head, "4").bias += 1.0
        module.save(dst)
    else:
        model = onnx_lite.load_model(src)
        sd = {k: v for k, v in model["initializers"].items()}
        sd["policy_head.4.bias"] = sd["policy_head.4.bias"] + 1.0
        onnx_lite.write_model(dst, sd, MC["num_channels"], MC["num_res_blocks"])


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_port_verify_catches_corruption(weights, port_files, tmp_path, fmt):
    _, net = weights
    src = str(port_files / FORMATS[fmt])   # verified by the CLI that wrote it
    bad = str(tmp_path / ("bad" + os.path.splitext(FORMATS[fmt])[1]))
    _corrupt(fmt, src, bad)
    with pytest.raises(AssertionError, match="diverges"):
        TX.verify_export(fmt, bad, net)


def test_jax_from_state_dict_equals_convert_state_dict(weights):
    _, net = weights
    sd = net.state_dict()
    got = jax_from_state_dict(sd, 2)
    want = convert_state_dict({k: v.numpy() for k, v in sd.items()}, 16, 2)
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, a), (_, b) in zip(flat_got, flat_want):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    # and it inverts state_dict_from_jax
    back = state_dict_from_jax(got["params"], got["batch_stats"], 2)
    for k, v in back.items():
        assert torch.equal(v, sd[k]), k


def test_cli_refuses_unknown_sources(tmp_path, capsys):
    with pytest.raises(ValueError, match="export"):
        cli.main(["export", "--checkpoint", str(tmp_path), "--format", "torch",
                  "--output", str(tmp_path / "x.pt"), "--device", "cpu"])
    junk = tmp_path / "junk"
    junk.write_bytes(b"not a checkpoint")
    with pytest.raises(ValueError, match="export"):
        cli.main(["export", "--checkpoint", str(junk), "--format", "torch",
                  "--output", str(tmp_path / "x.pt"), "--device", "cpu"])
    with pytest.raises(ValueError, match="format"):
        TX.verify_export("pickle", str(junk), XiangqiNet(8, 1))

