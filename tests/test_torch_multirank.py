"""Multi-rank training through the port's real CLI on the CPU, over gloo:
rank processes of ``python -m xiangqi_alphazero_torch.train
--coordinator ... --num-processes 2 --process-id i`` against the same
tiny run on one rank (the JAX package's ``tests/test_multihost.py``, with
the port's ranks in place of its fake pod):

- 2-rank data-parallel: self-play stats, the replay ring and the gated
  eval's outcomes exactly equal; losses of iteration 1 within rtol 1e-5
  and of iteration 2 (which starts from parameters that differ within the
  next bound) within rtol 1e-3, the JAX test's loss tolerance;
  parameters after one iteration within rtol 1e-2, atol 1e-3 (the JAX
  test's, ``test_multihost.py:158``);
- 2-rank ``--model-parallel 2``: the same;
- a checkpoint saved under TP resumes at one rank, and one rank's under
  TP: the resumed iteration's self-play equals the uninterrupted run's
  exactly, its losses within rtol 1e-3;
- the 2-rank pod with a fault injected on every rank at iteration 2,
  under ``--auto-restart``, equals the uninterrupted 2-rank run exactly
  (``training_stats.json`` without its times), the iteration-2 eval
  included;
- the replay-ring guard raises on both ranks when one rank's checkpoint
  lacks its ring.

The config is ``tests/_multihost_worker.py::TINY`` with a shorter game cap
(8 plies): the gated eval runs 40 simulations a move, which sets these
tests' time.
"""

import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = [
    "--mode", "quick",
    "--channels", "8", "--res-blocks", "1",
    "--simulations", "4", "--games-per-iter", "8",
    "--max-game-length", "8", "--batch-size", "64", "--epochs", "1",
    "--eval-games", "4", "--eval-interval", "2",
    "--save-interval", "1", "--min-buffer", "1",
    "--iterations", "2", "--seed", "3", "--dtype", "float32", "--device", "cpu",
]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Pod:
    """The CLI's rank processes, started at once: ``args`` for every rank,
    ``rank_args[i]`` and ``rank_env[i]`` for rank i alone."""

    def __init__(self, ckpt_dir, args=(), n: int = 2, rank_args=None, rank_env=None):
        port = _free_port()
        self.procs = []
        for i in range(n):
            env = dict(os.environ, OMP_NUM_THREADS="1", **((rank_env or {}).get(i, {})))
            cmd = [sys.executable, "-m", "xiangqi_alphazero_torch.train", *TINY, *args,
                   *(rank_args or {}).get(i, []), "--checkpoint-dir", str(ckpt_dir),
                   "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(n),
                   "--process-id", str(i)]
            self.procs.append(subprocess.Popen(cmd, cwd=REPO, env=env, text=True,
                                               stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT))

    def wait(self, timeout: float = 300.0, ok: bool = True):
        """Every rank's (returncode, output); with ``ok``, asserts rc 0."""
        outs = []
        try:
            for p in self.procs:
                out = p.communicate(timeout=timeout)[0]
                outs.append((p.returncode, out))
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if ok:
            for i, (rc, out) in enumerate(outs):
                assert rc == 0, f"rank {i} failed (rc={rc}):\n{out[-4000:]}"
        return outs


def _one_rank(ckpt_dir, *args) -> None:
    """The same CLI on one rank, in this process (one torch thread)."""
    from xiangqi_alphazero_torch.train.__main__ import main

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert main([*TINY, *args, "--checkpoint-dir", str(ckpt_dir)]) == 0
    finally:
        torch.set_num_threads(n)


def _stats(ckpt_dir):
    with open(os.path.join(ckpt_dir, "training_stats.json")) as f:
        return json.load(f)


def _without_times(stats):
    if isinstance(stats, dict):
        return {k: _without_times(v) for k, v in stats.items() if k != "time"}
    if isinstance(stats, list):
        return [_without_times(s) for s in stats]
    return stats


def _copy_checkpoint(src, dst, name="checkpoint_iter1", replay=True):
    os.makedirs(dst, exist_ok=True)
    shutil.copy(os.path.join(src, name), os.path.join(dst, name))
    shutil.copy(os.path.join(src, "training_stats.json"), os.path.join(dst, "training_stats.json"))
    if replay:
        shutil.copy(os.path.join(src, name + ".replay.npz"),
                    os.path.join(dst, name + ".replay.npz"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Directories of: one rank, 2 iterations; 2-rank data-parallel, 2
    iterations; the same with a fault at iteration 2 on each rank under
    ``--auto-restart 2``; 2-rank ``--model-parallel 2``, 1 iteration. The
    pods run while the one-rank run runs here."""
    root = tmp_path_factory.mktemp("multirank")
    d = {k: root / k for k in ("one", "dp", "restart", "tp")}
    pods = [
        Pod(d["dp"]),
        Pod(d["restart"], ["--auto-restart", "2"],
            rank_env={i: {"XQAZ_FAULT_ITER": f"2:{root}/fault_p{i}"} for i in range(2)}),
        Pod(d["tp"], ["--model-parallel", "2", "--iterations", "1"]),
    ]
    _one_rank(d["one"])
    for p in pods:
        p.wait()
    # keep what the tests read: a checkpoint is ~0.4 GB (the policy head
    # alone has 23M params), and the suite's disk is shared
    for name in ("one", "dp", "tp", "restart"):
        for f in os.listdir(d[name]):
            if f.startswith(("checkpoint_iter2", "best_model")) or (
                    name == "restart" and f.startswith("checkpoint_iter")):
                os.remove(d[name] / f)
    d["root"] = root
    yield d
    shutil.rmtree(root)   # ~0.4 GB a checkpoint: the policy head is 23M params


@pytest.fixture
def scratch(tmp_path):
    """``tmp_path``, deleted after the test (checkpoints are large)."""
    yield tmp_path
    shutil.rmtree(tmp_path)


def _assert_same_selfplay_and_losses(got, want, loss_rtol):
    assert got["self_play"] == want["self_play"]
    assert got["training"]["batches"] == want["training"]["batches"]
    for k in ("policy_loss", "value_loss", "total_loss"):
        np.testing.assert_allclose(got["training"][k], want["training"][k], rtol=loss_rtol,
                                   err_msg=k)


def _assert_params_close(a_dir, b_dir, name="checkpoint_iter1"):
    a = torch.load(os.path.join(a_dir, name), weights_only=True)
    b = torch.load(os.path.join(b_dir, name), weights_only=True)
    assert a["params"].keys() == b["params"].keys()
    for k, v in a["params"].items():
        np.testing.assert_allclose(b["params"][k].numpy(), v.numpy(), rtol=1e-2, atol=1e-3,
                                   err_msg=k)


@pytest.mark.parametrize("pod", ["dp", "tp"])
def test_two_ranks_match_one_rank(runs, pod):
    one, got = _without_times(_stats(runs["one"])), _without_times(_stats(runs[pod]))
    assert [s["iteration"] for s in got] == ([1, 2] if pod == "dp" else [1])
    _assert_same_selfplay_and_losses(got[0], one[0], 1e-5)
    _assert_params_close(runs["one"], runs[pod])
    with np.load(runs["one"] / "checkpoint_iter1.replay.npz") as a, \
            np.load(runs[pod] / "checkpoint_iter1.replay.npz") as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    if pod == "dp":
        _assert_same_selfplay_and_losses(got[1], one[1], 1e-3)
        assert got[1]["evaluation"] == one[1]["evaluation"]
        assert got[1]["evaluation"]["plies"] > 0
    # one log-file writer; every rank's lines carry its rank
    log = (runs[pod] / "training.log").read_text()
    assert "[p0]" in log and "[p1]" not in log


def test_restarted_pod_equals_uninterrupted_pod(runs):
    """The fault fired on both ranks, each rank's supervisor resumed it
    from checkpoint_iter1, and the run equals the uninterrupted pod's."""
    assert (runs["root"] / "fault_p0").exists() and (runs["root"] / "fault_p1").exists()
    got, want = _stats(runs["restart"]), _stats(runs["dp"])
    assert [s["iteration"] for s in got] == [1, 2]
    assert _without_times(got) == _without_times(want)
    assert got[1]["evaluation"], "the iteration-2 gated eval must have run"


@pytest.mark.parametrize("direction", ["tp_to_one", "one_to_tp"])
def test_checkpoint_resumes_across_mesh_shapes(runs, scratch, direction):
    """Iteration 1's checkpoint of one layout resumes in the other; the
    resumed iteration 2 matches the one-rank run's (no eval: the eval
    interval is raised past it)."""
    src = runs["tp"] if direction == "tp_to_one" else runs["one"]
    dst = scratch / "resumed"
    _copy_checkpoint(src, dst)
    args = ["--resume", str(dst / "checkpoint_iter1"), "--eval-interval", "4"]
    if direction == "tp_to_one":
        _one_rank(dst, *args)
    else:
        Pod(dst, [*args, "--model-parallel", "2"]).wait()
    got, want = _without_times(_stats(dst)), _without_times(_stats(runs["one"]))
    assert [s["iteration"] for s in got] == [1, 2]
    _assert_same_selfplay_and_losses(got[1], want[1], 1e-3)


def test_replay_ring_guard_raises_on_every_rank(runs, scratch):
    """Each rank resumes its own copy of a checkpoint; rank 1's copy lacks
    the replay ring, so both ranks must refuse it."""
    for i in (0, 1):
        _copy_checkpoint(runs["one"], scratch / f"p{i}", replay=i == 0)
    pod = Pod(scratch / "ckpt", rank_args={
        i: ["--resume", str(scratch / f"p{i}" / "checkpoint_iter1")] for i in (0, 1)})
    for i, (rc, out) in enumerate(pod.wait(ok=False)):
        assert rc != 0, f"rank {i} missed the guard:\n{out[-3000:]}"
        assert "exists on some ranks but not all" in out, out[-3000:]
