"""The port's ``--auto-restart`` supervisor and its stall watchdog
(``xiangqi_alphazero_torch/train/__main__.py``), as the JAX package's
``tests/test_train.py`` tests its own: a fault injected at iteration 2
(``XQAZ_FAULT_ITER``) is survived by a relaunch from checkpoint_iter1, a
child that makes no checkpoint-dir progress is killed by its process
group, and a clean exit code passes through. The port's watchdog polls
every min(30, timeout / 5) s where the JAX one polls every 30 s, so the
kill test takes seconds. The 2-rank restart is in
``test_torch_multirank.py``."""

import json
import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_auto_restart_supervisor(tmp_path):
    """An injected fault kills the run at iteration 2; the supervisor
    resumes it from checkpoint_iter1 and the run completes."""
    import subprocess

    ckpt = tmp_path / "ckpt"
    marker = tmp_path / "fault_fired"
    env = dict(os.environ, XQAZ_FAULT_ITER=f"2:{marker}", OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "xiangqi_alphazero_torch.train", "--device", "cpu",
           "--mode", "quick", "--iterations", "2", "--games-per-iter", "2",
           "--simulations", "4", "--channels", "8", "--res-blocks", "1",
           "--max-game-length", "8", "--eval-games", "2", "--eval-interval", "10",
           "--epochs", "1", "--batch-size", "16", "--save-interval", "1",
           "--min-buffer", "1", "--checkpoint-dir", str(ckpt), "--seed", "11",
           "--auto-restart", "2"]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert marker.exists()   # the fault really fired once
    assert "[supervisor] training exited" in proc.stdout
    assert (ckpt / "checkpoint_iter2").is_file()
    with open(ckpt / "training_stats.json") as f:
        stats = json.load(f)
    assert [s["iteration"] for s in stats] == [1, 2]
    shutil.rmtree(ckpt)   # ~0.4 GB a checkpoint: the policy head is 23M params


def test_stall_watchdog_kills_hung_child(tmp_path):
    """A child that makes no checkpoint-dir progress past the stall
    timeout is killed by its own process group and reported with the
    stall sentinel rc."""
    from xiangqi_alphazero_torch.train.__main__ import _run_with_stall_watchdog

    t0 = time.monotonic()
    rc = _run_with_stall_watchdog(
        [sys.executable, "-c", "import time; time.sleep(600)"],
        str(tmp_path), stall_timeout_s=3,
    )
    assert rc == 98
    assert time.monotonic() - t0 < 30   # killed, did not sit out the sleep


def test_stall_watchdog_passes_through_clean_exit(tmp_path):
    from xiangqi_alphazero_torch.train.__main__ import _run_with_stall_watchdog

    rc = _run_with_stall_watchdog(
        [sys.executable, "-c", "raise SystemExit(7)"],
        str(tmp_path), stall_timeout_s=600,
    )
    assert rc == 7
