"""CLI entry: python -m xiangqi_alphazero_torch.train --mode quick|standard|full|tpu

Mirrors the JAX package's CLI (reference: training/train.py:707-764): the
presets, their overrides, ``--resume PATH`` (a ``checkpoint_iter{N}``) and
``--init-from PATH`` (a ``best_model.pt``). Trains on the card unless given
``--device cpu``.

Several processes: run the same command in each with its own
``--process-id i`` and ``--coordinator HOST:PORT --num-processes N``
(``distributed.py`` picks the backend and each rank's card). One process on
a host with several visible cards and ``--mesh-mode auto`` starts one rank
per card itself, over a local TCP store, as the JAX package's single
process meshes all local devices. ``--auto-restart N`` supervises the run:
it relaunches it from its newest checkpoint after a failure, and kills a
run that makes no progress in its checkpoint directory for
``XQAZ_STALL_TIMEOUT_S`` seconds. The run it supervises takes cuDNN's
deterministic algorithms on the card, so that a resumed run is
bit-identical to an uninterrupted one; a run without ``--auto-restart``
keeps cuDNN's defaults.
"""

import logging
import os
import signal
import subprocess
import sys
import time

from .checkpoint import latest_checkpoint
from .config import build_argparser, config_from_args

_CLI = [sys.executable, "-m", "xiangqi_alphazero_torch.train"]
# set by the supervisor for the runs it starts
_SUPERVISED = "XQAZ_SUPERVISED"


def _probe_device(timeout_s: int = 120) -> bool:
    """Whether the card answers: ``torch.cuda.is_available()`` and a small
    product on it, in a child process that can be killed if the device
    hangs (the JAX package probes its TPU the same way)."""
    try:
        subprocess.run(
            [sys.executable, "-c",
             "import torch; assert torch.cuda.is_available();"
             "x = torch.ones(8, 8, device='cuda'); assert (x @ x)[0, 0].item() == 8.0"],
            timeout=timeout_s, check=True,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )
        return True
    except (subprocess.TimeoutExpired, subprocess.CalledProcessError):
        return False


def _wait_for_device(max_wait_s: int, retry_s: int = 60) -> bool:
    """Block (bounded) until the card answers; True if it did."""
    deadline = time.monotonic() + max_wait_s
    while True:
        if _probe_device():
            return True
        if time.monotonic() >= deadline:
            return False
        print(f"[supervisor] CUDA device unreachable; retrying in {retry_s} s "
              f"({int(deadline - time.monotonic())} s of patience left)", flush=True)
        time.sleep(retry_s)


def _run_with_stall_watchdog(cmd, ckpt_dir: str, stall_timeout_s: int) -> int:
    """Run the training child in its own process group; if it makes no
    filesystem progress under ``ckpt_dir`` for ``stall_timeout_s``, kill
    the GROUP (only the group this created) and return 98. The trainer
    touches ``<ckpt_dir>/.heartbeat`` at every phase boundary, so the
    timeout bounds one silent phase, not an iteration. The child is polled
    every ``min(30, stall_timeout_s / 5)`` seconds."""
    poll_s = min(30.0, max(stall_timeout_s / 5.0, 0.1))

    def progress_mtime() -> float:
        newest = 0.0
        if os.path.isdir(ckpt_dir):
            for name in os.listdir(ckpt_dir):
                try:
                    newest = max(newest, os.path.getmtime(os.path.join(ckpt_dir, name)))
                except OSError:
                    pass
        return newest

    proc = subprocess.Popen(cmd, start_new_session=True)
    last_progress = time.monotonic()
    last_mtime = progress_mtime()
    while True:
        try:
            return proc.wait(timeout=poll_s)
        except subprocess.TimeoutExpired:
            pass
        m = progress_mtime()
        if m > last_mtime:
            last_mtime = m
            last_progress = time.monotonic()
        elif time.monotonic() - last_progress > stall_timeout_s:
            print(f"[supervisor] no checkpoint-dir progress for {stall_timeout_s} s; "
                  f"killing hung child pgid {proc.pid}", flush=True)
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
            return 98   # sentinel: stalled, not a clean failure


def _strip(argv, flag: str):
    """``argv`` without ``flag VALUE`` and ``flag=VALUE``."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a == flag:
            skip = True
        elif not a.startswith(flag + "="):
            out.append(a)
    return out


def _supervise(argv, attempts: int, ckpt_dir: str, on_cpu: bool) -> int:
    """Relaunch the training process from the newest checkpoint on
    failure, up to ``attempts`` times. A dead device is not recoverable in
    process, so recovery is a fresh process resuming from the last
    checkpoint (which carries the nets, the optimizer, the generators and
    the replay ring: the resumed run continues bit-identically). Before
    each launch the card is probed, and the supervisor waits up to
    ``XQAZ_RESTART_MAX_WAIT_S`` (default 3600 s) for it without spending
    an attempt; a child with no checkpoint-dir progress for
    ``XQAZ_STALL_TIMEOUT_S`` (default 1800 s) is killed. Under several
    processes each runs its own supervisor; the relaunched ranks meet
    again at the coordinator."""
    base = _strip(argv, "--auto-restart")
    max_wait = int(os.environ.get("XQAZ_RESTART_MAX_WAIT_S", "3600"))
    stall_timeout = int(os.environ.get("XQAZ_STALL_TIMEOUT_S", "1800"))
    os.environ[_SUPERVISED] = "1"   # the children's cuDNN: deterministic
    rc = 1
    for attempt in range(attempts + 1):
        if not on_cpu and not _wait_for_device(max_wait):
            print("[supervisor] CUDA device never came back; giving up", flush=True)
            return 97
        child = list(base)
        latest = latest_checkpoint(ckpt_dir)
        if latest is not None:   # resume the newest checkpoint, over any --resume
            child = _strip(child, "--resume") + ["--resume", latest]
        rc = _run_with_stall_watchdog(_CLI + child, ckpt_dir, stall_timeout)
        if rc == 0:
            return 0
        if attempt < attempts:
            print(f"[supervisor] training exited rc={rc}; restarting "
                  f"({attempts - attempt} attempts left, "
                  f"resume={latest_checkpoint(ckpt_dir)})", flush=True)
    return rc


def _launch_local_ranks(argv, n: int) -> int:
    """One rank per visible card over a local TCP store; returns the first
    failing rank's code (the others are then stopped), else 0."""
    from ..distributed import free_port

    port = free_port()
    procs = [subprocess.Popen(_CLI + list(argv) + [
        "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(n),
        "--process-id", str(i)]) for i in range(n)]
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c]
            if failed or all(c == 0 for c in codes):
                return failed[0] if failed else 0
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_argparser().parse_args(argv)
    cfg, resume = config_from_args(args)

    if args.auto_restart:
        return _supervise(argv, args.auto_restart, cfg.checkpoint_dir,
                          on_cpu=args.device == "cpu")

    import torch

    device = args.device
    if (cfg.num_processes == 1 and cfg.mesh_mode == "auto"
            and torch.device(device).type == "cuda" and torch.cuda.device_count() > 1):
        return _launch_local_ranks(argv, torch.cuda.device_count())
    os.makedirs(cfg.checkpoint_dir, exist_ok=True)
    handlers = [logging.StreamHandler()]
    if cfg.process_id == 0:   # one log-file writer per shared checkpoint dir
        handlers.append(logging.FileHandler(os.path.join(cfg.checkpoint_dir, "training.log")))
    logging.basicConfig(
        level=logging.INFO,
        format=("%(asctime)s [%(levelname)s] %(message)s" if cfg.num_processes == 1
                else f"%(asctime)s [%(levelname)s] [p{cfg.process_id}] %(message)s"),
        handlers=handlers,
        force=True,
    )
    if cfg.num_processes > 1:
        from ..distributed import distributed_init

        device = distributed_init(cfg.coordinator_address, cfg.num_processes,
                                  cfg.process_id, device).device

    from .trainer import AlphaZeroTrainer

    # cuDNN's default backward algorithms may sum in another order from run
    # to run: a supervised run resumes bit-identically only with the
    # deterministic ones
    torch.backends.cudnn.deterministic = os.environ.get(_SUPERVISED) == "1"
    trainer = AlphaZeroTrainer(cfg, device=device)
    trainer.train(resume=resume, init_from=args.init_from)
    from ..ops import legal_mask as LM

    logging.getLogger("xiangqi_az_torch").info(
        "legal_mask kernel launches: %d", LM.legal_mask_cuda.launches)
    if cfg.num_processes > 1:
        from ..distributed import shutdown

        shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
