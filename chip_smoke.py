#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py [--dense-baseline PATH] [--only multirank|nccl|tools]

``--dense-baseline`` names a copy of the earlier dense legal-mask kernel
(one thread per action over per-action constants; for example
``git show 975e6d0:xiangqi_alphazero_torch/csrc/legal_mask.cu`` saved under
the ignored ``xiangqi_alphazero_torch/_build/``). It is built beside the
kernel and timed against it, interleaved, in the same run; without it that
comparison is left out.

Phases, each of which asserts (any failure exits nonzero, nothing is caught
and carried on):

1. device: the card's name and count, and its power limit from nvidia-smi;
2. build: ``nvcc`` builds every ``csrc/*.cu`` for sm_90a, all at once;
3. kernel: the legal-mask kernel against its plain PyTorch version on the
   card, bit for bit (tolerance: exact equality), on 16,384 boards of
   seeded random playouts, the hand-made edge boards and 32 wild boards, at
   ragged batches around every boundary of its grid and at the training
   path's (32, 256, 512), with every split of a row over blocks, and at
   B = 16384 in one call (the plain version in
   chunks of 2048); ~200 playout and edge boards also against the
   pure-Python oracle. Each call moves the launch counter by one;
4. search: ``run_mcts`` with a dyadic mock network gives exactly the CPU's
   visits on the card;
5. net: the card's forward of the 128-channel, 6-block net against the CPU
   forward of the same weights (float32 on both, TF32 off; atol 1e-3 on
   logits and values, for sums taken in other orders over 13 conv layers);
6. serve, the main path: a reference-layout ``.pt`` of seeded random weights
   at 128 channels x 6 blocks is served by the port's HTTP API on localhost,
   on the card, at 500 simulations: load_model, new_game, three human moves
   (each AI reply legal by the oracle), and four sessions moving at once
   (the searches must coalesce). The kernel's launch count is set to 0
   just before and read just after;
6b. train, the training path (``xiangqi_alphazero_torch.train``):
   (a) lockstep self-play of 8 games x 16 simulations x 24 plies with the
   dyadic mock network, openings and resign on, on the card and on the CPU
   from the same seeded CPU draws: every recorded array and the winners
   exactly equal (at temperature 1 throughout; a second fleet past the
   temperature threshold holds ``pi_probs`` at atol 1e-6, since the card's
   and the CPU's ``pow`` differ in the last bits), and ``evaluate_pair`` at
   8 games of two exact mock nets with peaked priors: equal winners and
   final boards; (b) one learner step at 128 channels x 6
   blocks, float32 with TF32 off, batch 256 from that replay, card against
   CPU: losses at rtol 1e-5, each device's gradients elementwise within
   1e-4 |g| + 1e-4 max |g| of a float64 backward on the same ReLU branches
   (see ``check_learner_card_vs_cpu``), after one Adam step at most 0.1%
   of the parameters beyond 0.05 lr, batch-norm statistics at atol 1e-6 +
   rtol 1e-5; (c) ``AlphaZeroTrainer``
   on the card with the ``tpu`` preset's net, fleet and batch (128 x 6, 512
   games, batch 1024, bf16), only depth cut (logged), 2 iterations with
   eval and checkpoints. The kernel's launch count is set to 0 just before
   ``train()`` and must equal what the loop's own ply and simulation
   counters predict; after it, the kernel equals its plain version on the
   fleet's replay boards at an eval half (32) and at the fleet (512). It
   prints the training path's rates, peak memory and a ``torch.profiler``
   reading of 1 self-play ply;
6c. gumbel, the Gumbel paths: (a) ``run_gumbel_mcts`` at 8 positions x 64
   simulations, m = 16, with the dyadic mock network and root draws from
   CPU generators of one seed: visits, chosen, actions and order on the
   card exactly the CPU's, pi_improved within 1e-6, and lane 0 alone
   equal to lane 0 of the batch; (b) the HTTP API with
   ``search_algo="gumbel"`` on the same ``.pt`` as phase 6: three AI moves
   at 500 and three at 32 simulations, each launching the kernel exactly
   once for its root state and once per simulation, and four coalesced
   session moves, each acting a move its search visited; (c) the trainer
   of 6b (c) with ``search_algo="gumbel"`` at 32 simulations (the same
   cuts, logged), its launches equal to the loop's prediction, the kernel
   equal to its plain version on the fleet's boards, rates and a profile
   of 1 ply; (d) an arena match, Gumbel-32 against PUCT-32 on one net,
   16 games, a 24-ply cap: counts that sum to the games, launches equal to
   1 + plies x (2 x 32 + 1);
7. timings: the kernel at B = 1 (the opening) and 2, 4, 8, 32 (an eval
   half of the ``tpu`` preset), 256 (half of a 512-game eval), 512 (the
   ``tpu`` fleet), 2048, 16384 (mid-game boards), each first checked
   against its plain version, as the profiler's device time per launch and as
   CUDA-events time per back-to-back call, beside its bytes bound, the
   device time of a fill of the same bytes (a floor) and its plain
   version, and beside the dense baseline when given (old, new, new, old); the device time of each split of a row over blocks at B = 1..8;
   the net forward at B = 1 and 8 (CUDA events);
8. ``torch.profiler`` over one search of 50 simulations, PUCT and then
   Gumbel, for where an AI move's time goes (device busy share, launches, top kernels, host ops);
   then one search of the opening at 200 simulations by each, timed
   without the profiler, interleaved (PUCT, Gumbel, Gumbel, PUCT);
9. tools, at 128 channels x 6 blocks on the card: (a) ``python -m
   xiangqi_alphazero_torch.serve export`` run as a user runs it, as 8
   processes at once: phase 6's ``.pt`` and phase 6b (c)'s
   ``checkpoint_iter2`` in the four formats; each artifact reloaded from
   disk and verified against the card's float32 forward at atol 2e-3 (the
   ``.pt`` and the npz in the port's net on the card, TorchScript through
   ``torch.jit.load`` on the card, ONNX through the ``onnx_lite`` walker),
   and the re-exported ``.pt`` serving the original's first AI move at 64
   simulations; (b) the int8 twin on the card against the CPU on 512
   playout boards: the first layer's int8 activations equal, logits and
   values within 1e-3, legal argmax agreement >= 99%; then the int8,
   float32 and bf16 forwards timed at B = 1, 8, 256, 512 (CUDA events,
   interleaved); (c) ``utils.benchmark`` at the standard preset's net
   (128 x 6) at 64 simulations and batch 256 with ``--trace DIR``: its table, the kernel's launches equal to its rows'
   prediction (the ``benchmark`` path of the ``kernels`` line), and
   ``utils.trace_tools`` on the trace (device time within the traced
   wall); (d) the native rules core built with the host's C++ compiler,
   its movegen equal to the Python movegen on ~200 playout and edge
   boards and taken by the oracle, ``minimax_move`` at depth 2 legal and
   repeatable, and both movegens' rates.

10. multirank, the multi-device path at 128 channels x 6 blocks, float32
   with TF32 off: (a) data-parallel, 2 ranks over gloo pinned to one card
   against 1 rank: the probes (``xiangqi_alphazero_torch.parallel.probe``)
   play 64 games of self-play (16 simulations, a 16-move cap) and an
   8-game eval with the exact mock nets, whose records, replay ring and
   outcomes equal 1 rank's exactly; with the real net they print the share
   of identical games; one learner step at batch 256 against 1 rank's
   (``check_step``: losses, Adam's first moment, which holds the reduced,
   clipped gradient, the parameters and the batch-norm statistics), and 8
   steps of the trainer's learner path, each within MR_NOISE times the
   witness of rounding alone, 1 rank on the rows in reverse order; the
   learner step under the profiler, the collectives'
   time read from the trace; a profile of one 2-rank ply (the card's idle
   share); then the training CLI on 1 rank and on 2 (the quick preset at
   full width, only depth cut, logged; both under ``--auto-restart 1``,
   which takes cuDNN's deterministic algorithms), its losses and
   max|dparam| printed, every rank's kernel launches equal to its loop
   counters; (b) TP, ``--model-parallel 2`` over the 2 ranks: the sharded
   forward against the replicated one (logits atol 1e-4, values 1e-5), one
   TP step checked as in (a), and one CLI iteration; (c) the 2-rank pod
   with a fault injected at iteration 2 on every rank under
   ``--auto-restart 1``: its ``training_stats.json`` equals the
   uninterrupted 2-rank run's exactly (times left out); (d) where there
   are two cards, the probes of (a) over NCCL, a card a rank, checked as
   in (a), and the CLI as one process with ``--mesh-mode auto``, which
   starts a rank a card (else logged as unmeasured); (e) one learner step
   with cuDNN's default and its deterministic algorithms, interleaved.
   Every launch has a timeout. It prints self-play simulations/s (1 rank;
   per rank and in all at 2), learner ms a step at 1 and 2 ranks, the
   collectives' ms a step, the idle share and the phase's wall, beside the
   card's name and power limit. ``--only multirank`` runs phases 1, 2 and
   10; ``--only nccl`` phases 1, 2 and (d) with the 1-rank runs it is held
   against.
11. flagship and tools, on the card: (a) ``scripts/flagship_run.sh`` as a
   user runs it (the training CLI under ``--auto-restart``) at the flagship
   width, fleet and batch (256 channels x 10 blocks, Gumbel-32, 256 games,
   batch 1024, bf16), only depth cut, each cut logged: 2 iterations, a
   40-move cap, 1 epoch, the gated eval past the last iteration (at the
   recipe's 100 simulations it would take ~1 min), a min-buffer the first
   iteration fills. It prints self-play
   simulations/s and s per ply, learner ms a step, s per iteration and
   peak device memory; the kernel's launches must equal the loop counters'
   prediction; (b) ``scripts/minimax_anchor.play_match``: (a)'s
   ``checkpoint_iter2`` at 32 simulations (cut from 200) against minimax
   depth 1, 8 games (W + D + L == 8, launches == searches x (8 + 32)); then
   2 games at 8 simulations and depth 0 on phase 6's 128 x 6 ``.pt``, on
   the card and on the CPU, equal in every field (else the first search
   that differs is named); (c) ``scripts/serve_latency.run_grid`` on phase
   6's ``.pt`` at {100, 500} simulations x {1, 4} sessions (8 requests a
   cell at 100, 4 at 500) and on (a)'s net at 500 x 1 (4 requests), every
   batch width warmed first: p50, the slowest request and the count (too
   few for a p95), moves/s and the mean coalesced batch; (d)
   ``scripts/h2h_gumbel_puct --skip-train`` over the arms of 6b (c) (PUCT)
   and 6c (c) (Gumbel): the arena over their current parameters, 8 games
   of PUCT-4 a side (cut from 40), the arena's 300-ply cap (counts sum to
   the games, launches == 1 + plies x 9); an Elo ladder of 6b (c)'s
   initial net against its checkpoint, and ``scripts/strength_report`` of
   6b (c)'s run over it. The 8-game matches are plumbing checks, not
   strength measurements.
   ``--only tools`` runs phases 1, 2, the two training runs of 6b (c) and
   6c (c), and 11.

The line before the last lists each kernel as JSON; the last line is
``{"ok": true, "device": {...}}``. Without CUDA it exits nonzero before
printing any result.
"""

import argparse
import contextlib
import copy
import ctypes
import dataclasses
import gc
import io
import json
import logging
import os
import shlex
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch

from xiangqi_alphazero_torch.distributed import free_port
from xiangqi_alphazero_torch.engine import env as E
from xiangqi_alphazero_torch.engine import tables as T
from xiangqi_alphazero_torch.engine.edge_boards import edge_boards, wild_boards
from xiangqi_alphazero_torch.engine import native, oracle
from xiangqi_alphazero_torch.engine.oracle import Position, decode_action
from xiangqi_alphazero_torch.models import (
    XiangqiNet,
    init_net,
    load_reference_pt,
    policy_logits_fn,
)
from xiangqi_alphazero_torch.models import quant as Q
from xiangqi_alphazero_torch.ops import _build
from xiangqi_alphazero_torch.ops import legal_mask as LM
from xiangqi_alphazero_torch.parallel import probe as PROBE
from xiangqi_alphazero_torch.parallel.probe import dyadic_eval, peaked_dyadic_eval
from xiangqi_alphazero_torch.scripts import h2h_gumbel_puct as H2H
from xiangqi_alphazero_torch.scripts import minimax_anchor as MINIMAX
from xiangqi_alphazero_torch.scripts import serve_latency as LATENCY
from xiangqi_alphazero_torch.scripts import strength_report as REPORT
from xiangqi_alphazero_torch.search import GumbelConfig, MCTSConfig, run_gumbel_mcts, run_mcts
from xiangqi_alphazero_torch.serve import export as TX
from xiangqi_alphazero_torch.serve.api import make_server
from xiangqi_alphazero_torch.serve.predictor import Predictor
from xiangqi_alphazero_torch.train import arena as TARENA
from xiangqi_alphazero_torch.train import config as TC
from xiangqi_alphazero_torch.train import elo as ELO
from xiangqi_alphazero_torch.train import learner as TL
from xiangqi_alphazero_torch.train import selfplay as TS
from xiangqi_alphazero_torch.train import evaluate as TE
from xiangqi_alphazero_torch.train.evaluate import EvalSettings, evaluate_pair
from xiangqi_alphazero_torch.train.replay import ReplayBuffer
from xiangqi_alphazero_torch.train.trainer import AlphaZeroTrainer
from xiangqi_alphazero_torch.utils import benchmark as BENCH
from xiangqi_alphazero_torch.utils import trace_tools as TT

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
INT32_OPS_PER_S = 33.5e12     # H100 SXM, 64 INT32 lanes per SM, half the fp32 rate
CHANNELS, BLOCKS = 128, 6     # the shipped model's width
SIMS = 500                    # the API's default search depth
PROFILE_SIMS = 50             # the profiler's cost grows with its events: 50 keeps the
                              # whole run inside its time limit
COMPARE_SIMS = 200            # phase 8's interleaved PUCT-against-Gumbel search (was SIMS)
BOARDS, PLIES, SEED = 2048, 80, 0   # playouts kept every 10 plies: 8 x 2048 boards
TIMED_BATCHES = (1, 2, 4, 8, 32, 256, 512, 2048, 16384)
SPLITS = (1, 2, 4, 8, 16)           # blocks per board, timed at B <= 8
KERNELS = [
    {
        "name": "legal_mask",
        "route": "cuda",
        "source": "xiangqi_alphazero_torch/csrc/legal_mask.cu",
        "replaces": "xiangqi_alphazero_tpu/ops/legal_mask.py:393",
        "wrapper": LM.legal_mask_cuda,
        "library_ms": None,   # no single PyTorch call computes this function
    },
]


def log(*args) -> None:
    print(*args, flush=True)


# ------------------------------------------------------------------ phases


def phase_device() -> dict:
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name} (count {count}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return {"kind": name, "count": count, "smi": smi}


def phase_build(dense_src) -> None:
    t0 = time.perf_counter()
    results = _build.build_all(extra={DenseBaseline.NAME: dense_src} if dense_src else None)
    log(f"build: {len(results)} source(s) in {time.perf_counter() - t0:.2f} s")
    for r in results.values():
        log(f"  {r.name}: nvcc {r.seconds:.2f} s -> {r.path.name}")
        for line in r.log.splitlines():
            if "Used" in line or "stack frame" in line:
                log("   ", line.strip())


def random_boards(dev, n: int, plies: int, seed: int):
    """Boards and sides of ``n`` seeded random playouts on ``dev``, kept
    every 10 plies: int8[plies // 10, n, 90] and int8[plies // 10, n]."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    st = E.reset_batch(n, device=dev)
    boards, sides = [], []
    for ply in range(1, plies + 1):
        scores = torch.rand((n, E.ACTION_SPACE), generator=gen, device=dev)
        st = E.step_batch(st, torch.where(st.legal, scores, -1.0).argmax(dim=1))
        if ply % 10 == 0:
            boards.append(st.board)
            sides.append(st.side)
    return torch.stack(boards), torch.stack(sides)


def to_dev(dev, boards: np.ndarray, sides) -> tuple:
    return (torch.tensor(np.asarray(boards), dtype=torch.int8, device=dev),
            torch.tensor(np.asarray(sides), dtype=torch.int8, device=dev))


def check_kernel(kern, b, s, **kw) -> tuple:
    """One kernel call against the plain version (in chunks of 2048); the
    launch counter must move by exactly one. Returns the legal moves and
    the largest difference."""
    before = kern.launches
    got = kern(b.contiguous(), s.contiguous(), **kw)
    torch.cuda.synchronize()
    assert kern.launches == before + 1, "the launch counter must move by one per call"
    err = 0
    for i in range(0, len(b), 2048):
        want = E.legal_mask(b[i:i + 2048], s[i:i + 2048])
        err = max(err, int((got[i:i + 2048].int() - want.int()).abs().max()))
        assert torch.equal(got[i:i + 2048], want), f"kernel != plain at B={len(b)}, boards {i}.. {kw}"
    return int(got.sum()), err


def phase_kernel(dev, playouts) -> int:
    """The kernel against its plain version and the oracle; returns the
    largest difference seen (0: every comparison is asserted bit-exact)."""
    kern = LM.legal_mask_cuda
    edges = edge_boards().values()
    edge_b, edge_s = to_dev(dev, np.stack([b for b, _ in edges]), [s for _, s in edges])
    wild_b, wild_s = to_dev(dev, *wild_boards(32, SEED))
    play_b, play_s = playouts[0].reshape(-1, E.NSQ), playouts[1].reshape(-1)
    # ragged batches around every boundary of the grid: edge and wild boards
    # first, then playouts
    mix_b = torch.cat([edge_b, wild_b, play_b])
    mix_s = torch.cat([edge_s, wild_s, play_s])
    err = 0
    for b in (1, 2, 3, 4, 5, 7, 8, 9, 15, 16, 17, 32, 127, 128, 129, 256, 512, 2048):
        n, e = check_kernel(kern, mix_b[:b], mix_s[:b])
        err = max(err, e)
        log(f"kernel vs plain, B={b}: equal ({n} legal moves)")
    for split in (1, 2, 4, 8, 16, 32, 64):
        for b in (1, 5, 9, 41):
            err = max(err, check_kernel(kern, mix_b[:b], mix_s[:b], blocks_per_board=split)[1])
    log("kernel vs plain: every split of a row over 1..64 blocks equal at B = 1, 5, 9, 41")
    n, e = check_kernel(kern, wild_b, wild_s)
    err = max(err, e)
    log(f"kernel vs plain: {len(wild_b)} wild boards equal ({n} legal moves)")
    n, e = check_kernel(kern, play_b, play_s)
    err = max(err, e)
    log(f"kernel vs plain, B={len(play_b)} in one call: equal ({n} legal moves)")
    boards = torch.cat([play_b, edge_b])
    sides = torch.cat([play_s, edge_s])
    idx = np.unique(np.r_[np.linspace(0, len(play_b) - 1, 190).astype(int),
                          np.arange(len(play_b), len(boards))])
    got = kern(boards[idx].contiguous(), sides[idx].contiguous()).cpu()
    for row, i in enumerate(idx):
        pos = Position()
        pos.board = [int(x) for x in boards[i].tolist()]
        pos.side = int(sides[i])
        want = set(pos.legal_actions())
        assert set(torch.nonzero(got[row])[:, 0].tolist()) == want, f"oracle, board {i}"
    log(f"kernel vs oracle: {len(idx)} boards equal")
    return err


class DenseBaseline(LM.LegalMaskKernel):
    """The earlier dense design of the legal-mask kernel (one block per
    board, one thread per action over per-action constants), built from a
    source named on the command line, for timing beside the kernel in the
    same run. It shares the kernel's wrapper checks, so the two differ only
    on the card. It is no part of the package."""

    NAME = "legal_mask_dense"
    SYMBOL = "legal_mask_kernel"

    def __init__(self, src: str, dev):
        super().__init__()
        fn = _build.load(self.NAME, src).xq_legal_mask
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        self.fn = fn
        t = T.tables()
        flags = np.zeros(E.ACTION_SPACE, np.int16)
        for bit, (key, side) in enumerate(LM.CLASSES):   # its flag bits, in this order
            flags |= (t[key] if side is None else t[key][side]).astype(np.int16) << bit
        block = t["BLOCK"].T.astype(bool)
        squares = np.zeros((E.ACTION_SPACE, 8), np.uint8)
        for a in np.flatnonzero(block.any(axis=1)):
            sq = np.flatnonzero(block[a])
            squares[a, :len(sq)] = sq
        self.consts = [torch.from_numpy(c).to(dev) for c in
                       (flags, block.sum(axis=1).astype(np.uint8), squares)]

    def _launch(self, board, side, out, blocks_per_board) -> int:
        return self.fn(board.data_ptr(), side.data_ptr(),
                       *[c.data_ptr() for c in self.consts], out.data_ptr(),
                       board.shape[0], torch.cuda.current_stream().cuda_stream)


def advance_random(plies: int, seed: int) -> Position:
    """The oracle rolled forward by seeded random legal moves, history
    stripped (as the search parity of the JAX package's tests does)."""
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


def phase_search(dev, sims: int = 64) -> None:
    cases = [advance_random(p, s) for p, s in
             [(0, 0), (3, 1), (8, 2), (15, 3), (26, 4), (37, 5)]]
    roots = E.cat_states([
        E.state_from_numpy(np.asarray(p.board, np.int8), p.side) for p in cases
    ])
    cfg = MCTSConfig(num_simulations=sims)
    with torch.inference_mode():
        cpu = run_mcts(dyadic_eval, roots, cfg, add_noise=False)
        card = run_mcts(dyadic_eval, roots.to(dev), cfg, add_noise=False)
    for f in ("visits", "actions", "order", "valid"):
        assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), f
    log(f"search on the card == CPU: {len(cases)} positions x {sims} sims, "
        f"visits {card.visits.sum(dim=1).tolist()}")


def write_random_pt(path: str, seed: int) -> None:
    """A reference-layout .pt of seeded random weights at the shipped width,
    with non-trivial batch-norm statistics."""
    gen = torch.Generator().manual_seed(seed)
    torch.manual_seed(seed)
    net = XiangqiNet(CHANNELS, BLOCKS)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    torch.save(
        {"model_state_dict": net.state_dict(),
         "config": {"num_channels": CHANNELS, "num_res_blocks": BLOCKS}},
        path,
    )


def positions_features(dev, n: int, seed: int) -> torch.Tensor:
    boards, sides = [], []
    for i in range(n):
        p = advance_random(3 * i, seed + i)
        boards.append(p.board_array())
        sides.append(p.side)
    return E.features(torch.tensor(np.stack(boards), device=dev),
                      torch.tensor(sides, dtype=torch.int8, device=dev))


def phase_net(dev, pt: str) -> torch.nn.Module:
    cpu_net = load_reference_pt(pt)
    card_net = load_reference_pt(pt).to(dev)
    x = positions_features("cpu", 8, seed=11)
    with torch.inference_mode():
        want = cpu_net(x)
        got = card_net(x.to(dev))
    errs = [float((g.cpu() - w).abs().max()) for g, w in zip(got, want)]
    log(f"net {CHANNELS}ch/{BLOCKS}res, card vs CPU forward: max |d logits| "
        f"{errs[0]:.3g}, max |d value| {errs[1]:.3g} (atol 1e-3)")
    assert max(errs) <= 1e-3, errs
    return card_net


class Client:
    """JSON over HTTP to the local server (no proxy)."""

    def __init__(self, base: str):
        self.base = base
        self.opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))

    def __call__(self, path: str, body=None):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(self.base + path, data=data)
        try:
            with self.opener.open(req, timeout=600) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())


def play_global_game(api, sims: int, seed: int, exact: bool) -> tuple:
    """A new global game at ``sims`` simulations and three human moves,
    each AI reply legal by the oracle. Returns the AI moves' latencies and
    kernel launches; with ``exact`` each move must launch the kernel once
    for the root's state and once per simulation."""
    kern = LM.legal_mask_cuda
    code, res = api("/api/new_game", {"human_side": "red", "num_simulations": sims})
    assert code == 200 and res["current_player"] == 1, res
    pos = Position()
    rng = np.random.default_rng(seed)
    times, launches = [], []
    for move in range(3):
        a = int(rng.choice(pos.legal_actions()))
        fr, fc, tr, tc = decode_action(a)
        before = kern.launches
        t0 = time.perf_counter()
        code, res = api("/api/human_move", {"from_row": fr, "from_col": fc,
                                             "to_row": tr, "to_col": tc})
        dt = time.perf_counter() - t0
        assert code == 200, res
        pos.apply(a)
        ai = res["ai_move"]["action"]
        assert ai in pos.legal_actions(), f"illegal AI move {ai}"
        pos.apply(ai)
        assert res["board"] == pos.board_array().reshape(10, 9).tolist()
        launched = kern.launches - before
        assert launched == 1 + sims if exact else launched >= 1 + sims, launched
        times.append(dt)
        launches.append(launched)
        log(f"human_move {move + 1}: AI reply {res['ai_move']['label']} in "
            f"{dt:.3f} s ({sims} sims, {launched} kernel launches)")
    return times, launches


def phase_serve(dev, model_dir: str, model_name: str, sims: int, seed: int,
                search_algo: str = "puct", more_sims=()) -> dict:
    """The main path: the HTTP API on the card, with the PUCT search or the
    Gumbel search (``search_algo``). Returns latencies and the launch
    counts of this phase. ``more_sims`` are further depths of the global
    game. With Gumbel each AI move's launches are asserted exactly (the
    root's state, then one per simulation: the root reuses its legal mask),
    and each coalesced session reply must act a move its search visited."""
    gumbel = search_algo == "gumbel"
    httpd, service = make_server("127.0.0.1", 0, [model_dir], device=dev,
                                 search_algo=search_algo)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    api = Client("http://127.0.0.1:%d" % httpd.server_address[1])
    out = {"ai_move_s_by_sims": {}, "launches_per_move": {}, "session_move_s": []}
    try:
        for k in KERNELS:
            k["wrapper"].launches = 0
        t0 = time.perf_counter()
        code, res = api("/api/load_model", {"model_name": model_name, "num_simulations": sims})
        assert code == 200 and res["success"], res
        out["load_model_s"] = time.perf_counter() - t0
        log(f"load_model ({search_algo}, {sims} sims, warm-up search included): "
            f"{out['load_model_s']:.3f} s on {res['device']}")
        code, res = api("/api/models")
        assert code == 200 and res["device"] == torch.cuda.get_device_name(0), res
        assert all(p.device.type == dev.type for p in service.predictor.net.parameters())
        assert service.predictor.algo == search_algo

        for n in (sims,) + tuple(more_sims):
            out["ai_move_s_by_sims"][n], out["launches_per_move"][n] = play_global_game(
                api, n, seed, exact=gumbel)
        out["ai_move_s"] = out["ai_move_s_by_sims"][sims]
        code, res = api("/api/human_move", {"from_row": 0, "from_col": 0,
                                             "to_row": 5, "to_col": 5})
        assert code == 400, res
        code, res = api("/api/load_model", {"model_name": "missing.pt"})
        assert code == 404, res

        sids = []
        for _ in range(4):
            code, res = api("/api/session/new", {"human_side": "red"})
            assert code == 200, res
            sids.append(res["session_id"])
        replies = [None] * len(sids)

        def play(i):
            t0 = time.perf_counter()
            replies[i] = api("/api/session/move", {
                "session_id": sids[i], "from_row": 3, "from_col": 0,
                "to_row": 4, "to_col": 0,
            }) + (time.perf_counter() - t0,)

        threads = [threading.Thread(target=play, args=(i,)) for i in range(len(sids))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        start = Position()
        start.apply(27 * 90 + 36)   # the pawn (3,0) -> (4,0)
        for code, res, dt in replies:
            assert code == 200, res
            assert res["ai_move"]["action"] in start.legal_actions(), res["ai_move"]
            if gumbel:
                # chosen is acted (the board shows it) and was visited (the
                # analysis lists only visited moves)
                sel = [m for m in res["ai_analysis"]["top_moves"] if m["selected"]]
                assert len(sel) == 1 and sel[0]["action"] == res["ai_move"]["action"], res
                after = start.copy()
                after.apply(res["ai_move"]["action"])
                assert res["board"] == after.board_array().reshape(10, 9).tolist()
            out["session_move_s"].append(dt)
        code, stats = api("/api/session/stats")
        assert code == 200 and stats["search"]["mean_batch"] > 1, stats
        log(f"4 concurrent session moves ({search_algo}): "
            f"{[round(x, 3) for x in out['session_move_s']]} s, search stats {stats['search']}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        if service.searcher is not None:
            service.searcher.stop()
        thread.join()
    out["launches"] = {k["name"]: k["wrapper"].launches for k in KERNELS}
    for name, n in out["launches"].items():
        assert n > 0, f"kernel {name} was not launched on the main path"
    log(f"{search_algo} serving path kernel launches: {out['launches']}")
    return out


# ------------------------------------------------------------ training path

TRAIN_FLEET, TRAIN_SIMS, TRAIN_PLIES = 8, 16, 24       # (a): card against CPU
LEARNER_BATCH = 256                                     # (b)
SP_RECORDS = ("boards", "sides", "pi_actions", "pi_probs", "values", "rec",
              "winners", "plies", "total_moves")


def check_selfplay_card_vs_cpu(dev, s: TS.SelfPlaySettings, pi_atol: float):
    """One fleet on the card and on the CPU from the same seeded CPU draws;
    returns the CPU's record."""
    with torch.inference_mode():
        card, cpu = (TS.selfplay_games(dyadic_eval, TRAIN_FLEET, s,
                                       torch.Generator().manual_seed(SEED), where)
                     for where in (dev, torch.device("cpu")))
    for f in SP_RECORDS:
        g, w = getattr(card, f).cpu(), getattr(cpu, f)
        if f == "pi_probs" and pi_atol:
            err = float((g - w).abs().max())
            assert err <= pi_atol, f"self-play pi_probs: card != CPU by {err}"
        else:
            assert torch.equal(g, w), f"self-play {f}: card != CPU"
    assert card.sims_per_ply == cpu.sims_per_ply
    log(f"  self-play card == CPU (temperature threshold {s.temperature_threshold}"
        f"{', pi_probs atol %g' % pi_atol if pi_atol else ', exact'}): {TRAIN_FLEET} games, "
        f"{len(cpu.sims_per_ply)} plies, winners {cpu.winners.tolist()}, "
        f"recorded plies {cpu.plies.tolist()}")
    return cpu


def replay_of(out: TS.SelfPlayOut, k: int) -> ReplayBuffer:
    """The trainer's insertion of one fleet: time-major rows, mirrored."""
    rec = out.rec.reshape(-1).numpy()
    buf = ReplayBuffer(4 * rec.size, k)
    buf.add_games(*(getattr(out, f).reshape(rec.size, -1).squeeze(-1).numpy()[rec]
                    for f in ("boards", "sides", "pi_actions", "pi_probs", "values")))
    return buf


# gradients, elementwise: |d| <= GRAD_RTOL |g| + GRAD_ATOL max |g| of the tensor
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-4
STEP_FAR = 1e-3                     # share of parameters allowed beyond 0.05 lr


def relu_branches(net) -> tuple:
    """Forward hooks on ``net`` that keep, in forward order, which branch
    each of its ReLUs took per element (a ReLU's output is > 0 exactly
    where its input is). Returns (the list they fill, the hooks)."""
    kept, hooks = [], []

    def out_hook(_m, _i, out):
        kept.append(out.detach() > 0)

    def in_hook(_m, inp):
        kept.append(inp[0].detach() > 0)

    hooks.append(net.input_conv.register_forward_hook(out_hook))
    for blk in net.res_blocks:
        hooks.append(blk.conv2.register_forward_pre_hook(in_hook))   # relu(bn1(..))
        hooks.append(blk.register_forward_hook(out_hook))
    for m in (net.policy_head[2], net.value_head[2], net.value_head[5]):
        hooks.append(m.register_forward_hook(out_hook))
    return kept, hooks


def forward_on_branches(n, feats, branches, kept) -> tuple:
    """``XiangqiNet``'s forward in the parameters' dtype end to end (the
    net's own casts its heads to float32), with each ReLU taking the
    branches in ``branches`` (``mask * x``, whose gradient is the mask, as
    ReLU's is), or its own when ``branches`` is None; the branches taken
    are appended to ``kept``."""
    it = iter(branches) if branches is not None else None

    def relu(z):
        m = next(it).to(z.device) if it is not None else z > 0
        kept.append(m)
        return z * m.to(z.dtype)

    x = feats.permute(0, 3, 1, 2)
    y = relu(n.input_conv[1](n.input_conv[0](x)))
    for blk in n.res_blocks:
        h = relu(blk.bn1(blk.conv1(y)))
        y = relu(blk.bn2(blk.conv2(h)) + y)
    p, v = n.policy_head, n.value_head
    logits = p[4](relu(p[1](p[0](y))).flatten(1))
    value = v[7](v[6](relu(v[4](relu(v[1](v[0](y))).flatten(1)))))
    return logits, value


def learner_grads(net, rows, where, dtype, reference=False, branches=None):
    """One forward and backward of ``net`` in ``dtype`` on ``where``, in
    train mode: the package's forward, or with ``reference`` the
    reference forward ``forward_on_branches``. Returns (losses and
    gradients in float64 on the host, the ReLU branches taken)."""
    n = copy.deepcopy(net).to(where, dtype).train()
    batch = [torch.as_tensor(x).to(where) for x in rows]
    batch = [b.to(dtype) if b.is_floating_point() else b for b in batch]
    if reference:
        kept, hooks = [], []
        m = TL.compute_loss(lambda f: forward_on_branches(n, f.to(dtype), branches, kept),
                           *batch)
    else:
        kept, hooks = relu_branches(n)
        m = TL.compute_loss(n, *batch)
    for h in hooks:
        h.remove()
    m.total_loss.backward()
    losses = torch.stack([m.policy_loss, m.value_loss]).detach().double().cpu()
    grads = {k: p.grad.detach().double().cpu() for k, p in n.named_parameters()}
    return losses, grads, [b.cpu() for b in kept]


def check_learner_card_vs_cpu(dev, buf: ReplayBuffer) -> None:
    """One learner step at the shipped width, float32 with TF32 off, card
    against CPU. The losses agree at rtol 1e-5. Each device's gradients are
    held elementwise, within GRAD_RTOL of |g| plus GRAD_ATOL of the
    tensor's largest |g|, against a float64 forward and backward on the CPU
    that takes the same ReLU branches as that device's forward. (The CPU
    tests' atol is 1e-6 absolute at 8 channels; cuDNN's float32 weight
    gradients at this size read ~3e-5 of max |g|, ten times the CPU's, so
    the absolute atol would fail on the card by rounding alone.) A float64 run
    that takes its own branches differs from either in a handful of the
    ~40M ReLU elements, whose inputs lie within float32 rounding of 0, and
    that alone puts the worst gradient ~1% off normwise (logged, not
    checked). As a control, the card's gradients with TF32 convolutions
    must fail the same check. After one Adam step at most a share STEP_FAR of the
    parameters may differ by more than 0.05 lr (the step moves each by at
    most ~lr, so a bound of 2 lr on all of them, kept as a sanity check,
    cannot separate a wrong step); the batch-norm statistics agree at atol
    1e-6 + rtol 1e-5."""
    lr, wd = 2e-3, 1e-4
    perm, wmask, _ = buf.epoch_plan(LEARNER_BATCH, 1, np.random.default_rng(SEED))
    assert wmask[0].all(), "the replay must fill one batch"
    rows = [a[perm[0]] for a in buf.arrays()] + [wmask[0]]
    net = init_net(torch.Generator().manual_seed(SEED), CHANNELS, BLOCKS)
    cpu = torch.device("cpu")
    (l_cpu, g_cpu, b_cpu), (l_card, g_card, b_card) = (
        learner_grads(net, rows, w, torch.float32) for w in (cpu, dev))
    torch.testing.assert_close(l_card, l_cpu, rtol=1e-5, atol=0)
    l_free, g_free, b_free = learner_grads(net, rows, cpu, torch.float64, reference=True)

    def flips(a, b):
        return sum(int((x != y).sum()) for x, y in zip(a, b))

    def normwise(g, ref):
        return max(float((g[k] - ref[k]).abs().max() / ref[k].abs().max()) for k in ref)

    def held(name, g32, b32):
        """The worst |d| / (atol + rtol |g|) of f32 gradients against f64 on
        their branches, logged beside the error against f64's own; and the
        f64 losses."""
        l64, g64, _ = learner_grads(net, rows, cpu, torch.float64, reference=True, branches=b32)
        ratio = {k: float(((g32[k] - g64[k]).abs()
                           / (GRAD_ATOL * g64[k].abs().max() + GRAD_RTOL * g64[k].abs())).max())
                 for k in g64}
        k_worst = max(ratio, key=ratio.get)
        log(f"  {name} f32 gradients against f64 on the same ReLU branches: worst "
            f"|d| / ({GRAD_ATOL:g} max |g| + {GRAD_RTOL:g} |g|) {ratio[k_worst]:.3g} ({k_worst}), "
            f"normwise {normwise(g32, g64):.3g}; against f64 on its own branches "
            f"({flips(b32, b_free)} of {sum(b.numel() for b in b_free)} ReLU elements differ): "
            f"normwise {normwise(g32, g_free):.3g}")
        return ratio[k_worst], l64

    worst = {}
    for name, l32, g32, b32 in (("cpu", l_cpu, g_cpu, b_cpu), ("card", l_card, g_card, b_card)):
        worst[name], l64 = held(name, g32, b32)
        torch.testing.assert_close(l32, l64, rtol=1e-5, atol=0)
    assert max(worst.values()) <= 1.0, worst
    log(f"  ReLU elements on other branches, card f32 vs CPU f32: {flips(b_card, b_cpu)}; "
        f"f64 losses on its own branches {l_free.tolist()}")
    # a control the check must reject: the card's convolutions in TF32
    torch.backends.cudnn.allow_tf32 = True
    _, g_tf32, b_tf32 = learner_grads(net, rows, dev, torch.float32)
    torch.backends.cudnn.allow_tf32 = False
    assert held("card TF32 (control)", g_tf32, b_tf32)[0] > 1.0, "TF32 must fail the check"

    states = []
    for where in (cpu, dev):
        n = copy.deepcopy(net).to(where).train()
        batch = [torch.as_tensor(x).to(where) for x in rows]
        TL.train_step(n, TL.make_optimizer(n.parameters(), lr, wd), *batch)
        states.append({k: v.cpu() for k, v in n.state_dict().items()})
    p_err, far, total = 0.0, 0, 0
    for k in states[0]:
        if k.endswith("num_batches_tracked"):
            continue
        if "running" in k:
            torch.testing.assert_close(states[1][k], states[0][k], rtol=1e-5, atol=1e-6, msg=k)
            continue
        d = (states[1][k] - states[0][k]).abs()
        p_err = max(p_err, float(d.max()))
        far += int((d > 0.05 * lr).sum())
        total += d.numel()
    assert far <= STEP_FAR * total, f"{far} of {total} parameters beyond 0.05 lr"
    assert p_err <= 2 * lr + 1e-7, p_err
    log(f"  learner step {CHANNELS}ch/{BLOCKS}res f32, B={LEARNER_BATCH}, card vs CPU: losses "
        f"{l_card.tolist()} vs {l_cpu.tolist()}; worst gradient ratio to tolerance: card "
        f"{worst['card']:.3g}, CPU {worst['cpu']:.3g}; after one Adam step {far} of {total} "
        f"parameters beyond 0.05 lr (allowed {STEP_FAR * total:.0f}), max |d param| {p_err:.3g}")


def train_config(ckpt_dir: str, **options) -> TC.TrainingConfig:
    """The ``tpu`` preset's net, fleet and batch; only depth is cut.
    ``options`` set the rest (the search algorithm)."""
    cfg = TC.tpu_config()
    cuts = dict(num_simulations=32, max_game_length=24, num_epochs=1, eval_simulations=16,
                min_buffer_size=1000, num_iterations=2, eval_interval=2, save_interval=2)
    for k, v in cuts.items():
        log(f"  cut: {k} {getattr(cfg, k)} -> {v}")
        setattr(cfg, k, v)
    for k, v in options.items():
        log(f"  option: {k} {getattr(cfg, k)} -> {v}")
        setattr(cfg, k, v)
    cfg.checkpoint_dir = ckpt_dir
    return cfg


def predicted_launches(cfg: TC.TrainingConfig, stats: list) -> int:
    """The legal-mask launches the loop's own counters predict: self-play
    launches once at the reset, once per opening round, once per
    simulation and once per env step (with PUCT and with Gumbel alike: each
    root reuses its state's mask); eval once at the reset and, per ply,
    once per simulation of each half's search and once per step."""
    n = 0
    for it in stats:
        sp = it["self_play"]
        n += 1 + cfg.random_opening_moves + sp["simulations"] + sp["plies"]
        if it["evaluation"]:
            n += 1 + it["evaluation"]["plies"] * (2 * cfg.eval_simulations + 1)
    return n


def profile_selfplay(dev, trainer, smi: str, plies: int = 2) -> dict:
    """``torch.profiler`` over ``plies`` plies of the trainer's self-play
    fleet (after one warm ply): device busy share, kernels per simulation,
    and the legal-mask kernel's device time per launch."""
    from torch.profiler import ProfilerActivity, profile

    s, b = trainer.sp_settings, trainer.cfg.num_games_per_iter
    gen = torch.Generator().manual_seed(SEED)
    with torch.inference_mode():
        carry = TS._init_carry(b, s, gen, dev)
        body = TS._make_body(policy_logits_fn(trainer.best_net), b, s, True, gen)
        body(carry)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            t0 = time.perf_counter()
            sims = sum(body(carry) for _ in range(plies))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            time.sleep(PROFILE_PAD_S)
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    launches = sum(e.count for e in kernels)
    mask = [e for e in kernels if LM.KERNEL_SYMBOL in e.key]
    mask_n = sum(e.count for e in mask)
    mask_us = sum(e.self_device_time_total for e in mask) / max(mask_n, 1)
    out = {"wall_s": wall, "busy_s": busy, "idle_share": 1 - busy / wall,
           "kernels_per_sim": launches / sims, "mask_us_per_launch": mask_us,
           "mask_launches": mask_n, "sims": sims}
    log(f"  profile on {smi}, {plies} self-play plies at B={b} x {s.num_simulations} sims "
        f"(profiler on): wall {wall:.4f} s, device busy {busy:.4f} s, idle share {out['idle_share']:.4f}, "
        f"{launches} device kernels ({out['kernels_per_sim']:.1f} per simulation); "
        f"{LM.KERNEL_SYMBOL} {mask_us:.3f} us per launch over {mask_n} launches")
    groups = {"net (conv/gemm)": 0.0, LM.KERNEL_SYMBOL: 0.0, "other": 0.0}
    for e in kernels:
        name = e.key.lower()
        key = (LM.KERNEL_SYMBOL if LM.KERNEL_SYMBOL in name else
               "net (conv/gemm)" if any(w in name for w in _NET_KERNEL_WORDS) else "other")
        groups[key] += e.self_device_time_total / 1e6
    log("  device time by group: " + ", ".join(f"{k} {v:.4f} s" for k, v in groups.items()))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:90]}")
    return out


def phase_train(dev, smi: str, ckpt_dir: str) -> dict:
    """The training path: (a) self-play and eval, card == CPU; (b) one
    learner step, card against CPU; (c) the trainer at full width, its
    checkpoints in ``ckpt_dir`` (phase 9 exports ``checkpoint_iter2``)."""
    t0 = time.perf_counter()
    base = TS.SelfPlaySettings(
        num_simulations=TRAIN_SIMS, max_game_length=TRAIN_PLIES, random_opening_moves=4,
        enable_resign=True, resign_threshold=-0.1, resign_check_steps=2,
        temperature_threshold=TRAIN_PLIES + 8)
    cpu_out = check_selfplay_card_vs_cpu(dev, base, 0.0)
    check_selfplay_card_vs_cpu(dev, base._replace(temperature_threshold=8), 1e-6)
    es = EvalSettings(num_simulations=TRAIN_SIMS, max_game_length=TRAIN_PLIES)
    boards = []
    finalize = TE._finalize

    def keep_boards(states, *a):
        boards.append(states.board.cpu())
        return finalize(states, *a)

    TE._finalize = keep_boards
    try:
        with torch.inference_mode():
            ev = [evaluate_pair(peaked_dyadic_eval(37), peaked_dyadic_eval(53), TRAIN_FLEET,
                                es, where) for where in (dev, torch.device("cpu"))]
    finally:
        TE._finalize = finalize
    assert torch.equal(ev[0].winners.cpu(), ev[1].winners), "eval winners: card != CPU"
    assert torch.equal(boards[0], boards[1]), "eval final boards: card != CPU"
    assert ev[0].plies_run == ev[1].plies_run
    log(f"  evaluate_pair card == CPU: {TRAIN_FLEET} games, winners {ev[1].winners.tolist()}, "
        f"{ev[1].plies_run} plies")
    log(f"  (a) done in {time.perf_counter() - t0:.1f} s")

    t1 = time.perf_counter()
    check_learner_card_vs_cpu(dev, replay_of(cpu_out, base.max_children))
    log(f"  (b) done in {time.perf_counter() - t1:.1f} s")

    t2 = time.perf_counter()
    os.makedirs(ckpt_dir)
    out = run_trainer(dev, ckpt_dir, smi)
    log(f"  (c) done in {time.perf_counter() - t2:.1f} s")
    return out


def run_trainer(dev, ckpt_dir: str, smi: str, **options) -> dict:
    """(c): two iterations of ``AlphaZeroTrainer.train()`` on the card, the
    kernel's launches counted around them; ``options`` as for
    ``train_config``."""
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter("  trainer: %(message)s"))
    logger = logging.getLogger("xiangqi_az_torch")
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    cfg = train_config(ckpt_dir, **options)
    trainer = AlphaZeroTrainer(cfg, device=dev)
    step_losses = []
    train_network = trainer.train_network

    def recording_train_network():
        stats = train_network()
        if trainer.last_losses is not None:
            step_losses.append(trainer.last_losses)
        return stats

    trainer.train_network = recording_train_network
    # an earlier trainer of this script lives on in its reference cycle (the
    # method patched above) until a collection: free it before the peak
    gc.collect()
    torch.cuda.reset_peak_memory_stats(dev)
    for k in KERNELS:
        k["wrapper"].launches = 0
    trainer.train()
    torch.cuda.synchronize()
    launches = {k["name"]: k["wrapper"].launches for k in KERNELS}
    peak = torch.cuda.max_memory_allocated(dev)
    logger.removeHandler(handler)

    stats = trainer.training_stats
    want = predicted_launches(cfg, stats)
    assert launches["legal_mask"] == want, f"kernel launches {launches} != predicted {want}"
    for name, n in launches.items():
        assert n > 0, f"kernel {name} was not launched on the training path"
    buf = trainer.buffer
    n = len(buf)
    probs = buf.pi_probs[:n]
    row_sums = probs.sum(axis=1)
    assert (np.abs(row_sums - 1) <= 1e-5).sum() + (row_sums == 0).sum() == n, "pi rows"
    assert not (probs[buf.pi_actions[:n] < 0] != 0).any(), "pi mass on an empty slot"
    assert set(np.unique(buf.values[:n]).tolist()) <= {-1.0, 0.0, 1.0}, "z labels"
    losses = np.concatenate(step_losses).sum(axis=1)
    assert np.isfinite(losses).all() and len(losses) >= 10, len(losses)
    tenth = max(len(losses) // 10, 1)
    first, last = float(losses[:tenth].mean()), float(losses[-tenth:].mean())
    assert last < first, (first, last)
    ev = stats[1]["evaluation"]
    assert ev and "model_updated" in ev, ev

    # the kernel on boards the fleet played, at the training path's batches:
    # an eval half (one side's search) and the fleet
    fleet = cfg.num_games_per_iter
    rows = np.linspace(0, n - 1, fleet).astype(int)
    played = to_dev(dev, buf.boards[rows], buf.sides[rows])
    for b in (cfg.eval_games // 2, fleet):
        check_kernel(LM.legal_mask_cuda, played[0][:b], played[1][:b])
    log(f"  kernel vs plain on replay boards at B = {cfg.eval_games // 2}, {fleet}: equal")

    # a fresh trainer restores the checkpoint exactly
    fresh = AlphaZeroTrainer(cfg, device=dev)
    fresh.restore(os.path.join(ckpt_dir, f"checkpoint_iter{cfg.num_iterations}"))
    for a, b in ((fresh.net, trainer.net), (fresh.best_net, trainer.best_net)):
        for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), k
    assert_same_tree(fresh.opt.state_dict(), trainer.opt.state_dict())
    assert torch.equal(fresh.rng.get_state(), trainer.rng.get_state())
    assert fresh.np_rng.bit_generator.state == trainer.np_rng.bit_generator.state
    assert fresh.iteration == trainer.iteration and fresh.total_games == trainer.total_games
    del fresh

    # the best model serves on the card
    pred = Predictor.load(os.path.join(ckpt_dir, "best_model.pt"), num_simulations=32,
                          algo=cfg.search_algo, device=dev)
    pos = Position()
    move = pred.ai_move(pos)["ai_move"]["action"]
    assert move in Position().legal_actions(), move
    log(f"  best_model.pt served on the card ({cfg.search_algo}): AI move {move} is legal")

    prof = profile_selfplay(dev, trainer, smi, plies=1)
    sp = [it["self_play"] for it in stats]
    tr = [it["training"] for it in stats if it["training"]]
    b = cfg.num_games_per_iter
    sp_s = sum(x["time"] for x in sp)
    rates = {
        "selfplay_games_per_s": sum(x["games"] for x in sp) / sp_s,
        "selfplay_sims_per_s": b * sum(x["simulations"] for x in sp) / sp_s,
        "selfplay_s_per_ply": sp_s / sum(x["plies"] for x in sp),
        "train_steps_per_s": sum(x["batches"] for x in tr) / sum(x["time"] for x in tr),
        "train_samples_per_s": cfg.batch_size * sum(x["batches"] for x in tr)
        / sum(x["time"] for x in tr),
        "eval_s": ev["time"],
        "iteration_s": [it["time"] for it in stats],
        "peak_memory_bytes": peak,
    }
    log(f"  training path ({cfg.search_algo} self-play) on {smi}: " + json.dumps(rates))
    log(f"  losses: first tenth {first:.4f}, last tenth {last:.4f} over {len(losses)} steps; "
        f"eval {ev}; kernel launches {launches} == predicted {want}")
    return {"launches": launches, "rates": rates, "profile": prof,
            "checkpoint": os.path.join(ckpt_dir, f"checkpoint_iter{cfg.num_iterations}")}


# ------------------------------------------------------------ Gumbel path

GUMBEL_FLEET, GUMBEL_SIMS, GUMBEL_M = 8, 64, 16           # (a): card against CPU
ARENA_GAMES, ARENA_SIMS, ARENA_PLIES = 16, 32, 24         # (d): the trainer's move cap


def check_gumbel_card_vs_cpu(dev) -> None:
    """(a): ``run_gumbel_mcts`` with the dyadic mock network on the card
    and on the CPU, the root draws from CPU generators of one seed:
    visits, chosen, actions and order exactly equal, pi_improved within
    1e-6; and lane 0 alone (width 1) equals lane 0 of the width-8 batch on
    the card."""
    cases = [advance_random(3 * i, 40 + i) for i in range(GUMBEL_FLEET)]
    roots = E.cat_states([E.state_from_numpy(np.asarray(p.board, np.int8), p.side)
                          for p in cases])
    cfg = GumbelConfig(num_simulations=GUMBEL_SIMS, max_considered=GUMBEL_M)

    def search(r):
        return run_gumbel_mcts(dyadic_eval, r, cfg, generator=torch.Generator().manual_seed(SEED))

    with torch.inference_mode():
        cpu, card = search(roots), search(roots.to(dev))
        solo = search(roots.to(dev).map(lambda x: x[:1]))
    for f in ("visits", "chosen", "actions", "order", "valid"):
        assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), f"gumbel {f}: card != CPU"
    err = float((card.pi_improved.cpu() - cpu.pi_improved).abs().max())
    assert err <= 1e-6, f"gumbel pi_improved: card != CPU by {err}"
    for f in ("visits", "chosen", "order"):
        assert torch.equal(getattr(solo, f)[0], getattr(card, f)[0]), f"lane 0 {f}: width 1 != 8"
    log(f"  (a) Gumbel search on the card == CPU: {GUMBEL_FLEET} positions x {GUMBEL_SIMS} sims, "
        f"m = {GUMBEL_M}; chosen {card.chosen.tolist()}, visited slots "
        f"{(card.visits > 0).sum(dim=1).tolist()}; pi_improved max |d| {err:.3g}; "
        f"lane 0 at width 1 == width 8")


def run_arena(dev, pt: str) -> dict:
    """(d): Gumbel-32 against PUCT-32 on the card, one net on both sides;
    the kernel's launches must be 1 (the reset) + per ply the two halves'
    simulations and one env step."""
    net = load_reference_pt(pt).to(dev).eval()
    s = TARENA.ArenaSettings(num_simulations=ARENA_SIMS, max_game_length=ARENA_PLIES,
                             algo_a="gumbel", algo_b="puct")
    kern = LM.legal_mask_cuda
    for k in KERNELS:
        k["wrapper"].launches = 0
    t0 = time.perf_counter()
    out = TARENA.make_hosted_arena(net, net, ARENA_GAMES, s, dev)(
        torch.Generator().manual_seed(SEED))
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = kern.launches
    assert out["a_wins"] + out["b_wins"] + out["draws"] == ARENA_GAMES, out
    want = 1 + out["plies_run"] * (2 * ARENA_SIMS + 1)
    assert out["launches"] == want, f"arena launches {out['launches']} != predicted {want}"
    log(f"  (d) arena gumbel-{ARENA_SIMS} (a) vs puct-{ARENA_SIMS} (b), {ARENA_GAMES} games, "
        f"{ARENA_PLIES}-ply cap: " + json.dumps(out))
    return out


def phase_gumbel(dev, model_dir: str, model_name: str, smi: str, ckpt_dir: str) -> dict:
    """The Gumbel paths: (a) the search, card == CPU; (b) serving at the
    shipped width, 500 and 32 simulations; (c) Gumbel training at the
    ``tpu`` preset's width and fleet, its checkpoints in ``ckpt_dir``
    (phase 11's head-to-head takes them as its Gumbel arm); (d) an arena
    match."""
    t0 = time.perf_counter()
    check_gumbel_card_vs_cpu(dev)
    t1 = time.perf_counter()
    serve = phase_serve(dev, model_dir, model_name, SIMS, SEED + 1, search_algo="gumbel",
                        more_sims=(32,))
    log(f"  (b) done in {time.perf_counter() - t1:.1f} s")
    t2 = time.perf_counter()
    os.makedirs(ckpt_dir)
    train = run_trainer(dev, ckpt_dir, smi, search_algo="gumbel")
    log(f"  (c) done in {time.perf_counter() - t2:.1f} s")
    arena = run_arena(dev, os.path.join(model_dir, model_name))
    log(f"  (a)-(d) in {time.perf_counter() - t0:.1f} s")
    return {"serve": serve, "train": train, "arena": arena}


def assert_same_tree(a, b, path="") -> None:
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_tree(x, y, f"{path}/{i}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a.cpu(), b.cpu()), path
    else:
        assert a == b, path


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call over ``iters`` calls, timed with CUDA events after
    a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def candidate_count(boards: torch.Tensor, sides: torch.Tensor) -> int:
    """Candidate moves the kernel tests on these boards: the table entries
    of every piece of the side to move."""
    b = boards.cpu().numpy().astype(np.int64)
    s = sides.cpu().numpy().astype(np.int64)[:, None]
    kind, si = np.where(b * s > 0, b * s, 0), (s < 0).astype(np.int64)
    cls = np.select([kind == 1, kind == 2, kind == 3, kind == 7, kind == 4],
                    [si, 2 + si, 4 + si, 6 + si, 8], 9)
    per = (LM.action_constants() != LM.EMPTY).sum(axis=2)        # [class, from]
    return int(np.where(kind > 0, per[cls, np.arange(E.NSQ)], 0).sum())


def mask_bound_ms(boards: torch.Tensor, sides: torch.Tensor) -> tuple:
    """The least time for the mask of these boards: its bytes (90 board
    bytes and 1 side byte read, 8100 mask bytes written, per board) over the
    memory rate, against its operations (one test per candidate move of
    these boards) over the int32 rate."""
    batch = len(boards)
    t_bytes = batch * (E.NSQ + 1 + E.ACTION_SPACE) / HBM_BYTES_PER_S * 1e3
    t_ops = candidate_count(boards, sides) / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


PROFILE_PAD_S = 0.05   # idle host time at each end of a profiler window
PROFILE_TRIES = 3


def device_us(fn, symbol: str, n: int = 100) -> float:
    """The profiler's device time per launch (us) of the kernel ``symbol``
    over ``n`` back-to-back calls of ``fn``.

    The profiler keeps only device records whose converted timestamps fall
    inside its window, so a short window can lose launches at its edges
    (an H100 run once kept 25 of 100). The launches are therefore padded
    by idle host time at both ends, and a window that kept fewer than 90%
    of them is taken again. If every try loses records, the time is the
    mean over the launches the fullest window kept, and the log says so.
    """
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = (0, 0.0)
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        evs = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and symbol in e.key]
        count = sum(e.count for e in evs)
        assert count <= n, f"profiler saw {count} launches of {symbol}, want {n}"
        if count > best[0]:
            best = (count, sum(e.self_device_time_total for e in evs))
        if count >= 0.9 * n:
            break
        log(f"  profiler kept {count} of {n} launches of {symbol}; taking the window again")
    count, total = best
    assert count >= n // 10, f"profiler saw {count} launches of {symbol}, want {n}"
    if count < 0.9 * n:
        log(f"  profiler kept at most {count} of {n} launches of {symbol} in "
            f"{PROFILE_TRIES} windows; the time is their mean")
    return total / count


def timed_inputs(dev, playouts, b: int) -> tuple:
    """Serving's B = 1 is the opening; larger batches are mid-game boards
    (the ply-40 playouts, and at 16384 every kept ply)."""
    if b == 1:
        st = E.reset_batch(1, device=dev)
        return st.board.contiguous(), st.side.contiguous()
    boards, sides = playouts
    if b <= boards.shape[1]:
        return boards[3, :b].contiguous(), sides[3, :b].contiguous()
    return boards.reshape(-1, E.NSQ)[:b].contiguous(), sides.reshape(-1)[:b].contiguous()


def interleaved(fns: dict, measure) -> dict:
    """``measure(fn)`` of each function in the order a, b, ..., ..., b, a;
    the mean of the two readings of each."""
    names = list(fns)
    order = names + names[::-1]
    got = {n: [] for n in names}
    for n in order:
        got[n].append(measure(fns[n]))
    return {n: sum(v) / len(v) for n, v in got.items()}


def phase_timings(dev, playouts, net, dense) -> dict:
    """The kernel at every timed batch: the profiler's device time per
    launch (``ms``, the kernel's own time, against which the bound is
    read) and the CUDA-events time per back-to-back call (``call_ms``,
    set by the host wrapper at small B), each beside the dense baseline's
    when it is given, interleaved (old, new, new, old)."""
    kern = LM.legal_mask_cuda
    saved = kern.launches
    rows = {}
    for b in TIMED_BATCHES:
        bb, ss = timed_inputs(dev, playouts, b)
        assert len(bb) == b
        check_kernel(kern, bb, ss)   # the timed boards give the plain version's mask
        iters = 200 if b <= 8 else (50 if b <= 2048 else 20)
        fns = {"new": lambda: kern(bb, ss)}
        if dense is not None:
            assert torch.equal(dense(bb, ss), kern(bb, ss)), f"dense baseline != kernel at B={b}"
            fns = {"dense": lambda: dense(bb, ss), **fns}
        call = interleaved(fns, lambda fn: cuda_ms(fn, iters))
        symbols = {"new": LM.KERNEL_SYMBOL, "dense": DenseBaseline.SYMBOL}
        dev_us = interleaved({n: (f, symbols[n]) for n, f in fns.items()},
                             lambda fs: device_us(fs[0], fs[1], min(iters, 100)))
        row = {"ms": dev_us["new"] / 1e3, "call_ms": call["new"],
               "dense_ms": dev_us["dense"] / 1e3 if dense is not None else None,
               "dense_call_ms": call.get("dense")}
        # a floor: the device time of writing the same bytes with a fill
        fill = torch.empty((b, E.ACTION_SPACE), dtype=torch.bool, device=dev)
        row["fill_ms"] = device_us(lambda: fill.fill_(False), "elementwise", min(iters, 100)) / 1e3
        row["plain_ms"] = None if b > 2048 else cuda_ms(lambda: E.legal_mask(bb, ss), max(iters // 10, 5))
        row["bound_ms"], row["bound_by"] = mask_bound_ms(bb, ss)
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        if dense is not None:
            row["dense_share_of_bound"] = row["bound_ms"] / row["dense_ms"]
        rows[b] = row

        def fmt(x, unit="ms"):
            return "not given" if x is None else f"{x:.5f} {unit}"
        log(f"legal_mask B={b}: device time per launch {fmt(row['ms'])} (dense baseline "
            f"{fmt(row['dense_ms'])}); per call {fmt(row['call_ms'])} (dense baseline "
            f"{fmt(row['dense_call_ms'])}); bound {row['bound_ms']:.6f} ms "
            f"({row['bound_by']}), share of bound {row['share_of_bound']:.4f}; a fill of the "
            f"same bytes {fmt(row['fill_ms'])}; plain "
            f"version {'not timed' if row['plain_ms'] is None else fmt(row['plain_ms'])} "
            f"(not a yardstick)")
    # each split of a row over blocks at serving's batches: device time
    splits = {}
    for b in (1, 2, 4, 8):
        bb, ss = timed_inputs(dev, playouts, b)
        t = {sp: [] for sp in SPLITS}
        for order in (SPLITS, SPLITS[::-1]):
            for sp in order:
                t[sp].append(device_us(lambda: kern(bb, ss, blocks_per_board=sp),
                                       LM.KERNEL_SYMBOL) / 1e3)
        splits[b] = {sp: sum(v) / 2 for sp, v in t.items()}
        log(f"legal_mask B={b}, device ms per launch by blocks per board (default "
            f"{LM.launch_plan(b).blocks_per_board}): " + ", ".join(
                f"{sp}: {ms:.5f}" for sp, ms in splits[b].items()))
    kern.launches = saved   # timing launches are not main-path launches
    with torch.inference_mode():
        for b in (1, 8):
            x = positions_features(dev, b, seed=21)
            log(f"net forward {CHANNELS}ch/{BLOCKS}res B={b}: "
                f"{cuda_ms(lambda: net(x), 50):.4f} ms")
    return {"rows": rows, "splits": splits}


_NET_KERNEL_WORDS = ("conv", "gemm", "cudnn", "xmma", "cutlass", "implicit", "winograd")


def phase_profile(dev, net, sims: int, algo: str = "puct") -> None:
    """Where one AI move's time goes: ``torch.profiler`` over one search of
    the opening at ``sims`` simulations with the ``algo`` search, on a
    warmed predictor."""
    from torch.profiler import ProfilerActivity, profile

    pred = Predictor(net, num_simulations=sims, algo=algo, device=dev)
    pos = Position()
    pred.search_position(pos)
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        pred.search_position(pos)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    averages = prof.key_averages()   # one pass over the events: it takes seconds
    kernels = [e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    launches = sum(e.count for e in kernels)
    log(f"profile, one {algo} search of {sims} sims (profiler on): wall {wall:.4f} s, "
        f"device busy {busy:.4f} s, idle share {1 - busy / wall:.4f}, "
        f"{launches} device kernels ({launches / sims:.1f} per simulation)")
    groups = {"net (conv/gemm)": 0.0, LM.KERNEL_SYMBOL: 0.0, "other": 0.0}
    for e in kernels:
        name = e.key.lower()
        key = (LM.KERNEL_SYMBOL if LM.KERNEL_SYMBOL in name else
               "net (conv/gemm)" if any(w in name for w in _NET_KERNEL_WORDS) else "other")
        groups[key] += e.self_device_time_total / 1e6
    log("  device time by group: " + ", ".join(
        f"{k} {v:.4f} s" for k, v in groups.items()))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:90]}")
    host = [e for e in averages if e.device_type == torch.autograd.DeviceType.CPU]
    log(f"  host: {sum(e.count for e in host)} profiled ops; top by self CPU time:")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:12]:
        log(f"  {e.self_cpu_time_total / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:90]}")


def phase_profiles(dev, net) -> dict:
    """Phase 8: each search profiled at ``PROFILE_SIMS``, then one search
    of the opening at ``COMPARE_SIMS`` simulations by each, timed without the
    profiler in the order PUCT, Gumbel, Gumbel, PUCT: the two searches
    compared in the same conditions (earlier phases' order and profiler
    windows do not favour either). Returns the mean seconds of each."""
    for algo in ("puct", "gumbel"):
        phase_profile(dev, net, PROFILE_SIMS, algo)
    preds = {a: Predictor(net, num_simulations=COMPARE_SIMS, algo=a, device=dev)
             for a in ("puct", "gumbel")}

    def one_search(pred):
        t0 = time.perf_counter()
        pred.search_position(Position())
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    out = interleaved(preds, one_search)
    log(f"one search of the opening at {COMPARE_SIMS} sims, no profiler, interleaved (puct, gumbel, "
        f"gumbel, puct): puct {out['puct']:.4f} s, gumbel {out['gumbel']:.4f} s, "
        f"ratio {out['gumbel'] / out['puct']:.3f}")
    return out


# ------------------------------------------------------------------ tools

EXPORT_FORMATS = {"torch": "pt", "npz": "npz", "torchscript": "ts", "onnx": "onnx"}
EXPORT_ATOL = 2e-3                       # serve/export.py's default, as in the JAX package
EXPORT_SIMS = 64
INT8_BOARDS = 512
INT8_LOGIT_ATOL = 1e-3                   # int8 twin, card against CPU (logits and values)
INT8_ARGMAX_AGREE = 0.99
INT8_BATCHES = (1, 8, 256, 512)
# the standard preset's net (128 x 6, bf16) at the harness's default 64 simulations,
# not the preset's 200: a third of the trace's events and the time to read them
HARNESS_ARGS = ["--channels", "128", "--blocks", "6", "--batch", "256"]
NATIVE_BOARDS = 200
NATIVE_DEPTH = 2


def phase_export(dev, sources: dict, out_dir: str) -> dict:
    """(a) ``python -m xiangqi_alphazero_torch.serve export`` as a user runs
    it, in every format from every source, all processes at once; then each
    artifact reloaded from disk and verified here against the card's float32
    forward of its source (TF32 off), and the re-exported ``.pt`` served."""
    procs = {}
    try:
        for src_name, src in sources.items():
            for fmt, ext in EXPORT_FORMATS.items():
                out = os.path.join(out_dir, f"{src_name}.{ext}")
                procs[(src_name, fmt)] = (out, subprocess.Popen(
                    [sys.executable, "-m", "xiangqi_alphazero_torch.serve", "export",
                     "--checkpoint", src, "--format", fmt, "--output", out],
                    cwd=os.path.dirname(os.path.abspath(__file__)),
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for (src_name, fmt), (out, proc) in procs.items():
            text = proc.communicate(timeout=600)[0]
            assert proc.returncode == 0, (
                f"serve export {src_name} {fmt} exited {proc.returncode}:\n{text}")
            log(f"  export {src_name} -> {fmt}: " + " | ".join(text.strip().splitlines()))
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    diffs = {}
    for src_name, src in sources.items():
        net = Predictor.load(src, device=dev).net
        for fmt, ext in EXPORT_FORMATS.items():
            d = TX.verify_export(fmt, os.path.join(out_dir, f"{src_name}.{ext}"), net,
                                 atol=EXPORT_ATOL)
            diffs[f"{src_name}/{fmt}"] = d
            log(f"  {src_name} {fmt}: reloaded and verified on the card (onnx: onnx_lite walker), "
                f"max|dlogits| {d['max_abs_dlogits']:.6g}, max|dvalue| {d['max_abs_dvalue']:.6g} "
                f"(atol {EXPORT_ATOL})")
    moves = [Predictor.load(path, num_simulations=EXPORT_SIMS, device=dev)
             .ai_move(Position())["ai_move"]["action"]
             for path in (sources["random"], os.path.join(out_dir, "random.pt"))]
    assert moves[0] == moves[1], f"the re-exported .pt moves {moves[1]}, the original {moves[0]}"
    log(f"  re-exported .pt serves the original's first AI move at {EXPORT_SIMS} sims: {moves[0]}")
    return diffs


def phase_int8(dev, playouts, net) -> dict:
    """(b) the int8 twin of the 128 x 6 net on the card against the CPU on
    512 playout boards; then int8, float32 and bf16 forwards timed with CUDA
    events at B = 1, 8, 256, 512, interleaved."""
    boards, sides = timed_inputs(dev, playouts, INT8_BOARDS)
    feats = E.features(boards, sides)
    qg, qc = Q.quantize_net(net, device=dev), Q.quantize_net(net, device="cpu")
    with torch.inference_mode():
        pg = Q._im2col(feats).reshape(INT8_BOARDS * E.NSQ, -1)
        ag, sg = Q._quant_act(pg)
        ac, sc = Q._quant_act(pg.cpu())
        assert torch.equal(ag.cpu(), ac) and torch.equal(sg.cpu(), sc), "stem int8 activations"
        lg, vg = Q.int8_forward(qg, feats)
        lc, vc = Q.int8_forward(qc, feats.cpu())
        lf, vf = net(feats)
    err_l = float((lg.cpu() - lc).abs().max())
    err_v = float((vg.cpu() - vc).abs().max())
    assert err_l <= INT8_LOGIT_ATOL and err_v <= INT8_LOGIT_ATOL, (err_l, err_v)
    legal = E.legal_mask(boards.cpu(), sides.cpu())

    def legal_argmax(x):
        return torch.where(legal, x.cpu(), -torch.inf).argmax(dim=1)

    agree = float((legal_argmax(lg) == legal_argmax(lc)).float().mean())
    assert agree >= INT8_ARGMAX_AGREE, f"int8 card vs CPU legal argmax agreement {agree}"
    vs_float = float((legal_argmax(lg) == legal_argmax(lf)).float().mean())
    corr = float(np.corrcoef(vg.cpu().numpy().ravel(), vf.cpu().numpy().ravel())[0, 1])
    log(f"  (b) int8 on the card == CPU: {INT8_BOARDS} boards, stem int8 activations equal; "
        f"max|dlogits| {err_l:.6g}, max|dvalue| {err_v:.6g} (atol {INT8_LOGIT_ATOL}); legal "
        f"argmax agreement {agree:.4f}; against the float32 net: legal argmax agreement "
        f"{vs_float:.4f}, value correlation {corr:.4f}")
    bf16 = copy.deepcopy(net)
    bf16.dtype = torch.bfloat16
    times = {}
    with torch.inference_mode():
        for b in INT8_BATCHES:
            x = E.features(*timed_inputs(dev, playouts, b))
            iters = 200 if b <= 8 else 50
            fns = {"float32": lambda: net(x), "bf16": lambda: bf16(x),
                   "int8": lambda: Q.int8_forward(qg, x)}
            times[b] = interleaved(fns, lambda fn: cuda_ms(fn, iters))
            log(f"  forward 128x6 B={b}, ms per call (CUDA events; order float32, bf16, int8, "
                f"int8, bf16, float32): " + ", ".join(f"{k} {v:.5f}" for k, v in times[b].items())
                + f"; int8 / bf16 {times[b]['int8'] / times[b]['bf16']:.3f}")
    return {"max_abs_dlogits": err_l, "max_abs_dvalue": err_v, "argmax_agree": agree,
            "vs_float_agree": vs_float, "value_corr": corr, "ms": times}


def phase_harness(trace_dir: str) -> dict:
    """(c) the profiling harness at the standard preset's net on the card with a
    trace; the kernel's launches against its rows' counts; then the trace
    read by trace_tools."""
    for k in KERNELS:
        k["wrapper"].launches = 0
    out = BENCH.main(HARNESS_ARGS + ["--trace", trace_dir])
    torch.cuda.synchronize()
    launches = LM.legal_mask_cuda.launches
    want = out["setup_launches"] + sum(r["calls"] * r["launches_per_call"] for r in out["rows"])
    assert launches == want, f"harness launches {launches} != predicted {want}"
    log(f"  (c) harness launches {launches} == predicted {want} "
        f"(1 reset + sum of calls x launches per call over the rows)")
    events = TT.load_trace_events(trace_dir)
    log("\n".join(TT.report(events, top=15)))
    rows = TT.aggregate_device_ops(events)
    device_ms, wall_ms = sum(ms for _, ms, _ in rows), TT.traced_wall_ms(events)
    assert 0 < device_ms <= wall_ms, (device_ms, wall_ms)
    traced = sum(r["launches_per_call"] for r in out["rows"])
    seen = sum(n for name, _, n in rows if LM.KERNEL_SYMBOL in name)
    assert 0 < seen <= traced, f"trace holds {seen} launches of the mask, {traced} were made"
    log(f"  trace: {len(events)} events, device {device_ms:.3f} ms over a traced wall of "
        f"{wall_ms:.3f} ms (busy share {device_ms / wall_ms:.4f}); {seen} of the {traced} traced "
        f"mask launches kept")
    return {"launches": launches, "rows": out["rows"], "device_ms": device_ms,
            "wall_ms": wall_ms, "trace_mask_launches": seen}


def phase_native(playouts) -> dict:
    """(d) the native rules core: built with the host's compiler, equal to
    the Python movegen on ~200 playout and edge boards, taken by the
    oracle; minimax at depth 2 legal and repeatable; movegen rates."""
    assert native.available(), f"the native core did not build (compiler {native.compiler()})"
    with tempfile.TemporaryDirectory() as tmp:   # the oracle built it already: time a build
        t0 = time.perf_counter()
        assert native._build(Path(tmp) / "libxq_core.so"), "the native core did not build"
        log(f"  (d) native core builds with {native.compiler()} in "
            f"{time.perf_counter() - t0:.2f} s; loaded {native.library_path().name}")
    boards, sides = playouts
    idx = torch.linspace(0, boards.shape[1] - 1, NATIVE_BOARDS // boards.shape[0]).long()
    cases = [(b.numpy(), int(s)) for ply in range(boards.shape[0])
             for b, s in zip(boards[ply, idx].cpu(), sides[ply, idx].cpu())]
    cases += [(b, int(s)) for b, s in edge_boards().values()]
    positions = []
    for b, s in cases:
        p = Position()
        p.board, p.side = [int(x) for x in b], s
        positions.append(p)
    oracle.use_python_rules(True)
    try:
        t0 = time.perf_counter()
        py = [p.legal_actions() for p in positions]
        t_py = time.perf_counter() - t0
    finally:
        oracle.use_python_rules(False)
    t0 = time.perf_counter()
    nat = [native.gen_legal(p.board_array(), p.side) for p in positions]
    t_nat = time.perf_counter() - t0
    assert nat == py, "native gen_legal != the Python movegen"
    calls = []
    gen_legal = native.gen_legal
    native.gen_legal = lambda b, s: calls.append(1) or gen_legal(b, s)
    try:
        opening = Position().legal_actions()
    finally:
        native.gen_legal = gen_legal
    assert calls == [1] and len(opening) == 44, "the oracle did not take the native path"
    mid = len(positions) // 2
    for p, legal in ((Position(), opening), (positions[mid], py[mid])):
        a = native.minimax_move(p.board_array(), p.side, NATIVE_DEPTH)
        assert a in legal, f"minimax depth {NATIVE_DEPTH} moved {a}, not a legal move"
        assert a == native.minimax_move(p.board_array(), p.side, NATIVE_DEPTH), "minimax repeat"
    rates = {"native_pos_per_s": len(positions) / t_nat, "python_pos_per_s": len(positions) / t_py}
    log(f"  native gen_legal == Python movegen on {len(positions)} boards; the oracle takes the "
        f"native path; minimax depth {NATIVE_DEPTH} legal and repeatable; movegen "
        f"{rates['native_pos_per_s']:.1f} positions/s native, {rates['python_pos_per_s']:.1f} "
        f"Python ({rates['native_pos_per_s'] / rates['python_pos_per_s']:.1f}x)")
    return rates


def phase_tools(dev, playouts, net, pt: str, ckpt: str, tmp: str) -> dict:
    """Phase 9 at the shipped width on the card: (a) export, (b) the int8
    twin, (c) the profiling harness and its trace, (d) the native core."""
    out_dir = os.path.join(tmp, "exports")
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    export = phase_export(dev, {"random": pt, "checkpoint": ckpt}, out_dir)
    log(f"  (a) done in {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    int8 = phase_int8(dev, playouts, net)
    log(f"  (b) done in {time.perf_counter() - t1:.1f} s")
    t2 = time.perf_counter()
    harness = phase_harness(os.path.join(tmp, "trace"))
    log(f"  (c) done in {time.perf_counter() - t2:.1f} s")
    t3 = time.perf_counter()
    nat = phase_native(playouts)
    log(f"  (d) done in {time.perf_counter() - t3:.1f} s")
    return {"export": export, "int8": int8, "harness": harness, "native": nat,
            "benchmark_launches": harness["launches"]}


# ------------------------------------------------------------ multi-rank path

MR_RANKS = 2
MR_TIMEOUT = 900               # s, every launch of phase 10
MR_GAMES, MR_SIMS, MR_PLIES = 64, 16, 16
MR_LR = 1e-3                   # the probes' learner step
# the training CLI at the shipped width (the quick preset's loop; float32
# for the comparisons); only depth is cut, each cut logged in the phase
MR_EVAL_SIMS = TC.quick_config().eval_simulations   # the gated eval: no flag sets it
MR_CUTS = {"--games-per-iter": "64", "--simulations": "16", "--max-game-length": "10",
           "--batch-size": "256", "--epochs": "1", "--eval-games": "8",
           "--eval-interval": "2", "--save-interval": "1", "--min-buffer": "256",
           "--iterations": "2"}
MR_ARGS = ["--mode", "quick", "--channels", str(CHANNELS), "--res-blocks", str(BLOCKS),
           "--dtype", "float32", "--seed", str(SEED + 7)] + [
    x for kv in MR_CUTS.items() for x in kv]
MR_LOSS_RTOL = 1e-4            # the learner against one rank on the same batch
MR_STEPS = 8                   # the learner probes' multi-step plan
MR_PROFILED_STEPS = 5          # learner steps under the profiler
MR_NOISE = 4                   # the sharded learner within this times the witness
STEP_BATCH = ("boards", "sides", "pi_actions", "pi_probs", "z", "w")


def visible_cards() -> list:
    """The ids of the cards this process sees, as CUDA_VISIBLE_DEVICES
    names them."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    return env.split(",") if env else [str(i) for i in range(torch.cuda.device_count())]


_LAUNCH_LINE = "legal_mask kernel launches: "


def start_cli(dev, out_dir: str, n: int, extra=(), env=None, rank_env=None) -> list:
    """The training CLI as ``n`` rank processes (one plain process for
    n = 1), TF32 off (NVIDIA_TF32_OVERRIDE=0), each rank's output to
    ``out_dir/rank{i}.log``; returns (process, log path) pairs."""
    os.makedirs(out_dir, exist_ok=True)
    port = free_port()
    procs = []
    for i in range(n):
        dist_args = [] if n == 1 else ["--coordinator", f"127.0.0.1:{port}",
                                       "--num-processes", str(n), "--process-id", str(i)]
        e = dict(os.environ, NVIDIA_TF32_OVERRIDE="0", OMP_NUM_THREADS="1",
                 **(env or {}), **((rank_env or {}).get(i, {})))
        path = os.path.join(out_dir, f"rank{i}.log")
        with open(path, "w") as fh:
            procs.append((subprocess.Popen(
                [sys.executable, "-m", "xiangqi_alphazero_torch.train", *MR_ARGS, *extra,
                 "--device", dev.type,
                 "--checkpoint-dir", os.path.join(out_dir, "ckpt"), *dist_args],
                stdout=fh, stderr=subprocess.STDOUT, env=e,
                cwd=os.path.dirname(os.path.abspath(__file__))), path))
    return procs


def wait_cli(procs: list, what: str) -> list:
    """Every rank's log text; fails (killing the rest) if one exits
    nonzero or outlives MR_TIMEOUT."""
    deadline = time.monotonic() + MR_TIMEOUT
    try:
        for p, _ in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = [Path(path).read_text() for _, path in procs]
    for i, ((p, _), text) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{what}: rank {i} exited {p.returncode}:\n{text[-4000:]}"
    return logs


def cli_stats(out_dir: str) -> list:
    with open(os.path.join(out_dir, "ckpt", "training_stats.json")) as f:
        return json.load(f)


def without_times(stats):
    if isinstance(stats, dict):
        return {k: without_times(v) for k, v in stats.items() if k != "time"}
    if isinstance(stats, list):
        return [without_times(s) for s in stats]
    return stats


def log_dicts(text: str, tag: str) -> list:
    """The dicts a rank logged after ``tag`` (its per-phase stats)."""
    import ast

    return [ast.literal_eval(line.split(tag, 1)[1]) for line in text.splitlines()
            if tag in line]


def rank_launches(text: str) -> int:
    return sum(int(line.split(_LAUNCH_LINE)[1]) for line in text.splitlines()
               if _LAUNCH_LINE in line)


def param_gap(a_dir: str, b_dir: str, it: int, lr: float) -> tuple:
    """(max |dparam|, share of the parameters beyond 0.05 lr) between two
    runs' checkpoint_iter{it} (the replicated layout)."""
    a, b = (torch.load(os.path.join(d, "ckpt", f"checkpoint_iter{it}"), map_location="cpu",
                       weights_only=True)["params"] for d in (a_dir, b_dir))
    worst, far, total = 0.0, 0, 0
    for k, v in a.items():
        if "running" in k or "num_batches" in k:
            continue
        d = (v.float() - b[k].float()).abs()
        worst, far, total = max(worst, float(d.max())), far + int((d > 0.05 * lr).sum()), \
            total + d.numel()
    return worst, far / total


def predicted_rank_launches(stats: list, openings: int, eval_sims: int, searches: int) -> int:
    """One rank's legal-mask launches by its loop counters: self-play once
    at the reset, per opening round, per simulation and per env step; eval
    once at the reset and, per ply, once per simulation of each of the
    rank's ``searches`` half-searches and once per step."""
    n = 0
    for it in stats:
        sp = it["self_play"]
        n += 1 + openings + sp["simulations"] + sp["plies"]
        if it["evaluation"]:
            n += 1 + it["evaluation"]["plies"] * (searches * eval_sims + 1)
    return n


def mr_probe_inputs(net) -> dict:
    """The probes' inputs: the seeded net at the shipped width, self-play
    settings of the CLI runs' depth, the dyadic eval's."""
    sd = {f"sd/{k}": v.cpu().numpy() for k, v in net.state_dict().items()}
    sp = dict(num_simulations=MR_SIMS, max_game_length=MR_PLIES, random_opening_moves=4,
              enable_resign=True, resign_threshold=-0.1, resign_check_steps=2,
              temperature_threshold=15)
    common = {"seed": np.array(SEED), "games": np.array(MR_GAMES),
              "settings": np.array(json.dumps(sp))}
    return {
        "sp_dyadic": dict(common, evaluator=np.array("dyadic")),
        "sp_net": dict(common, evaluator=np.array("net"), channels=np.array(CHANNELS),
                       blocks=np.array(BLOCKS), **sd),
        "eval_dyadic": {"settings": np.array(json.dumps(dict(num_simulations=MR_SIMS,
                                                             max_game_length=MR_PLIES))),
                        "games": np.array(8), "evaluator": np.array("dyadic")},
        "net": dict(channels=np.array(CHANNELS), blocks=np.array(BLOCKS), **sd),
    }


def spread(got: dict, want: dict, lr: float) -> dict:
    """How far one run of the learner probes lies from another: the
    largest relative loss difference, max|dparam|, the share of the
    parameters beyond 0.05 lr, and max|d running statistic|."""
    d_loss = np.abs(got["losses"] - want["losses"]) / np.abs(want["losses"])
    worst, far, total, stats = 0.0, 0, 0, 0.0
    for name, w in want.items():
        if not name.startswith("sd/") or "num_batches" in name:
            continue
        d = np.abs(got[name] - w)
        if "running" in name:
            stats = max(stats, float(d.max()))
            continue
        worst, far, total = max(worst, float(d.max())), far + int((d > 0.05 * lr).sum()), \
            total + d.size
    return {"loss": float(d_loss.max()), "dparam": worst, "far": far / total, "stats": stats}


def moment_ratios(got: dict, want: dict) -> dict:
    """Each tensor's largest |d| of Adam's first moment (0.1 x the reduced,
    clipped gradient) over its tolerance GRAD_RTOL |m| + GRAD_ATOL max |m|,
    the max over every tensor (a one-element bias's gradient may be a sum
    that cancels)."""
    moments = {k: w for k, w in want.items() if k.startswith("mu/")}
    scale = max(float(np.abs(w).max()) for w in moments.values())
    return {k[3:]: float((np.abs(got[k] - w) / (GRAD_RTOL * np.abs(w) + GRAD_ATOL * scale)).max())
            for k, w in moments.items()}


def check_step(got: dict, ref: dict, what: str) -> dict:
    """One learner step against 1 rank's (``ref["step"]``): losses within
    MR_LOSS_RTOL, at most a share STEP_FAR of the parameters beyond 0.05
    lr and none beyond 2 lr, running statistics within atol 1e-6 + rtol
    1e-5; Adam's first moment within MR_NOISE times the witness of
    rounding alone, 1 rank on the batch's rows in reverse order (or within
    its tolerance: at full width the card's float32 gradients of one batch
    summed in another order differ by several times ``moment_ratios``'
    tolerance, ReLU elements near 0 taking the other branch)."""
    want = ref["step"]
    s = spread(got, want, MR_LR)
    ratios = moment_ratios(got, want)
    witness = max(moment_ratios(ref["step_reversed"], want).values())
    top = {k: round(v, 3) for k, v in sorted(ratios.items(), key=lambda kv: -kv[1])[:3]}
    for name, w in want.items():
        if "running" in name:
            assert (np.abs(got[name] - w) <= 1e-6 + 1e-5 * np.abs(w)).all(), f"{what}: {name}"
    bound = max(MR_NOISE * witness, 1.0)
    log(f"  {what}: losses {got['losses'].tolist()} against 1 rank's {want['losses'].tolist()} "
        f"(max rel {s['loss']:.3g}, rtol {MR_LOSS_RTOL:g}); Adam's first moment at "
        f"{max(ratios.values()):.3g} of its tolerance (worst {top}; witness, rows reversed, "
        f"{witness:.3g}; bound {bound:.3g}); max|dparam| {s['dparam']:.3g}, share beyond "
        f"0.05 lr {s['far']:.3g} (at most {STEP_FAR:g})")
    assert s["loss"] <= MR_LOSS_RTOL, (what, s)
    assert max(ratios.values()) <= bound, (what, ratios, witness)
    assert s["far"] <= STEP_FAR and s["dparam"] <= 2 * MR_LR, (what, s)
    return s


def multirank_base(dev) -> dict:
    """What the multi-rank runs are held against: the probes' inputs and
    their 1-rank outputs on the card."""
    k = 128
    net = init_net(torch.Generator().manual_seed(SEED), CHANNELS, BLOCKS)
    inp = mr_probe_inputs(net)
    ref = {name: PROBE.run(mode, inp[name], None, dev) for name, mode in
           (("sp_dyadic", "selfplay"), ("eval_dyadic", "eval"), ("sp_net", "selfplay"))}
    out = TS.SelfPlayOut(**{f: torch.from_numpy(ref["sp_dyadic"][f]) for f in SP_RECORDS})
    buf = replay_of(out, k)
    perm, wmask, _ = buf.epoch_plan(LEARNER_BATCH, 2, np.random.default_rng(SEED))
    assert wmask[0].all() and len(perm) >= MR_STEPS, "the replay must fill the steps"
    batch = dict(zip(("boards", "sides", "pi_actions", "pi_probs", "z"),
                     (a[perm[0]] for a in buf.arrays())), w=wmask[0])
    step_in = dict(inp["net"], **batch, lr=np.array(MR_LR), wd=np.array(1e-4))
    steps_in = dict(inp["net"], **dict(zip(("boards", "sides", "pi_actions", "pi_probs", "z"),
                                           buf.arrays())),
                    perm=perm[:MR_STEPS], wmask=wmask[:MR_STEPS], lr=np.array(MR_LR),
                    wd=np.array(1e-4))
    ref["step"] = PROBE.run("step", step_in, None, dev)
    ref["step_reversed"] = PROBE.run("step", dict(step_in, **{
        k: np.ascontiguousarray(step_in[k][::-1]) for k in STEP_BATCH}), None, dev)
    ref["steps"] = PROBE.run("steps", steps_in, None, dev)
    ref["steps_reversed"] = PROBE.run("steps", dict(
        steps_in, perm=np.ascontiguousarray(steps_in["perm"][:, ::-1]),
        wmask=np.ascontiguousarray(steps_in["wmask"][:, ::-1])), None, dev)
    feats = E.features(torch.from_numpy(batch["boards"]), torch.from_numpy(batch["sides"]))
    fwd_in = dict(inp["net"], feats=feats.numpy())
    ref["forward"] = PROBE.run("forward", fwd_in, None, dev)
    return {"inp": inp, "ref": ref, "buf": buf, "step_in": step_in, "steps_in": steps_in,
            "fwd_in": fwd_in, "batch": batch}


def check_probes(base: dict, out: list, what: str) -> None:
    """The data-parallel probe jobs of ``probe_jobs`` against 1 rank's:
    the mock nets' self-play, ring and eval exactly; the real net's games
    counted; one step (``check_step``); the 8-step plan, held as the step
    is."""
    ref, k = base["ref"], 128
    for f in SP_RECORDS:
        assert np.array_equal(out[0][f], ref["sp_dyadic"][f]), f"{what}: self-play {f} != 1 rank"
    dp_buf = replay_of(TS.SelfPlayOut(**{f: torch.from_numpy(out[0][f]) for f in SP_RECORDS}), k)
    for a, b in zip(dp_buf.arrays(), base["buf"].arrays()):
        assert np.array_equal(a, b), f"{what}: replay ring != 1 rank"
    for f in ("winners", "new_is_red", "plies_run"):
        assert np.array_equal(out[1][f], ref["eval_dyadic"][f]), f"{what}: eval {f} != 1 rank"
    log(f"  {what}, exact mock nets: self-play ({MR_GAMES} games, {MR_SIMS} sims, "
        f"{int(ref['sp_dyadic']['rec'].sum())} records), its replay ring ({len(base['buf'])} rows) "
        f"and the eval (8 games, winners {ref['eval_dyadic']['winners'].tolist()}, "
        f"{int(ref['eval_dyadic']['plies_run'])} plies) equal 1 rank's")
    got, want = out[2], ref["sp_net"]
    same = [all(np.array_equal(got[f][:, g], want[f][:, g])
                for f in ("boards", "pi_actions", "rec")) and got["winners"][g] == want["winners"][g]
            for g in range(MR_GAMES)]
    log(f"  {what}, real net ({CHANNELS} x {BLOCKS}, float32): {sum(same)} of {MR_GAMES} games "
        f"identical to 1 rank's ({sum(same) / MR_GAMES:.4f})")
    check_step(out[3], ref, f"{what}, learner step, batch {LEARNER_BATCH}")
    # the trainer's learner path over MR_STEPS steps: rounding grows from
    # step to step, so the spread is held against the witness's, 1 rank
    # with each step's columns in reverse order (as ``check_step`` holds
    # one step)
    got = spread(out[4], ref["steps"], MR_LR)
    witness = spread(ref["steps_reversed"], ref["steps"], MR_LR)
    floor = {"loss": MR_LOSS_RTOL, "far": STEP_FAR, "stats": 1e-5}
    bound = {k: max(MR_NOISE * witness[k], f) for k, f in floor.items()}
    first = float(np.abs(out[4]["losses"][0] / ref["steps"]["losses"][0] - 1).max())
    log(f"  {what}, {MR_STEPS} learner steps (train_epochs, batch {LEARNER_BATCH}, lr {MR_LR:g}) "
        f"against 1 rank: {got}; witness, columns reversed, {witness}; bounds {bound}; first "
        f"step's losses rel {first:.3g}")
    assert out[4]["losses"].shape == ref["steps"]["losses"].shape == (MR_STEPS, 2)
    assert first <= MR_LOSS_RTOL, (what, first)
    assert all(got[k] <= bound[k] for k in bound), (what, got, bound)


def probe_jobs(base: dict) -> list:
    """The data-parallel probe jobs that ``check_probes`` reads, then the
    step's profile and one self-play ply's."""
    inp = base["inp"]
    return [("selfplay", inp["sp_dyadic"]), ("eval", inp["eval_dyadic"]),
            ("selfplay", inp["sp_net"]), ("step", base["step_in"]), ("steps", base["steps_in"]),
            ("step_profile", dict(base["step_in"], steps=np.array(MR_PROFILED_STEPS))),
            ("profile", inp["sp_net"])]


def collectives_line(rows: np.ndarray) -> str:
    return (f"ms a step {np.round(rows[:, 0], 3).tolist()}, in the gradient all-reduce "
            f"{np.round(rows[:, 1], 3).tolist()}, in the other collectives "
            f"{np.round(rows[:, 2], 3).tolist()}")


def time_cudnn_modes(dev, base: dict, smi: str) -> dict:
    """One learner step with cuDNN's default and its deterministic
    algorithms, interleaved, at the shapes of this phase's CLI runs
    (float32, TF32 off, batch 256) and of the bf16 training default
    (batch 1024); CUDA events over 10 steps a reading."""
    rows = [a for a in base["buf"].arrays()]
    out = {}
    for dtype, batch in ((torch.float32, LEARNER_BATCH), (torch.bfloat16, 1024)):
        net = init_net(torch.Generator().manual_seed(SEED), CHANNELS, BLOCKS, dtype, dev).train()
        opt = TL.make_optimizer(net.parameters(), MR_LR, 1e-4)
        idx = np.arange(batch) % len(base["buf"])
        args = [torch.from_numpy(np.ascontiguousarray(a[idx])).to(dev) for a in rows]
        args.append(torch.ones(batch, device=dev))

        def step(deterministic):
            def f():
                torch.backends.cudnn.deterministic = deterministic
                TL.train_step(net, opt, *args)
            return f

        try:
            ms = interleaved({"default": step(False), "deterministic": step(True)},
                             lambda fn: cuda_ms(fn, 10))
        finally:
            torch.backends.cudnn.deterministic = False
        out[f"{str(dtype).split('.')[1]}_b{batch}"] = ms
    log(f"  (e) learner ms a step, cuDNN default against deterministic (interleaved, 1 rank, "
        f"{CHANNELS} x {BLOCKS}), {smi}: {json.dumps(out)}")
    return out


def phase_multirank(dev, smi: str, tmp: str) -> dict:
    """(a) 2 ranks against 1 on the probes and through the CLI, (b) TP,
    (c) the restarted pod, all on one card over gloo; (d) NCCL where there
    are two cards; (e) cuDNN's deterministic algorithms timed."""
    t_phase = time.perf_counter()
    log(f"  cuts of the CLI runs (quick preset at {CHANNELS} x {BLOCKS}, float32): "
        + ", ".join(f"{a} {v}" for a, v in MR_CUTS.items())
        + f"; the gated eval at the preset's {MR_EVAL_SIMS} simulations (no flag sets it); "
        "the 1-rank and TP runs stop after iteration 1")
    base = multirank_base(dev)
    ref = base["ref"]
    one_card = {"CUDA_VISIBLE_DEVICES": visible_cards()[0]}

    # (a) the probes: 2 rank processes on one card against 1 rank here
    t0 = time.perf_counter()
    dp_out, dp_logs = PROBE.launch(probe_jobs(base), MR_RANKS, device=dev.type,
                                   timeout=MR_TIMEOUT, env=one_card)
    log(f"  probes, {MR_RANKS} data-parallel ranks on one card: {time.perf_counter() - t0:.1f} s; "
        + "; ".join(line for text in dp_logs for line in text.splitlines()
                    if "backend" in line or "launches" in line))
    assert all("backend gloo" in text for text in dp_logs), "2 ranks on one card must take gloo"
    check_probes(base, dp_out, f"(a) {MR_RANKS} ranks")
    one_prof = PROBE.run("step_profile", dict(base["step_in"], steps=np.array(MR_PROFILED_STEPS)),
                         None, dev)["ranks"]
    log(f"  (a) learner step under the profiler (batch {LEARNER_BATCH}, {MR_PROFILED_STEPS} steps), "
        f"{smi}: 1 rank {collectives_line(one_prof)}; {MR_RANKS} ranks over gloo "
        f"{collectives_line(dp_out[5]['ranks'])}")
    prof = dp_out[6]["ranks"]   # per rank: busy s, wall s, kernels, simulations
    idle = 1 - prof[:, 0].sum() / prof[:, 1].max()
    log(f"  idle share of the card over one ply of {MR_RANKS}-rank self-play ({MR_GAMES} games x "
        f"{MR_SIMS} sims, profiler on), {smi}: {idle:.4f} (busy {prof[:, 0].tolist()} s, "
        f"wall {prof[:, 1].tolist()} s, kernels {prof[:, 2].tolist()})")

    # the CLI: 1 rank (one iteration), then 2 ranks (two), each timed
    # alone, both supervised (cuDNN's deterministic algorithms); then the
    # restarted pod, one TP iteration and the TP probes together
    runs = {n: os.path.join(tmp, "multirank", n) for n in ("one", "dp", "restart", "tp")}
    t0 = time.perf_counter()
    one_logs = wait_cli(start_cli(dev, runs["one"], 1, ["--iterations", "1", "--mesh-mode", "off",
                                                        "--auto-restart", "1"], env=one_card),
                        "1-rank CLI")
    t_one = time.perf_counter() - t0
    t0 = time.perf_counter()
    dp_logs = wait_cli(start_cli(dev, runs["dp"], MR_RANKS, ["--auto-restart", "1"], env=one_card),
                       "2-rank CLI")
    t_dp = time.perf_counter() - t0
    assert all("backend gloo" in text for text in dp_logs), "2 ranks on one card must take gloo"
    t0 = time.perf_counter()
    faults = os.path.join(tmp, "multirank")
    pods = [start_cli(dev, runs["restart"], MR_RANKS, ["--auto-restart", "1"], env=one_card,
                      rank_env={i: {"XQAZ_FAULT_ITER": f"2:{faults}/fault_p{i}"}
                                for i in range(MR_RANKS)}),
            start_cli(dev, runs["tp"], MR_RANKS, ["--model-parallel", "2", "--iterations", "1"],
                      env=one_card)]
    tp_out = PROBE.launch([("forward", base["fwd_in"]), ("step", base["step_in"])], MR_RANKS,
                          model_parallel=2, device=dev.type, timeout=MR_TIMEOUT, env=one_card)[0]
    restart_logs, tp_logs = (wait_cli(p, w) for p, w in zip(pods, ("restart", "TP CLI")))
    t_pair = time.perf_counter() - t0

    # (b) tensor parallel over 2 ranks on the card
    dl = float(np.abs(tp_out[0]["logits"] - ref["forward"]["logits"]).max())
    dv = float(np.abs(tp_out[0]["value"] - ref["forward"]["value"]).max())
    log(f"  (b) TP forward ({MR_RANKS} ranks, --model-parallel 2, B = {LEARNER_BATCH}) against the "
        f"replicated forward: max|dlogits| {dl:.3g} (atol 1e-4), max|dvalue| {dv:.3g} (atol 1e-5)")
    assert dl <= 1e-4 and dv <= 1e-5, (dl, dv)
    check_step(tp_out[1], base["ref"], "(b) TP learner step")

    one, dp = cli_stats(runs["one"]), cli_stats(runs["dp"])
    lr = float(one[0]["training"]["learning_rate"])
    for it in range(len(one)):
        worst, far = param_gap(runs["one"], runs["dp"], it + 1, lr)
        a, b = one[it]["training"], dp[it]["training"]
        log(f"  (a) CLI iteration {it + 1}: self-play {'equal' if without_times(one[it]['self_play']) == without_times(dp[it]['self_play']) else 'different'}; "
            f"losses 1 rank {a['policy_loss']:.6f}/{a['value_loss']:.6f}, 2 ranks "
            f"{b['policy_loss']:.6f}/{b['value_loss']:.6f} (rel {abs(b['total_loss'] / a['total_loss'] - 1):.3g}); "
            f"max|dparam| {worst:.3g}, share beyond 0.05 lr ({lr:g}) {far:.3g}; eval 1 rank "
            f"{without_times(one[it]['evaluation'])}, 2 ranks {without_times(dp[it]['evaluation'])}")
    assert [s["iteration"] for s in dp] == [1, 2] and dp[1]["evaluation"], "2-rank CLI stats"
    restart = cli_stats(runs["restart"])
    assert all(os.path.exists(f"{faults}/fault_p{i}") for i in range(MR_RANKS)), "no fault fired"
    assert any("[supervisor] training exited" in text for text in restart_logs)
    assert without_times(restart) == without_times(dp), \
        f"(c) restarted pod != uninterrupted pod:\n{restart}\n{dp}"
    log(f"  (c) the {MR_RANKS}-rank pod with a fault at iteration 2 on every rank, under "
        f"--auto-restart 1, equals the uninterrupted (supervised) pod's training_stats.json "
        f"(times left out)")
    tp = cli_stats(runs["tp"])
    worst, far = param_gap(runs["one"], runs["tp"], 1, lr)
    log(f"  (b) TP CLI iteration 1: self-play {'equal' if without_times(tp[0]['self_play']) == without_times(one[0]['self_play']) else 'different'}; "
        f"losses {tp[0]['training']['policy_loss']:.6f}/{tp[0]['training']['value_loss']:.6f}; "
        f"max|dparam| against 1 rank {worst:.3g}, share beyond 0.05 lr {far:.3g}")

    # (d) NCCL, one card a rank, where there are two
    if torch.cuda.device_count() >= MR_RANKS:
        multirank_nccl(dev, smi, tmp, base, runs["one"])
    else:
        log(f"  (d) NCCL unmeasured: {torch.cuda.device_count()} card (NCCL refuses two ranks "
            f"on one)")
    cudnn = time_cudnn_modes(dev, base, smi)

    # launches: every rank of the 2-rank run, against its loop counters
    launches = [rank_launches(text) for text in dp_logs]
    want = [predicted_rank_launches(dp, 4, MR_EVAL_SIMS, 1)] * MR_RANKS
    assert launches == want, f"2-rank CLI launches {launches} != predicted {want}"
    assert rank_launches(one_logs[0]) == predicted_rank_launches(one, 4, MR_EVAL_SIMS, 2)

    # rates, from each rank's own stats
    sp_one = log_dicts(one_logs[0], "self-play: ")
    sp_dp = [log_dicts(text, "self-play: ") for text in dp_logs]
    tr_one = [s for s in log_dicts(one_logs[0], "train: ") if s]
    tr_dp = [s for s in log_dicts(dp_logs[0], "train: ") if s]
    local = MR_GAMES // MR_RANKS
    rates = {
        "selfplay_sims_per_s_1rank": MR_GAMES * sum(s["simulations"] for s in sp_one)
        / sum(s["time"] for s in sp_one),
        "selfplay_sims_per_s_per_rank": [local * sum(s["simulations"] for s in r)
                                         / sum(s["time"] for s in r) for r in sp_dp],
        "learner_ms_per_step_1rank": 1e3 * sum(s["time"] for s in tr_one)
        / sum(s["batches"] for s in tr_one),
        "learner_ms_per_step_2ranks": 1e3 * sum(s["time"] for s in tr_dp)
        / sum(s["batches"] for s in tr_dp),
        "profiled_step_ms_1rank": float(one_prof[0, 0]),
        "profiled_step_ms_2ranks": dp_out[5]["ranks"][:, 0].tolist(),
        "collective_ms_per_step_2ranks": {"gradient": dp_out[5]["ranks"][:, 1].tolist(),
                                          "other": dp_out[5]["ranks"][:, 2].tolist()},
        "idle_share_2rank_ply": float(idle),
        "cudnn_ms": cudnn,
        "cli_s": {"one": t_one, "dp": t_dp, "restart+tp+tp_probes": t_pair},
    }
    rates["selfplay_sims_per_s_2ranks_total"] = MR_GAMES * sum(
        s["simulations"] for s in sp_dp[0]) / max(sum(s["time"] for s in r) for r in sp_dp)
    log(f"  multi-rank rates on {smi}: " + json.dumps(rates))
    log(f"  legal_mask launches: 2-rank CLI {launches} (== the loop counters), 1 rank "
        f"{rank_launches(one_logs[0])}; phase wall {time.perf_counter() - t_phase:.1f} s, {smi}")
    return {"launches": sum(launches), "rates": rates}


def multirank_nccl(dev, smi: str, tmp: str, base: dict, one_dir: str) -> None:
    """(d) (a) over NCCL, one card a rank: the probes against 1 rank's as
    in (a), then the CLI as a user with several cards runs it (one
    process, ``--mesh-mode auto``, which starts a rank a card) against the
    1-rank CLI run in ``one_dir``."""
    t0 = time.perf_counter()
    cards = {"CUDA_VISIBLE_DEVICES": ",".join(visible_cards()[:MR_RANKS])}
    out, logs = PROBE.launch(probe_jobs(base), MR_RANKS, device=dev.type, timeout=MR_TIMEOUT,
                             env=cards)
    assert all("backend nccl" in text for text in logs), "a card a rank must take NCCL"
    check_probes(base, out, f"(d) {MR_RANKS} ranks over NCCL")
    rows = out[5]["ranks"]
    log(f"  (d) learner step under the profiler over NCCL, {smi}: ms a step "
        f"{np.round(rows[:, 0], 3).tolist()}, in NCCL's kernels on the card (the gradient and "
        f"the rest together) {np.round(rows[:, 2], 3).tolist()}")
    run = os.path.join(tmp, "multirank", "nccl")
    text = wait_cli(start_cli(dev, run, 1, ["--iterations", "1", "--mesh-mode", "auto"],
                             env=cards), "NCCL CLI")[0]
    assert text.count("backend nccl") == MR_RANKS, "the CLI must start a rank a card over NCCL"
    nccl, one = cli_stats(run), cli_stats(one_dir)
    worst, far = param_gap(one_dir, run, 1, float(one[0]["training"]["learning_rate"]))
    assert rank_launches(text) == MR_RANKS * predicted_rank_launches(nccl, 4, MR_EVAL_SIMS, 1)
    log(f"  (d) CLI, one process on {MR_RANKS} cards (a rank a card, NCCL), iteration 1: "
        f"self-play {'equal' if without_times(nccl[0]['self_play']) == without_times(one[0]['self_play']) else 'different'} "
        f"to 1 rank's; losses {nccl[0]['training']['policy_loss']:.6f}/"
        f"{nccl[0]['training']['value_loss']:.6f} against 1 rank's "
        f"{one[0]['training']['policy_loss']:.6f}/{one[0]['training']['value_loss']:.6f}; "
        f"max|dparam| {worst:.3g}, share beyond 0.05 lr {far:.3g}; launches "
        f"{rank_launches(text)}; {time.perf_counter() - t0:.1f} s, {smi}")


def phase_nccl_only(dev, smi: str, tmp: str) -> None:
    """(d) alone, with what it is held against: the 1-rank probes and the
    1-rank CLI run."""
    assert torch.cuda.device_count() >= MR_RANKS, "NCCL needs a card a rank"
    base = multirank_base(dev)
    one = os.path.join(tmp, "multirank", "one")
    wait_cli(start_cli(dev, one, 1, ["--iterations", "1", "--mesh-mode", "off"],
                       env={"CUDA_VISIBLE_DEVICES": visible_cards()[0]}), "1-rank CLI")
    multirank_nccl(dev, smi, tmp, base, one)


# ------------------------------------------------------------ flagship and tools

FLAGSHIP_SCRIPT = os.path.join("xiangqi_alphazero_torch", "scripts", "flagship_run.sh")
FLAGSHIP_ITERS = 2
# the flagship recipe at its full width, fleet and batch (256 x 10, 256
# games, batch 1024, bf16, Gumbel-32); only depth is cut, each cut logged.
# The gated eval falls past the last iteration: at the recipe's 100
# simulations a move it would take ~1 min (no flag sets its depth)
FLAGSHIP_CUTS = {"--max-game-length": "40", "--epochs": "1", "--eval-interval": "3",
                 "--min-buffer": "2048"}
FLAGSHIP_TIMEOUT = 900                           # s
ANCHOR_DEPTH, ANCHOR_GAMES, ANCHOR_SIMS = 1, 8, 32
PARITY_DEPTH, PARITY_GAMES, PARITY_SIMS = 0, 2, 8   # (b): card against CPU, 128 x 6
LATENCY_CELLS = ((100, 8), (500, 4))              # (sims, requests a cell), 128 x 6
LATENCY_CONC = [1, 4]
FLAGSHIP_LATENCY = (500, 1, 4)                   # sims, concurrency, requests: 256 x 10
H2H_GAMES, H2H_SIMS = 8, 4        # the arena (300-ply cap, its default): sims cut from 40
LADDER_PLIES = 40                 # the Elo ladder's move cap (train.elo's default 300)
_PEAK_LINE = "peak device memory: "


def script_flags(path: str, module: str, iters: int) -> list:
    """The flags a shell script passes to ``python -m <module>``, with its
    first argument (``"$ITERS"``) at ``iters`` and no further arguments."""
    with open(path) as f:
        text = f.read().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines() if f"-m {module}" in ln)
    words = shlex.split(line.replace('"$ITERS"', str(iters)).replace('"$@"', ""))
    return words[words.index(module) + 1:]


def kill_by_arg(marker: str) -> None:
    """SIGKILL every process whose command line holds ``marker`` (the
    supervisor starts its child in a session of its own)."""
    for pid in os.listdir("/proc"):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                if marker.encode() in f.read():
                    os.kill(int(pid), 9)
        except (OSError, ValueError):
            pass


def run_flagship(dev, smi: str, out_dir: str) -> dict:
    """(a): ``flagship_run.sh`` as a user runs it (the CLI under its
    ``--auto-restart`` supervisor), depth cut; its rates, peak memory and
    the kernel's launches against the loop counters' prediction."""
    repo = os.path.dirname(os.path.abspath(__file__))
    ckpt = os.path.join(out_dir, "ckpt")
    cuts = [x for kv in FLAGSHIP_CUTS.items() for x in kv] + ["--checkpoint-dir", ckpt]
    script = os.path.join(repo, FLAGSHIP_SCRIPT)
    full = TC.config_from_args(TC.build_argparser().parse_args(
        script_flags(script, "xiangqi_alphazero_torch.train", 200)))[0]
    cfg = TC.config_from_args(TC.build_argparser().parse_args(
        script_flags(script, "xiangqi_alphazero_torch.train", FLAGSHIP_ITERS) + cuts))[0]
    for k, v in dataclasses.asdict(cfg).items():
        if v != getattr(full, k) and k != "checkpoint_dir":
            log(f"  cut: {k} {getattr(full, k)} -> {v}")
    log(f"  recipe: {cfg.num_channels} x {cfg.num_res_blocks}, {cfg.search_algo}-"
        f"{cfg.num_simulations} (m = {cfg.max_considered}), {cfg.num_games_per_iter} games, "
        f"batch {cfg.batch_size}, {cfg.dtype}, ring {cfg.max_buffer_size}")
    os.makedirs(out_dir)
    path = os.path.join(out_dir, "flagship.log")
    t0 = time.perf_counter()
    with open(path, "w") as fh:
        proc = subprocess.Popen(["bash", FLAGSHIP_SCRIPT, str(FLAGSHIP_ITERS), *cuts], cwd=repo,
                                stdout=fh, stderr=subprocess.STDOUT,
                                env=dict(os.environ, PYTHON=sys.executable))
        try:
            proc.wait(timeout=FLAGSHIP_TIMEOUT)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            kill_by_arg(ckpt)
    wall = time.perf_counter() - t0
    text = Path(path).read_text()
    assert proc.returncode == 0, f"flagship_run.sh exited {proc.returncode}:\n{text[-4000:]}"
    with open(os.path.join(ckpt, "training_stats.json")) as f:
        stats = json.load(f)
    assert [it["iteration"] for it in stats] == list(range(1, FLAGSHIP_ITERS + 1)), stats
    launches, want = rank_launches(text), predicted_launches(cfg, stats)
    assert launches == want, f"flagship kernel launches {launches} != predicted {want}"
    peak = [int(ln.split(_PEAK_LINE)[1].split()[0]) for ln in text.splitlines()
            if _PEAK_LINE in ln]
    assert len(peak) == 1, peak
    assert not any(it["evaluation"] for it in stats), "the flagship's eval is cut"
    sp = [it["self_play"] for it in stats]
    tr = [it["training"] for it in stats if it["training"]]
    assert tr and all(np.isfinite(t["policy_loss"]) and np.isfinite(t["value_loss"]) for t in tr)
    sp_s = sum(x["time"] for x in sp)
    rates = {
        "selfplay_sims_per_s": cfg.num_games_per_iter * sum(x["simulations"] for x in sp) / sp_s,
        "selfplay_s_per_ply": sp_s / sum(x["plies"] for x in sp),
        "learner_ms_per_step": [1e3 * t["time"] / t["batches"] for t in tr],
        "learner_steps": [t["batches"] for t in tr],
        "iteration_s": [it["time"] for it in stats],
        "peak_memory_bytes": peak[0],
        "cli_wall_s": wall,
    }
    log(f"  (a) flagship on {smi}: " + json.dumps(rates))
    log("  losses " + ", ".join(f"{t['policy_loss']:.4f}/{t['value_loss']:.4f}" for t in tr)
        + f"; kernel launches {launches} == predicted {want}")
    return {"launches": launches, "rates": rates,
            "checkpoint": os.path.join(ckpt, f"checkpoint_iter{FLAGSHIP_ITERS}")}


class CountingPredictor:
    """A Predictor whose batched searches are counted and recorded (the
    net's moves of an anchor match), for the launch prediction and for
    finding where two devices' matches part."""

    def __init__(self, pred):
        self.pred, self.searches, self.visits = pred, 0, []

    def search_batch(self, positions, pad_to=None):
        self.searches += 1
        out = self.pred.search_batch(positions, pad_to=pad_to)
        self.visits.append([(r[0].tolist(), r[1].tolist()) for r in out])
        return out


def run_anchor(dev, flagship_ckpt: str, pt: str) -> dict:
    """(b): the flagship's checkpoint against minimax depth 1 on the card,
    launches == searches x (width + simulations); then the card against
    the CPU at 2 games on the 128 x 6 .pt, equal in every field."""
    pred = CountingPredictor(Predictor.load(flagship_ckpt, num_simulations=ANCHOR_SIMS,
                                            device=dev))
    for k in KERNELS:
        k["wrapper"].launches = 0
    t0 = time.perf_counter()
    res = MINIMAX.play_match(pred, ANCHOR_DEPTH, ANCHOR_GAMES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = LM.legal_mask_cuda.launches
    assert res["net_wins"] + res["draws"] + res["net_losses"] == ANCHOR_GAMES, res
    want = pred.searches * (ANCHOR_GAMES + ANCHOR_SIMS)
    assert launches == want, f"anchor launches {launches} != predicted {want}"
    log(f"  (b) anchor, a plumbing check ({ANCHOR_GAMES} games rate no strength): flagship "
        f"checkpoint_iter{FLAGSHIP_ITERS} (puct-{ANCHOR_SIMS}, cut from 200) against minimax "
        f"depth {ANCHOR_DEPTH}, {ANCHOR_GAMES} games: "
        f"W-D-L {res['net_wins']}-{res['draws']}-{res['net_losses']}, score {res['score']}, "
        f"Elo against the anchor {res['elo_vs_anchor']}, avg plies {res['avg_plies']}; "
        f"{wall:.1f} s; {pred.searches} batched searches, kernel launches {launches} == "
        f"predicted {want}")
    runs = []
    for where in (dev, torch.device("cpu")):
        p = CountingPredictor(Predictor.load(pt, num_simulations=PARITY_SIMS, device=where))
        t1 = time.perf_counter()
        runs.append((MINIMAX.play_match(p, PARITY_DEPTH, PARITY_GAMES), p,
                     time.perf_counter() - t1))
    (card, pc, tc), (cpu, pcpu, tcpu) = runs
    first = next(((i, lane) for i, (a, b) in enumerate(zip(pc.visits, pcpu.visits))
                  for lane in range(len(a)) if a[lane] != b[lane]), None)
    assert card == cpu and first is None, (
        f"anchor card != CPU: {card} against {cpu}; first differing search (index, lane) "
        f"{first}")
    log(f"  anchor card == CPU at {PARITY_GAMES} games x {PARITY_SIMS} sims, depth "
        f"{PARITY_DEPTH}, 128 x 6: {card} ({pc.searches} searches equal; card {tc:.1f} s, "
        f"CPU {tcpu:.1f} s)")
    return {"launches": launches, "result": res, "wall_s": wall, "searches": pred.searches}


def run_latency(dev, smi: str, pt: str, flagship_ckpt: str) -> dict:
    """(c): the serving-latency grid on the 128 x 6 .pt, and one cell on the
    flagship's net; every bucket warmed first."""
    for k in KERNELS:
        k["wrapper"].launches = 0
    pred = Predictor.load(pt, device=dev)
    rows = []
    for sims, requests in LATENCY_CELLS:
        rows += [("128x6",) + r for r in LATENCY.run_grid(pred, [sims], LATENCY_CONC, requests)]
    sims, conc, requests = FLAGSHIP_LATENCY
    flag = Predictor.load(flagship_ckpt, device=dev)
    rows += [("256x10",) + r for r in LATENCY.run_grid(flag, [sims], [conc], requests)]
    torch.cuda.synchronize()
    launches = LM.legal_mask_cuda.launches
    assert launches > 0
    log(f"  (c) serving latency on {smi} (PUCT, float32, TF32 off; the opening; net, sims, "
        "concurrency: p50 ms, max ms, requests, moves/s, mean batch; too few requests for a "
        "p95):")
    for net, s, c, p50, p95, top, n, thr, mb in rows:
        assert 0 < p50 <= p95 <= top and thr > 0 and 1 <= mb <= c, (net, s, c, p50, top, thr, mb)
        log(f"    {net} s{s} c{c}: {p50:.3f}, {top:.3f}, {n}, {thr:.4f}, {mb:.3f}")
    log(f"  latency kernel launches {launches}")
    return {"launches": launches, "rows": rows}


def run_h2h(dev, tmp: str, puct_dir: str, gumbel_dir: str) -> dict:
    """(d): the head-to-head over the arms of 6b (c) (PUCT) and 6c (c)
    (Gumbel), ``--skip-train``: the arena over their current parameters;
    then an Elo ladder of 6b (c)'s initial net and its checkpoint, and the
    strength report of 6b (c)'s run over it."""
    out = os.path.join(tmp, "h2h")
    os.makedirs(out)
    os.symlink(puct_dir, os.path.join(out, "puct"))
    os.symlink(gumbel_dir, os.path.join(out, "gumbel"))
    for k in KERNELS:
        k["wrapper"].launches = 0
    t0 = time.perf_counter()
    assert H2H.main(["--skip-train", "--gumbel-iters", "2", "--puct-iters", "2", "--games",
                     str(H2H_GAMES), "--arena-sims", str(H2H_SIMS), "--out", out,
                     "--device", dev.type]) == 0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = LM.legal_mask_cuda.launches
    with open(os.path.join(out, "result.json")) as f:
        res = json.load(f)
    arena = res["arena"]
    assert arena["a_wins"] + arena["b_wins"] + arena["draws"] == H2H_GAMES, res
    want = 1 + arena["plies_run"] * (2 * H2H_SIMS + 1)
    assert launches == want, f"h2h arena launches {launches} != predicted {want}"
    log(f"  (d) head-to-head --skip-train, a plumbing check ({H2H_GAMES} games rate no "
        f"strength; gumbel = 6c (c), puct = 6b (c); current parameters; puct-{H2H_SIMS} both, "
        f"cut from 40; 300-ply cap): "
        f"{json.dumps(res)}; {wall:.1f} s; kernel launches {launches} == predicted {want}")

    cfg = TC.tpu_config()
    iter0 = os.path.join(tmp, "ladder", "iter0.pt")
    os.makedirs(os.path.dirname(iter0))
    net = init_net(torch.Generator().manual_seed(cfg.seed), CHANNELS, BLOCKS)
    torch.save({"model_state_dict": net.state_dict(),
                "config": {"num_channels": CHANNELS, "num_res_blocks": BLOCKS}}, iter0)
    for k in KERNELS:
        k["wrapper"].launches = 0
    ladder = ELO.round_robin([iter0, os.path.join(puct_dir, "checkpoint_iter2")],
                             games=H2H_GAMES, sims=H2H_SIMS, max_game_length=LADDER_PLIES,
                             device=dev)
    elo_launches = LM.legal_mask_cuda.launches
    ladder_path = os.path.join(tmp, "ladder", "ladder.json")
    with open(ladder_path, "w") as f:
        json.dump(ladder, f)
    log(f"  Elo ladder (6b (c)'s initial net as iter0, its checkpoint_iter2's best net; "
        f"{H2H_GAMES} games, puct-{H2H_SIMS}, {LADDER_PLIES}-ply cap): {json.dumps(ladder)}; "
        f"launches {elo_launches}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert REPORT.main(["--run", puct_dir, "--ladder", ladder_path]) == 0
    table = buf.getvalue().strip().splitlines()
    assert len(table) == 4 and table[2].startswith("| 0 |") and table[3].startswith("| 2 |"), table
    log("  strength report of 6b (c):\n    " + "\n    ".join(table))
    return {"launches": launches, "elo_launches": elo_launches, "result": res, "wall_s": wall}


def phase_flagship_tools(dev, smi: str, tmp: str, pt: str, puct_dir: str,
                         gumbel_dir: str) -> dict:
    """Phase 11: (a) the flagship recipe, (b) the minimax anchor, (c) the
    serving-latency grid, (d) the head-to-head and the strength report."""
    out = {}
    steps = [("a", "flagship", lambda: run_flagship(dev, smi, os.path.join(tmp, "flagship"))),
             ("b", "anchor", lambda: run_anchor(dev, out["flagship"]["checkpoint"], pt)),
             ("c", "latency", lambda: run_latency(dev, smi, pt, out["flagship"]["checkpoint"])),
             ("d", "h2h", lambda: run_h2h(dev, tmp, puct_dir, gumbel_dir))]
    for tag, name, fn in steps:
        t0 = time.perf_counter()
        out[name] = fn()
        log(f"  ({tag}) done in {time.perf_counter() - t0:.1f} s")
    return out


# -------------------------------------------------------------------- main


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dense-baseline", metavar="PATH",
                        help="source of the earlier dense kernel, timed beside this one")
    parser.add_argument("--only", choices=["multirank", "nccl", "tools"],
                        help="run phases 1-2 and only phase 10 (multirank), only its "
                        "NCCL part (d) with the 1-rank runs it is held against, or only "
                        "phase 11 (tools) after the two training runs whose checkpoints it "
                        "takes (6b (c), 6c (c)); prints no kernels line")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()

    phases = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        phases[name] = time.perf_counter() - t0
        log(f"phase {name}: {phases[name]:.1f} s")
        return out

    device = timed("1 device", phase_device)
    timed("2 build", phase_build, args.dense_baseline)
    if args.only:
        with tempfile.TemporaryDirectory() as tmp:
            if args.only == "multirank":
                timed("10 multirank", phase_multirank, dev, device["smi"], tmp)
            elif args.only == "nccl":
                timed("10 (d) nccl", phase_nccl_only, dev, device["smi"], tmp)
            else:
                pt = os.path.join(tmp, f"random_{CHANNELS}x{BLOCKS}.pt")
                write_random_pt(pt, SEED)
                ckpt, gumbel_ckpt = os.path.join(tmp, "train"), os.path.join(tmp, "gumbel_train")
                os.makedirs(ckpt)
                os.makedirs(gumbel_ckpt)
                timed("6b (c) train", lambda: run_trainer(dev, ckpt, device["smi"]))
                timed("6c (c) gumbel train",
                      lambda: run_trainer(dev, gumbel_ckpt, device["smi"], search_algo="gumbel"))
                timed("11 flagship and tools", phase_flagship_tools, dev, device["smi"], tmp,
                      pt, ckpt, gumbel_ckpt)
        log(device["smi"])
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": device["kind"], "count": device["count"]}}))
        return 0
    dense = DenseBaseline(args.dense_baseline, dev) if args.dense_baseline else None
    playouts = random_boards(dev, BOARDS, PLIES, SEED)
    err = timed("3 kernel", phase_kernel, dev, playouts)
    timed("4 search", phase_search, dev)
    with tempfile.TemporaryDirectory() as tmp:
        name = f"random_{CHANNELS}x{BLOCKS}.pt"
        write_random_pt(os.path.join(tmp, name), SEED)
        net = timed("5 net", phase_net, dev, os.path.join(tmp, name))
        serve = timed("6 serve", phase_serve, dev, tmp, name, SIMS, SEED)
        ckpt = os.path.join(tmp, "train")
        train = timed("6b train", phase_train, dev, device["smi"], ckpt)
        gumbel_ckpt = os.path.join(tmp, "gumbel_train")
        gumbel = timed("6c gumbel", phase_gumbel, dev, tmp, name, device["smi"], gumbel_ckpt)
        timings = timed("7 timings", phase_timings, dev, playouts, net, dense)
        search_s = timed("8 profile", phase_profiles, dev, net)
        tools = timed("9 tools", phase_tools, dev, playouts, net, os.path.join(tmp, name),
                      train["checkpoint"], tmp)
        multirank = timed("10 multirank", phase_multirank, dev, device["smi"], tmp)
        tools11 = timed("11 flagship and tools", phase_flagship_tools, dev, device["smi"], tmp,
                        os.path.join(tmp, name), ckpt, gumbel_ckpt)
    log(f"AI move latency at {SIMS} sims: "
        f"{[round(x, 4) for x in serve['ai_move_s']]} s; 4 concurrent session moves: "
        f"{[round(x, 4) for x in serve['session_move_s']]} s; Gumbel AI move latency "
        f"by sims: { {n: [round(x, 4) for x in v] for n, v in gumbel['serve']['ai_move_s_by_sims'].items()} } s; "
        f"one {COMPARE_SIMS}-sim search, interleaved: { {k: round(v, 4) for k, v in search_s.items()} } s; "
        f"total {time.perf_counter() - t_start:.1f} s; phases (s) "
        f"{ {k: round(v, 1) for k, v in phases.items()} }")

    kernels = []
    rows = timings["rows"]
    for k in KERNELS:
        main_row = rows[1]   # serving's AI move runs the kernel at B = 1
        kernels.append({
            "name": k["name"], "route": k["route"], "source": k["source"],
            "replaces": k["replaces"], "launches": serve["launches"][k["name"]],
            "launches_by_path": {"serve": serve["launches"][k["name"]],
                                 "train": train["launches"][k["name"]],
                                 "gumbel_serve": gumbel["serve"]["launches"][k["name"]],
                                 "gumbel_train": gumbel["train"]["launches"][k["name"]],
                                 "arena": gumbel["arena"]["launches"],
                                 "benchmark": tools["benchmark_launches"],
                                 "multirank": multirank["launches"],
                                 "flagship": tools11["flagship"]["launches"],
                                 "anchor": tools11["anchor"]["launches"],
                                 "latency": tools11["latency"]["launches"],
                                 "h2h_arena": tools11["h2h"]["launches"],
                                 "elo": tools11["h2h"]["elo_launches"]},
            "max_abs_err": err, "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": k["library_ms"],
            "by_batch": {str(b): r for b, r in rows.items()},
            "ms_by_blocks_per_board": {str(b): {str(sp): ms for sp, ms in r.items()}
                                       for b, r in timings["splits"].items()},
        })
    log(device["smi"])
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"], "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
