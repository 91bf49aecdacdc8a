"""AlphaZero training orchestration: self-play -> train -> gated eval loop.

Port of ``xiangqi_alphazero_tpu.train.trainer``. Reference parity
(training/train.py:168-638): two nets (the candidate and the best), self-play
always uses the best net, evaluation every eval_interval iterations promotes
the candidate at win_rate >= threshold or resets it to the incumbent,
checkpoints every save_interval, and a training_stats.json rewritten each
iteration.

Runs on the card unless the caller passes ``device="cpu"``; without CUDA a
default trainer raises. Self-play and eval run the best net (and the
candidate, in eval) in eval mode under ``torch.inference_mode()``; the
learner trains the candidate in train mode. The compute dtype follows
``cfg.dtype`` (bf16 by default, as in the JAX package). The JAX seeds are
kept: the net from ``seed``, the search stream (every self-play draw) from
``seed + 1``, the epoch plans from ``np.random.default_rng(seed + 2)``. A
checkpoint holds all of it, so a resumed run is bit-identical to an
uninterrupted one (on the card only with cuDNN's deterministic algorithms,
which the training CLI takes). With ``search_algo="gumbel"`` self-play
runs the Gumbel search (the halving's winner acts, the improved policy is
the target); the gated eval stays the reference's PUCT match, as in the
JAX trainer.

Multi-device training (the JAX trainer's mesh paths): when the process
has joined a process group (``distributed.py``) and ``mesh_mode="auto"``,
the trainer runs data-parallel over every rank, or data x tensor parallel
with ``model_parallel`` 2 or 4 (``parallel/sharding.py``). Batch axes are
padded to the data axis with the JAX formulas: pad games are played and
dropped, pad columns carry zero weight. Every rank holds the same replay
ring and takes the same decisions; rank 0 alone writes the log, the stats,
the heartbeat, the checkpoints, ``best_model.pt`` and the replay ring.
Under TP the candidate's head layers and their Adam moments are sharded;
self-play and eval run replicated nets, and checkpoints hold the replicated
layout, so a run resumes at any mesh shape. ``_heartbeat`` and
``_maybe_inject_fault`` serve the ``--auto-restart`` supervisor
(``train/__main__.py``).
"""

from __future__ import annotations

import copy
import json
import logging
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import distributed as D
from ..models import count_parameters, init_net, policy_logits_fn
from ..parallel import sharding as SH
from ..serve.predictor import _EXPORT_HINT, resolve_device
from . import checkpoint as ckpt
from .config import TrainingConfig, check_supported
from .evaluate import EvalSettings, evaluate_pair
from .learner import make_optimizer, set_learning_rate, train_epochs
from .replay import ReplayBuffer
from .selfplay import SelfPlaySettings, selfplay_games

logger = logging.getLogger("xiangqi_az_torch")

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _pad_to(n: int, d: int) -> int:
    return -(-n // d) * d


class AlphaZeroTrainer:
    def __init__(self, cfg: TrainingConfig, device=None):
        self.cfg = cfg
        ctx = D.context()
        self.device = resolve_device(ctx.device if ctx is not None and device is None
                                     else device)
        check_supported(cfg)
        self.net = init_net(
            torch.Generator().manual_seed(cfg.seed), cfg.num_channels, cfg.num_res_blocks,
            _DTYPES[cfg.dtype], self.device,
        ).train()
        self.best_net = copy.deepcopy(self.net).eval()

        # auto data-parallel over every rank of the process group; with
        # model_parallel > 1 a (data, model) grid whose head layers (and
        # their Adam moments) the candidate holds sharded over 'model'
        world = ctx.world if ctx is not None else 1
        self.is_main = ctx is None or ctx.rank == 0
        self.mesh = None
        if cfg.mesh_mode == "auto" and world > 1:
            if cfg.model_parallel > 1:
                self.mesh = SH.make_tp_mesh(cfg.model_parallel)
                logger.info("data x model parallel over %d ranks (%d x %d)", world,
                            world // cfg.model_parallel, cfg.model_parallel)
            else:
                self.mesh = SH.make_mesh()
                logger.info("data-parallel over %d ranks (%s)", world, cfg.mesh_axis)
        if cfg.model_parallel > 1 and self.mesh is None:
            raise ValueError(
                "model_parallel > 1 needs mesh_mode='auto' and more than one rank "
                f"(have {world}, mesh_mode={cfg.mesh_mode!r})")
        self._tp = self.mesh is not None and cfg.model_parallel > 1
        if self.mesh is not None:
            SH.set_bn_group(self.net, self.mesh.data_group)
        if self._tp:
            # the candidate's replicated copy, for the gated match
            self._eval_net = copy.deepcopy(self.best_net)
            SH.tp_place(self.mesh, self.net)
        self.opt = make_optimizer(self.net.parameters(), cfg.learning_rate, cfg.weight_decay,
                                  mesh=self.mesh)

        self.buffer = ReplayBuffer(cfg.max_buffer_size, cfg.max_children)
        self.iteration = 0
        self.total_games = 0
        self.training_stats = []
        self.last_losses = None   # per-step (policy, value) of the last train_network
        self.rng = torch.Generator().manual_seed(cfg.seed + 1)
        self.np_rng = np.random.default_rng(cfg.seed + 2)

        # the JAX trainer builds these settings without playout_cap_per_game
        self.sp_settings = SelfPlaySettings(
            num_simulations=cfg.num_simulations,
            c_puct=cfg.c_puct,
            max_children=cfg.max_children,
            max_game_length=cfg.max_game_length,
            temperature_threshold=cfg.temperature_threshold,
            temperature_schedule=cfg.temperature_schedule,
            random_opening_moves=cfg.random_opening_moves,
            enable_resign=cfg.enable_resign,
            resign_threshold=cfg.resign_threshold,
            resign_check_steps=cfg.resign_check_steps,
            search_algo=cfg.search_algo,
            max_considered=cfg.max_considered,
            playout_cap_prob=cfg.playout_cap_prob,
            playout_cap_sims=cfg.playout_cap_sims,
        )
        self.eval_settings = EvalSettings(
            num_simulations=cfg.eval_simulations,
            c_puct=cfg.c_puct,
            max_children=cfg.max_children,
            max_game_length=cfg.max_game_length,
        )
        # batch axes padded to the data axis (pad games are played and left
        # out of the counts, pad columns carry zero weight); the color
        # halves need an even eval batch
        align = self.mesh.n_data if self.mesh is not None else 1
        self._sp_batch = _pad_to(cfg.num_games_per_iter, align)
        self._eval_batch = _pad_to(cfg.eval_games, 2 * align if align % 2 else align)
        self._train_cols = _pad_to(cfg.batch_size, align)
        if self.mesh is not None:
            self._selfplay_run = SH.make_sharded_selfplay(self._sp_batch, self.sp_settings,
                                                          self.mesh)
            self._eval_run = SH.make_sharded_eval(self._eval_batch, self.eval_settings,
                                                  self.mesh)

        os.makedirs(cfg.checkpoint_dir, exist_ok=True)
        logger.info(
            "model: %d channels x %d blocks, %s params%s, %s compute, on %s",
            cfg.num_channels, cfg.num_res_blocks, f"{count_parameters(self.net):,}",
            " (this rank's shards)" if self._tp else "", cfg.dtype, self.device,
        )
        if self.device.type == "cuda":
            logger.info(
                "TF32: cuDNN convolutions %s, matmuls %s; cuDNN deterministic %s",
                torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.deterministic,
            )

    # ------------------------------------------------------------ phases
    def _heartbeat(self) -> None:
        """Touch ``<checkpoint_dir>/.heartbeat`` at every phase boundary, so
        that the ``--auto-restart`` stall watchdog (which watches the
        directory's mtimes) sees a healthy iteration longer than its
        timeout make progress."""
        if not self.is_main:
            return
        try:
            with open(os.path.join(self.cfg.checkpoint_dir, ".heartbeat"), "w") as f:
                f.write(f"{self.iteration} {time.time():.0f}\n")
        except OSError:
            pass

    def _candidate_state(self) -> Dict[str, torch.Tensor]:
        """The candidate's state dict in the replicated layout."""
        state = self.net.state_dict()
        return SH.tp_full_state(self.mesh, state) if self._tp else state

    def _load_candidate(self, state: Dict[str, torch.Tensor]) -> None:
        """Set the candidate from a replicated state dict."""
        self.net.load_state_dict(SH.tp_local_state(self.mesh, state) if self._tp else state)

    def self_play(self) -> Dict:
        t0 = time.time()
        self._heartbeat()
        with torch.inference_mode():
            ev = policy_logits_fn(self.best_net)
            if self.mesh is None:
                out = selfplay_games(ev, self._sp_batch, self.sp_settings, self.rng,
                                     self.device, logits_eval=True)
            else:
                out = self._selfplay_run(ev, self.rng, self.device)
        g = self.cfg.num_games_per_iter   # drop the padding games
        rec = out.rec[:, :g].reshape(-1).cpu().numpy()
        k = self.cfg.max_children

        def flat(x, *shape):   # time-major [T, B, ...] -> recorded rows
            return x[:, :g].reshape(-1, *shape).cpu().numpy()[rec]

        n_new = self.buffer.add_games(
            flat(out.boards, 90), flat(out.sides), flat(out.pi_actions, k),
            flat(out.pi_probs, k), flat(out.values),
        )
        winners = out.winners[:g].cpu().numpy()
        self.total_games += len(winners)
        stats = {
            "games": int(len(winners)),
            "red_wins": int((winners == 1).sum()),
            "black_wins": int((winners == -1).sum()),
            "draws": int((winners == 0).sum()),
            "avg_steps": float(out.plies[:g].float().mean()),
            "new_samples": int(n_new),
            "buffer_size": len(self.buffer),
            "plies": len(out.sims_per_ply),
            "simulations": int(sum(out.sims_per_ply)),
            "time": time.time() - t0,
        }
        logger.info("self-play: %s", stats)
        return stats

    def train_network(self) -> Dict:
        if len(self.buffer) < self.cfg.min_buffer_size:
            logger.info(
                "buffer %d < min %d, skipping training",
                len(self.buffer), self.cfg.min_buffer_size,
            )
            return {}
        t0 = time.time()
        self._heartbeat()
        lr = self.cfg.lr_at(self.iteration)
        set_learning_rate(self.opt, lr)
        perm, wmask, n_batches = self.buffer.epoch_plan(
            self.cfg.batch_size, self.cfg.num_epochs, self.np_rng
        )
        if self._train_cols > self.cfg.batch_size:
            # padding to the data axis: the extra columns read row 0 (they
            # enter the batch-norm statistics, as in the JAX trainer) with
            # zero weight
            pad = self._train_cols - self.cfg.batch_size
            perm = np.pad(perm, ((0, 0), (0, pad)))
            wmask = np.pad(wmask, ((0, 0), (0, pad)))
        self.net.train()
        losses = train_epochs(self.net, self.opt, self.buffer.arrays(), perm, wmask).numpy()
        tot_p = float(losses[:, 0].sum())
        tot_v = float(losses[:, 1].sum())
        stats = {
            "policy_loss": tot_p / max(n_batches, 1),
            "value_loss": tot_v / max(n_batches, 1),
            "total_loss": (tot_p + tot_v) / max(n_batches, 1),
            "learning_rate": lr,
            "batches": n_batches,
            "time": time.time() - t0,
        }
        self.last_losses = losses
        logger.info("train: %s", stats)
        return stats

    def evaluate(self) -> Dict:
        t0 = time.time()
        self._heartbeat()
        if self._tp:   # the candidate's replicated copy plays
            self._eval_net.load_state_dict(self._candidate_state())
        cand = self._eval_net if self._tp else self.net
        cand.eval()
        with torch.inference_mode():
            ev_new, ev_old = policy_logits_fn(cand), policy_logits_fn(self.best_net)
            if self.mesh is None:
                out = evaluate_pair(ev_new, ev_old, self._eval_batch, self.eval_settings,
                                    self.device, logits_eval=True)
            else:
                out = self._eval_run(ev_new, ev_old, self.device)
        self.net.train()
        # count the real games only: the candidate is red in the first
        # ceil(G/2) games of the red half, black in the first floor(G/2) of
        # the black half
        winners = out.winners.cpu().numpy()
        new_is_red = out.new_is_red.cpu().numpy()
        g = self.cfg.eval_games
        half = self._eval_batch // 2
        sel = np.zeros(self._eval_batch, bool)
        sel[: (g + 1) // 2] = True
        sel[half: half + g // 2] = True
        w, red = winners[sel], new_is_red[sel]
        new_wins = int(((w == 1) & red).sum() + ((w == -1) & ~red).sum())
        old_wins = int(((w == -1) & red).sum() + ((w == 1) & ~red).sum())
        draws = int((w == 0).sum())
        win_rate = (new_wins + 0.5 * draws) / max(g, 1)
        updated = win_rate >= self.cfg.eval_win_rate
        if updated:
            self.best_net.load_state_dict(cand.state_dict())
            logger.info(">>> best model updated (win_rate %.2f) <<<", win_rate)
        else:
            # candidate failed the gate: reset to incumbent (train.py:532)
            self._load_candidate(self.best_net.state_dict())
            logger.info("candidate rejected (win_rate %.2f)", win_rate)
        return {
            "new_wins": new_wins,
            "old_wins": old_wins,
            "draws": draws,
            "win_rate": win_rate,
            "model_updated": updated,
            "plies": out.plies_run,
            "time": time.time() - t0,
        }

    # -------------------------------------------------------- lifecycle
    def _model_config(self) -> Dict:
        return {"num_channels": self.cfg.num_channels,
                "num_res_blocks": self.cfg.num_res_blocks}

    def save(self, is_best: bool = False) -> str:
        """Write a checkpoint of the replicated layout (rank 0 writes; under
        TP every rank takes part in gathering the shards)."""
        opt_state = self.opt.state_dict()
        if self._tp:
            opt_state = SH.tp_full_optimizer(self.mesh, self.net, opt_state)
        payload = {
            "iteration": self.iteration,
            "params": self._candidate_state(),
            "best_params": self.best_net.state_dict(),
            "optimizer": opt_state,
            "generators": {"search": self.rng.get_state()},
            "np_rng": self.np_rng.bit_generator.state,
            "total_games": self.total_games,
            "config": self._model_config(),
        }
        path = ckpt.checkpoint_path(self.cfg.checkpoint_dir, self.iteration)
        if self.is_main:
            ckpt.save_checkpoint(self.cfg.checkpoint_dir, self.iteration, payload)
            # every rank holds the same ring: one writer
            if self.cfg.checkpoint_replay:
                np.savez(path + ".replay.npz", **self.buffer.state_dict())
            if is_best:
                ckpt.save_best_model(self.cfg.checkpoint_dir, self.iteration,
                                     self.best_net.state_dict(), self._model_config())
        if self.mesh is not None:   # no rank runs ahead of a checkpoint being written
            torch.distributed.barrier(group=self.mesh.host_group)
        logger.info("checkpoint saved: %s", path)
        return path

    def restore(self, path: str) -> None:
        restored = ckpt.load_checkpoint(path)
        self._load_candidate(restored["params"])
        self.best_net.load_state_dict(restored["best_params"])
        opt_state = restored["optimizer"]
        if self._tp:
            opt_state = SH.tp_local_optimizer(self.mesh, self.net, opt_state)
        self.opt.load_state_dict(opt_state)
        self.rng.set_state(restored["generators"]["search"])
        self.np_rng.bit_generator.state = restored["np_rng"]
        self.iteration = int(restored["iteration"])
        self.total_games = int(restored["total_games"])
        replay_path = os.path.abspath(path) + ".replay.npz"
        if self.cfg.checkpoint_replay:
            has = os.path.exists(replay_path)
            if self.mesh is not None:
                # every rank must restore the SAME ring: a rank missing the
                # file would feed other batches into the collectives
                some, every = SH.host_flags(self.mesh, has)
                if some and not every:
                    raise ValueError(
                        f"{replay_path} exists on some ranks but not all (rank 0 "
                        "writes it) — copy it to every host, or set "
                        "--checkpoint-replay 0")
            if has:
                with np.load(replay_path) as z:
                    self.buffer.load_state({k: z[k] for k in z.files})
                logger.info("replay ring restored: %d samples", len(self.buffer))
            else:
                logger.warning(
                    "replay ring %s not found: resuming with a COLD buffer — "
                    "NOT the bit-exact resume this checkpoint was written for "
                    "(copy the .replay.npz next to the checkpoint, or silence "
                    "with --checkpoint-replay 0)", replay_path,
                )
        # keep ONE cumulative training_stats.json across a resume
        stats_path = os.path.join(self.cfg.checkpoint_dir, "training_stats.json")
        if os.path.exists(stats_path):
            try:
                with open(stats_path) as f:
                    prior = json.load(f)
                self.training_stats = [
                    s for s in prior if int(s.get("iteration", 0)) <= self.iteration
                ]
            except (json.JSONDecodeError, OSError):
                pass  # corrupt/partial stats file: start a fresh list
        logger.info("restored %s at iteration %d", path, self.iteration)

    def run_iteration(self) -> Dict:
        self.iteration += 1
        self._maybe_inject_fault()
        t0 = time.time()
        sp_stats = self.self_play()
        train_stats = self.train_network()
        eval_stats = {}
        if (
            self.iteration % self.cfg.eval_interval == 0
            and len(self.buffer) >= self.cfg.min_buffer_size
        ):
            eval_stats = self.evaluate()
        if self.iteration % self.cfg.save_interval == 0:
            self.save(is_best=True)
        stats = {
            "iteration": self.iteration,
            "time": time.time() - t0,
            "self_play": sp_stats,
            "training": train_stats,
            "evaluation": eval_stats,
        }
        self.training_stats.append(stats)
        if self.is_main:   # one writer per shared checkpoint dir
            with open(os.path.join(self.cfg.checkpoint_dir, "training_stats.json"), "w") as f:
                json.dump(self.training_stats, f, indent=2, default=str)
        logger.info("iteration %d done in %.1fs", self.iteration, stats["time"])
        return stats

    def warm_start(self, best_model_path: str) -> None:
        """Initialize the candidate AND best weights from a ``best_model``
        ``.pt`` (weights only). The iteration counter and the optimizer
        start fresh: a NEW run seeded with trained weights, not a resume."""
        if os.path.isdir(best_model_path) or not best_model_path.endswith(".pt"):
            raise ValueError(
                f"{best_model_path} is not a .pt best_model; export an orbax "
                "model with " + _EXPORT_HINT.format(path=best_model_path)
            )
        restored = torch.load(best_model_path, map_location="cpu", weights_only=True)
        self._load_candidate(restored["model_state_dict"])
        self.best_net.load_state_dict(restored["model_state_dict"])
        self.opt = make_optimizer(self.net.parameters(), self.cfg.learning_rate,
                                  self.cfg.weight_decay, mesh=self.mesh)
        logger.info("warm start from %s (exported at iteration %s)",
                    best_model_path, restored.get("iteration", "?"))

    def _maybe_inject_fault(self) -> None:
        """Fault injection for the ``--auto-restart`` supervisor:
        ``XQAZ_FAULT_ITER="N:/marker/path"`` raises at iteration N unless
        the marker file exists (the raise creates it, so one crash per
        marker)."""
        spec = os.environ.get("XQAZ_FAULT_ITER")
        if not spec:
            return
        n, marker = spec.split(":", 1)
        if self.iteration == int(n) and not os.path.exists(marker):
            with open(marker, "w"):
                pass
            raise RuntimeError(f"injected fault at iteration {n} (XQAZ_FAULT_ITER)")

    def train(self, resume: Optional[str] = None, init_from: Optional[str] = None) -> None:
        if resume:
            self.restore(resume)
        elif init_from:
            self.warm_start(init_from)
        while self.iteration < self.cfg.num_iterations:
            self.run_iteration()
        self.save(is_best=True)
        logger.info("training complete: %d iterations", self.iteration)
