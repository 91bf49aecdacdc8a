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
uninterrupted one. With ``search_algo="gumbel"`` self-play runs the Gumbel
search (the halving's winner acts, the improved policy is the target); the
gated eval stays the reference's PUCT match, as in the JAX trainer.

Not ported: the mesh, tensor-parallel and multi-process paths (ROADMAP A7),
and the restart supervisor's heartbeat and fault injection (A10);
``check_supported`` raises for their options.
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

from ..models import count_parameters, init_net, policy_logits_fn
from ..serve.predictor import _EXPORT_HINT, resolve_device
from . import checkpoint as ckpt
from .config import TrainingConfig, check_supported
from .evaluate import EvalSettings, evaluate_pair
from .learner import make_optimizer, set_learning_rate, train_epochs
from .replay import ReplayBuffer
from .selfplay import SelfPlaySettings, selfplay_games

logger = logging.getLogger("xiangqi_az_torch")

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class AlphaZeroTrainer:
    def __init__(self, cfg: TrainingConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        n_dev = torch.cuda.device_count() if self.device.type == "cuda" else 1
        check_supported(cfg, n_dev)
        self.net = init_net(
            torch.Generator().manual_seed(cfg.seed), cfg.num_channels, cfg.num_res_blocks,
            _DTYPES[cfg.dtype], self.device,
        ).train()
        self.best_net = copy.deepcopy(self.net).eval()
        self.opt = make_optimizer(self.net.parameters(), cfg.learning_rate, cfg.weight_decay)

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
        # the color halves need an even batch; the padding game is played
        # and left out of the count, as in the JAX trainer
        self._eval_batch = cfg.eval_games + cfg.eval_games % 2

        os.makedirs(cfg.checkpoint_dir, exist_ok=True)
        logger.info(
            "model: %d channels x %d blocks, %s params, %s compute, on %s",
            cfg.num_channels, cfg.num_res_blocks,
            f"{count_parameters(self.net):,}", cfg.dtype, self.device,
        )
        if self.device.type == "cuda":
            logger.info(
                "TF32: cuDNN convolutions %s, matmuls %s",
                torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
            )

    # ------------------------------------------------------------ phases
    def self_play(self) -> Dict:
        t0 = time.time()
        with torch.inference_mode():
            out = selfplay_games(
                policy_logits_fn(self.best_net), self.cfg.num_games_per_iter,
                self.sp_settings, self.rng, self.device, logits_eval=True,
            )
        rec = out.rec.reshape(-1).cpu().numpy()
        k = self.cfg.max_children

        def flat(x, *shape):   # time-major [T, B, ...] -> recorded rows
            return x.reshape(-1, *shape).cpu().numpy()[rec]

        n_new = self.buffer.add_games(
            flat(out.boards, 90), flat(out.sides), flat(out.pi_actions, k),
            flat(out.pi_probs, k), flat(out.values),
        )
        winners = out.winners.cpu().numpy()
        self.total_games += len(winners)
        stats = {
            "games": int(len(winners)),
            "red_wins": int((winners == 1).sum()),
            "black_wins": int((winners == -1).sum()),
            "draws": int((winners == 0).sum()),
            "avg_steps": float(out.plies.float().mean()),
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
        lr = self.cfg.lr_at(self.iteration)
        set_learning_rate(self.opt, lr)
        perm, wmask, n_batches = self.buffer.epoch_plan(
            self.cfg.batch_size, self.cfg.num_epochs, self.np_rng
        )
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
        self.net.eval()
        with torch.inference_mode():
            out = evaluate_pair(
                policy_logits_fn(self.net), policy_logits_fn(self.best_net),
                self._eval_batch, self.eval_settings, self.device, logits_eval=True,
            )
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
            self.best_net.load_state_dict(self.net.state_dict())
            logger.info(">>> best model updated (win_rate %.2f) <<<", win_rate)
        else:
            # candidate failed the gate: reset to incumbent (train.py:532)
            self.net.load_state_dict(self.best_net.state_dict())
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
        payload = {
            "iteration": self.iteration,
            "params": self.net.state_dict(),
            "best_params": self.best_net.state_dict(),
            "optimizer": self.opt.state_dict(),
            "generators": {"search": self.rng.get_state()},
            "np_rng": self.np_rng.bit_generator.state,
            "total_games": self.total_games,
            "config": self._model_config(),
        }
        path = ckpt.save_checkpoint(self.cfg.checkpoint_dir, self.iteration, payload)
        if self.cfg.checkpoint_replay:
            np.savez(path + ".replay.npz", **self.buffer.state_dict())
        if is_best:
            ckpt.save_best_model(self.cfg.checkpoint_dir, self.iteration,
                                 self.best_net.state_dict(), self._model_config())
        logger.info("checkpoint saved: %s", path)
        return path

    def restore(self, path: str) -> None:
        restored = ckpt.load_checkpoint(path)
        self.net.load_state_dict(restored["params"])
        self.best_net.load_state_dict(restored["best_params"])
        self.opt.load_state_dict(restored["optimizer"])
        self.rng.set_state(restored["generators"]["search"])
        self.np_rng.bit_generator.state = restored["np_rng"]
        self.iteration = int(restored["iteration"])
        self.total_games = int(restored["total_games"])
        replay_path = os.path.abspath(path) + ".replay.npz"
        if self.cfg.checkpoint_replay:
            if os.path.exists(replay_path):
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
        self.net.load_state_dict(restored["model_state_dict"])
        self.best_net.load_state_dict(restored["model_state_dict"])
        self.opt = make_optimizer(self.net.parameters(), self.cfg.learning_rate,
                                  self.cfg.weight_decay)
        logger.info("warm start from %s (exported at iteration %s)",
                    best_model_path, restored.get("iteration", "?"))

    def train(self, resume: Optional[str] = None, init_from: Optional[str] = None) -> None:
        if resume:
            self.restore(resume)
        elif init_from:
            self.warm_start(init_from)
        while self.iteration < self.cfg.num_iterations:
            self.run_iteration()
        self.save(is_best=True)
        logger.info("training complete: %d iterations", self.iteration)
