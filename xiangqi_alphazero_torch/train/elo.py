"""Elo ladder: round-robin arena matches across checkpoints and a
Bradley-Terry rating fit.

Port of ``xiangqi_alphazero_tpu.train.elo``; ``fit_elo`` and
``expected_score`` are its numpy-only code, copied. The reference tracks
strength only as the gated eval's win rate against the current best
(reference: train.py:512-533); this tool plays every pair through the arena
(``train/arena.py``: color-halved lockstep batches, temperature sampling)
and fits Elo-scaled Bradley-Terry ratings by maximum likelihood, anchoring
the FIRST model at rating 0.

    python -m xiangqi_alphazero_torch.train.elo \
        --models iter10.pt iter30.pt best.pt --games 32 --sims 40
Prints one JSON line: {"ratings": {...}, "pairs": [...]}.

Draws count as half a win for each side (the standard BT extension the
gated eval's 0.5-draw scoring already uses, reference: train.py:520).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

ELO_SCALE = 400.0 / math.log(10.0)  # rating = ELO_SCALE * BT strength


def fit_elo(
    results: Sequence[Tuple[int, int, float, float]],
    num_models: int,
    iters: int = 500,
) -> np.ndarray:
    """Maximum-likelihood Bradley-Terry ratings on the Elo scale.

    ``results``: (i, j, score_i, games) per pair — score_i is model i's
    total points against j (win 1, draw 0.5) over ``games`` games.
    Fitted with the standard MM iteration (Hunter 2004): monotone,
    hyperparameter-free, deterministic. Model 0 is anchored at 0; a model
    with zero points floors at the strength epsilon (a finite, very
    negative rating — an all-loss record has no finite ML optimum)."""
    eps = 1e-12
    pi = np.ones(num_models, np.float64)         # BT strengths
    wins = np.zeros(num_models, np.float64)      # total points per model
    for i, j, s_i, n in results:
        wins[i] += s_i
        wins[j] += n - s_i
    for _ in range(iters):
        denom = np.full(num_models, eps, np.float64)
        for i, j, s_i, n in results:
            d = n / (pi[i] + pi[j])
            denom[i] += d
            denom[j] += d
        pi = np.maximum(wins / denom, eps)
        pi = pi / pi[0]                          # anchor model 0
    return ELO_SCALE * np.log(pi)


def expected_score(r_a: float, r_b: float) -> float:
    """Elo expected score of a vs b."""
    return 1.0 / (1.0 + 10.0 ** ((r_b - r_a) / 400.0))


def round_robin(
    model_paths: List[str],
    games: int = 32,
    sims: int = 40,
    temperature: float = 0.2,
    max_game_length: int = 300,
    seed: int = 0,
    device=None,
) -> Dict:
    """Play every pair through the arena on ``device`` (CUDA unless given
    another) and fit ratings; pair k draws from a CPU generator seeded
    ``seed + k``."""
    import torch

    from ..serve.predictor import Predictor
    from .arena import ArenaSettings, make_hosted_arena

    preds = [Predictor.load(p, device=device) for p in model_paths]
    n = len(preds)
    batch = games + games % 2
    s = ArenaSettings(num_simulations=sims, temperature=temperature,
                      max_game_length=max_game_length)
    pairs = []
    results = []
    k = 0
    for i in range(n):
        for j in range(i + 1, n):
            run = make_hosted_arena(preds[i].net, preds[j].net, batch, s, preds[i].device)
            out = run(torch.Generator().manual_seed(seed + k))
            k += 1
            score_i = out["a_wins"] + 0.5 * out["draws"]
            results.append((i, j, score_i, batch))
            pairs.append({
                "a": model_paths[i], "b": model_paths[j],
                "a_wins": out["a_wins"], "b_wins": out["b_wins"],
                "draws": out["draws"],
            })
    ratings = fit_elo(results, n)
    return {
        "ratings": {p: round(float(r), 1) for p, r in zip(model_paths, ratings)},
        "pairs": pairs,
        "games_per_pair": batch,
        "sims": sims,
    }


def main(argv=None) -> int:
    import argparse
    import json

    p = argparse.ArgumentParser(description="checkpoint Elo ladder")
    p.add_argument("--models", nargs="+", required=True,
                   help="two or more reference-layout .pt checkpoints")
    p.add_argument("--games", type=int, default=32)
    p.add_argument("--sims", type=int, default=40)
    p.add_argument("--temperature", type=float, default=0.2)
    p.add_argument("--max-game-length", type=int, default=300)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to play on (default cuda; 'cpu' for the CPU)")
    args = p.parse_args(argv)
    if len(args.models) < 2:
        p.error("need at least two models")
    out = round_robin(
        args.models, games=args.games, sims=args.sims, temperature=args.temperature,
        max_game_length=args.max_game_length, seed=args.seed, device=args.device,
    )
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
