"""External Elo anchor: checkpoint nets against the native alpha-beta minimax.

Port of the repo's ``scripts/minimax_anchor.py``. The Elo ladder
(``train/elo.py``) rates a run's snapshots against each other; this pins
the scale to an absolute opponent, the material alpha-beta minimax at a
fixed depth (``engine/native/xq_core.cpp::xq_minimax_move``, the search the
reference's web app plays at its four levels).

Depth and the reference's levels (off by one, as in the JAX script):
``minimax_move(depth=D)`` scores each root move with -negamax(D), D + 1
plies of lookahead in all, so ``--depth D`` plays the reference's web
level D + 1 (``--depth 1`` its default difficulty, ``--depth 2`` its
maximum). Anchor JSONs store the raw ``--depth``.

Protocol per model: ``--games`` games, the net red in the first half and
black in the second; the net side is a greedy search (temperature 0, no
noise: the serving configuration) batched over every live game in one
``Predictor.search_batch``; the minimax side is the native core with one
seed a move from a single counter. Rules and termination are the host
oracle's. ``--epsilon`` > 0 makes the minimax side play a uniformly random
legal move with that probability a move (a coin from the same seed), for
graded opponents between depths.

Output: one JSON line per model (W-D-L, score, the Elo gap against the
anchor, 400 log10(s / (1 - s)) with s clamped to a finite value), and the
whole table in ``--out``.

    python -m xiangqi_alphazero_torch.scripts.minimax_anchor \\
        --models runs/torch/flagship/checkpoint_iter200 --depth 1 --games 64 \\
        [--sims 200] [--algo puct|gumbel] [--epsilon 0.5] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..engine import native
from ..engine.oracle import Position

DEFAULT_OUT = "runs/torch/anchor.json"


def play_match(pred, depth: int, games: int, base_seed: int = 17,
               epsilon: float = 0.0) -> dict:
    """One anchor cell: ``pred`` (anything with ``search_batch(positions,
    pad_to)``, a ``Predictor``) against minimax at ``depth``. With
    ``epsilon`` > 0 the minimax side plays a random legal move with that
    probability a move, the coin and the move drawn from the move's seed."""
    assert native.available(), "native core required for the minimax anchor"

    pos = [Position() for _ in range(games)]
    net_side = [1 if g < (games + 1) // 2 else -1 for g in range(games)]
    winner = [None] * games  # +1 red, -1 black, 0 draw
    move_seed = base_seed

    while any(w is None for w in winner):
        # settle terminals first (covers positions reached by either side)
        for g in range(games):
            if winner[g] is None:
                done, w = pos[g].result()
                if done:
                    winner[g] = w
        # the net's moves: one batched search over all its live turns
        net_turn = [g for g in range(games)
                    if winner[g] is None and pos[g].side == net_side[g]]
        if net_turn:
            results = pred.search_batch([pos[g] for g in net_turn], pad_to=games)
            for g, res in zip(net_turn, results):
                actions, visits, order = res[0], res[1], res[2]
                if len(res) > 3:  # gumbel: the halving winner acts
                    a = int(res[3])
                else:
                    # greedy = max visits; ties broken by movegen precedence
                    # (the reference's argmax-first semantics)
                    top = visits == visits.max()
                    masked = np.where(top, order, np.iinfo(np.int32).max)
                    a = int(actions[int(np.argmin(masked))])
                pos[g].apply(a)
                done, w = pos[g].result()
                if done:
                    winner[g] = w
        # the minimax moves: the native core releases the GIL, so a thread
        # pool runs the games' searches on every core
        mm_turn = [g for g in range(games)
                   if winner[g] is None and pos[g].side != net_side[g]]
        if mm_turn:
            seeds = {}
            for g in mm_turn:
                move_seed += 1
                seeds[g] = move_seed

            def _mm(g):
                if epsilon > 0.0:
                    r = np.random.default_rng(seeds[g])
                    if r.random() < epsilon:
                        legal = pos[g].legal_actions()
                        if not legal:
                            return g, None
                        return g, int(legal[r.integers(len(legal))])
                return g, native.minimax_move(
                    pos[g].board_array(), pos[g].side, depth, seed=seeds[g])

            with ThreadPoolExecutor(max_workers=min(32, len(mm_turn))) as ex:
                results_mm = list(ex.map(_mm, mm_turn))
            for g, a in results_mm:
                if a is None:  # no legal move: the side to move loses
                    winner[g] = -pos[g].side
                    continue
                pos[g].apply(a)
                done, w = pos[g].result()
                if done:
                    winner[g] = w

    wins = sum(1 for g in range(games) if winner[g] == net_side[g])
    losses = sum(1 for g in range(games) if winner[g] == -net_side[g])
    draws = games - wins - losses
    score = (wins + 0.5 * draws) / games
    s = min(max(score, 1 / (2 * games)), 1 - 1 / (2 * games))  # finite Elo
    return {
        "net_wins": wins, "draws": draws, "net_losses": losses,
        "score": round(score, 4),
        "elo_vs_anchor": round(400.0 * math.log10(s / (1.0 - s)), 1),
        "avg_plies": round(float(np.mean([p.ply for p in pos])), 1),
    }


def protocol(depth: int, sims: int, algo: str, epsilon: float) -> dict:
    eps_note = (f" with epsilon={epsilon} random-move blunder rate"
                if epsilon > 0 else "")
    return {
        "anchor": f"alpha-beta minimax depth {depth} "
                  f"(= {depth + 1} plies total = reference web AI "
                  f"level {depth + 1}; native xq_core, "
                  "engine.js-compatible material eval)" + eps_note,
        "net_search": f"{algo}-{sims} temp 0 greedy",
        "colors": "net red first half, black second half",
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="nets against the minimax anchor")
    p.add_argument("--models", nargs="+", required=True,
                   help=".pt files or the trainer's checkpoint_iter{N} files")
    p.add_argument("--depth", type=int, default=3,
                   help="search depth D after the root move (D+1 plies in all = "
                        "the reference web AI's level D+1)")
    p.add_argument("--games", type=int, default=64)
    p.add_argument("--sims", type=int, default=200)
    p.add_argument("--algo", default="puct", choices=["puct", "gumbel"])
    p.add_argument("--epsilon", type=float, default=0.0,
                   help="per-move probability that the minimax side plays a random "
                        "legal move instead (0 = pure minimax)")
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--device", default="cuda",
                   help="torch device of the net's search (default cuda; 'cpu' for the CPU)")
    args = p.parse_args(argv)

    from ..serve.predictor import Predictor

    results = []
    for path in args.models:
        pred = Predictor.load(path, num_simulations=args.sims, algo=args.algo,
                              device=args.device)
        t0 = time.perf_counter()
        r = play_match(pred, args.depth, args.games, epsilon=args.epsilon)
        r.update(model=path, depth=args.depth, games=args.games,
                 sims=args.sims, algo=args.algo, epsilon=args.epsilon,
                 wall_s=round(time.perf_counter() - t0, 1))
        results.append(r)
        print(json.dumps(r), flush=True)

    out = {"protocol": protocol(args.depth, args.sims, args.algo, args.epsilon),
           "results": results}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
