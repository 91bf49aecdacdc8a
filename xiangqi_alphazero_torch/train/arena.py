"""Model-vs-model arena: pit two checkpoints over a batch of games.

Port of ``xiangqi_alphazero_tpu.train.arena``. The gated eval
(``evaluate.py``) is deterministic (temperature 0, no noise; reference
train.py:478-496), which is right for promotion gating but useless for
strength matches from one start position: every game in a color half would
be the same. The arena plays the same lockstep color-halved batch, but the
PUCT side samples its moves at a small temperature and the Gumbel side acts
its halving winner, whose per-ply Gumbel sample varies the games. Every
draw comes from one CPU ``torch.Generator``, so the card and the CPU play
the same match from the same seed.

The match machinery (color halves, the half swap) lives once, in
``evaluate.py``; this module only fills its search and pick hooks for each
side, whose nets may differ in topology, search and budget.

CLI (``.pt`` checkpoints; on the card unless ``--device cpu``):
    python -m xiangqi_alphazero_torch.train.arena --a a.pt --b b.pt \
        --algo-a gumbel --sims-a 32 --algo-b puct --sims-b 200 --games 64
Prints one JSON line {a_wins, b_wins, draws, ...}.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from ..models import policy_logits_fn
from ..search import gumbel as G
from ..search import mcts as M
from .evaluate import EvalSettings, evaluate_pair


class ArenaSettings(NamedTuple):
    num_simulations: int = 40
    c_puct: float = 1.5
    max_children: int = 128
    max_game_length: int = 300
    temperature: float = 0.2
    # per-side search: "puct" (reference semantics) or "gumbel" (the
    # sequential-halving root, search/gumbel.py). Per-side budgets default
    # to num_simulations; together they express the strength-per-compute
    # matches the Gumbel mode exists for (e.g. gumbel-32 against puct-200).
    algo_a: str = "puct"
    algo_b: str = "puct"
    sims_a: int = 0            # 0 -> num_simulations
    sims_b: int = 0
    max_considered: int = 16   # gumbel m


def _side_hooks(algo: str, sims: int, s: ArenaSettings,
                generator: torch.Generator) -> Tuple[Callable, Callable]:
    """(search_fn, select_fn) for one side. The Gumbel side acts its
    halving winner: the per-ply Gumbel sample already gives the games the
    variety the PUCT side gets from temperature sampling."""
    if algo == "gumbel":
        gcfg = G.GumbelConfig(num_simulations=sims,
                              max_considered=min(s.max_considered, s.max_children),
                              max_children=s.max_children)
        return (
            lambda ev, st: G.run_gumbel_mcts(ev, st, gcfg, logits_eval=True,
                                             generator=generator),
            lambda res: res.chosen,
        )
    if algo != "puct":
        raise ValueError(f"unknown search algo {algo!r}")
    mcfg = M.MCTSConfig(sims, s.c_puct, max_children=s.max_children)
    return (
        lambda ev, st: M.run_mcts(ev, st, mcfg, add_noise=False, logits_eval=True),
        lambda res: M.sample_actions(res, s.temperature, generator),
    )


def make_hosted_arena(net_a, net_b, batch: int, s: ArenaSettings, device):
    """``run(generator) -> dict`` of the match's counts, ``net_a`` against
    ``net_b`` (eval-mode modules on ``device``; they may differ in
    topology), every draw from the CPU ``generator``."""
    if batch % 2:
        raise ValueError("arena batch must be even (color halves)")
    es = EvalSettings(num_simulations=s.num_simulations, c_puct=s.c_puct,
                      max_children=s.max_children, max_game_length=s.max_game_length)

    def run(generator: torch.Generator) -> dict:
        search_a, sel_a = _side_hooks(s.algo_a, s.sims_a or s.num_simulations, s, generator)
        search_b, sel_b = _side_hooks(s.algo_b, s.sims_b or s.num_simulations, s, generator)
        with torch.inference_mode():
            out = evaluate_pair(policy_logits_fn(net_a), policy_logits_fn(net_b), batch,
                                es, device, logits_eval=True, select_new=sel_a,
                                select_old=sel_b, search_new=search_a, search_old=search_b)
        a_w, b_w = int(out.new_wins), int(out.old_wins)
        return {
            "games": batch,
            "a_wins": a_w,
            "b_wins": b_w,
            "draws": int(out.draws),
            "avg_plies": float(out.avg_plies),
            "a_score": (a_w + 0.5 * (batch - a_w - b_w)) / batch,
            "plies_run": out.plies_run,
        }

    return run


def main(argv=None) -> int:
    import argparse
    import json

    from ..serve.predictor import Predictor

    p = argparse.ArgumentParser(description="model-vs-model arena")
    p.add_argument("--a", required=True, help="reference-layout .pt checkpoint")
    p.add_argument("--b", required=True)
    p.add_argument("--games", type=int, default=32)
    p.add_argument("--sims", type=int, default=40)
    p.add_argument("--temperature", type=float, default=0.2)
    p.add_argument("--max-game-length", type=int, default=300)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--algo-a", choices=["puct", "gumbel"], default="puct")
    p.add_argument("--algo-b", choices=["puct", "gumbel"], default="puct")
    p.add_argument("--sims-a", type=int, default=0,
                   help="side-a simulation budget (default --sims)")
    p.add_argument("--sims-b", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to play on (default cuda; 'cpu' for the CPU)")
    args = p.parse_args(argv)

    pa = Predictor.load(args.a, device=args.device)
    pb = Predictor.load(args.b, device=args.device)
    s = ArenaSettings(
        num_simulations=args.sims, temperature=args.temperature,
        max_game_length=args.max_game_length, algo_a=args.algo_a, algo_b=args.algo_b,
        sims_a=args.sims_a, sims_b=args.sims_b,
    )
    batch = args.games + args.games % 2
    run = make_hosted_arena(pa.net, pb.net, batch, s, pa.device)
    out = run(torch.Generator().manual_seed(args.seed))
    out["a"], out["b"] = args.a, args.b
    out["sims"], out["temperature"] = args.sims, args.temperature
    out["algo_a"], out["algo_b"] = args.algo_a, args.algo_b
    if args.sims_a or args.sims_b:
        out["sims_a"] = args.sims_a or args.sims
        out["sims_b"] = args.sims_b or args.sims
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
