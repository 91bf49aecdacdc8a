"""Neutral arena over training checkpoints' current parameters.

Port of the repo's ``scripts/arena_current.py``. ``train.arena`` loads a
checkpoint through ``Predictor.load``, which serves its best (gated)
parameters: right for gated runs, wrong for experiment arms trained with
gating off, whose best parameters are still the shared initial net. This
loads a ``checkpoint_iter{N}``'s current parameters, as the head-to-head
does, and runs the neutral protocol: PUCT-40 on both sides, temperature
0.2, alternating colours, every draw from one seeded CPU generator.

    python -m xiangqi_alphazero_torch.scripts.arena_current \\
        --a runs/torch/h2h/puct/checkpoint_iter6 --b runs/torch/h2h/gumbel/checkpoint_iter12 \\
        [--games 64] [--sims 40] [--device cpu]

Prints one JSON line: the match's counts with both paths, sims and games.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..models import XiangqiNet
from ..serve.predictor import resolve_device
from ..train.arena import ArenaSettings, make_hosted_arena
from ..train.checkpoint import load_checkpoint


def load_current(path: str, device=None) -> XiangqiNet:
    """The candidate net (``params``, not ``best_params``) of a trainer's
    ``checkpoint_iter{N}``, in eval mode on ``device`` (CUDA unless named)."""
    dev = resolve_device(device)
    restored = load_checkpoint(path)
    mc = restored["config"]
    net = XiangqiNet(channels=int(mc["num_channels"]), blocks=int(mc["num_res_blocks"]))
    net.load_state_dict(restored["params"])
    return net.to(dev).eval()


def current_arena(net_a, net_b, games: int, sims: int, temperature: float, seed: int) -> dict:
    """The neutral protocol between two loaded nets: ``games`` rounded up
    to even, PUCT at ``sims`` on both sides, draws from a CPU generator
    seeded ``seed``. Returns the arena's counts."""
    batch = games + games % 2
    s = ArenaSettings(num_simulations=sims, temperature=temperature)
    dev = next(net_a.parameters()).device
    run = make_hosted_arena(net_a, net_b, batch, s, dev)
    return run(torch.Generator().manual_seed(seed))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="arena over checkpoints' current parameters")
    p.add_argument("--a", required=True, help="a trainer's checkpoint_iter{N}")
    p.add_argument("--b", required=True)
    p.add_argument("--games", type=int, default=64)
    p.add_argument("--sims", type=int, default=40)
    p.add_argument("--temperature", type=float, default=0.2)
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--device", default="cuda",
                   help="torch device to play on (default cuda; 'cpu' for the CPU)")
    args = p.parse_args(argv)

    net_a = load_current(args.a, args.device)
    net_b = load_current(args.b, args.device)
    res = current_arena(net_a, net_b, args.games, args.sims, args.temperature, args.seed)
    print(json.dumps({"a": args.a, "b": args.b, **res, "sims": args.sims}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
