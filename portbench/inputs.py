"""Inputs made from the seed: the net's weights and the learner's rows.

Both are made on the device by a ``torch.Generator`` there, in a few large
calls, and handed alike to the program and to the plain reference. Each
kind of input draws from its own stream of the seed.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .reference import resnet

WEIGHTS, ROWS = 1, 2


def generator(seed: int, stream: int, device) -> torch.Generator:
    """The generator of one input stream of ``seed`` on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 8 + stream) % (1 << 63))
    return g


def net_weights(channels: int, blocks: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """A float32 state dict in the reference layout: conv and dense kernels
    normal with variance 1 / fan-in (one draw for all of them), dense biases
    and batch-norm shifts 0, batch-norm scales 1, running means 0 and
    variances 1."""
    shapes = [(n, k, s) for n, k, s in resnet.layers(channels, blocks) if k != "bn"]
    sizes = [int(np.prod(s)) for _, _, s in shapes]
    flat = torch.randn(sum(sizes), generator=generator(seed, WEIGHTS, device), device=device)
    out: Dict[str, torch.Tensor] = {}
    for (name, kind, shape), part in zip(shapes, flat.split(sizes)):
        fan_in = int(np.prod(shape[1:]))
        out[f"{name}.weight"] = (part * fan_in ** -0.5).reshape(shape)
        if kind == "dense":
            out[f"{name}.bias"] = torch.zeros(shape[0], device=device)
    for name, kind, (c,) in (x for x in resnet.layers(channels, blocks) if x[1] == "bn"):
        out[f"{name}.weight"] = torch.ones(c, device=device)
        out[f"{name}.bias"] = torch.zeros(c, device=device)
        out[f"{name}.running_mean"] = torch.zeros(c, device=device)
        out[f"{name}.running_var"] = torch.ones(c, device=device)
        out[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.long, device=device)
    return out


# the start position's 32 pieces
_PIECES = np.array([1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 7, 7, 7], np.int8)


def learner_rows(n: int, k: int, seed: int, device, min_moves: int = 20,
                 max_moves: int = 60) -> Tuple[np.ndarray, ...]:
    """``n`` training rows (boards int8[n, 90], sides int8[n], pi_actions
    int32[n, k], pi_probs f32[n, k], z f32[n]), as the replay ring holds
    them: each board a random subset of the 32 pieces (each kept with
    probability 3/4) on distinct squares; a policy target over 20-60 distinct
    actions with Dirichlet(1) weights, the other slots -1; z in {-1, 0, 1}."""
    g = generator(seed, ROWS, device)
    pieces = torch.as_tensor(np.concatenate([_PIECES, -_PIECES]), device=device)
    squares = torch.rand((n, 90), generator=g, device=device).argsort(dim=1)[:, :32]
    keep = torch.rand((n, 32), generator=g, device=device) < 0.75
    boards = torch.zeros((n, 90), dtype=torch.int8, device=device)
    boards.scatter_(1, squares, torch.where(keep, pieces, 0).to(torch.int8))
    sides = torch.where(torch.rand(n, generator=g, device=device) < 0.5, 1, -1).to(torch.int8)
    n_moves = torch.randint(min_moves, max_moves + 1, (n, 1), generator=g, device=device)
    used = torch.arange(k, device=device)[None, :] < n_moves
    # distinct actions: the first k of a random order of 8100, by a sort of
    # random keys taken in blocks of rows to bound the memory
    acts = torch.empty((n, k), dtype=torch.int32, device=device)
    for lo in range(0, n, 8192):
        keys = torch.rand((min(8192, n - lo), resnet.ACTION_SPACE), generator=g, device=device)
        acts[lo:lo + keys.shape[0]] = keys.topk(k, dim=1).indices.to(torch.int32)
    acts = torch.where(used, acts, -1)
    w = -torch.log(torch.rand((n, k), generator=g, device=device).clamp(min=1e-12))
    w = torch.where(used, w, 0.0)
    probs = w / w.sum(dim=1, keepdim=True)
    z = torch.randint(-1, 2, (n,), generator=g, device=device).float()
    return tuple(x.cpu().numpy() for x in (boards, sides, acts, probs, z))
