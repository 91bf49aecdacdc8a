"""What the harness takes from the program under test: its net, built from
the harness's weights. Everything else the drivers call by its public entry
point."""

from __future__ import annotations

from typing import Dict

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_net(cfg: dict, weights: Dict[str, torch.Tensor], device) -> torch.nn.Module:
    """The program's ``XiangqiNet`` at the configuration's width, depth and
    compute type, holding ``weights`` (copied)."""
    from xiangqi_alphazero_torch.models.resnet import XiangqiNet

    with torch.device("meta"):
        net = XiangqiNet(cfg["num_channels"], cfg["num_res_blocks"], DTYPES[cfg["dtype"]])
    net = net.to_empty(device=device)
    net.load_state_dict(weights)
    return net


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
