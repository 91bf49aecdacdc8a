"""Checkpointing: full training state + the slim best-model export.

Port of ``xiangqi_alphazero_tpu.train.checkpoint`` without orbax. Reference
parity (training/train.py:537-579): the full checkpoint carries the
iteration, the candidate's and the best net's state, the optimizer state and
the topology config; a separate ``best_model`` is written for serving.

- ``checkpoint_iter{N}`` is one ``torch.save`` file (no extension, the JAX
  package's directory name) of the trainer's payload dict; the trainer
  saves the replay ring beside it as ``checkpoint_iter{N}.replay.npz``.
- ``best_model.pt`` is a reference-layout ``.pt`` (``{"model_state_dict",
  "config"}``, plus ``"iteration"``), which ``models/convert.py::
  load_reference_pt`` and the port's ``serve`` load as they are; its
  topology also goes to ``best_model_config.json``.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional

import torch

BEST_MODEL = "best_model.pt"


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def checkpoint_path(ckpt_dir: str, iteration: int) -> str:
    return os.path.abspath(os.path.join(ckpt_dir, f"checkpoint_iter{iteration}"))


def save_checkpoint(ckpt_dir: str, iteration: int, payload: Dict[str, Any]) -> str:
    """Write the checkpoint under a temporary name and rename it, so that a
    process killed while saving (the ``--auto-restart`` supervisor resumes
    from the newest ``checkpoint_iter{N}``) leaves no partial file under
    the checkpoint's name, as orbax renames a finished save."""
    path = checkpoint_path(ckpt_dir, iteration)
    torch.save(_to_cpu(payload), path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def save_best_model(ckpt_dir: str, iteration: int, state_dict, model_config: Dict) -> str:
    path = os.path.abspath(os.path.join(ckpt_dir, BEST_MODEL))
    torch.save(
        {"model_state_dict": _to_cpu(state_dict), "config": dict(model_config),
         "iteration": int(iteration)},
        path,
    )
    with open(os.path.join(ckpt_dir, "best_model_config.json"), "w") as f:
        json.dump(model_config, f)
    return path


def load_checkpoint(path: str, device="cpu") -> Dict[str, Any]:
    return torch.load(os.path.abspath(path), map_location=device, weights_only=True)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """Newest ``checkpoint_iter{N}`` in ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    best, best_iter = None, -1
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"checkpoint_iter(\d+)", name)
        if m and int(m.group(1)) > best_iter:
            best, best_iter = os.path.join(ckpt_dir, name), int(m.group(1))
    return best
