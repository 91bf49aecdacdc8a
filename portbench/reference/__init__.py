"""The plain reference the harness judges the program by: plain PyTorch and
Python, importing nothing of the program under test."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def float32_exact():
    """float32 matmuls and convolutions in float32: TF32 off for the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
