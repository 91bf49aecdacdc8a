"""Xiangqi AlphaZero in PyTorch and CUDA, ported from ``xiangqi_alphazero_tpu``.

The JAX package is the reference; this package mirrors its layout module for
module and imports nothing of it (nor JAX). Entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU.
"""
