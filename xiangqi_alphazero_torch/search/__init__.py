"""Batched PUCT search (the Gumbel search is not ported yet)."""

from .mcts import (  # noqa: F401
    MCTSConfig,
    SearchResult,
    action_probs_dense,
    greedy_slots,
    movegen_precedence,
    run_mcts,
    sample_actions,
)
