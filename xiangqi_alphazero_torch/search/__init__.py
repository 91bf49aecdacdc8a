"""Batched PUCT search and the Gumbel root search."""

from .gumbel import (  # noqa: F401
    GumbelConfig,
    GumbelResult,
    halving_schedule,
    run_gumbel_mcts,
)
from .mcts import (  # noqa: F401
    MCTSConfig,
    SearchResult,
    action_probs_dense,
    greedy_slots,
    movegen_precedence,
    run_mcts,
    sample_actions,
)
