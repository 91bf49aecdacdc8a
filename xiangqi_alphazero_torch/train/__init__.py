"""Training: lockstep self-play, the replay ring, the learner, gated eval,
checkpoints and the trainer (port of ``xiangqi_alphazero_tpu.train``).

    python -m xiangqi_alphazero_torch.train --mode quick --iterations 2 --device cuda
"""

from .config import (  # noqa: F401
    PRESETS,
    TrainingConfig,
    full_config,
    quick_config,
    standard_config,
)
from .replay import ReplayBuffer  # noqa: F401
from .selfplay import SelfPlaySettings, selfplay_games  # noqa: F401
from .trainer import AlphaZeroTrainer  # noqa: F401

__all__ = ["PRESETS", "TrainingConfig", "ReplayBuffer", "SelfPlaySettings",
           "selfplay_games", "AlphaZeroTrainer", "full_config", "quick_config",
           "standard_config"]
