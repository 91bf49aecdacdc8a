"""Multi-device training over ``torch.distributed`` ranks (port of
``xiangqi_alphazero_tpu.parallel``); ``probe`` runs its pieces over N
ranks for the checks."""

from ..distributed import distributed_init  # noqa: F401
from .sharding import (  # noqa: F401
    batch_sharded,
    host_local_batch,
    make_mesh,
    make_sharded_eval,
    make_sharded_selfplay,
    make_sharded_train_step,
    make_tp_mesh,
    replicated,
    tp_place,
)
