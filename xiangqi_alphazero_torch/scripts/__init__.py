"""The port's counterparts of the repo's ``scripts/``: the minimax anchor,
the serving-latency grid, the arena over current parameters, the
Gumbel-vs-PUCT head-to-head, the strength report, the flagship recipe and
the host-readiness check. Each Python tool runs as ``python -m
xiangqi_alphazero_torch.scripts.<name>``, on the card unless given
``--device cpu``, and writes under ``runs/torch/`` by default."""
