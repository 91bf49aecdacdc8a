"""Multi-process bring-up: ``torch.distributed`` from the training CLI's
``--coordinator host:port --num-processes N --process-id i``.

Port of ``xiangqi_alphazero_tpu.distributed``. Every process (a "rank")
runs the same command with its own ``--process-id``; rank 0 serves the
TCP store at the coordinator's address. Before the process group starts,
each rank publishes its host name and card count in that store, so every
rank reaches the same verdict on two questions:

- its device: the CPU under ``device="cpu"``, else
  ``cuda:(local_rank % cards)``, where ``local_rank`` is its place among
  the ranks on its host (``process_id % cards`` when a host's ranks are
  numbered consecutively);
- the backend, by one logged rule with no flag: ``nccl`` when every rank
  drives a card of its own, ``gloo`` when ranks share a card or run on the
  CPU. NCCL refuses two ranks on one card, so one card carries two ranks
  only over gloo.

Whatever the backend, the collectives that ``parallel/sharding.py`` runs on
device tensors are ``all_reduce`` and ``broadcast`` only (all that gloo
implements for CUDA tensors), and host data (self-play records, eval
outcomes, flags) travels over a second group, gloo over CPU tensors.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import logging
import socket
from typing import List, Optional

import torch
import torch.distributed as dist

logger = logging.getLogger("xiangqi_az_torch")

_TIMEOUT = datetime.timedelta(minutes=30)


@dataclasses.dataclass(frozen=True)
class Context:
    """What ``distributed_init`` set up for this process."""

    rank: int
    world: int
    device: torch.device
    backend: str
    host_group: object   # gloo over CPU tensors, all ranks


_CONTEXT: Optional[Context] = None


def backend_rule(ranks: List[dict]) -> str:
    """``nccl`` when every rank drives a card of its own, else ``gloo``.
    ``ranks[r]`` is rank r's ``{"host", "cards"}`` (cards 0 on the CPU)."""
    per_host = {}
    for r in ranks:
        per_host.setdefault(r["host"], []).append(r["cards"])
    own_card = all(
        min(cards) > 0 and len(cards) <= min(cards) for cards in per_host.values()
    )
    return "nccl" if own_card else "gloo"


def distributed_init(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    device="cuda",
) -> Context:
    """Join the process group (once per process; a repeat call returns the
    first call's context, as the JAX function tolerates a repeat call).
    Ends with a barrier, while the ranks are still in step."""
    global _CONTEXT
    if _CONTEXT is not None:
        return _CONTEXT
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to train on the CPU")
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    host, port = coordinator_address.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), num_processes, is_master=process_id == 0,
                          timeout=_TIMEOUT)
    me = {"host": socket.gethostname(), "cards": cards}
    store.set(f"xqaz/rank{process_id}", json.dumps(me))
    ranks = [json.loads(store.get(f"xqaz/rank{r}")) for r in range(num_processes)]
    backend = backend_rule(ranks)
    if dev.type == "cuda":
        local_rank = [r for r in range(num_processes)
                      if ranks[r]["host"] == me["host"]].index(process_id)
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes, timeout=_TIMEOUT)
    host_group = dist.new_group(backend="gloo", timeout=_TIMEOUT)
    logger.info(
        "rank %d of %d on %s, backend %s (%s)", process_id, num_processes, dev, backend,
        "every rank drives a card of its own" if backend == "nccl"
        else "ranks share a card or run on the CPU")
    dist.barrier(group=host_group)
    _CONTEXT = Context(process_id, num_processes, dev, backend, host_group)
    return _CONTEXT


def free_port() -> int:
    """A free TCP port on localhost, for a coordinator of local ranks."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def context() -> Optional[Context]:
    """This process's context, or None when it has not joined a group."""
    return _CONTEXT


def shutdown() -> None:
    """Leave the process group (the end of a multi-process run)."""
    global _CONTEXT
    if _CONTEXT is not None:
        dist.destroy_process_group()
        _CONTEXT = None
