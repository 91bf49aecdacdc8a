"""Descent levels per batched simulation step of the traced self-play call,
from the program's counters: ``search.descent_levels`` (one per iteration
of ``search/mcts.py::_descend``'s loop, each of which reads the games' stop
flags back to the host) over ``search.simulations``. None without the
program's counters (``portbench/spans.py``)."""


def read(ctx):
    c = getattr(ctx, "program_counters", None) or {}
    if not c.get("search.simulations"):
        return None
    return c.get("search.descent_levels", 0) / c["search.simulations"]
