"""Device idle time charged to the search's descent, % of the traced
self-play window: the idle stretches the host spent in the program's span
``search.descend`` (one ``search/mcts.py::_descend`` call) by its self time
(``portbench/spans.py``). A part of ``device_idle.selfplay``. None without
the program's spans on the trace's clock."""

from portbench import spans

SPAN = "search.descend"


def read(ctx):
    att = spans.read_spans(ctx)
    if att is None or SPAN not in att.names:
        return None
    return 100.0 * att.idle_s.get(SPAN, 0.0) / ctx.trace.window_s
