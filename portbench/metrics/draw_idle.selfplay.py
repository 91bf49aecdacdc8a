"""Device idle time charged to the host's draws on the CPU generator, % of
the traced self-play window: the idle stretches the host spent in the
program's ``draw.*`` spans (each draw with its copy to the card:
``search/mcts.py::_gamma``/``_gumbel``, ``search/gumbel.py::_root_gumbel``,
``train/selfplay.py::_draw_*``) by their self time (``portbench/spans.py``).
A part of ``device_idle.selfplay``. None without the program's spans on the
trace's clock."""

from portbench import spans

PREFIX = "draw."


def read(ctx):
    att = spans.read_spans(ctx)
    if att is None or not any(n.startswith(PREFIX) for n in att.names):
        return None
    return 100.0 * sum(s for n, s in att.idle_s.items() if n.startswith(PREFIX)) \
        / ctx.trace.window_s
