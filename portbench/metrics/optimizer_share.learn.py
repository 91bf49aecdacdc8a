"""The optimizer's share of the traced learner call, %: device seconds of
the events launched within the program's span ``learn.optimizer``
(``train/learner.py::Optimizer.step``: the clip and Adam), matched to their
launch by correlation id (``portbench/spans.py``), over the window. None
without the program's spans on the trace's clock."""

from portbench import spans

SPAN = "learn.optimizer"


def read(ctx):
    att = spans.read_spans(ctx)
    if att is None or SPAN not in att.names:
        return None
    return 100.0 * att.device_s.get(SPAN, 0.0) / ctx.trace.window_s
