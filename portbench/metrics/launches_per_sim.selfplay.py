"""Device operations (kernels, copies, fills) per batched simulation step
of the traced self-play call: what the search's host code launches for
each simulation, the openings and the per-ply work included."""


def read(ctx):
    steps = ctx.counters.get("sim_steps")
    if not steps or not ctx.trace.events:
        return None
    return ctx.trace.ops()[0] / steps
