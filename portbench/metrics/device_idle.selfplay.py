"""The device's idle share of the traced self-play call, %: one minus the
union of the device events' intervals over the call's wall time."""


def read(ctx):
    if not ctx.trace.events:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
