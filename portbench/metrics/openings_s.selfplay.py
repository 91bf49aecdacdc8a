"""Host seconds from the start of the traced self-play call to its first
evaluation: the openings' draws on the host's CPU generator and their env
steps, which every call pays before its first search (host clock)."""


def read(ctx):
    return ctx.counters.get("openings_s")
