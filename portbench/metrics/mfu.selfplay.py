"""Model FLOPs utilisation of the net in self-play, %: forward FLOPs of
every position the traced call evaluated (the searches and the resign
checks), over its wall time, over the device's dense bf16 peak."""

from portbench import flops


def read(ctx):
    peak = (ctx.peaks or {}).get("bf16_flops_per_s")
    if not peak or not ctx.counters.get("positions"):
        return None
    work = ctx.counters["positions"] * flops.forward_flops(ctx.cfg["num_channels"],
                                                           ctx.cfg["num_res_blocks"])
    return 100.0 * work / ctx.trace.window_s / peak
