"""Model FLOPs utilisation of the learner, %: the forward and backward
FLOPs of the rows trained in the traced call, over its wall time, over the
device's dense bf16 peak."""

from portbench import flops


def read(ctx):
    peak = (ctx.peaks or {}).get("bf16_flops_per_s")
    if not peak or not ctx.counters.get("rows"):
        return None
    work = ctx.counters["rows"] * flops.train_flops(ctx.cfg["num_channels"],
                                                    ctx.cfg["num_res_blocks"])
    return 100.0 * work / ctx.trace.window_s / peak
