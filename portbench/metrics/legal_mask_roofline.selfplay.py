"""The legal-move mask kernel's share of its roofline, %: the bytes its
launches must move (every launch of self-play covers the whole fleet) at
the device's HBM bandwidth, over the kernel's summed device time in the
trace."""

from portbench import flops

KERNEL = "legal_mask_by_piece"


def read(ctx):
    bw = (ctx.peaks or {}).get("hbm_bytes_per_s")
    launches, seconds = ctx.trace.ops(KERNEL)
    if not bw or not launches or seconds <= 0:
        return None
    need = launches * flops.legal_mask_bytes(ctx.counters["games"]) / bw
    return 100.0 * need / seconds
