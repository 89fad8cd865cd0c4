"""nmsr_redecode_roofline: NMS-r's re-decode trajectory of a round's
captured rows at its least time (its iterations as ``roofline_nmsr``
counts them, against the rows in and the T + 1 slots out;
``roofline_nmsr.redecode_bound_s``) over the device time of the kernels
launched inside ``osd.engine.redecode_trajectory``; NMS-r's rounds only."""

from gpubench import roofline_nmsr, trace


def read(ctx):
    if ctx.kind != "system" or ctx.trace is None or ctx.config["variant"] != "NMS-r":
        return None
    spent, calls = trace.range_seconds(ctx.trace, "redecode")
    w = ctx.work
    return 100.0 * calls * roofline_nmsr.redecode_bound_s(
        w["h"], w["cap"], w["iters"]) / spent
