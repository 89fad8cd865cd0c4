"""minima_roofline: the discrepancy minima's least time, the parity term
of every captured row against the path's padded TEPs
(``roofline.k5_bound_s``), over the device time of the kernels launched
inside ``osd.engine.block_discrepancy_minima``."""

from gpubench import roofline, trace


def read(ctx):
    if ctx.kind != "system" or ctx.trace is None:
        return None
    spent, calls = trace.range_seconds(ctx.trace, "minima")
    w = ctx.work
    return 100.0 * calls * roofline.k5_bound_s(
        w["cap"], w["m"], w["k"], w["teps"]) / spent
