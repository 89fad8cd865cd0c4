"""prepare_roofline: the preparation's least time, its GF(2) elimination
of the captured rows with the permutation loaded
(``roofline.ge_bound_s``), over the device time of the kernels launched
inside ``osd.engine.prepare``."""

from gpubench import roofline, trace


def read(ctx):
    if ctx.kind != "system" or ctx.trace is None:
        return None
    spent, calls = trace.range_seconds(ctx.trace, "prepare")
    w = ctx.work
    return 100.0 * calls * roofline.ge_bound_s(
        w["cap"], w["m"], w["n"], w["k"], "perm") / spent
