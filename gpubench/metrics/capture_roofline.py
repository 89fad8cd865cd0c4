"""capture_roofline: the capture step's least time (its decode's f32
instructions against the captured rows out; ``roofline.capture_bound_s``)
over the device time of the kernels launched inside ``capture_round``."""

from gpubench import roofline, trace


def read(ctx):
    if ctx.kind != "system" or ctx.trace is None:
        return None
    spent, calls = trace.range_seconds(ctx.trace, "capture_round")
    w = ctx.work
    return 100.0 * calls * roofline.capture_bound_s(
        w["h"], w["cap_b"], w["iters"], w["cap"]) / spent
