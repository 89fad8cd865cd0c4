"""nmsr_capture_roofline: NMS-r's capture step at its least time (the
decode's f32 instructions as ``roofline_nmsr`` counts them, against the
captured rows out; ``roofline_nmsr.capture_bound_s``) over the device
time of the kernels launched inside ``capture_round``; NMS-r's rounds
only."""

from gpubench import roofline_nmsr, trace


def read(ctx):
    if ctx.kind != "system" or ctx.trace is None or ctx.config["variant"] != "NMS-r":
        return None
    spent, calls = trace.range_seconds(ctx.trace, "capture_round")
    w = ctx.work
    return 100.0 * calls * roofline_nmsr.capture_bound_s(
        w["h"], w["cap_b"], w["iters"], w["cap"]) / spent
