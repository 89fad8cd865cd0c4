"""enms_phase1_roofline: ENMS's fused step at its least time, the f32
instructions of the frame-iterations and decisions its frames need under
the cell's schedule (counted by the reference on the run's checked steps)
on the extended matrix the decoder runs on (``variants/ENMS.py``'s
``extend`` of H; ``roofline.compact_bound_s``), over the device time of
the kernels launched inside ``ops.nms_edge.fused_counters_edge_compact``;
ENMS's steps only."""

from gpubench import core, roofline, trace


def read(ctx):
    if ctx.kind != "phase1" or ctx.trace is None or ctx.config["variant"] != "ENMS":
        return None
    spent, calls = trace.range_seconds(ctx.trace, "phase1_step")
    w = ctx.work
    h = core.decoder("ENMS").extend(w["h"])
    return 100.0 * calls * roofline.compact_bound_s(
        h, w["frame_iters_per_step"], w["closings_per_step"]) / spent
