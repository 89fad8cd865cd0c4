"""phase1_roofline: a fused step's least time, the f32 instructions of the
frame-iterations and decisions its frames need under the cell's schedule
(every frame the first stage, the frames carried on the rest; counted by
the reference on the run's checked steps; ``roofline.compact_bound_s``),
over the device time of the kernels launched inside
``ops.nms_edge.fused_counters_edge_compact``."""

from gpubench import roofline, trace


def read(ctx):
    if ctx.kind != "phase1" or ctx.trace is None:
        return None
    spent, calls = trace.range_seconds(ctx.trace, "phase1_step")
    w = ctx.work
    return 100.0 * calls * roofline.compact_bound_s(
        w["h"], w["frame_iters_per_step"], w["closings_per_step"]) / spent
