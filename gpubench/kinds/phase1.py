"""Fused Monte-Carlo steps: the port's
``ops.nms_edge.fused_counters_edge_compact`` (kernel K3), the call of
``system.Phase1.step`` and of ``run_nms_mc``'s fused branch, in a closed
loop over the window.

Traffic keys: ``snr_db``, ``batch`` (frames a step), ``block_frames`` (the
compaction group), ``schedule`` ((iterations, fraction of a group) stages),
``warmup_steps``, ``checked_steps`` and ``check_within``.  Step ``i``
takes the 32-bit seed ``(seed * 100003 + i) & 0x7FFFFFFF``.
"""

from __future__ import annotations

import os
import random

from ..reference import judge, sampling, setup
from . import drive, peak_bytes, release, sync


def run(cell, tracer) -> dict:
    from short_ldpc_decoding_osd_tpu_torch.convert import load_run
    from short_ldpc_decoding_osd_tpu_torch.ops import nms_edge

    cfg, tr = cell.config, cell.traffic
    dev = cell.device
    run_ = load_run(os.path.join(cell.root, cfg["run_dir"]), dev)
    code, variant, iters = run_["code"], run_["variant"], run_["num_iterations"]
    params = {k: v.cpu() for k, v in run_["nms_params"].items()}
    schedule = tuple(tuple(stage) for stage in tr["schedule"])

    def step(i):
        return nms_edge.fused_counters_edge_compact(
            code, params, variant, iters, tr["snr_db"], tr["batch"],
            seed=sampling.step_seed(cell.seed, i),
            block_frames=tr["block_frames"], schedule=schedule, device=dev)

    for j in range(tr["warmup_steps"]):
        step(-1 - j)
    sync(dev)

    checked = sorted(random.Random(cell.seed).sample(
        range(tr["check_within"]), tr["checked_steps"]))
    kept = {}
    inner = tracer.wrap(nms_edge, "fused_counters_edge_compact", "phase1_step")

    def one_step(i):
        out = step(i)
        if i in checked:
            kept[i] = out

    try:
        timed = drive(one_step, cell.seconds, dev, tracer, cell.t_start)
        peak = peak_bytes(dev)
        for i in checked:
            if i >= timed["ran"]:
                kept[i] = step(i)
    finally:
        nms_edge.fused_counters_edge_compact = inner
    kept = {i: c.cpu() for i, c in kept.items()}
    release(dev)

    ref = setup.build(cell.root, cfg, tr, dev)
    args = {"batch": tr["batch"], "iters": int(cfg["num_iterations"]),
            "schedule": schedule, "block_frames": tr["block_frames"]}
    per_unit, notes, frame_iters, closings = [], [], 0, 0
    for i in checked:
        want, fi, cl = judge.reference_counters(
            ref, args, sampling.step_seed(cell.seed, i))
        per_unit.append({"counter_mismatch": judge.counter_mismatch(
            kept[i].tolist(), want)})
        notes.append(f"step {i} counters {kept[i].tolist()}")
        frame_iters += fi
        closings += cl
    return timed | {
        "frames": timed["units"] * tr["batch"],
        "memory_peak_bytes": peak,
        "per_unit": per_unit,
        "checked": checked,
        "work": {"h": ref["tables"].h.cpu().numpy(),
                 "frame_iters_per_step": frame_iters / len(checked),
                 "closings_per_step": closings / len(checked),
                 "notes": notes},
    }
