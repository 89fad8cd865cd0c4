"""Two-phase rounds: the port's ``system.TwoPhase.full_round`` in a closed
loop over the window.

Traffic keys: ``snr_db``, ``cap_b`` (frames a round), ``cap`` (capture
rows a round), ``warmup_rounds``, ``checked_rounds`` and ``check_within``
(the judged rounds are drawn from the seed among the first
``check_within``; one the window did not reach runs after it, untimed).
"""

from __future__ import annotations

import os
import random

from ..reference import judge, setup
from . import drive, peak_bytes, release, sync

# round indices of the warm-up, apart from the window's 0, 1, 2, ...
WARMUP_BASE = 10**6


def run(cell, tracer) -> dict:
    from short_ldpc_decoding_osd_tpu_torch import system as port_system
    from short_ldpc_decoding_osd_tpu_torch.osd import engine

    cfg, tr = cell.config, cell.traffic
    dev = cell.device
    two_phase = port_system.TwoPhase(
        run_dir=os.path.join(cell.root, cfg["run_dir"]), cap_b=tr["cap_b"],
        cap=tr["cap"], snr_db=tr["snr_db"], device=dev, seed=cell.seed)
    for j in range(tr["warmup_rounds"]):
        two_phase.full_round(WARMUP_BASE + j)
    sync(dev)

    checked = sorted(random.Random(cell.seed).sample(
        range(tr["check_within"]), tr["checked_rounds"]))
    kept: dict[int, dict] = {}
    current = {"round": None}

    def stash(key):
        def keep(out):
            if current["round"] in kept:
                kept[current["round"]][key] = out
        return keep

    taps = [(two_phase, "capture_round", "capture_round", stash("capture")),
            (two_phase, "phase2", "phase2", stash("phase2")),
            (engine, "redecode_trajectory", "redecode", stash("traj")),
            (two_phase.dia, "refine_fast", "dia", None),
            (engine, "prepare", "prepare", stash("prep")),
            (engine, "block_discrepancy_minima", "minima", stash("minima")),
            (engine, "sliding_walk", "walk", None)]
    originals = [(obj, attr, tracer.wrap(obj, attr, name, after))
                 for obj, attr, name, after in taps]

    def one_round(i):
        current["round"] = i
        if i in checked:
            kept[i] = {}
        two_phase.full_round(i)

    try:
        timed = drive(one_round, cell.seconds, dev, tracer, cell.t_start)
        peak = peak_bytes(dev)
        for i in checked:
            if i >= timed["ran"]:
                one_round(i)
    finally:
        for obj, attr, inner in originals:
            if obj is engine:
                setattr(obj, attr, inner)
    del two_phase
    release(dev)

    ref = setup.build(cell.root, cfg, tr, dev)
    args = {"seed": cell.seed, "cap_b": tr["cap_b"], "cap": tr["cap"],
            "iters": int(cfg["num_iterations"]), "window": int(cfg["window"]),
            "soft_margin": float(cfg["soft_margin"])}
    decoder = ref["decoder"]
    per_unit, notes, ties, counts = [], [], 0, []
    for i in checked:
        k = kept.pop(i)
        counters, buf = k["capture"]
        out, refined, detected = k["phase2"]
        minima, argmins = k["minima"]
        nums = decoder.capture_numbers(ref, args, i, counters, buf["count"],
                                       buf["llr"], buf["labels"])
        nums |= decoder.redecode_numbers(ref, args, buf["llr"], buf["labels"],
                                         k["traj"], detected)
        nums |= judge.stage_numbers(
            ref, args, buf["llr"], buf["labels"], k["traj"], refined,
            k["prep"], minima, argmins, out["success"], out["strict_success"])
        ties += nums.pop("walk_ties")
        per_unit.append(nums)
        counts.append({"round": i, "counters": counters.tolist(),
                       "failures": int(buf["count"])})
        notes.append(f"round {i} counters {counters.tolist()}, failures "
                     f"{int(buf['count'])}")
        del k, counters, buf, out, refined, detected, minima, argmins
    m, n = ref["tables"].h.shape
    return timed | {
        "frames": timed["units"] * tr["cap_b"],
        "memory_peak_bytes": peak,
        "per_unit": per_unit,
        "checked": checked,
        "counts": counts,
        "work": {"h": ref["tables"].h.cpu().numpy(), "m": m, "n": n,
                 "k": ref["k"], "cap_b": tr["cap_b"], "cap": tr["cap"],
                 "iters": args["iters"], "teps": int(ref["teps"].shape[0]),
                 "walk_ties": ties, "notes": notes},
    }
