"""The controls of the comparison that decides ``correct``: the reference
put in the system's place, one precision below what the configuration
states, judged by the same numbers as a run.  Each has to come out as not
correct.

* two-phase cells (float32, weighted contractions with TF32 off): every
  contraction (the DIA filter, the discrepancies' weighted sums, the
  stopper) on TF32 operands;
* fused-step cells (float32 messages): the channel input and every
  message rounded to bfloat16.

    python3 gpubench/control.py --workload <cell> --seeds 11,12,13

runs the control at the cell's own size on the card and prints one JSON
line a seed with its numbers and the cell's limits.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import types

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def system_numbers(ref, args, seed: int, index: int, mode: str = "tf32") -> dict:
    """Round ``index`` of the control in the system's place, judged."""
    from gpubench.reference import decode, judge, osd, sampling

    decoder = ref["decoder"]
    iters, cap = args["iters"], args["cap"]
    llr_all, words = sampling.awgn_round(seed, index, ref["g"], args["cap_b"],
                                         ref["sigma"])
    soft = decoder.soft_outputs(llr_all, ref, iters, {iters})[iters]
    bit_err, detected = decode.frame_stats(soft, words, ref["tables"].h)
    counters = torch.tensor(decode.count(bit_err, detected))
    rows = decode.capture(detected, cap)
    llr, labels = llr_all[rows].contiguous(), words[rows]
    soft = decoder.soft_outputs(llr, ref, iters, set(range(iters + 1)))
    traj = torch.stack([soft[i] for i in range(iters + 1)], 0)
    _, det = decode.frame_stats(traj[iters], labels, ref["tables"].h)
    refined = osd.refine(traj.permute(1, 0, 2), ref["taps"], ref["bias"], mode)
    prep = osd.prepare(refined, llr, labels, ref["h_osd"], ref["k"])
    rows = judge.rows_per_block(cap, ref["disc_budget"],
                                ref["teps"].shape[0] * prep["m_matrix"].shape[1])
    parts = []
    for s in range(0, cap, rows):
        disc = osd.discrepancies(*(prep[key][s:s + rows] for key in (
            "m_matrix", "hard_original", "mag_original", "hard_updated")),
            ref["teps"], mode)
        parts.append(osd.block_minima(disc, ref["valid"], ref["bounds"]))
        del disc
    minima = torch.cat([p[0] for p in parts])
    argmins = torch.cat([p[1] for p in parts])
    dec = osd.decisions(prep, minima, argmins, ref["teps"], ref["bounds"],
                        ref["w1"], ref["w2"], args["window"],
                        args["soft_margin"], mode)
    args = dict(args, seed=seed)
    nums = decoder.capture_numbers(ref, args, index, counters,
                                   detected.sum(), llr, labels)
    nums |= decoder.redecode_numbers(ref, args, llr, labels, traj, det)
    nums |= judge.stage_numbers(ref, args, llr, labels, traj, refined,
                                types.SimpleNamespace(**prep), minima, argmins,
                                dec["success"], dec["strict_success"])
    return nums


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    from gpubench import core
    from gpubench.reference import sampling, setup

    cell = core.find_cell(ROOT, args.workload)
    dev = torch.device("cuda", 0)
    cfg, tr = cell.config, cell.traffic
    for seed in (int(s) for s in args.seeds.split(",")):
        if tr["kind"] == "system":
            ref = setup.build(ROOT, cfg, tr, dev)
            nums = system_numbers(ref, {
                "cap_b": tr["cap_b"], "cap": tr["cap"],
                "iters": int(cfg["num_iterations"]),
                "window": int(cfg["window"]),
                "soft_margin": float(cfg["soft_margin"])}, seed, 0)
        else:
            nums = phase1_control(ROOT, cfg, tr, dev,
                                  sampling.step_seed(seed, 0))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "numbers": nums, "limits": cell.limits}), flush=True)
    return 0


def phase1_control(root, cfg, tr, dev, step_seed: int) -> dict:
    """``counter_mismatch`` of a step of the bfloat16 control against the
    float32 reference."""
    from gpubench.reference import judge, setup

    args = {"batch": tr["batch"], "iters": int(cfg["num_iterations"]),
            "schedule": tuple(tuple(s) for s in tr["schedule"]),
            "block_frames": tr["block_frames"]}
    low = setup.build(root, cfg, tr, dev, round_fn=bf16)
    got, _, _ = judge.reference_counters(low, args, step_seed)
    del low
    ref = setup.build(root, cfg, tr, dev)
    want, _, _ = judge.reference_counters(ref, args, step_seed)
    return {"counter_mismatch": judge.counter_mismatch(got, want)}


if __name__ == "__main__":
    sys.exit(main())
