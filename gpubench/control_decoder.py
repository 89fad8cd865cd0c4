"""The controls of a two-phase cell's capture and re-decode checks: the
reference's decode one precision below in the system's place, judged by
the configuration's decoder file (``reference/variants/<variant>.py``).
Each has to come out as not correct.

* ``bf16``: the channel input and every message rounded to bfloat16
  (``soft_outputs``' ``round_fn``);
* ``tf32``: the operands of the decoder's weighted products rounded to
  TF32, a 10-bit mantissa, as a tensor core takes them (``soft_outputs``'
  ``operand_fn``; NMS-r's network).

    python3 gpubench/control_decoder.py --workload <cell> --seeds 11,12 [--modes bf16,tf32]

runs each control at the cell's own size on the card and prints one JSON
line a seed and mode with its numbers and the cell's limits.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def tf32(x) -> torch.Tensor:
    """``x`` as f32 with its mantissa rounded to 10 bits (to nearest, ties
    away from zero)."""
    bits = torch.as_tensor(x, dtype=torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


MODES = {"bf16": {"round_fn": bf16}, "tf32": {"operand_fn": tf32}}


def decoder_numbers(ref, args, seed: int, index: int, mode: str) -> dict:
    """Round ``index``'s capture and re-decode numbers with the control
    ``mode`` in the system's place."""
    from gpubench.reference import decode, sampling

    dec = ref["decoder"]
    iters, cap = args["iters"], args["cap"]
    low = MODES[mode]
    llr_all, words = sampling.awgn_round(seed, index, ref["g"], args["cap_b"],
                                         ref["sigma"])
    soft = dec.soft_outputs(llr_all, ref, iters, {iters}, **low)[iters]
    bit_err, detected = decode.frame_stats(soft, words, ref["tables"].h)
    counters = torch.tensor(decode.count(bit_err, detected))
    rows = decode.capture(detected, cap)
    llr, labels = llr_all[rows].contiguous(), words[rows]
    del llr_all, words, soft
    soft = dec.soft_outputs(llr, ref, iters, set(range(iters + 1)), **low)
    traj = torch.stack([soft[i] for i in range(iters + 1)], 0)
    _, det = decode.frame_stats(traj[iters], labels, ref["tables"].h)
    args = dict(args, seed=seed)
    nums = dec.capture_numbers(ref, args, index, counters, detected.sum(), llr,
                               labels)
    return nums | dec.redecode_numbers(ref, args, llr, labels, traj, det)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--modes", default="bf16,tf32")
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    from gpubench import core
    from gpubench.reference import setup

    cell = core.find_cell(ROOT, args.workload)
    cfg, tr = cell.config, cell.traffic
    if tr["kind"] != "system":
        raise SystemExit(f"{args.workload} is no two-phase cell")
    dev = torch.device("cuda", 0)
    ref = setup.build(ROOT, cfg, tr, dev)
    run = {"cap_b": tr["cap_b"], "cap": tr["cap"],
           "iters": int(cfg["num_iterations"])}
    for seed in (int(s) for s in args.seeds.split(",")):
        for mode in args.modes.split(","):
            nums = decoder_numbers(ref, run, seed, 0, mode)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "mode": mode, "numbers": nums,
                              "limits": cell.limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
