"""The reference's view of one cell: its tables on a device, built from the
configuration's raw files alone.

The phase-1 decoder is the configuration's ``variant``, judged by the file
``variants/<variant>.py`` (``core.decoder``), which holds:

* ``weights(nms_params)``: the decoder's parameters, from the run's raw
  ``nms_params.pkl``;
* ``soft_outputs(llr, ref, iters, slots, round_fn=None)``: {slot: (B, n)
  f32} soft outputs after each iteration in ``slots``, the controls'
  decode in the system's place;
* ``capture_numbers(ref, cell, index, counters, count, llr, labels)`` and
  ``redecode_numbers(ref, cell, llr, labels, traj, detected)``: the
  capture and the re-decode checks, each ``{number name: value}`` with a
  limit of each name in the cell's checks file;
* for a phase-1 cell, ``counters(codeword, llr, ref, iters, schedule,
  block_frames, round_fn=None)``: the fused step's rule.
"""

from __future__ import annotations

import torch

from ..core import decoder
from . import artifacts, codes, osd, sampling
from .decode import Tables


def build(root: str, config: dict, traffic: dict, device, round_fn=None) -> dict:
    """Everything the judge needs: the code's tables, generator and channel
    sigma, the decoder's module and weights, the DIA filter, the stopper,
    the TEP table and the memory budgets of the blocked computations."""
    dec = decoder(config["variant"])
    run = artifacts.load_run(root, config)
    h = run["h"]
    g = codes.generator(h)
    m, n = h.shape
    k = g.shape[0]
    if m != n - k:
        raise ValueError("the reference needs a full-rank parity matrix")
    edge_col, var_edges = codes.edges(h)
    iters = int(config["num_iterations"])
    taps, bias = osd.dia_filter(run["conv"], run["head_kernel"],
                                run["head_bias"], iters + 1)
    flat, valid, bounds = codes.tep_table(run["path"], k,
                                          int(config["num_segments"]))
    return {
        "tables": Tables(h, edge_col, var_edges, device),
        "g": torch.as_tensor(g, dtype=torch.float32, device=device),
        "k": k,
        "sigma": sampling.sigma_for_snr(float(traffic["snr_db"]), k / n),
        "decoder": dec,
        "weights": dec.weights(run["nms"]),
        "taps": taps,
        "bias": bias,
        "w1": run["w1"],
        "w2": run["w2"],
        "h_osd": torch.as_tensor(h, device=device),
        "teps": torch.as_tensor(flat, device=device),
        "valid": torch.as_tensor(valid, device=device),
        "bounds": bounds,
        # elements of a (rows, m, TEPs) block of the discrepancy computation
        "disc_budget": 2**27,
        # frames a slice of the fused counters' rule: group-aligned, about
        # 2**27 message words
        "chunk": max(int(traffic.get("block_frames", 1)),
                     2**27 // (edge_col.size + 1)
                     // int(traffic.get("block_frames", 1))
                     * int(traffic.get("block_frames", 1))),
        "round_fn": round_fn,
    }

