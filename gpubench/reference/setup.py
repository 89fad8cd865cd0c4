"""The reference's view of one cell: its tables on a device, built from the
configuration's raw files alone."""

from __future__ import annotations

import torch

from . import artifacts, codes, osd, sampling
from .decode import Tables


def build(root: str, config: dict, traffic: dict, device, round_fn=None) -> dict:
    """Everything the judge needs: the code's tables, generator and channel
    sigma, the decoder weights, the DIA filter, the stopper, the TEP table
    and the memory budgets of the blocked computations."""
    if config["variant"] != "NMS-1":
        raise ValueError(f"the reference decodes NMS-1, not {config['variant']}")
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
        "weights": (1.0, run["w_chk"], 1.0),
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

