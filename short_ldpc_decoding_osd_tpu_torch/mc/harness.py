"""Monte-Carlo capture step: sample, decode, count, capture failures.

Port of ``build_nms_mc_step`` (``short_ldpc_decoding_osd_tpu/mc/harness.py:144-292``).
The step is factored into :func:`sample_batch` (channel) and
:func:`count_and_capture` (counters + the failures-first compaction), so the
second half can be held against JAX on identical arrays.

Capture keeps detected failures (nonzero syndrome) first, IN FRAME ORDER:
the stable ``argsort(~flag)[:capacity]`` of ``harness.py:275-276``.  Rows
past ``count`` are padding (non-failures); failures beyond the capacity are
overflow, which the caller counts (``bench.py:389-397``).

The JAX harness triages fused-kernel errors and demotes to a slower rung
(``_attempt_fused``/``_kernel_error_kind``, ``harness.py:42-92``).  The port
does not: a kernel that fails to build or launch fails the run.
``run_nms_mc`` and the demotion ladder are not ported.
"""

from __future__ import annotations

import torch

from .._device import resolve_device
from ..channel.awgn import ChannelSpec, sample_batch
from ..codes import Code
from ..ops import nms, nms_edge


def count_and_capture(llr: torch.Tensor, words: torch.Tensor,
                      soft_last: torch.Tensor, h, capture_capacity: int = 0):
    """Counters and failure capture for one decoded batch.

    Returns ``counters`` (5,) int64 = [frames, frame_errors, bit_errors,
    detected, undetected] and, when ``capture_capacity`` > 0, ``capture``
    with ``count`` (detected failures in the batch, 0-d), ``llr`` and
    ``labels`` (capacity, n): failures first in frame order."""
    st = nms.frame_stats(soft_last, words, h)
    counters = torch.stack([
        torch.tensor(llr.shape[0], dtype=torch.int64, device=llr.device),
        st["frame_error"].sum(),
        st["bit_errors"].to(torch.int64).sum(),
        st["detected_failure"].sum(),
        st["undetected_error"].sum(),
    ])
    if not capture_capacity:
        return counters, None
    flag = st["detected_failure"]
    order = torch.sort((~flag).to(torch.int8), stable=True).indices
    take = order[:capture_capacity]
    capture = {"count": flag.sum(), "llr": llr[take], "labels": words[take]}
    return counters, capture


def build_nms_mc_step(code: Code, variant: str, num_iterations: int,
                      spec: ChannelSpec, batch: int,
                      capture_capacity: int = 0, all_zeros: bool = False,
                      device: str | torch.device = "cuda"):
    """Build ``step(params, generator) -> (counters, capture)``.

    The decode is the edge kernel K1 (``nms_edge.decode_final_edge``) for
    the scalar variants and the dense ``nms.decode_final`` for NMS-r.
    ``generator`` is a ``torch.Generator`` on ``device``."""
    dev = resolve_device(device)
    decode_h = code.extended().h if variant == "ENMS" else code.h
    gen_matrix = torch.as_tensor(code.g, dtype=torch.float32, device=dev)
    edge_cols = nms.edge_columns(decode_h) if variant == "NMS-r" else None

    def step(params: dict, generator: torch.Generator):
        llr, words = sample_batch(generator, spec, gen_matrix, batch,
                                  all_zeros=all_zeros)
        if variant == "NMS-r":
            soft_last = nms.decode_final(params, decode_h, llr, num_iterations,
                                         variant, edge_cols)
        else:
            soft_last = nms_edge.decode_final_edge(params, decode_h, llr,
                                                   num_iterations, variant)
        return count_and_capture(llr, words, soft_last, decode_h,
                                 capture_capacity)

    return step
