"""The dense decode kernel K6 of the port and the capture step's decoders
vs the JAX package (CPU); K7 and the pinned rungs of the harness are in
``tests/test_torch_dense_rungs.py``.

On the CPU the wrappers run the kernels' plain twins.  Tolerances:

* K6's twin against JAX ``decode_final_pallas(interpret=True)``: 2e-4 abs
  and rel, JAX's own tolerance for its kernel against the XLA decoder
  (``tests/test_nms_pallas.py``), with identical hard decisions: the two
  sum the column totals in different orders (the twin row by row, JAX as a
  tree), so they differ by f32 rounding only.
* K6's twin against K1's twin: exact.  Both sum each column in ascending
  check order and run the same tournament, which is why the capture step
  pinned to K6 equals the K1 step on the card, counters and buffers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from short_ldpc_decoding_osd_tpu.codes import get_code as jax_get_code
from short_ldpc_decoding_osd_tpu.ops import nms as jnms
from short_ldpc_decoding_osd_tpu.ops.nms_pallas import decode_final_pallas
from short_ldpc_decoding_osd_tpu_torch import _kernels
from short_ldpc_decoding_osd_tpu_torch.channel import ChannelSpec
from short_ldpc_decoding_osd_tpu_torch.codes import get_code
from short_ldpc_decoding_osd_tpu_torch.mc import harness
from short_ldpc_decoding_osd_tpu_torch.ops import (mc_dense, nms, nms_dense, nms_edge,
                                                  nms_edge_padded)
from short_ldpc_decoding_osd_tpu_torch.osd import engine

from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

TOL = 2e-4
DENSE_RUNG_CODES = ["ccsds_128_64", "code1_64_32", "qc_96_48", "array_121_60",
                    "array_121_80"]


def _params(variant, h=None):
    """Port and JAX parameters of the same values."""
    jp = jnms.init_params(variant, h)
    return {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}, jp


def _h(code):
    return torch.as_tensor(np.asarray(code.h), dtype=torch.float32)


def _check_k6_against_jax(h_np, llr, iters, variant, row_scaled=False):
    """``row_scaled``: the tolerance is relative to each frame's largest
    output.  On qc_96_48's extended H (192 rows of degree 10) messages grow
    to ~1e5 and column totals cancel to ~1, so the f32 reorder error scales
    with the frame's magnitudes, not with the output element."""
    p, jp = _params(variant, h_np)
    got = nms_dense._decode_dense_plain(
        torch.as_tensor(h_np, dtype=torch.float32), torch.as_tensor(llr), iters,
        nms.scalar_weights(p, variant)).numpy()
    want = np.asarray(decode_final_pallas(jp, jnp.asarray(h_np), jnp.asarray(llr),
                                          iters, variant, block_frames=8,
                                          interpret=True))
    if row_scaled:
        scale = np.maximum(1.0, np.abs(want).max(axis=1, keepdims=True))
        assert (np.abs(got - want) <= TOL * scale).all()
    else:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got < 0, want < 0)
    return got


# --- K6 --------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["NMS-1", "NMS-3", "ENMS"])
def test_k6_twin_matches_jax_pallas(variant):
    code = jax_get_code("ccsds_128_64")
    h = code.extended().h if variant == "ENMS" else code.h
    llr = np.random.default_rng(0).normal(1.0, 0.8, (16, code.n)).astype(np.float32)
    _check_k6_against_jax(np.asarray(h), llr, 8, variant)


def test_k6_twin_duplicate_min_semantics():
    """The tie-forcing input of tests/test_nms_pallas.py: LLRs rounded to
    0.1, so rows hold duplicated minima."""
    code = jax_get_code("ccsds_128_64")
    llr = np.round(np.random.default_rng(1).normal(1.0, 0.5, (8, code.n)),
                   1).astype(np.float32)
    _check_k6_against_jax(np.asarray(code.h), llr, 6, "NMS-1")


@pytest.mark.parametrize("name,variant", [("qc_96_48", "NMS-1"),
                                          ("qc_96_48", "ENMS"),
                                          ("array_121_60", "NMS-2")])
def test_k6_twin_irregular_and_extended(name, variant):
    """qc_96_48 has check degrees {6, 7}; ENMS runs on its extended H
    (240, 96), which only the twin takes (K6 holds at most (66, 121)-sized
    masks of this density class, see test_holds_the_five_dense_rung_codes)."""
    code = jax_get_code(name)
    h = code.extended().h if variant == "ENMS" else code.h
    llr = np.random.default_rng(2).normal(1.0, 0.9, (16, code.n)).astype(np.float32)
    _check_k6_against_jax(np.asarray(h), llr, 8, variant,
                          row_scaled=variant == "ENMS")


def test_k6_degree_one_row_sends_big():
    """A row of degree 1 sends w_chk * 3.4e38 (the TPU kernel's clamp), and
    zero rows are inert, as in JAX."""
    h = np.array([[1, 1, 1, 0], [0, 0, 0, 1], [0, 0, 0, 0]], np.float32)
    llr = np.random.default_rng(3).normal(0.5, 1.0, (8, 4)).astype(np.float32)
    got = _check_k6_against_jax(h, llr, 1, "NMS-1")
    assert np.abs(got[:, 3]).min() > 1e37


@pytest.mark.parametrize("name", DENSE_RUNG_CODES)
def test_k6_twin_equals_k1_twin_and_dense_decoder(name):
    code = get_code(name)
    p, _ = _params("NMS-1")
    llr = torch.as_tensor(np.random.default_rng(4).normal(
        1.0, 0.8, (64, code.n)).astype(np.float32))
    got = nms_dense.decode_final_dense(p, _h(code), llr, 12)
    k1 = nms_edge._decode_edge_plain(llr, code.h, 12,
                                     nms.scalar_weights(p, "NMS-1"), False)
    assert torch.equal(got, k1)
    ref = nms.decode_final(p, code.h, llr, 12)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=TOL, atol=TOL)
    assert torch.equal(got < 0, ref < 0)


def test_k6_refusals():
    code = get_code("ccsds_128_64")
    p, _ = _params("NMS-r", code.h)
    llr = torch.zeros((4, code.n))
    with pytest.raises(ValueError, match="NMS-r"):
        nms_dense.decode_final_dense(p, _h(code), llr, 4, "NMS-r")
    wimax = get_code("wimax_1056_880")
    with pytest.raises(ValueError, match="does not hold"):
        nms_dense.decode_final_dense(_params("NMS-1")[0], _h(wimax),
                                     torch.zeros((4, wimax.n)), 4)


def test_holds_the_five_dense_rung_codes():
    for name in DENSE_RUNG_CODES:
        code = get_code(name)
        assert nms_dense.holds(code.m, code.n)
        assert nms_dense.holds(code.m, code.n, code.k)
    for name in ("wimaxlike_384_192", "wimax_1056_880"):
        code = get_code(name)
        assert not nms_dense.holds(code.m, code.n)
    # the layout's words: the slab tables (2 + dc m + dv n) and one frame
    # (dc m + 2n) of the densest (64, 128) mask, dc = 128 and dv = 64
    assert nms_dense.smem_bytes(64, 128) == 4 * (2 + 2 * 8192 + 8192 + 256)


# --- the capture step's decoders ---------------------------------------------

@pytest.mark.parametrize("name,variant,device,kw,want", [
    ("ccsds_128_64", "NMS-1", "cpu", {}, "edge"),
    ("ccsds_128_64", "NMS-1", "cuda", {}, "edge"),
    ("ccsds_128_64", "NMS-r", "cpu", {}, "plain"),
    ("ccsds_128_64", "NMS-r", "cuda", {}, "edge"),  # NMS-r's own kernel
    ("ccsds_128_64", "NMS-r", "cuda", {"batch": 1024}, "edge"),  # any batch
    ("qc_96_48", "NMS-r", "cuda", {}, "plain"),  # irregular: not supported
    # dc 11: no NMS-r kernel, so the padded layout from NMS_R_MIN_BATCH up
    ("array_121_60", "NMS-r", "cuda", {}, "edge_padded"),
    ("array_121_60", "NMS-r", "cuda", {"batch": 1024}, "plain"),
    ("ccsds_128_64", "NMS-r", "cuda", {"decoder": "edge_padded"}, "edge_padded"),
    ("ccsds_128_64", "NMS-r", "cpu", {"decoder": "edge"}, "edge"),  # the twin
    ("wimax_1056_880", "NMS-1", "cuda", {}, "edge"),
    ("ccsds_128_64", "NMS-1", "cuda", {"decoder": "plain"}, "plain"),
    ("ccsds_128_64", "NMS-1", "cpu", {"decoder": "edge_padded"}, "edge_padded"),
    ("ccsds_128_64", "NMS-1", "cpu", {"decoder": "dense"}, "dense"),
])
def test_select_decoder(name, variant, device, kw, want):
    """The port's defaults at 4,096 frames unless stated (the decision
    reads the device's type only, so "cuda" needs no card here)."""
    h = get_code(name).h
    kw = {"batch": 4096} | kw
    assert harness.select_decoder(h, variant, device=device, **kw) == want


@pytest.mark.parametrize("name,holds", [
    ("ccsds_128_64", True), ("code1_64_32", True),  # regular, dc 8 and 6
    ("qc_96_48", False), ("wimaxlike_384_192", False),  # irregular
    ("array_121_60", False), ("wimax_1056_880", False),  # dc 11 and 20
])
def test_nmsr_kernel_route_leaves_the_trainer_padded(name, holds):
    """On CUDA NMS-r's capture step and re-decode take its edge kernel
    where it holds the code (a regular check degree of bucket 0), at every
    batch; the trainer, which needs gradients, keeps the padded layout
    wherever the layout supports the code."""
    h = get_code(name).h
    assert nms_edge.kernel_holds(h, "NMS-r") is holds
    for batch in (256, 262_144):
        picked = harness.select_decoder(h, "NMS-r", batch, device="cuda")
        route = engine.redecode_route(h, "NMS-r", torch.device("cuda"), batch)
        assert (picked == "edge") is holds and (route == "edge") is holds
    assert (nms_edge_padded.train_select(h, "NMS-r", "cuda")
            is nms_edge_padded.supports(h, "NMS-r"))


@pytest.mark.parametrize("name,variant,decoder", [
    ("wimax_1056_880", "NMS-1", "dense"), ("qc_96_48", "NMS-r", "edge"),
    ("array_121_60", "NMS-r", "edge"),  # dc 11: above NMS-r's kernel bucket
    ("ccsds_128_64", "NMS-r", "dense"), ("qc_96_48", "NMS-r", "edge_padded"),
    ("ccsds_128_64", "NMS-1", "xla")])
def test_pinned_decoder_that_cannot_take_the_code_raises(name, variant, decoder):
    with pytest.raises(ValueError):
        harness.select_decoder(get_code(name).h, variant, 4096, decoder=decoder,
                               device="cpu")


def test_capture_step_dense_equals_edge():
    """The capture step pinned to K6 equals the default K1 step on the same
    generator: counters, capture count and buffers (the card's gate)."""
    code = get_code("ccsds_128_64")
    spec = ChannelSpec.awgn(2.5, code.rate)
    p, _ = _params("NMS-1")
    out = {}
    for decoder in ("edge", "dense"):
        step = harness.build_nms_mc_step(code, "NMS-1", 12, spec, 512,
                                         capture_capacity=64, decoder=decoder,
                                         device="cpu")
        assert step.decoder == decoder
        out[decoder] = step(p, torch.Generator().manual_seed(7))
    (ce, cap_e), (cd, cap_d) = out["edge"], out["dense"]
    assert torch.equal(ce, cd) and int(cap_e["count"]) > 0
    for key in ("count", "llr", "labels"):
        assert torch.equal(cap_e[key], cap_d[key])


def test_no_dense_launch_counted_on_cpu():
    _kernels.reset_launches()
    code = get_code("code1_64_32")
    mc_dense.fused_counters(code, _params("NMS-1")[0], "NMS-1", 4, 3.0, 64, 1,
                            device="cpu")
    nms_dense.decode_final_dense(_params("NMS-1")[0], _h(code),
                                 torch.zeros((4, code.n)), 4)
    assert sum(_kernels.LAUNCHES.values()) == 0
    assert {"dense_final", "mc_dense"} <= set(_kernels.LAUNCHES)
