"""The padded edge layout (``ops/nms_edge_padded.py``) vs JAX's edge-layout
XLA decoder and vs the port's dense decoder (CPU).

Mirrors ``tests/test_nms_edge_xla.py``.  Tolerances: 1e-4 abs against JAX
``decode_edge_xla(mode="highest")`` and the dense decoder (the two sum the
column totals in different orders, f32 rounding only) with identical hard
decisions; NMS-r 1e-3 relative to the largest output (untrained NN weights
make magnitudes explode, which amplifies reorder noise absolutely but not
relatively); gradients 1e-4 abs and rel, JAX's tolerance for the same
comparison (``test_gradients_match_dense``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from short_ldpc_decoding_osd_tpu.codes import get_code as jax_get_code
from short_ldpc_decoding_osd_tpu.ops import nms as jnms
from short_ldpc_decoding_osd_tpu.ops import nms_edge_xla as jxla
from short_ldpc_decoding_osd_tpu_torch.channel import ChannelSpec
from short_ldpc_decoding_osd_tpu_torch.codes import get_code
from short_ldpc_decoding_osd_tpu_torch.mc import harness
from short_ldpc_decoding_osd_tpu_torch.ops import nms, nms_edge_padded as pad

from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)


def _params(variant, h=None):
    jp = jnms.init_params(variant, h)
    return {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}, jp


@pytest.mark.parametrize("name", ["ccsds_128_64", "wimax_1056_880"])
@pytest.mark.parametrize("variant", ["NMS-1", "NMS-2", "NMS-3"])
def test_matches_jax_edge_xla_and_dense(name, variant):
    code = jax_get_code(name)
    llr = np.random.default_rng(0).normal(1.0, 0.8, (32, code.n)).astype(np.float32)
    p, jp = _params(variant)
    h = np.asarray(code.h)
    got = pad.decode_edge_padded(p, h, torch.as_tensor(llr), 6, variant).numpy()
    ref = np.asarray(jxla.decode_edge_xla(jp, h, jnp.asarray(llr), 6, variant,
                                          mode="highest"))
    assert got.shape == (7, 32, code.n)
    assert np.abs(ref - got).max() < 1e-4
    assert np.array_equal(np.sign(ref[-1]), np.sign(got[-1]))
    gotf = pad.decode_final_edge_padded(p, h, torch.as_tensor(llr), 6,
                                        variant).numpy()
    reff = np.asarray(jxla.decode_final_edge_xla(jp, h, jnp.asarray(llr), 6,
                                                 variant, mode="highest"))
    assert np.abs(reff - gotf).max() < 1e-4
    np.testing.assert_array_equal(gotf, got[-1])
    dense = nms.decode(p, h, torch.as_tensor(llr), 6, variant).numpy()
    assert np.abs(dense - got).max() < 1e-4


def test_irregular_padding_inert():
    """Check degrees 2/3/4: padding slots perturb neither the tournament,
    the sign parity nor the column sums."""
    h = np.array([[1, 1, 0, 0, 0, 0], [0, 1, 1, 1, 0, 0], [1, 0, 1, 0, 1, 1]],
                 np.int8)
    cols, real = pad.edge_layout(h)
    jcols, jreal = jxla.edge_layout(h)
    np.testing.assert_array_equal(cols, jcols)
    np.testing.assert_array_equal(real, jreal)
    assert cols.shape == (3, 4) and real.sum() == h.sum()
    llr = np.random.default_rng(1).normal(0.5, 1.0, (16, 6)).astype(np.float32)
    p, jp = _params("NMS-1")
    got = pad.decode_edge_padded(p, h, torch.as_tensor(llr), 5).numpy()
    ref = np.asarray(jnms.decode(jp, jnp.asarray(h, jnp.float32), jnp.asarray(llr), 5))
    assert np.abs(ref - got).max() < 1e-5
    dense = nms.decode(p, h, torch.as_tensor(llr), 5).numpy()
    assert np.abs(dense - got).max() < 1e-5


def test_nms_r_matches_jax_and_dense_on_regular_code():
    code = jax_get_code("ccsds_128_64")
    llr = np.random.default_rng(2).normal(1.0, 0.8, (16, code.n)).astype(np.float32)
    p, jp = _params("NMS-r", code.h)
    h = np.asarray(code.h)
    got = pad.decode_edge_padded(p, h, torch.as_tensor(llr), 6, "NMS-r").numpy()
    for ref in (np.asarray(jxla.decode_edge_xla(jp, h, jnp.asarray(llr), 6, "NMS-r",
                                                mode="highest")),
                nms.decode(p, h, torch.as_tensor(llr), 6, "NMS-r",
                           nms.edge_columns(h)).numpy()):
        assert np.abs(ref - got).max() / max(np.abs(ref).max(), 1.0) < 1e-3
        assert np.array_equal(np.sign(ref[-1]), np.sign(got[-1]))


def test_nms_r_irregular_raises():
    h = np.array([[1, 1, 0, 0], [1, 1, 1, 0], [0, 1, 1, 1]], np.int8)
    assert not pad.supports(h, "NMS-r") and not jxla.supports(h, "NMS-r")
    assert pad.supports(h, "NMS-1")
    p, _ = _params("NMS-r", get_code("ccsds_128_64").h)
    with pytest.raises(ValueError, match="regular"):
        pad.decode_final_edge_padded(p, h, torch.zeros((4, 4)), 3, "NMS-r")


@pytest.mark.parametrize("name,variant,device,batch,want", [
    ("ccsds_128_64", "NMS-r", "cuda", 4096, False),  # NMS-r's kernel holds it
    ("ccsds_128_64", "NMS-r", "cuda", pad.NMS_R_MIN_BATCH, False),
    ("array_121_60", "NMS-r", "cuda", 4096, True),  # dc 11: no NMS-r kernel
    ("array_121_60", "NMS-r", "cuda", pad.NMS_R_MIN_BATCH, True),
    ("array_121_60", "NMS-r", "cuda", 1024, False),  # the dense step is faster
    ("ccsds_128_64", "NMS-r", "cuda", 1024, False),
    ("ccsds_128_64", "NMS-r", "cpu", 4096, False),
    ("qc_96_48", "NMS-r", "cuda", 4096, False),
    ("ccsds_128_64", "NMS-1", "cuda", 4096, False),  # K1 and K6 hold it
    ("wimax_1056_880", "NMS-1", "cuda", 4096, False),  # K1 holds it
])
def test_auto_select(name, variant, device, batch, want):
    assert pad.auto_select(get_code(name).h, variant, device, batch) is want


def test_harness_edge_padded_counters_match_plain():
    """The capture step pinned to the padded layout counts what the plain
    dense step counts on the same generator (JAX's
    test_harness_rung_counters_match_dense)."""
    code = get_code("ccsds_128_64")
    spec = ChannelSpec.awgn(3.0, code.rate)
    p, _ = _params("NMS-1")
    out = {}
    for decoder in ("edge_padded", "plain"):
        step = harness.build_nms_mc_step(code, "NMS-1", 8, spec, 512,
                                         decoder=decoder, device="cpu")
        out[decoder] = step(p, torch.Generator().manual_seed(3))[0]
    assert torch.equal(out["edge_padded"], out["plain"])


@pytest.mark.parametrize("name,variant", [
    ("wimax_1056_880", "NMS-1"), ("wimax_1056_880", "NMS-3"),
    ("ccsds_128_64", "NMS-r")])
def test_gradients_match_dense(name, variant):
    """The training loss gradient through the padded layout equals the
    dense decoder's to f32 reorder tolerance (gathers are linear and the
    argmin tie sets are the same); JAX checks NMS-3 only."""
    code = get_code(name)
    rng = np.random.default_rng(9)
    llr = torch.as_tensor(rng.normal(0.8, 1.0, (8, code.n)).astype(np.float32))
    words = torch.zeros((8, code.n), dtype=torch.int32)
    h = np.asarray(code.h)
    edge_cols = nms.edge_columns(h) if variant == "NMS-r" else None
    grads = []
    for fn in (lambda p: nms.decode(p, h, llr, 5, variant, edge_cols),
               lambda p: pad.decode_edge_padded(p, h, llr, 5, variant)):
        p = {k: v.clone().requires_grad_() for k, v in
             nms.init_params(variant, h).items()}
        nms.multi_iteration_loss(fn(p), words).backward()
        grads.append({k: v.grad.numpy() for k, v in p.items()})
    for k in grads[0]:
        np.testing.assert_allclose(grads[1][k], grads[0][k], rtol=1e-4, atol=1e-4)


def test_gradient_matches_jax_edge_xla():
    code = jax_get_code("ccsds_128_64")
    rng = np.random.default_rng(4)
    llr = rng.normal(0.8, 1.0, (8, code.n)).astype(np.float32)
    words = np.zeros((8, code.n), np.int32)
    h = np.asarray(code.h)
    import jax

    jgrad = jax.grad(lambda jp: jnms.multi_iteration_loss(
        jxla.decode_edge_xla(jp, h, jnp.asarray(llr), 5, "NMS-3"),
        jnp.asarray(words)))(jnms.init_params("NMS-3"))
    p = {k: v.clone().requires_grad_() for k, v in nms.init_params("NMS-3").items()}
    nms.multi_iteration_loss(pad.decode_edge_padded(
        p, h, torch.as_tensor(llr), 5, "NMS-3"), torch.as_tensor(words)).backward()
    for k in p:
        np.testing.assert_allclose(p[k].grad.numpy(), np.asarray(jgrad[k]),
                                   rtol=1e-4, atol=1e-4)
