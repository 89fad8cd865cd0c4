"""Port ops/nms.py and ops/nms_edge.py vs the JAX package (CPU).

The dense decoders compute the same sums in another order than XLA, so
soft values agree to 1e-5 (abs + rel) with identical hard decisions and
detected flags.  The JAX edge kernel (Pallas, interpret mode, "highest")
is itself ~3e-5 off the XLA decoder after 12 iterations, hence 1e-4 there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from short_ldpc_decoding_osd_tpu.codes import get_code as jax_get_code
from short_ldpc_decoding_osd_tpu.ops import nms as jnms
from short_ldpc_decoding_osd_tpu.ops import nms_edge_pallas as jedge
from short_ldpc_decoding_osd_tpu_torch import _kernels
from short_ldpc_decoding_osd_tpu_torch.ops import nms, nms_edge

from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)


def _params(variant, h, seed):
    """The same random-ish parameters for both packages (numpy leaves)."""
    rng = np.random.default_rng(seed)
    base = jnms.init_params(variant, h, seed=seed)
    # the NMS-r check net is scaled down so the messages stay bounded: with
    # its raw initial weights they grow ~10x per iteration and f32 rounding
    # differences grow with them
    return {k: (np.asarray(v) + rng.normal(0, 0.05, np.shape(v))).astype(np.float32)
            if v.size == 1 else 0.3 * np.array(v, np.float32)
            for k, v in base.items()}


def _llr(n, batch, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(1.0, 0.8, (batch, n)).astype(np.float32)


def _torch(params):
    return {k: torch.as_tensor(v) for k, v in params.items()}


def _jax(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


def _h(code_name, variant):
    code = jax_get_code(code_name)
    return code.extended().h if variant == "ENMS" else code.h


@pytest.mark.parametrize("variant", ["NMS-1", "NMS-2", "NMS-3", "NMS-r", "ENMS"])
def test_dense_decode_matches_jax(variant):
    h = _h("ccsds_128_64", variant)
    params = _params(variant, h, seed=1)
    llr = _llr(h.shape[1], 48, seed=2)
    cols = nms.edge_columns(h) if variant == "NMS-r" else None
    jcols = jnp.asarray(jnms.edge_columns(h)) if variant == "NMS-r" else None
    ref = np.asarray(jnms.decode(_jax(params), jnp.asarray(h, jnp.float32),
                                 jnp.asarray(llr), 8, variant, jcols))
    got = nms.decode(_torch(params), h, torch.as_tensor(llr), 8, variant,
                     cols).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_array_equal(got < 0, ref < 0)
    final = nms.decode_final(_torch(params), h, torch.as_tensor(llr), 8,
                             variant, cols).numpy()
    np.testing.assert_allclose(final, got[-1], **TOL)

    labels = (np.random.default_rng(3).uniform(size=llr.shape) < 0.1).astype(np.int32)
    st_ref = jnms.frame_stats(jnp.asarray(ref[-1]), jnp.asarray(labels),
                              jnp.asarray(h, jnp.float32))
    st = nms.frame_stats(torch.as_tensor(got[-1]), torch.as_tensor(labels), h)
    for key in ("frame_error", "bit_errors", "detected_failure",
                "undetected_error"):
        np.testing.assert_array_equal(st[key].numpy(), np.asarray(st_ref[key]))

    loss_ref = float(jnms.multi_iteration_loss(jnp.asarray(ref), jnp.asarray(labels)))
    loss = float(nms.multi_iteration_loss(torch.as_tensor(got), torch.as_tensor(labels)))
    assert abs(loss - loss_ref) <= 1e-5 * abs(loss_ref)


@pytest.mark.parametrize("code_name,variant", [
    ("ccsds_128_64", "NMS-1"),
    ("ccsds_128_64", "NMS-3"),
    ("qc_96_48", "NMS-1"),
])
def test_edge_matches_jax_pallas_interpret(code_name, variant):
    h = _h(code_name, variant)
    params = _params(variant, h, seed=4)
    llr = _llr(h.shape[1], 32, seed=5)
    ref_final = np.asarray(jedge.decode_final_edge(
        _jax(params), h, jnp.asarray(llr), 12, variant, block_frames=32,
        interpret=True, mode="highest"))
    ref_traj = np.asarray(jedge.decode_traj_edge(
        _jax(params), h, jnp.asarray(llr), 12, variant, block_frames=32,
        interpret=True, mode="highest"))
    final = nms_edge.decode_final_edge(_torch(params), h, torch.as_tensor(llr),
                                       12, variant).numpy()
    traj = nms_edge.decode_traj_edge(_torch(params), h, torch.as_tensor(llr),
                                     12, variant).numpy()
    np.testing.assert_allclose(final, ref_final, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(traj, ref_traj, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(traj < 0, ref_traj < 0)


@pytest.mark.parametrize("code_name,variant", [
    ("ccsds_128_64", "NMS-1"),
    ("ccsds_128_64", "NMS-2"),
    ("ccsds_128_64", "ENMS"),   # extended H: mixed row weights, dummy edges
    ("qc_96_48", "NMS-3"),      # irregular check degrees {6, 7}
])
def test_edge_matches_port_dense(code_name, variant):
    h = _h(code_name, variant)
    params = _torch(_params(variant, h, seed=6))
    llr = torch.as_tensor(_llr(h.shape[1], 64, seed=7))
    dense = nms.decode(params, h, llr, 12, variant).numpy()
    traj = nms_edge.decode_traj_edge(params, h, llr, 12, variant).numpy()
    final = nms_edge.decode_final_edge(params, h, llr, 12, variant).numpy()
    np.testing.assert_allclose(traj, dense, **TOL)
    np.testing.assert_array_equal(traj < 0, dense < 0)
    np.testing.assert_array_equal(final, traj[-1])
    st_d = nms.frame_stats(torch.as_tensor(dense[-1]), torch.zeros(llr.shape), h)
    st_e = nms.frame_stats(torch.as_tensor(final), torch.zeros(llr.shape), h)
    np.testing.assert_array_equal(st_e["detected_failure"].numpy(),
                                  st_d["detected_failure"].numpy())


@pytest.mark.parametrize("code_name", ["ccsds_128_64", "qc_96_48"])
def test_edge_layout_reconstructs_h(code_name):
    h = jax_get_code(code_name).h
    edge_col, var_edges = nms_edge.edge_layout(h)
    dc, m = edge_col.shape
    rebuilt = np.zeros_like(h)
    for j in range(dc):
        for c in range(m):
            if edge_col[j, c] >= 0:
                rebuilt[c, edge_col[j, c]] += 1
    np.testing.assert_array_equal(rebuilt, h)
    # each variable lists its edges in ascending check order
    for v in range(h.shape[1]):
        edges = var_edges[:, v][var_edges[:, v] >= 0]
        checks = edges % m
        np.testing.assert_array_equal(checks, np.flatnonzero(h[:, v]))
        np.testing.assert_array_equal(edge_col.reshape(-1)[edges], v)


def test_edge_wrappers_refuse_nms_r_and_count_no_cpu_launch():
    """The edge wrappers take NMS-r only where its kernel holds the code (a
    regular check degree of bucket 0): an irregular code raises.  On the
    CPU they run the plain twins and launch nothing."""
    irregular = jax_get_code("qc_96_48").h
    with pytest.raises(ValueError, match="NMS-r"):
        nms_edge.decode_final_edge(
            _torch(_params("NMS-r", irregular, 0)), irregular,
            torch.as_tensor(_llr(irregular.shape[1], 4, seed=8)), 4, "NMS-r")
    h = jax_get_code("ccsds_128_64").h
    llr = torch.as_tensor(_llr(h.shape[1], 4, seed=8))
    _kernels.reset_launches()
    nms_edge.decode_traj_edge({"check": torch.tensor([0.1])}, h, llr, 4)
    nms_edge.decode_final_edge(_torch(_params("NMS-r", h, 0)), h, llr, 4,
                               "NMS-r")
    assert sum(_kernels.LAUNCHES.values()) == 0  # the CPU runs the plain twin
