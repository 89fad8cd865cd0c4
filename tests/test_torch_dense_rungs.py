"""The dense Monte-Carlo kernel K7 of the port and the pinned rungs of the
harness (``mc/ladder.py``, ``run_nms_mc(rung=)``) vs the JAX package
(CPU); K6 and the capture step's decoders are in
``tests/test_torch_dense.py``.

On the CPU the wrappers run the kernels' plain twins.  Tolerances:

* K7's counters against JAX (the same hash frames through JAX's XLA
  decoder and the count rule of ``mc_pallas.py:199-207``): 2 frames per
  lane, the tolerance of ``tests/test_mc_cascade.py``: f32 rounding
  differences between decoders can flip a razor-edge frame.
* K7's twin against K4's twin on one seed: exact (same frames, same
  arithmetic).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from short_ldpc_decoding_osd_tpu.channel import sigma_for_snr
from short_ldpc_decoding_osd_tpu.codes import get_code as jax_get_code
from short_ldpc_decoding_osd_tpu.ops import mc_cascade as jcascade
from short_ldpc_decoding_osd_tpu.ops import nms as jnms
from short_ldpc_decoding_osd_tpu_torch.channel import ChannelSpec
from short_ldpc_decoding_osd_tpu_torch.codes import get_code
from short_ldpc_decoding_osd_tpu_torch.mc import harness, ladder
from short_ldpc_decoding_osd_tpu_torch.ops import mc_dense, nms, nms_edge
from short_ldpc_decoding_osd_tpu_torch.utils.metrics import DecodeStats

from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

ATOL = 2


def _params(variant, h=None):
    """Port and JAX parameters of the same values."""
    jp = jnms.init_params(variant, h)
    return {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}, jp


def _h(code):
    return torch.as_tensor(np.asarray(code.h), dtype=torch.float32)


# --- K7 --------------------------------------------------------------------

def _jax_sample(fids, seed, code, sigma):
    """JAX's ``mc_cascade._sample`` through a tiny interpret-mode kernel."""
    from jax.experimental import pallas as pl

    b, n, k = fids.shape[0], code.n, code.k

    def kern(f_ref, g_ref, cw_ref, llr_ref):
        cw, llr = jcascade._sample(f_ref[:], jnp.int32(seed), g_ref[:],
                                   jnp.float32(sigma), jnp.float32(1.0), n, k)
        cw_ref[:] = cw
        llr_ref[:] = llr

    shape = jax.ShapeDtypeStruct((b, n), jnp.float32)
    return pl.pallas_call(kern, out_shape=(shape, shape), interpret=True)(
        jnp.asarray(fids, jnp.int32)[:, None], jnp.asarray(code.g, jnp.float32))


def _jax_counts(code, variant, iters, snr_db, batch, seed):
    """The JAX side of K7: its hash frames, its XLA decoder, and the count
    rule of mc_pallas.py:199-207 written out in numpy."""
    cw, llr = _jax_sample(np.arange(batch), seed, code,
                          float(sigma_for_snr(snr_db, code.rate)))
    soft = np.asarray(jnms.decode_final(jnms.init_params(variant),
                                        jnp.asarray(code.h, jnp.float32), llr,
                                        iters, variant))
    hard = (soft < 0).astype(np.float32)
    err = np.abs(hard - np.asarray(cw))
    frame_err = err.max(axis=1)
    detected = ((hard @ code.h.T.astype(np.float32)) % 2).max(axis=1)
    undetected = np.maximum(frame_err - detected, 0.0)
    return np.array([batch, frame_err.sum(), err.sum(), detected.sum(),
                     undetected.sum()])


@pytest.mark.parametrize("name,variant", [("ccsds_128_64", "NMS-1"),
                                          ("qc_96_48", "NMS-3")])
def test_k7_counts_match_jax(name, variant):
    got = mc_dense.fused_counters(get_code(name), _params(variant)[0], variant, 8,
                                  2.5, 512, 17, device="cpu")
    assert got.dtype == torch.int64 and got.shape == (5,) and int(got[0]) == 512
    want = _jax_counts(jax_get_code(name), variant, 8, 2.5, 512, 17)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_k7_count_rule_matches_frame_stats():
    """count_frames is the harness's counters on the same decisions."""
    code = get_code("qc_96_48")
    rng = np.random.default_rng(5)
    soft = torch.as_tensor(rng.normal(0.3, 1.0, (256, code.n)).astype(np.float32))
    words = torch.as_tensor(rng.integers(0, 2, (256, code.n)).astype(np.int32))
    got = mc_dense.count_frames(soft, words.to(torch.float32), _h(code))
    want, _ = harness.count_and_capture(soft, words, soft, code.h)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["ccsds_128_64", "array_121_80"])
def test_k7_twin_equals_k4_twin(name):
    code = get_code(name)
    p, _ = _params("NMS-1")
    k7 = mc_dense.fused_counters(code, p, "NMS-1", 12, 3.0, 1024, 9, device="cpu")
    k4 = nms_edge.fused_counters_edge(code, p, "NMS-1", 12, 3.0, 1024, 9,
                                      device="cpu")
    assert torch.equal(k7, k4)


# --- the ladder and the pinned rungs -----------------------------------------

def test_ladder_rungs_and_blocks():
    assert ladder.RUNGS == ("compact", "oneshot", "dense", "xla")
    assert ladder.apply_pinned_rung(None) is None
    assert ladder.apply_pinned_rung("") is None
    for rung in ladder.RUNGS:
        assert ladder.apply_pinned_rung(rung) == rung
    with pytest.raises(ValueError, match="compact|oneshot|dense|xla"):
        ladder.apply_pinned_rung("edge")
    assert ladder.ladder_blocks(262_144, 12) == (512, True)
    assert ladder.ladder_blocks(384, 12) == (128, True)
    assert ladder.ladder_blocks(96, 12) == (32, False)
    assert ladder.ladder_blocks(1024, 5) == (512, False)


def _kseed(seed, idx):
    return (seed * 100003 + idx) & 0x7FFFFFFF


def test_run_nms_mc_dense_rung(monkeypatch):
    """rung="dense" runs K7 every step with the step seeds of the fused
    branch; with no overflow it decodes the default rung's frames, so the
    two sweeps agree exactly."""
    code = get_code("ccsds_128_64")
    p, _ = _params("NMS-1")
    calls = []
    real = mc_dense.fused_counters

    def spy(*a, **k):
        calls.append(k["seed"])
        return real(*a, **k)

    kw = dict(batch=256, error_budget=40, seed=3, device="cpu")
    monkeypatch.setattr(mc_dense, "fused_counters", spy)
    dense, _ = harness.run_nms_mc(code, p, "NMS-1", 8, 3.0, rung="dense", **kw)
    monkeypatch.undo()
    assert calls == [_kseed(3, i) for i in range(len(calls))] and len(calls) >= 2
    default, _ = harness.run_nms_mc(code, p, "NMS-1", 8, 3.0, **kw)
    assert dense == default
    want = DecodeStats(bits_per_frame=code.n)
    for s in calls:
        c = real(code, p, "NMS-1", 8, 3.0, 256, s, device="cpu").numpy()
        want = want.merge(DecodeStats(*map(int, c[:3]), code.n, int(c[3]), int(c[4])))
    assert dense == want


def test_run_nms_mc_oneshot_and_xla_rungs():
    code = get_code("ccsds_128_64")
    p, _ = _params("NMS-1")
    kw = dict(batch=256, max_frames=512, seed=5, device="cpu")
    oneshot, _ = harness.run_nms_mc(code, p, "NMS-1", 8, 3.0, rung="oneshot", **kw)
    want = sum(nms_edge.fused_counters_edge(code, p, "NMS-1", 8, 3.0, 256,
                                            _kseed(5, i), device="cpu").numpy()
               for i in range(2))
    assert (oneshot.frames, oneshot.frame_errors) == (int(want[0]), int(want[1]))
    xla, _ = harness.run_nms_mc(code, p, "NMS-1", 8, 3.0, rung="xla", **kw)
    built = harness.build_nms_mc_step(code, "NMS-1", 8, ChannelSpec.awgn(
        3.0, code.rate), 256, decoder="plain", device="cpu")
    gen = torch.Generator()
    total = 0
    for i in range(2):
        gen.manual_seed(5 * 1_000_003 + i)
        total = total + built(p, gen)[0].numpy()
    assert (xla.frames, xla.frame_errors, xla.bit_errors) == tuple(
        int(x) for x in total[:3])


@pytest.mark.parametrize("case", [
    dict(name="wimax_1056_880", variant="NMS-1", rung="dense", batch=64),
    dict(name="qc_96_48", variant="ENMS", rung="dense", batch=64),
    dict(name="ccsds_128_64", variant="NMS-r", rung="oneshot", batch=64),
    dict(name="ccsds_128_64", variant="NMS-1", rung="compact", batch=96),
    dict(name="ccsds_128_64", variant="NMS-1", rung="dense", batch=100),
    dict(name="ccsds_128_64", variant="NMS-1", rung="bogus", batch=64),
], ids=["dense_big_code", "dense_enms", "oneshot_nmsr", "compact_small_batch",
        "dense_ragged_batch", "unknown"])
def test_pinned_rung_that_cannot_take_the_code_raises(case):
    code = get_code(case["name"])
    p = nms.init_params(case["variant"], code.h)
    with pytest.raises(ValueError):
        harness.run_nms_mc(code, p, case["variant"], 8, 3.0, batch=case["batch"],
                           max_frames=case["batch"], rung=case["rung"],
                           device="cpu")


def test_pinned_rung_with_capture_raises():
    code = get_code("ccsds_128_64")
    with pytest.raises(ValueError, match="fused"):
        harness.run_nms_mc(code, nms.init_params("NMS-1"), "NMS-1", 8, 3.0,
                           batch=64, capture_failures=True, rung="dense",
                           device="cpu")



@pytest.mark.parametrize("entry", [
    lambda: mc_dense.fused_counters(get_code("ccsds_128_64"),
                                    nms.init_params("NMS-1"), "NMS-1", 4, 3.0, 64, 1),
    lambda: harness.run_nms_mc(get_code("ccsds_128_64"), nms.init_params("NMS-1"),
                               "NMS-1", 8, 3.0, rung="dense"),
    lambda: harness.build_nms_mc_step(get_code("ccsds_128_64"), "NMS-1", 8,
                                      ChannelSpec.awgn(3.0, 0.5), 64,
                                      decoder="dense"),
], ids=["fused_counters", "run_nms_mc_dense", "build_nms_mc_step_dense"])
def test_cuda_default_raises_without_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()
