"""K8 (``cascade_counters``) of the port vs JAX's interpret-mode K8 Pallas
kernels and the compaction-rule golden (CPU), including a real forced
capacity overflow and its retry."""

import numpy as np
import torch

from short_ldpc_decoding_osd_tpu.codes import get_code as jax_get_code
from short_ldpc_decoding_osd_tpu.ops import mc_cascade as jcascade
from short_ldpc_decoding_osd_tpu.ops import nms as jnms
from short_ldpc_decoding_osd_tpu_torch.codes import get_code
from short_ldpc_decoding_osd_tpu_torch.ops import mc_cascade
from torch_mc_common import ATOL, _golden, _params

from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)


# --- K8 against the Pallas kernels (interpret mode) --------------------------

def test_cascade_matches_jax_pallas():
    code, jcode = get_code("ccsds_128_64"), jax_get_code("ccsds_128_64")
    batch, t1, T, seed = 1024, 4, 8, 11
    ref = np.asarray(jcascade.cascade_counters(
        jcode, jnms.init_params("NMS-1"), "NMS-1", T, 3.0, batch, seed, t1=t1,
        block_frames=256, mode="highest", interpret=True))
    got = mc_cascade.cascade_counters(code, _params(), "NMS-1", T, 3.0, batch,
                                      seed, t1=t1, block_frames=256, device="cpu")
    assert got.dtype == torch.int64 and int(got[0]) == batch
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)
    want, _ = _golden("ccsds_128_64", seed, batch, T, stages=((t1, batch),),
                      block=batch)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_cascade_overflow_retry(monkeypatch):
    """A calibration cache poisoned with share 0 gives a capacity far below
    the flagged frames: the retry doubles it until every frame is counted,
    with the counters of an ample capacity.  The case of
    tests/test_mc_cascade.py (1.0 dB, t1 = 2, T = 6) against JAX too."""
    code = get_code("ccsds_128_64")
    args = (code, _params(), "NMS-1", 6, 1.0, 512, 5)
    kw = dict(t1=2, block_frames=128, device="cpu")
    monkeypatch.setattr(mc_cascade, "_CAP_CACHE", {})
    ample = mc_cascade.cascade_counters(*args, **kw)
    key = next(iter(mc_cascade._CAP_CACHE))
    assert mc_cascade._CAP_CACHE[key] > 0.5  # most frames unconverged at t1
    mc_cascade._CAP_CACHE[key] = 0.0
    calls = []
    phase2 = mc_cascade.phase2
    monkeypatch.setattr(mc_cascade, "phase2",
                        lambda mc, t, ids: calls.append(len(ids)) or phase2(mc, t, ids))
    poisoned = mc_cascade.cascade_counters(*args, **kw)
    assert calls == [384, 512]  # 6 + 2 * 128 rounded up, then doubled (<= batch)
    assert int(poisoned[0]) == 512
    np.testing.assert_array_equal(poisoned.numpy(), ample.numpy())
    ref = np.asarray(jcascade.cascade_counters(
        jax_get_code("ccsds_128_64"), jnms.init_params("NMS-1"), "NMS-1", 6,
        1.0, 512, 5, t1=2, block_frames=128, mode="highest", interpret=True))
    np.testing.assert_allclose(poisoned.numpy(), ref, atol=ATOL)

