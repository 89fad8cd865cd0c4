"""Helpers shared by the port's phase-1 Monte-Carlo tests
(``tests/test_torch_mc_*.py``): the numpy golden of the hash sampler and
the compaction rule written out over JAX's XLA decoder.  Not collected by
pytest (no ``test_`` prefix).

The JAX side of K3 and K4 cannot run on the CPU: those Pallas kernels draw
from the TPU's on-core PRNG, which has no CPU interpret lowering.  So the
port's K3 and K4 (which draw from the hash sampler instead) are held
against goldens built from the numpy sampler and JAX's XLA decoder
(``nms.decode``), with the compaction rule written out in numpy.  Counter
tolerance is ``ATOL`` = 2 frames throughout, the tolerance of
``tests/test_mc_cascade.py``: f32 rounding differences between decoders on
razor-edge soft values can flip a frame.
"""

import jax.numpy as jnp
import numpy as np

from short_ldpc_decoding_osd_tpu.channel import sigma_for_snr
from short_ldpc_decoding_osd_tpu.codes import get_code as jax_get_code
from short_ldpc_decoding_osd_tpu.ops import mc_cascade as jcascade
from short_ldpc_decoding_osd_tpu.ops import nms as jnms
from short_ldpc_decoding_osd_tpu_torch.ops import nms

_MASK = np.uint64(0xFFFFFFFF)
ATOL = 2


# --- numpy golden of the hash sampler (as tests/test_mc_cascade.py) -------

def _mix_np(x):
    """numpy golden of mc_cascade._mix (uint64 carrier, 32-bit wrap)."""
    x = x.astype(np.uint64) & _MASK
    x ^= x >> np.uint64(16)
    x = (x * np.uint64(0x85EBCA6B)) & _MASK
    x ^= x >> np.uint64(13)
    x = (x * np.uint64(0xC2B2AE35)) & _MASK
    x ^= x >> np.uint64(16)
    return x & _MASK


def _sample_np(fids, seed, code, sigma, mean=1.0):
    """numpy golden of mc_cascade._sample (exact integer path; f64 waveform)."""
    n, k = code.n, code.k
    gold1 = np.uint64(np.uint32(jcascade._GOLD1))
    gold2 = np.uint64(np.uint32(jcascade._GOLD2))
    base = _mix_np((fids.astype(np.uint64) * gold1 + np.uint64(seed)) & _MASK)
    streams = np.arange(1, k + 1, dtype=np.uint64)
    words = _mix_np(base[:, None] ^ ((streams[None, :] * gold2) & _MASK))
    msg = (words & np.uint64(1)).astype(np.int64)
    codeword = (msg @ code.g.astype(np.int64)) % 2
    sn = np.arange(n, dtype=np.uint64)
    w1 = _mix_np(base[:, None] ^ (((sn + np.uint64(k + 1)) * gold2) & _MASK))
    w2 = _mix_np(base[:, None] ^ (((sn + np.uint64(k + 1 + n)) * gold2) & _MASK))
    u1 = (w1 >> np.uint64(8)).astype(np.float64) / 16777216.0 + 0.5 / 16777216.0
    u2 = (w2 >> np.uint64(8)).astype(np.float64) / 16777216.0 + 0.5 / 16777216.0
    z = np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)
    llr = (1.0 - 2.0 * codeword) * (mean + sigma * z)
    return codeword, llr, words



# --- the compaction rule written out over JAX's XLA decoder --------------

def _golden(code_name, seed, batch, num_iterations, snr_db=3.0, stages=(),
            block=None, params=None, variant="NMS-1"):
    """Counters [frames, frame_err, bit_err, detected, undetected] and the
    overflow count of the hash frames ``0..batch-1`` decoded by ``variant``
    with the JAX parameter tree ``params`` (default: NMS-1's initial
    factor) under the rule: at each
    stage ``(cumulative iterations, rows)`` a frame with a zero syndrome is
    judged there, and of each ``block`` group's alive unconverged frames
    (frame order) those ranked >= rows are judged there too (overflow);
    the rest go on; frames alive at the end are judged at T."""
    code = jax_get_code(code_name)
    h = code.h.astype(np.int64)
    sigma = float(sigma_for_snr(snr_db, code.rate))
    codeword, llr, _ = _sample_np(np.arange(batch), seed, code, sigma)
    outs = np.asarray(jnms.decode(
        jnms.init_params("NMS-1") if params is None else params,
        jnp.asarray(code.h, jnp.float32), jnp.asarray(llr, jnp.float32),
        num_iterations, variant))
    decision = outs[num_iterations] < 0
    alive = np.ones(batch, bool)
    overflow = 0
    for cum_iters, rows in stages:
        hard = outs[cum_iters] < 0
        unconv = (hard.astype(np.int64) @ h.T % 2).any(axis=1)
        u = (alive & unconv).reshape(-1, block)
        rank = np.cumsum(u, axis=1) - u
        covered = (u & (rank < rows)).ravel()
        judged = alive & ~covered
        decision[judged] = hard[judged]
        overflow += int((alive & unconv & ~covered).sum())
        alive = covered
    err = decision != codeword
    frame_err = err.any(axis=1)
    synd = (decision.astype(np.int64) @ h.T % 2).any(axis=1)
    counters = np.array([batch, frame_err.sum(), err.sum(),
                         (frame_err & synd).sum(), (frame_err & ~synd).sum()])
    return counters, overflow


def _params():
    return nms.init_params("NMS-1")



def _kseed(seed, idx):
    """The per-step seed ``run_nms_mc`` derives from its seed and index."""
    return (seed * 100003 + idx) & 0x7FFFFFFF
