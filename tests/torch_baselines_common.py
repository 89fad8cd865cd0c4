"""Shared inputs of the port's baseline tests (``test_torch_baselines_*``):
the small code of ``tests/test_baselines.py`` built by both packages, its
numpy-seeded noisy batches, the 256 CCSDS failure frames of
``runs/refparity/base_failures.npz`` with the JAX package's record of
them, and helpers that run a JAX baseline and its port on the same
inputs."""

import os

import jax.numpy as jnp
import numpy as np

from short_ldpc_decoding_osd_tpu.codes import get_code as jax_get_code
from short_ldpc_decoding_osd_tpu.codes import make_regular_ldpc as jax_make_regular_ldpc
from short_ldpc_decoding_osd_tpu_torch.codes import get_code, make_regular_ldpc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFPARITY = os.path.join(ROOT, "runs", "refparity")
# the frames where the .npz's PB cost fields (a TPU record) differ from the
# JAX package run live on the CPU
PB_RECORD_DIFF_FRAMES = [36, 126, 128, 145, 194]


def small_codes():
    """(port code, JAX code) of ``make_regular_ldpc(48, 24, row_weight=6,
    seed=9)``, with equal G."""
    port = make_regular_ldpc(48, 24, row_weight=6, seed=9)
    jax_code = jax_make_regular_ldpc(48, 24, row_weight=6, seed=9)
    assert np.array_equal(port.g, jax_code.g)
    return port, jax_code


def ccsds_codes():
    port, jax_code = get_code("ccsds_128_64"), jax_get_code("ccsds_128_64")
    assert np.array_equal(port.g, jax_code.g)
    return port, jax_code


def noisy_batch(code, batch, snr_db, seed):
    """``tests/test_baselines.py``'s ``_noisy_batch``: BPSK over AWGN from a
    numpy generator, (llr f32, words int32)."""
    rng = np.random.default_rng(seed)
    words = code.encode(rng.integers(0, 2, (batch, code.k)))
    sigma = np.sqrt(1.0 / (2 * code.rate * 10 ** (snr_db / 10)))
    rx = 1.0 + sigma * rng.standard_normal((batch, code.n))
    llr = np.where(words == 0, rx, -rx).astype(np.float32)
    return llr, words.astype(np.int32)


def refparity():
    """The 256 failure frames at 3.0 dB and the JAX package's per-frame
    record of its baselines on them (``scripts/reference_parity.py``)."""
    return dict(np.load(os.path.join(REFPARITY, "base_failures.npz")))


def jax_np(out: dict) -> dict:
    """A JAX baseline's output dict as numpy."""
    return {k: np.asarray(v) for k, v in out.items()}


def port_np(out: dict) -> dict:
    """A port baseline's output dict as numpy."""
    return {k: v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v)
            for k, v in out.items()}


def jax_args(llr, words):
    return jnp.asarray(llr), jnp.asarray(words)


def assert_outputs_equal(port: dict, jax_out: dict, label=""):
    """Every field of a baseline's output equal, value for value."""
    assert set(port) == set(jax_out), (label, set(port) ^ set(jax_out))
    for key, want in jax_out.items():
        got = port[key]
        assert got.shape == want.shape, (label, key)
        diff = np.flatnonzero(np.ravel(got != want))
        assert diff.size == 0, (label, key, diff[:10])
