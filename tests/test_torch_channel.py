"""Port channel/awgn.py and utils/metrics.py vs the JAX package (CPU).

The host-side quantities (sigma, blend quadrature, Wilson intervals, stats
containers) are equal to the JAX package's to 1e-9 or exactly; the samplers
draw from a torch.Generator, not a JAX key, so they are held by moments."""

import math

import numpy as np
import pytest
import torch

from short_ldpc_decoding_osd_tpu.channel import awgn as jawgn
from short_ldpc_decoding_osd_tpu.utils import metrics as jmetrics
from short_ldpc_decoding_osd_tpu_torch.channel import awgn
from short_ldpc_decoding_osd_tpu_torch.codes import get_code
from short_ldpc_decoding_osd_tpu_torch.utils import metrics

from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("snr_lo,snr_hi,rate", [
    (1.0, 4.0, 0.5), (2.5, 2.5, 0.5), (0.0, 6.0, 880 / 1056)])
def test_sigma_and_blend_match_jax(snr_lo, snr_hi, rate):
    assert awgn.sigma_for_snr(snr_hi, rate) == jawgn.sigma_for_snr(snr_hi, rate)
    got = awgn.blend_moments(snr_lo, snr_hi, rate)
    want = jawgn.blend_moments(snr_lo, snr_hi, rate)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    spec, jspec = (awgn.ChannelSpec.blend(snr_lo, snr_hi, rate),
                   jawgn.ChannelSpec.blend(snr_lo, snr_hi, rate))
    assert math.isclose(spec.sigma, jspec.sigma, rel_tol=1e-9)
    ray, jray = (awgn.ChannelSpec.rayleigh_spec(snr_hi, rate, 2.0),
                 jawgn.ChannelSpec.rayleigh_spec(snr_hi, rate, 2.0))
    assert (ray.rayleigh, ray.fading_block, ray.sigma) == (
        jray.rayleigh, jray.fading_block, jray.sigma)


def test_rayleigh_sampler_moments():
    code = get_code("ccsds_128_64")
    spec = awgn.ChannelSpec.rayleigh_spec(80.0, code.rate)  # sigma 1e-4
    llr, words = awgn.sample_batch(torch.Generator().manual_seed(9), spec,
                                   torch.as_tensor(code.g), 4096)
    gain = (llr * (1 - 2 * words)).numpy().reshape(-1)
    # unit-power Rayleigh: E[g^2] = 1, E[g] = sqrt(pi)/2
    assert abs((gain ** 2).mean() - 1.0) < 0.02
    assert abs(gain.mean() - math.sqrt(math.pi) / 2) < 0.01
    # constant over blocks of fading_block consecutive samples
    blocks = gain.reshape(-1, spec.fading_block)
    np.testing.assert_allclose(blocks, blocks[:, :1].repeat(spec.fading_block, 1),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("k,n,z", [(0, 10, 1.96), (3, 10, 2.5758),
                                   (217_683, 2_097_152, 3.2905), (5, 0, 1.96)])
def test_wilson_and_stats_match_jax(k, n, z):
    assert metrics.wilson_interval(k, n, z) == jmetrics.wilson_interval(k, n, z)
    fields = dict(frames=n, frame_errors=k, bit_errors=3 * k, bits_per_frame=128,
                  detected_failures=k // 2, undetected_errors=k - k // 2)
    a, ja = metrics.DecodeStats(**fields), jmetrics.DecodeStats(**fields)
    b, jb = metrics.DecodeStats(frames=7, frame_errors=1), jmetrics.DecodeStats(
        frames=7, frame_errors=1)
    assert a.merge(b).to_dict() == ja.merge(jb).to_dict()
    assert a.fer_confidence(z) == ja.fer_confidence(z)
