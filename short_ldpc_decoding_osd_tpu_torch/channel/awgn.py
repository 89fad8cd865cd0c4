"""Channel sampling: BPSK over AWGN (optionally Rayleigh block fading).

Port of ``short_ldpc_decoding_osd_tpu/channel/awgn.py`` with an explicit
``torch.Generator`` in place of a JAX key (the two give different numbers
from one seed; tests compare moments, or feed both the same numpy draws).
Semantics follow the reference:

* the LLR proxy is the *raw channel sample* (no 2y/sigma^2 scaling), mean
  +1 for bit 0 and -1 for bit 1 (``Training_data_gen_128/data_generating.py:69-77``);
  learned normalization factors depend on this convention;
* the training SNR-range blend takes (mean, sigma) from moments of
  ``f_w(x) = exp(-|x - sigma_mid|)`` over ``[sigma(snr_lo), sigma(snr_hi)]``;
* testing uses a fixed sigma per SNR point, optionally Rayleigh fading
  constant over blocks of ``fading_block`` samples.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from scipy import integrate


def sigma_for_snr(snr_db: float, rate: float) -> float:
    """AWGN noise sigma for Eb/N0 ``snr_db`` at code rate ``rate``."""
    return math.sqrt(1.0 / (2.0 * rate * 10.0 ** (snr_db / 10.0)))


def blend_moments(snr_lo: float, snr_hi: float, rate: float) -> tuple[float, float]:
    """(mean, sigma) of the SNR-blend importance density; (1, sigma(snr))
    when the endpoints coincide.  Host-side scipy quadrature."""
    s1 = sigma_for_snr(snr_lo, rate)
    s2 = sigma_for_snr(snr_hi, rate)
    if snr_lo == snr_hi:
        return 1.0, s1
    mid = sigma_for_snr((snr_lo + snr_hi) / 2.0, rate)

    def f_w(x):
        return math.exp(-abs(x - mid))

    def f1(x):
        return 2.0 / (x**2) * f_w(x)

    def f2(x):
        return 4.0 * (1.0 / x**2 + 1.0 / x**4) * f_w(x)

    norm, _ = integrate.quad(f_w, s1, s2)
    mean = integrate.quad(f1, s1, s2)[0] / norm
    second = integrate.quad(f2, s1, s2)[0] / norm
    return mean, math.sqrt(second - mean**2)


@dataclasses.dataclass(frozen=True)
class ChannelSpec:
    """Static channel description."""

    mean: float
    sigma: float
    rayleigh: bool = False
    fading_block: int = 16  # samples per constant-fading block

    @classmethod
    def awgn(cls, snr_db: float, rate: float) -> "ChannelSpec":
        return cls(mean=1.0, sigma=sigma_for_snr(snr_db, rate))

    @classmethod
    def blend(cls, snr_lo: float, snr_hi: float, rate: float) -> "ChannelSpec":
        mean, sigma = blend_moments(snr_lo, snr_hi, rate)
        return cls(mean=mean, sigma=sigma)

    @classmethod
    def rayleigh_spec(cls, snr_db: float, rate: float,
                      duration: float = 1.0) -> "ChannelSpec":
        # reference block structure: 16 samples per carrier period
        return cls(mean=1.0, sigma=sigma_for_snr(snr_db, rate), rayleigh=True,
                   fading_block=int(16 * duration))


def sample_batch(generator: torch.Generator, spec: ChannelSpec,
                 gen_matrix: torch.Tensor, batch: int, all_zeros: bool = False):
    """Draw ``batch`` (llr_proxy, codeword) pairs on the generator's device.

    ``gen_matrix`` is the (k, n) generator matrix (any numeric dtype) on
    that device.  Returns llr (batch, n) float32 (positive ~ bit 0) and
    codewords (batch, n) int32."""
    k, n = gen_matrix.shape
    dev = gen_matrix.device
    noise = torch.randn((batch, n), generator=generator, device=dev)
    if spec.rayleigh:
        total = batch * n
        nblocks = -(-total // spec.fading_block)
        iq = torch.randn((2, nblocks), generator=generator, device=dev)
        mag = torch.sqrt((iq[0] ** 2 + iq[1] ** 2) / 2.0)
        gain = mag.repeat_interleave(spec.fading_block)[:total].reshape(batch, n)
    else:
        gain = spec.mean
    received = gain + noise * spec.sigma
    if all_zeros:
        return received, torch.zeros((batch, n), dtype=torch.int32, device=dev)
    messages = torch.randint(0, 2, (batch, k), generator=generator, device=dev)
    # GF(2) encode: an integer-exact f32 matmul, then parity
    prods = messages.to(torch.float32) @ gen_matrix.to(torch.float32)
    codewords = (prods - 2.0 * torch.floor(prods * 0.5)).to(torch.int32)
    llr = torch.where(codewords == 0, received, -received)
    return llr, codewords
