"""The channel draws of the two traffic kinds, derived again from the seed.

Frozen copies of the rules that fix which frames the system decodes:

* two-phase rounds: round ``i`` of seed ``s`` seeds a ``torch.Generator``
  on the frames' device with ``s * 1_000_003 + i``, then draws the noise
  ``randn(batch, n)`` and the messages ``randint(0, 2, (batch, k))`` in
  that order; codewords are ``mod2(msg @ G)``, the LLR proxy is
  ``+-(1 + sigma * noise)`` (positive for bit 0);
* fused Monte-Carlo steps: frame ``f`` of step seed ``s`` is a function of
  (s, f) alone, the murmur3 counter hash: message bit j from stream
  ``j + 1``, the normal of column v one Box-Muller value from streams
  ``k + 1 + v`` and ``k + 1 + n + v``.  On the card every float step is
  f32 (as the kernels compute it, without fused multiply-add); on the CPU
  the Box-Muller step runs in f64, rounded once to f32.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def sigma_for_snr(snr_db: float, rate: float) -> float:
    return math.sqrt(1.0 / (2.0 * rate * 10.0 ** (snr_db / 10.0)))


def round_seed(seed: int, index: int) -> int:
    return seed * 1_000_003 + index


def awgn_round(seed: int, index: int, g: torch.Tensor, batch: int,
               sigma: float):
    """(llr (batch, n) f32, codewords (batch, n) int32) of round ``index``;
    ``g`` is the (k, n) generator as f32 on the frames' device."""
    k, n = g.shape
    gen = torch.Generator(device=g.device)
    gen.manual_seed(round_seed(seed, index))
    noise = torch.randn((batch, n), generator=gen, device=g.device)
    received = 1.0 + noise * sigma
    msg = torch.randint(0, 2, (batch, k), generator=gen, device=g.device)
    prods = msg.to(torch.float32) @ g
    words = (prods - 2.0 * torch.floor(prods * 0.5)).to(torch.int32)
    return torch.where(words == 0, received, -received), words


_M32 = 0xFFFFFFFF
_GOLD1, _GOLD2 = 0x9E3779B9, 0xB4014E05
_TWO_PI_F32 = float(np.float32(6.283185307179586))


def _mul32(x, c):
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _uniform(w):
    return (w >> 8).to(torch.float32) * (1.0 / 16777216.0) + (0.5 / 16777216.0)


def step_seed(seed: int, step: int) -> int:
    """The 32-bit seed of fused step ``step`` of a run with ``seed``."""
    return (seed * 100003 + step) & 0x7FFFFFFF


def hash_frames(fid: torch.Tensor, seed: int, g: torch.Tensor, sigma: float):
    """(codeword, llr), both (B, n) f32, of frames ``fid`` (int64) of step
    seed ``seed``; ``sigma`` is rounded to f32 as the kernels take it."""
    k, n = g.shape
    dev = fid.device
    base = _mix((_mul32(fid & _M32, _GOLD1) + (seed & _M32)) & _M32)[:, None]

    def stream(counter):
        return _mix(base ^ _mul32(counter & _M32, _GOLD2))

    msg = (stream(torch.arange(1, k + 1, dtype=torch.int64, device=dev)) & 1)
    prods = msg.to(torch.float32) @ g
    codeword = prods - 2.0 * torch.floor(prods * 0.5)
    cols = torch.arange(n, dtype=torch.int64, device=dev)
    u1 = _uniform(stream(cols + (k + 1)))
    angle = _TWO_PI_F32 * _uniform(stream(cols + (k + 1 + n)))
    if dev.type == "cpu":
        u1, angle = u1.double(), angle.double()
    z = (torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(angle)).float()
    received = 1.0 + float(np.float32(sigma)) * z
    return codeword, (1.0 - 2.0 * codeword) * received
