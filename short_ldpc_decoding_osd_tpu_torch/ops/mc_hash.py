"""Counter-based murmur3 channel sampler: a frame from (seed, frame id).

Port of ``short_ldpc_decoding_osd_tpu/ops/mc_cascade.py:59-109`` (``_GOLD1``,
``_GOLD2``, ``_lshr``, ``_mix``, ``_stream_bits``, ``_bits_to_uniform``,
``_sample``), the plain PyTorch twin of the sampler written into the fused
Monte-Carlo kernels of ``csrc/mc_fused.cu``.  The same (seed, frame id)
gives the same message bits and the same normals in every kernel, so any
frame can be regenerated alone.

Words are uint32 values carried in int64 tensors and masked to 32 bits
after every step; a 32-bit product is formed from 16-bit halves, so no
intermediate leaves the int64 range (torch promises no wrap on overflow).

Per frame with base word ``b = mix(fid * GOLD1 + seed)``: message bit j is
bit 0 of stream ``j + 1``; the normal of column v is one Box-Muller value
(``cos`` only) from streams ``k + 1 + v`` and ``k + 1 + n + v``.  On the card
all float steps are f32, in the order of the CUDA kernel (built without
fused multiply-add), so the two agree to the last bit.  On the CPU the
Box-Muller step (``sqrt(-2 log u1) cos(2 pi u2)`` from the same f32 u1 and
2 pi u2) runs in f64 and is rounded once to f32: torch's f32 ``log`` and
``cos`` on the CPU run vectorised, in chunks on the thread pool, and once
came out up to 3.06e-5 off the f64 value (165 of 30,848 normals, in one of
several test-suite runs under 6 workers), where f64 leaves the rounded
result within an ulp of the exact one whatever the library path.
"""

from __future__ import annotations

import numpy as np
import torch

GOLD1 = 0x9E3779B9  # golden-ratio increment
GOLD2 = 0xB4014E05  # odd stream constant (int32 -1274982907)
_M32 = 0xFFFFFFFF
# 2*pi as the f32 the kernel multiplies by
TWO_PI_F32 = float(np.float32(6.283185307179586))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for uint32 values ``x`` (int64 tensor) and a
    32-bit constant ``c``, from 16-bit halves of ``c``."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def mix(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 of uint32 values held in an int64 tensor."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def base_words(fid: torch.Tensor, seed: int) -> torch.Tensor:
    """Per-frame base word ``mix(fid * GOLD1 + seed)``; ``fid`` int64."""
    return mix((_mul32(fid & _M32, GOLD1) + (seed & _M32)) & _M32)


def stream_bits(base: torch.Tensor, stream: torch.Tensor) -> torch.Tensor:
    """Word of each (frame base, stream counter) pair, broadcast."""
    return mix(base ^ _mul32(stream & _M32, GOLD2))


def bits_to_uniform(w: torch.Tensor) -> torch.Tensor:
    """(0, 1) uniform f32 from the top 24 bits of a word."""
    return (w >> 8).to(torch.float32) * (1.0 / 16777216.0) + (0.5 / 16777216.0)


def sample(fid: torch.Tensor, seed: int, g: torch.Tensor, sigma: float,
           mean: float = 1.0):
    """(codeword, llr), both (B, n) float32, of frames ``fid`` (int64).

    ``g`` is the (k, n) 0/1 generator matrix as float32 on the frames'
    device; ``sigma`` and ``mean`` are rounded to f32 first, as the kernels
    take them."""
    k, n = g.shape
    dev = fid.device
    base = base_words(fid, seed)[:, None]
    msg = (stream_bits(base, torch.arange(1, k + 1, dtype=torch.int64,
                                          device=dev)) & 1).to(torch.float32)
    prods = msg @ g  # integer-exact: at most k ones per sum
    codeword = prods - 2.0 * torch.floor(prods * 0.5)
    cols = torch.arange(n, dtype=torch.int64, device=dev)
    u1 = bits_to_uniform(stream_bits(base, cols + (k + 1)))
    u2 = bits_to_uniform(stream_bits(base, cols + (k + 1 + n)))
    angle = TWO_PI_F32 * u2
    if dev.type == "cpu":
        u1, angle = u1.double(), angle.double()
    z = (torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(angle)).float()
    received = float(np.float32(mean)) + float(np.float32(sigma)) * z
    llr = (1.0 - 2.0 * codeword) * received
    return codeword, llr
