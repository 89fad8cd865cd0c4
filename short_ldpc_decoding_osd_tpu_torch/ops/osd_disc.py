"""Fused TEP-discrepancy parity term: wrapper over the CUDA kernel K5.

Port of ``short_ldpc_decoding_osd_tpu/ops/osd_disc_pallas.py``
(``lterm_pallas`` :65 over ``_lterm_kernel`` :40):

    lterm[b, t] = sum_m u_l[b, m] * mod2( sum_k M[b, m, k] * T[t, k] )

The kernel (``csrc/osd_disc.cu``) never writes the (B, m, Ntot) parity
intermediate to device memory.  The caller adds ``c0 + u_m @ T^T``
(``osd/engine.py``).  The wrapper runs the plain twin ``lterm_reference``
only for CPU tensors; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from .. import _kernels


def lterm_reference(m_matrix: torch.Tensor, u_l: torch.Tensor,
                    teps_flat: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin: materializes the (B, m, Ntot) parity tensor.
    f32 products of 0/1 operands are exact, and row sums <= k < 2^24."""
    prods = torch.einsum("bmk,nk->bmn", m_matrix.to(torch.float32),
                         teps_flat.to(torch.float32))
    a = prods - 2.0 * torch.floor(prods * 0.5)
    return torch.einsum("bm,bmn->bn", u_l.to(torch.float32), a)


def lterm(m_matrix: torch.Tensor, u_l: torch.Tensor,
          teps_flat: torch.Tensor) -> torch.Tensor:
    """(B, Ntot) f32 ``sum_m u_l * mod2(M @ T^T)`` (kernel K5 on CUDA).

    ``m_matrix`` (B, m, k) int8 0/1, ``u_l`` (B, m) f32, ``teps_flat``
    (Ntot, k) int8 0/1, all contiguous on one device."""
    if m_matrix.device.type == "cpu":
        return lterm_reference(m_matrix, u_l, teps_flat)
    if m_matrix.device.type != "cuda":
        raise ValueError(f"unsupported device {m_matrix.device}")
    b, m, k = m_matrix.shape
    ntot = teps_flat.shape[0]
    if (m_matrix.dtype != torch.int8 or teps_flat.dtype != torch.int8
            or u_l.dtype != torch.float32):
        raise ValueError("lterm takes int8 m_matrix/teps and float32 u_l")
    if u_l.shape != (b, m) or teps_flat.shape != (ntot, k):
        raise ValueError(
            f"shape mismatch: M {tuple(m_matrix.shape)}, u_l "
            f"{tuple(u_l.shape)}, teps {tuple(teps_flat.shape)}"
        )
    if k > 256:
        raise ValueError(f"lterm kernel packs k <= 256 bits, got k={k}")
    for name, t in (("m_matrix", m_matrix), ("u_l", u_l), ("teps", teps_flat)):
        if not t.is_contiguous() or t.device != m_matrix.device:
            raise ValueError(f"{name} must be contiguous on {m_matrix.device}")
    out = torch.empty((b, ntot), dtype=torch.float32, device=m_matrix.device)
    lib = _kernels.library("osd_disc")
    status = lib.lterm_launch(
        m_matrix.data_ptr(), u_l.data_ptr(), teps_flat.data_ptr(),
        out.data_ptr(), b, m, k, ntot, _kernels.stream_handle(m_matrix.device),
    )
    _kernels.check(status, "lterm_launch")
    _kernels.LAUNCHES["lterm"] += 1
    return out
