"""The counter dtype of the Monte-Carlo and OSD steps.

Port of ``short_ldpc_decoding_osd_tpu/utils/dtypes.py``.  JAX runs without
x64 by default and picks int32 unless ``jax_enable_x64`` is on; PyTorch
has int64 throughout, and the port counts in int64 everywhere
(``mc/harness.count_and_capture``, the kernels' counters), so a per-step
sum can never wrap.
"""

from __future__ import annotations

import torch


def count_dtype() -> torch.dtype:
    """The dtype of every counter vector: ``torch.int64``."""
    return torch.int64
