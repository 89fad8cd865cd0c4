"""PyTorch + CUDA port of ``short_ldpc_decoding_osd_tpu`` for NVIDIA Hopper.

Module names mirror the JAX package so each counterpart is easy to find.
The JAX package stays the reference; this package imports ``torch`` and
never ``jax``, ``flax`` or anything of the JAX package (the small host-numpy
modules it needs are copied, not imported).

Entry points take an explicit ``device=`` that defaults to ``"cuda"``; they
raise when CUDA is unavailable instead of falling back to the CPU.  Tests
pass ``device="cpu"``, where every hand-written kernel's wrapper runs its
plain PyTorch twin.

Weighted matmuls and convolutions run in IEEE f32 under
``_device.full_f32``, which sets cuBLAS's and cuDNN's precision only for
the call and restores the caller's: the JAX package runs those
contractions at ``Precision.HIGHEST``, and a TF32 product flips
reliability ranks near ties.
"""

from time import perf_counter as _perf_counter

# the start of set-up span "setup.import", which the process's first other
# set-up span closes (``utils.profiling.setup_span``)
IMPORT_T0 = _perf_counter()
