"""Device resolution and numeric settings shared by the port's entry points."""

from __future__ import annotations

import contextlib

import torch


# the CUDA devices this process has started (set-up span "setup.device")
_STARTED: set[torch.device] = set()


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    absent (the port never falls back to the CPU silently).  The first
    call for a CUDA device makes its primary context, with a one-element
    allocation, inside set-up span ``setup.device``; later calls look the
    device up in a set."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev not in _STARTED:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run the plain PyTorch versions"
            )
        _start(dev)
    return dev


def _start(dev: torch.device) -> None:
    from .utils import profiling  # which imports this module

    with profiling.setup_span("device", dev):
        torch.empty(1, device=dev)
    _STARTED.add(dev)


def device_name(device: torch.device) -> str:
    """The card's name on CUDA (``torch.cuda.get_device_name``), else the
    device string (``"cpu"``): what a result line says it ran on."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


def synchronize(device: torch.device) -> None:
    """Wait for queued device work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def full_f32():
    """Run the enclosed cuBLAS matmuls and cuDNN convolutions in IEEE f32,
    not TF32, and restore the caller's settings on exit.

    The JAX package runs its weighted contractions at ``Precision.HIGHEST``
    (``osd/engine.py``, ``models/dia.py``): a TF32 operand keeps 10 mantissa
    bits, enough to flip reliability ranks near ties.  cuDNN allows TF32
    for convolutions by default, so the DIA's ``Conv1d`` needs this even
    where matmuls are already f32.  Backward passes run where
    ``backward()`` is called, so a training loop holds the whole step under
    this context.  Also a decorator."""
    matmul, conv = torch.backends.cuda.matmul, torch.backends.cudnn.conv
    saved = matmul.fp32_precision, conv.fp32_precision
    matmul.fp32_precision = conv.fp32_precision = "ieee"
    try:
        yield
    finally:
        matmul.fp32_precision, conv.fp32_precision = saved
