"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    absent (the port never falls back to the CPU silently)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for queued device work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
