"""Wall-clock timers and a structured metrics log.

Port of ``short_ldpc_decoding_osd_tpu/utils/profiling.py``: ``Timer``
(:26-51) and ``JsonlLogger`` (:68-77).  ``trace`` and ``flops_estimate``
are ``jax.profiler`` / XLA cost-analysis tools and have no counterpart
here; ``torch.profiler`` traces the card directly (``chip_smoke.py``).
"""

from __future__ import annotations

import contextlib
import json
import time

import torch

from .._device import synchronize


class Timer:
    """Blocking wall-clock timer for device work: each interval is closed
    by ``torch.cuda.synchronize()`` on a CUDA ``device`` (PyTorch returns
    before the card finishes), so it measures the work, not its enqueue."""

    def __init__(self, device: str | torch.device = "cpu"):
        self.device = torch.device(device)
        self.records: dict[str, list[float]] = {}

    @contextlib.contextmanager
    def measure(self, name: str):
        t0 = time.perf_counter()
        yield
        synchronize(self.device)
        self.records.setdefault(name, []).append(time.perf_counter() - t0)

    def summary(self) -> dict:
        return {
            name: {
                "n": len(vals),
                "total_s": sum(vals),
                "mean_s": sum(vals) / len(vals),
            }
            for name, vals in self.records.items()
        }


class JsonlLogger:
    """Append-mode structured metrics log (replaces the reference's .txt
    appends, ``ldpc_128_testing.py:138-153``)."""

    def __init__(self, path: str):
        self.path = path

    def log(self, record: dict):
        record = dict(record)
        record.setdefault("t", time.time())
        with open(self.path, "a") as fh:
            fh.write(json.dumps(record, default=str) + "\n")
