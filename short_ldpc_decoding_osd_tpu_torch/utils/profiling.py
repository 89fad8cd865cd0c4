"""Tracing, wall-clock timers, a FLOP count and a structured metrics log.

Port of ``short_ldpc_decoding_osd_tpu/utils/profiling.py``: ``trace``
(:16-23) over ``torch.profiler`` in place of ``jax.profiler``, ``Timer``
(:26-51), ``flops_estimate`` (:51-63) over PyTorch's flop counter in place
of XLA's cost analysis, and ``JsonlLogger`` (:68-77).
"""

from __future__ import annotations

import contextlib
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler
from torch.utils.flop_counter import FlopCounterMode

from .._device import resolve_device, synchronize


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed code with ``torch.profiler`` (the CPU, and the
    card's kernels when CUDA is available) and write a Chrome/Perfetto
    trace, ``<worker>.<timestamp>.pt.trace.json``, into ``log_dir`` on exit
    (TensorBoard's profiler plugin reads the directory).  Yields the
    profiler, whose ``key_averages()`` summarise the same events."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


class Timer:
    """Blocking wall-clock timer for device work: each interval is closed
    by ``torch.cuda.synchronize()`` on a CUDA ``device`` (PyTorch returns
    before the card finishes), so it measures the work, not its enqueue.
    ``device`` is the card unless the caller passes ``"cpu"``."""

    def __init__(self, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
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


def flops_estimate(fn, *args) -> float | None:
    """Floating-point operations of ``fn(*args)`` as PyTorch's
    ``FlopCounterMode`` counts them while the call runs; None when the
    call or the count fails, as the JAX package returns None when XLA has
    no cost analysis.

    The count differs from XLA's: it covers only the operations the flop
    counter has formulas for (matrix products, convolutions and attention,
    2 FLOPs a multiply-add), and counts no elementwise operation or
    reduction, which XLA's cost analysis also counts.  A matmul-only
    function gives the same number under both (2 m n k)."""
    try:
        with FlopCounterMode(display=False) as counter:
            fn(*args)
        return float(counter.get_total_flops())
    except Exception:
        return None


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
