"""The loops that drive the port, one module a traffic kind.

Each exposes ``run(cell, tracer) -> dict`` with the keys of ``drive``
(``units`` and ``window_s`` of the measured window, ``setup_s``,
``lead``, ``ran``), ``frames``, ``memory_peak_bytes``, ``per_unit`` (the judged
numbers of each checked unit), ``checked`` (their indices) and ``work``
(what the metric readers need, and ``notes`` on the checked units for
standard error).  The metric readers get the whole dict.
"""

from __future__ import annotations

import time

import torch

# share of a traced run's window that runs untraced first: the profiler's
# host recording slows the host, so the pace of an untraced unit is read
# there and the device time of a unit in the traced rest
LEAD_SHARE = 0.5


def _loop(unit, first: int, seconds: float, dev) -> tuple[int, float]:
    """Units ``first, first + 1, ...`` until ``seconds`` have passed,
    closed by a synchronisation: (units, seconds)."""
    t0 = time.perf_counter()
    i = first
    while True:
        unit(i)
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync(dev)
    return i - first, time.perf_counter() - t0


def drive(unit, seconds: float, dev, tracer, t_start: float) -> dict:
    """Run ``unit(i)`` for i = 0, 1, ... over the window.  Untraced, the
    whole window is measured.  Traced, its first ``LEAD_SHARE`` runs
    untraced (``lead``: its units and seconds) and the profiler covers
    the rest, which ``units`` and ``window_s`` then describe.  ``ran``
    counts the units of both."""
    t0 = time.perf_counter()
    out = {"setup_s": t0 - t_start, "lead": None}
    first = 0
    if tracer.enabled:
        first, lead_s = _loop(unit, 0, seconds * LEAD_SHARE, dev)
        out["lead"] = {"units": first, "window_s": lead_s}
        seconds *= 1.0 - LEAD_SHARE
    with tracer.window():
        out["units"], out["window_s"] = _loop(unit, first, seconds, dev)
    out["ran"] = first + out["units"]
    return out


def sync(dev) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def release(dev) -> None:
    """Hand the cached blocks of freed tensors back before the reference
    runs."""
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def peak_bytes(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
