"""The traced run: ``torch.profiler`` over the measured window, reduced to
the device's busy time, its operations, the device time of the kernels
launched inside each of the benchmark's ranges, and the breakdown.

The ranges are ``torch.profiler.record_function`` spans that the
benchmark opens around calls into the port (``Tracer.wrap``).  A kernel
belongs to a range when the host call that launched it (the CUDA API
event of the same correlation id) lies inside one of the
range's spans.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import json
import os

import numpy as np
import torch

WINDOW = "gpubench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


class RangeMissing(RuntimeError):
    """A range that a reported metric reads ran no call, or its calls
    launched no device work: the function was renamed, inlined or bound
    elsewhere, and the metric would go silent."""


def range_seconds(summary: dict, name: str) -> tuple[float, int]:
    """(device seconds, calls) of range ``name`` in a traced window;
    raises ``RangeMissing`` where there is nothing to read."""
    calls = summary["range_calls"].get(name, 0)
    spent = summary["ranges"].get(name, 0.0)
    if not calls or spent <= 0:
        raise RangeMissing(f"range {name!r}: {calls} calls, {spent} device "
                           "seconds in the traced window")
    return spent, calls


class Tracer:
    """Profiles the window when ``enabled``; otherwise every method is a
    no-op, so the untraced run pays for nothing but a flag test."""

    def __init__(self, enabled: bool, path: str):
        self.enabled, self.path = enabled, path
        self.prof = None

    def wrap(self, obj, attr: str, name: str, after=None):
        """Replace ``obj.attr`` by a wrapper that opens range ``name``
        around the call when tracing and hands the result to ``after``."""
        inner = getattr(obj, attr)

        @functools.wraps(inner)
        def wrapper(*args, **kwargs):
            with self.span(name):
                out = inner(*args, **kwargs)
            if after is not None:
                after(out)
            return out

        setattr(obj, attr, wrapper)
        return inner

    def span(self, name: str):
        if self.prof is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function("gpubench." + name)

    @contextlib.contextmanager
    def window(self):
        """The profiled window (a plain block when not tracing)."""
        if not self.enabled:
            yield
            return
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            self.prof = prof
            with torch.profiler.record_function(WINDOW):
                yield
        self.prof = None
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        prof.export_chrome_trace(self.path)

    def summary(self) -> dict:
        """Reduce the exported trace (and delete it)."""
        size = os.path.getsize(self.path)
        with open(self.path) as fh:
            events = json.load(fh)["traceEvents"]
        os.remove(self.path)
        return reduce_events(events) | {"trace_bytes": size}


def _merge(starts: np.ndarray, ends: np.ndarray):
    order = np.argsort(starts, kind="stable")
    merged = []
    for s, e in zip(starts[order], ends[order]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce_events(events: list) -> dict:
    """Busy and window seconds, device operations, per-range device
    seconds and calls, and the breakdown, from chrome-trace events."""
    window = [e for e in events if e.get("name") == WINDOW
              and e.get("cat") == "user_annotation"]
    if not window:
        raise RuntimeError("the trace holds no window span")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e
           and w0 <= float(e["ts"]) <= w1]
    if not dev:
        raise RuntimeError("the trace holds no device operation in the window")
    starts = np.array([float(e["ts"]) for e in dev])
    ends = np.minimum(starts + np.array([float(e["dur"]) for e in dev]), w1)
    merged = _merge(starts, ends)
    busy_us = sum(e - s for s, e in merged)

    launch_ts = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch_ts[e["args"]["correlation"]] = float(e["ts"])
    spans: dict[str, list] = {}
    for e in events:
        name = e.get("name", "")
        if (e.get("cat") == "user_annotation" and name.startswith("gpubench.")
                and name != WINDOW):
            spans.setdefault(name[len("gpubench."):], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    ranges = {name: 0.0 for name in spans}
    for name, ivals in spans.items():
        ivals.sort()
        opens = [s for s, _ in ivals]
        for e in dev:
            t = launch_ts.get(e.get("args", {}).get("correlation"))
            if t is None:
                continue
            i = bisect.bisect_right(opens, t) - 1
            if i >= 0 and t <= ivals[i][1]:
                ranges[name] += float(e["dur"]) * 1e-6

    by_name: dict[str, float] = {}
    for e in dev:
        by_name[e["name"][:160]] = by_name.get(e["name"][:160], 0.0) + float(e["dur"]) * 1e-6
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    edges = [w0] + [x for s, e in merged for x in (s, e)] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]),
                  reverse=True)[:10]
    host = [e for e in events if e.get("cat") in HOST_CATS and "dur" in e
            and e.get("name") != WINDOW]
    h0 = np.array([float(e["ts"]) for e in host])
    h1 = h0 + np.array([float(e["dur"]) for e in host])
    idle = []
    for length, at in gaps:
        inside = np.flatnonzero((h0 <= at) & (h1 >= at))
        doing = host[inside[np.argmax(h0[inside])]]["name"][:160] if len(inside) else "no host event"
        idle.append([doing, length * 1e-6])
    return {
        "busy_s": busy_us * 1e-6,
        "window_s": (w1 - w0) * 1e-6,
        "device_ops": len(dev),
        "ranges": ranges,
        "range_calls": {name: len(v) for name, v in spans.items()},
        "breakdown": {"device_ops": [[n, s] for n, s in top_ops],
                      "idle_gaps": idle},
    }
