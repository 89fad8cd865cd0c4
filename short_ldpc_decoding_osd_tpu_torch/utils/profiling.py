"""Tracing, named spans and counters, wall-clock timers, a FLOP count and
a structured metrics log.

Port of ``short_ldpc_decoding_osd_tpu/utils/profiling.py``: ``trace``
(:16-23) over ``torch.profiler`` in place of ``jax.profiler``, ``Timer``
(:26-51), ``flops_estimate`` (:51-63) over PyTorch's flop counter in place
of XLA's cost analysis, and ``JsonlLogger`` (:68-77).

The port's own recorder: the hot path opens :func:`span` around each stage
and calls :func:`count` for what it counts.  Both do nothing unless a
:func:`recording` block is open: a span is then a
``torch.profiler.record_function`` range named ``sldpc.<name>`` (a running
profiler's trace holds it on the clock and thread of the CUDA calls and
kernels it encloses) and an in-memory aggregate per name of calls, host
seconds and self host seconds; :func:`snapshot` reads the aggregates and
counters, :func:`reset` clears them.  Custom-kernel launches are counted
apart, in ``_kernels.LAUNCHES``.

The set-up record is a second record, always on: the port opens
:func:`setup_span` around each one-time stage of a process's start
(:data:`SETUP_STAGES`), with or without a :func:`recording` block, into a
record and stack of its own that :func:`reset` leaves alone, since they
describe the process and not a window; :func:`setup_snapshot` reads them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time

import torch
from torch.profiler import (ProfilerActivity, profile, record_function,
                            tensorboard_trace_handler)
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


class _NullSpan:
    """The span of a stage when nothing records: enters and exits."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()
_NO_CAP = 2**62


@dataclasses.dataclass
class Record:
    """Aggregates of the spans (name -> calls, host seconds, self host
    seconds, calls under each enclosing span, None at the top) and the
    counters.  A counter fed a device tensor keeps it, with its cap, until
    :meth:`snapshot` reads them all at once."""

    spans: dict = dataclasses.field(default_factory=dict)
    counters: dict = dataclasses.field(default_factory=dict)
    pending: dict = dataclasses.field(default_factory=dict)

    def snapshot(self) -> dict:
        """``{"spans": {name: {calls, seconds, self_seconds, parents}},
        "counters": {name: int}}``; reads the pending device counts with
        one transfer."""
        if self.pending:
            items = [(name, t, cap) for name, kept in self.pending.items()
                     for t, cap in kept]
            vals = torch.stack([t.reshape(()).to(torch.int64) for _, t, _ in items])
            caps = torch.tensor([_NO_CAP if c is None else c for _, _, c in items],
                                device=vals.device)
            for (name, _, _), v in zip(items, torch.minimum(vals, caps).tolist()):
                self.counters[name] = self.counters.get(name, 0) + v
            self.pending.clear()
        return {"spans": {name: dict(agg, parents=dict(agg["parents"]))
                          for name, agg in self.spans.items()},
                "counters": dict(self.counters)}

    def reset(self) -> None:
        self.spans.clear()
        self.counters.clear()
        self.pending.clear()


class _Span:
    """An open span while recording: a ``sldpc.<name>`` profiler range and
    its share of the record's aggregate.  ``device`` (default: the
    state's) closes it with its synchronisation."""

    __slots__ = ("name", "range", "state", "device", "t0", "children")

    def __init__(self, name: str, state: _State,
                 device: torch.device | None = None):
        self.name, self.state = name, state
        self.device = state.synchronize if device is None else device
        self.range = record_function("sldpc." + name)

    def __enter__(self):
        self.state.stack.append(self)
        self.children = 0.0
        self.range.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        state = self.state
        if self.device is not None:
            synchronize(self.device)
        dt = time.perf_counter() - self.t0
        self.range.__exit__(*exc)
        state.stack.pop()
        parent = state.stack[-1] if state.stack else None
        if parent is not None:
            parent.children += dt
        agg = state.record.spans.get(self.name)
        if agg is None:
            agg = state.record.spans[self.name] = {
                "calls": 0, "seconds": 0.0, "self_seconds": 0.0, "parents": {}}
        agg["calls"] += 1
        agg["seconds"] += dt
        agg["self_seconds"] += dt - self.children
        key = None if parent is None else parent.name
        agg["parents"][key] = agg["parents"].get(key, 0) + 1
        return False


@dataclasses.dataclass
class _State:
    record: Record
    synchronize: torch.device | None = None
    stack: list = dataclasses.field(default_factory=list)


_SHARED = Record()
# the one flag of the recorder: None when nothing records
_STATE: _State | None = None


def span(name: str):
    """Context of the stage ``name``: the shared do-nothing object unless a
    :func:`recording` block is open."""
    if _STATE is None:
        return _NULL_SPAN
    return _Span(name, _STATE)


def count(name: str, n, at_most: int | None = None) -> None:
    """Add ``n`` (a host number, or a device scalar read later by
    :meth:`Record.snapshot`, capped at ``at_most``) to counter ``name``
    while recording; nothing otherwise."""
    if _STATE is None:
        return
    record = _STATE.record
    if isinstance(n, torch.Tensor):
        record.pending.setdefault(name, []).append((n.detach(), at_most))
    else:
        n = n if at_most is None else min(n, at_most)
        record.counters[name] = record.counters.get(name, 0) + n


@contextlib.contextmanager
def recording(synchronize: torch.device | None = None,
              record: Record | None = None):
    """Record the spans and counters of the enclosed block into ``record``
    (default: the shared record that :func:`snapshot` reads); yields it.
    ``synchronize``, a device, closes every span with its synchronisation,
    so a span's host seconds are its stage's work and not its enqueue."""
    global _STATE
    saved = _STATE
    _STATE = _State(record if record is not None else _SHARED, synchronize)
    try:
        yield _STATE.record
    finally:
        _STATE = saved


def snapshot() -> dict:
    """The shared record's spans and counters (:meth:`Record.snapshot`)."""
    return _SHARED.snapshot()


def reset() -> None:
    """Clear the shared record (not the set-up record)."""
    _SHARED.reset()


# the one-time stages of a process's start, each a set-up span: the port's
# imports (from the package's first line to the first other set-up span),
# the first CUDA use of a device, loading a run directory, building a
# two-phase system, building and loading the kernel libraries, and the
# first round or fused step
SETUP_STAGES = ("setup.import", "setup.device", "setup.load_run",
                "setup.two_phase", "setup.kernels", "setup.first_unit")
# the process's set-up record: always on, never reset
_SETUP = _State(Record())


def _close_import(record: Record) -> None:
    from .. import IMPORT_T0

    dt = time.perf_counter() - IMPORT_T0
    record.spans["setup.import"] = {"calls": 1, "seconds": dt,
                                    "self_seconds": dt, "parents": {None: 1}}


def setup_span(name: str, device: torch.device | None = None) -> _Span:
    """Span ``setup.<name>`` of a one-time stage (:data:`SETUP_STAGES`),
    recorded into the set-up record whether or not anything records; a
    ``device`` closes it with its synchronisation, so it times the stage's
    work and not its enqueue.  The process's first set-up span closes
    ``setup.import``, open since the package's first line."""
    if "setup.import" not in _SETUP.record.spans:
        _close_import(_SETUP.record)
    return _Span("setup." + name, _SETUP, device)


def setup_count(name: str, n: int) -> None:
    """Add ``n`` to the set-up record's counter ``name``."""
    counters = _SETUP.record.counters
    counters[name] = counters.get(name, 0) + n


def setup_snapshot() -> dict:
    """``{"spans": {name: {calls, seconds, self_seconds, parents}},
    "kernels_built": int}`` of the set-up record: its spans so far, and the
    kernel sources ``nvcc`` compiled in this process."""
    snap = _SETUP.record.snapshot()
    return {"spans": snap["spans"],
            "kernels_built": snap["counters"].get("kernels_built", 0)}


class FirstUnit:
    """The flag of a unit (a round, a fused step) whose first call in the
    process runs inside set-up span ``setup.first_unit``: ``pending`` until
    :meth:`span` clears it and returns that span, closed by ``device``'s
    synchronisation; a later call of the unit tests the flag only."""

    __slots__ = ("pending",)

    def __init__(self):
        self.pending = True

    def span(self, device: torch.device) -> _Span:
        self.pending = False
        return setup_span("first_unit", device)


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
