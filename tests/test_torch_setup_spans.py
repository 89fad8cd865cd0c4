"""The port's set-up record (``utils/profiling.py``'s ``setup_span``) on the
CPU: a system's build and its first round, the first fused step, the first
CUDA use and the kernel libraries' first load each open their set-up span
once, with or without a ``recording()`` block; the units after the first
open no span and synchronise nothing; ``reset()`` leaves the record alone;
``kernels_built`` counts the sources whose build ran."""

import collections
import ctypes
import os
import types

import pytest
import torch

from short_ldpc_decoding_osd_tpu_torch import _device, _kernels, system
from short_ldpc_decoding_osd_tpu_torch.codes import get_code
from short_ldpc_decoding_osd_tpu_torch.ops import nms, nms_edge
from short_ldpc_decoding_osd_tpu_torch.utils import profiling

from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

CAP_B, CAP = 1024, 64


@pytest.fixture
def fresh(monkeypatch):
    """A set-up record of its own, as at a process's start: no set-up span
    yet, the first round and the first fused step still to come, no CUDA
    device started and no kernel library loaded."""
    monkeypatch.setattr(profiling, "_SETUP", profiling._State(profiling.Record()))
    monkeypatch.setattr(system._FIRST_ROUND, "pending", True)
    monkeypatch.setattr(nms_edge._FIRST_STEP, "pending", True)
    monkeypatch.setattr(_device, "_STARTED", set())
    monkeypatch.setattr(_kernels, "_libs", {})
    profiling.reset()
    yield
    profiling.reset()


def _spans():
    return profiling.setup_snapshot()["spans"]


def _forbid_setup_work(monkeypatch):
    """Make a set-up span, a profiler range and a synchronisation raise."""

    def forbidden(*args, **kwargs):
        raise AssertionError("set-up work in a steady unit")

    for name in ("setup_span", "_Span", "record_function", "synchronize"):
        monkeypatch.setattr(profiling, name, forbidden)
    monkeypatch.setattr(torch.cuda, "synchronize", forbidden)


def _compact_step(seed=3):
    return nms_edge.fused_counters_edge_compact(
        get_code("ccsds_128_64"), nms.init_params("NMS-1"), "NMS-1", 8, 3.0, 64,
        seed=seed, block_frames=32, schedule=((4, 0.5),), device="cpu")


def _oneshot_step(seed=3):
    return nms_edge.fused_counters_edge(
        get_code("ccsds_128_64"), nms.init_params("NMS-1"), "NMS-1", 4, 3.0, 64,
        seed=seed, device="cpu")


STEPS = {"compact": _compact_step, "oneshot": _oneshot_step}


def _fake_cuda(monkeypatch):
    """A CUDA device that is not there: ``is_available`` true, its
    synchronisations and one-element allocations counted on the CPU."""
    seen = {"sync": 0, "alloc": 0}
    empty = torch.empty

    def fake_empty(*size, device=None, **kwargs):
        if device is not None and torch.device(device).type == "cuda":
            seen["alloc"] += 1
            device = "cpu"
        return empty(*size, device=device, **kwargs)

    def fake_sync(device=None):
        seen["sync"] += 1

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", fake_sync)
    monkeypatch.setattr(torch, "empty", fake_empty)
    return seen


def test_build_and_two_rounds_fill_each_stage_once(fresh):
    """With recording off, a system's build and two rounds leave each of
    ``setup.import``, ``setup.load_run``, ``setup.two_phase`` and
    ``setup.first_unit`` once in the set-up record (the CPU starts no
    device and loads no kernel library) and nothing in the shared
    record."""
    tp = system.TwoPhase(cap_b=CAP_B, cap=CAP, device="cpu", seed=5)
    for i in range(2):
        tp.full_round(i)
    spans = _spans()
    assert set(spans) == {"setup.import", "setup.load_run", "setup.two_phase",
                          "setup.first_unit"}
    assert {name: s["calls"] for name, s in spans.items()} == dict.fromkeys(spans, 1)
    assert spans["setup.load_run"]["parents"] == {"setup.two_phase": 1}
    for name in ("setup.import", "setup.two_phase", "setup.first_unit"):
        assert spans[name]["parents"] == {None: 1}, name
    for s in spans.values():
        assert 0.0 < s["self_seconds"] <= s["seconds"]
    two = spans["setup.two_phase"]
    assert two["self_seconds"] == pytest.approx(
        two["seconds"] - spans["setup.load_run"]["seconds"], abs=1e-9)
    assert profiling.setup_snapshot()["kernels_built"] == 0
    assert profiling.snapshot() == {"spans": {}, "counters": {}}


def test_setup_spans_record_beside_a_recording(fresh):
    """Inside a ``recording()`` block the set-up spans still go to the
    set-up record, on a stack of their own: the shared record's spans keep
    their parents and hold no set-up span."""
    tp = system.TwoPhase(cap_b=CAP_B, cap=CAP, device="cpu", seed=5)
    with profiling.recording():
        tp.full_round(0)
    shared = profiling.snapshot()["spans"]
    assert not any(name.startswith("setup.") for name in shared)
    assert shared["round"]["parents"] == {None: 1}
    assert _spans()["setup.first_unit"]["calls"] == 1


@pytest.mark.parametrize("unit", ["round", "compact", "oneshot"])
def test_unit_after_the_first_opens_no_setup_span(fresh, unit, monkeypatch):
    """After the first, a round or a fused step opens no set-up span, no
    profiler range and no synchronisation (each would raise here), and
    its outputs equal a recomputation's bit for bit."""
    if unit == "round":
        tp = system.TwoPhase(cap_b=CAP_B, cap=CAP, device="cpu", seed=5)
        run = tp.full_round
    else:
        run = STEPS[unit]
    first = run(1)
    before = profiling.setup_snapshot()
    assert before["spans"]["setup.first_unit"]["calls"] == 1
    _forbid_setup_work(monkeypatch)
    again = run(1)
    run(2)
    assert profiling.setup_snapshot() == before
    for a, b in zip(*(x if isinstance(x, tuple) else (x,) for x in (first, again))):
        assert torch.equal(a, b)


def _op_counts(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return collections.Counter(e.name for e in prof.events())


def _bodies(tp):
    """Each unit's public call and the body it runs after the first."""
    code, params = get_code("ccsds_128_64"), nms.init_params("NMS-1")
    rows, final = nms_edge.build_rows_schedule(((4, 0.5),), 32, 8)
    return {
        "round": (lambda: tp.full_round(2), lambda: tp._round(2)),
        "compact": (
            lambda: nms_edge.fused_counters_edge_compact(
                code, params, "NMS-1", 8, 3.0, 64, seed=2, block_frames=32,
                schedule=((4, 0.5),), device="cpu"),
            lambda: nms_edge._compact_step(
                code, params, "NMS-1", 3.0, 64, 2, 32, rows, final, "cpu")),
        "oneshot": (
            lambda: nms_edge.fused_counters_edge(
                code, params, "NMS-1", 4, 3.0, 64, seed=2, device="cpu"),
            lambda: nms_edge._oneshot_step(
                code, params, "NMS-1", 4, 3.0, 64, 2, "cpu")),
    }


@pytest.mark.parametrize("unit", ["round", "compact", "oneshot"])
def test_unit_after_the_first_adds_no_operation(fresh, unit):
    """After the first, the profiler sees the same operations, one for one
    (no allocation, copy or synchronisation more), in a unit's call as in
    the body it wraps."""
    tp = system.TwoPhase(cap_b=CAP_B, cap=CAP, device="cpu", seed=5)
    call, body = _bodies(tp)[unit]
    call()
    steady = _op_counts(call)
    assert steady == _op_counts(body)
    assert not any(name.startswith("sldpc.") for name in steady)


def test_first_fused_step_of_either_kind_is_the_first_unit(fresh):
    """The two fused steps share one first unit: the first call of either
    is ``setup.first_unit``, and no later call of the other opens it."""
    _oneshot_step()
    _compact_step()
    _oneshot_step()
    spans = _spans()
    assert spans["setup.first_unit"]["calls"] == 1
    assert spans["setup.first_unit"]["parents"] == {None: 1}


def test_reset_leaves_the_setup_record(fresh):
    with profiling.recording():
        with profiling.setup_span("load_run"):
            with profiling.span("round"):
                pass
    before = profiling.setup_snapshot()
    assert set(before["spans"]) == {"setup.import", "setup.load_run"}
    assert set(profiling.snapshot()["spans"]) == {"round"}
    profiling.reset()
    assert profiling.snapshot() == {"spans": {}, "counters": {}}
    assert profiling.setup_snapshot() == before


def test_import_runs_from_the_package_start_to_the_first_setup_span(fresh):
    """``setup.import`` opens at the package's first line and closes when
    the process's first other set-up span opens, once."""
    import time

    import short_ldpc_decoding_osd_tpu_torch as port

    t0 = time.perf_counter()
    with profiling.setup_span("load_run"):
        t1 = time.perf_counter()
    with profiling.setup_span("two_phase"):
        pass
    spans = _spans()
    assert spans["setup.import"]["calls"] == 1
    assert spans["setup.import"]["parents"] == {None: 1}
    assert t0 - port.IMPORT_T0 <= spans["setup.import"]["seconds"] <= t1 - port.IMPORT_T0


def test_cuda_resolve_opens_the_device_span_once(fresh, monkeypatch):
    """The first ``resolve_device`` of a CUDA device makes its context with
    one allocation inside ``setup.device``, closed by a synchronisation;
    later calls allocate, synchronise and record nothing."""
    seen = _fake_cuda(monkeypatch)
    dev = _device.resolve_device("cuda")
    assert dev == torch.device("cuda")
    assert seen == {"sync": 1, "alloc": 1}
    for device in ("cuda", torch.device("cuda"), dev):
        assert _device.resolve_device(device) == dev
    assert seen == {"sync": 1, "alloc": 1}
    spans = _spans()
    assert spans["setup.device"]["calls"] == 1
    assert spans["setup.device"]["parents"] == {None: 1}


def test_cuda_resolve_without_cuda_still_raises(fresh):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    for _ in range(2):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            _device.resolve_device("cuda")
    assert "setup.device" not in _spans()


class _FakeLib:
    """A loaded library stand-in: any attribute takes argument types."""

    def __getattr__(self, name):
        fn = types.SimpleNamespace()
        object.__setattr__(self, name, fn)
        return fn


def test_library_opens_the_kernels_span_once(fresh, monkeypatch):
    """``_kernels.library``'s first call builds and loads every source
    inside ``setup.kernels``; later calls, of any library, open nothing."""
    builds, loads = [], []
    monkeypatch.setattr(_kernels, "build_all", lambda: builds.append(1) or {})
    monkeypatch.setattr(ctypes, "CDLL", lambda path: loads.append(path) or _FakeLib())
    for name in (*_kernels.SOURCES, "nms_edge"):
        assert isinstance(_kernels.library(name), _FakeLib)
    assert builds == [1] and len(loads) == len(_kernels.SOURCES)
    spans = _spans()
    assert spans["setup.kernels"]["calls"] == 1
    assert profiling.setup_snapshot()["kernels_built"] == 0


FAKE_NVCC = """#!/bin/sh
# a stand-in compiler: writes the -o file, fails on gf2_ge.cu
out=""
for a in "$@"; do
  case "$prev" in -o) out="$a" ;; esac
  case "$a" in *gf2_ge.cu) exit 1 ;; esac
  prev="$a"
done
: > "$out"
"""


def test_kernels_built_counts_the_builds_that_ran(fresh, monkeypatch, tmp_path):
    """``kernels_built`` counts each source that a build compiled in this
    process: not a library already built, not a build that failed, and
    nothing on a second call."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    build = tmp_path / "build"
    monkeypatch.setattr(_kernels, "BUILD_DIR", str(build))
    monkeypatch.setattr(_kernels, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_kernels, "BUILD_SECONDS", {})
    monkeypatch.setattr(_kernels, "BUILD_LOG", {})
    build.mkdir()
    open(_kernels._lib_path("nms_edge"), "w").close()
    with pytest.raises(RuntimeError, match="gf2_ge.cu"):
        _kernels.build_all()
    # osd_disc, mc_fused, nms_dense: built; nms_edge: there; gf2_ge: failed
    assert profiling.setup_snapshot()["kernels_built"] == 3
    for name in ("osd_disc", "mc_fused", "nms_dense"):
        assert os.path.exists(_kernels._lib_path(name)), name
    assert not os.path.exists(_kernels._lib_path("gf2_ge"))
    open(_kernels._lib_path("gf2_ge"), "w").close()
    _kernels.build_all()
    assert profiling.setup_snapshot()["kernels_built"] == 3


def test_every_setup_stage_is_a_span_the_port_opens(fresh, monkeypatch):
    """A process that starts a CUDA device, builds a system, runs a round
    and a fused step and loads the kernel libraries opens exactly the
    spans of ``SETUP_STAGES``."""
    _fake_cuda(monkeypatch)
    _device.resolve_device("cuda")
    tp = system.TwoPhase(cap_b=CAP_B, cap=CAP, device="cpu", seed=5)
    tp.full_round(0)
    _compact_step()
    monkeypatch.setattr(_kernels, "build_all", lambda: {})
    monkeypatch.setattr(ctypes, "CDLL", lambda path: _FakeLib())
    _kernels.library("nms_edge")
    assert set(_spans()) == set(profiling.SETUP_STAGES)
    assert len(profiling.SETUP_STAGES) == len(set(profiling.SETUP_STAGES))
