"""``gpubench/program.py``: the reduction of the port's ``sldpc.*`` spans on
synthetic chrome-trace events (self and inclusive device time, syncs and
idle by innermost span, the device time outside every span), the old
keys of ``trace.reduce_events`` unchanged beside them, the readings, and
a CPU run of a cell whose window records the port's counters."""

import os
import time
import types

import numpy
import pytest
import torch

from gpubench import core, program, trace

from conftest import ROOT


def _kernel(corr: int, launch: float, start: float, dur: float) -> list[dict]:
    return [{"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": launch,
             "dur": 2.0, "args": {"correlation": corr}},
            {"name": f"k{corr}", "cat": "kernel", "ts": start, "dur": dur,
             "args": {"correlation": corr}}]


def _span(name: str, s: float, e: float) -> dict:
    return {"name": name, "cat": "user_annotation", "ts": s, "dur": e - s}


def _runtime(name: str, ts: float) -> dict:
    return {"name": name, "cat": "cuda_runtime", "ts": ts, "dur": 1.0}


def _round_events() -> list[dict]:
    """A 1,000 us window: a round of capture (decode inside it) and
    phase 2, then a kernel outside every span."""
    return [
        _span(trace.WINDOW, 0.0, 1000.0),
        _span("sldpc.round", 10.0, 400.0),
        _span("sldpc.capture", 20.0, 150.0),
        _span("sldpc.capture.decode", 30.0, 100.0),
        _span("sldpc.phase2", 160.0, 390.0),
        *_kernel(1, 35.0, 40.0, 50.0),  # decode
        *_kernel(2, 120.0, 125.0, 20.0),  # capture, after decode
        *_kernel(3, 170.0, 180.0, 100.0),  # phase2
        *_kernel(4, 395.0, 398.0, 10.0),  # round, after phase2
        *_kernel(5, 500.0, 520.0, 30.0),  # outside
        _runtime("cudaMemcpy", 60.0),  # decode
        _runtime("cudaMemcpyAsync", 61.0),  # not a sync
        {"name": "aten::to", "cat": "cpu_op", "ts": 137.0, "dur": 6.0},
        {"name": "aten::copy_", "cat": "cpu_op", "ts": 138.0, "dur": 4.0},
        _runtime("cudaStreamSynchronize", 140.0),  # capture, in aten::to
        _runtime("cudaStreamSynchronize", 600.0),  # outside
    ]


def test_program_self_inclusive_and_outside():
    got = program.reduce_program(_round_events())
    spans = got["spans"]
    assert {n: s["calls"] for n, s in spans.items()} == {
        "round": 1, "capture": 1, "capture.decode": 1, "phase2": 1}
    us = {n: (round(s["seconds"] * 1e6, 6), round(s["self_seconds"] * 1e6, 6))
          for n, s in spans.items()}
    assert us == {"capture.decode": (50.0, 50.0), "capture": (70.0, 20.0),
                  "phase2": (100.0, 100.0), "round": (180.0, 10.0)}
    assert got["outside_s"] * 1e6 == pytest.approx(30.0)
    assert got["device_s"] * 1e6 == pytest.approx(210.0)


def test_program_syncs_by_innermost_span():
    got = program.reduce_program(_round_events())
    assert {n: s["syncs"] for n, s in got["spans"].items()} == {
        "round": 0, "capture": 1, "capture.decode": 1, "phase2": 0}
    assert got["outside_syncs"] == 1
    assert got["sync_sites"] == {"capture.decode / no operation": 1,
                                 "capture / aten::to": 1,
                                 "(outside) / no operation": 1}


def test_program_idle_by_span():
    """Each gap goes to the innermost span open where it starts: the
    device idles 35 us in decode (90-125), 35 in capture (145-180), 118 in
    phase 2 (280-398); 0-40, 408-520 and 550-1000 start outside."""
    got = program.reduce_program(_round_events())
    assert {n: round(s["idle_s"] * 1e6, 6) for n, s in got["spans"].items()} == {
        "capture.decode": 35.0, "capture": 35.0, "phase2": 118.0, "round": 0.0}
    assert got["outside_idle_s"] * 1e6 == pytest.approx(40.0 + 112.0 + 450.0)


def test_old_keys_unchanged_beside_the_program():
    """``trace.reduce_events`` reads the same with the port's spans in the
    trace; only an idle gap's host event may now be a ``sldpc.*`` span."""
    old = [e for e in _round_events() if not e["name"].startswith("sldpc.")]
    old += [_span("gpubench.capture_round", 15.0, 155.0),
            _span("gpubench.phase2", 158.0, 392.0)]
    new = old + [e for e in _round_events() if e["name"].startswith("sldpc.")]
    a, b = trace.reduce_events(old), trace.reduce_events(new)
    assert set(a) == set(b)
    for key in set(a) - {"breakdown"}:
        assert a[key] == b[key], key
    assert a["breakdown"]["device_ops"] == b["breakdown"]["device_ops"]
    assert ([g for _, g in a["breakdown"]["idle_gaps"]]
            == [g for _, g in b["breakdown"]["idle_gaps"]])
    # the span and the benchmark's range around the same call agree
    prog = program.reduce_program(new)
    assert prog["spans"]["capture"]["seconds"] == pytest.approx(
        b["ranges"]["capture_round"])
    assert prog["spans"]["phase2"]["seconds"] == pytest.approx(b["ranges"]["phase2"])


def test_span_with_no_call_is_missing():
    got = program.reduce_program(_round_events())
    assert program.span_seconds(got, "capture.decode") == pytest.approx((50e-6, 1))
    with pytest.raises(trace.RangeMissing, match="minima.k5"):
        program.span_seconds(got, "minima.k5")


def test_decode_bound_of_the_kernel_table():
    """K1's bound at the CCSDS capture (0.4137 ms, the port's kernel
    table) and at the WiMAX round (0.0439 ms)."""
    for name, batch, want in (("ccsds_128_64", 262144, 0.4137e-3),
                              ("wimax_1056_880", 4096, 0.0439e-3)):
        path = os.path.join(ROOT, "short_ldpc_decoding_osd_tpu_torch", "data",
                            name + ".npz")
        with numpy.load(path) as blob:
            h = blob["h"]
        assert program.decode_bound_s(h, batch, 12) == pytest.approx(want, rel=1e-3)


def test_readings_on_a_synthetic_round():
    h = numpy.ones((2, 4), numpy.uint8)
    events = _round_events() + [_span("sldpc.minima.k5", 165.0, 300.0)]
    summary = {"program": program.reduce_program(events)}
    work = {"h": h, "cap_b": 1000, "iters": 12, "cap": 64, "m": 2, "k": 2,
            "teps": 16}
    ctx = types.SimpleNamespace(kind="system", trace=summary, work=work,
                                profile={"counters": {"osd.rows": 128,
                                                      "osd.failures": 100}})
    got = {name: fn(ctx) for name, fn in program.READINGS.items()}
    assert got["host_syncs_per_round.system"] == 2.0
    assert got["host_syncs_per_step.phase1"] is None
    assert got["osd_rows_useful_pct.system"] == pytest.approx(78.125)
    assert got["capture_decode_roofline"] == pytest.approx(
        100.0 * program.decode_bound_s(h, 1000, 12) / 50e-6)
    assert got["k5_roofline"] == pytest.approx(
        100.0 * program.roofline.k5_bound_s(64, 2, 2, 16) / 100e-6)


def test_recording_window_counts_the_rows(monkeypatch):
    """A CPU run of the CCSDS system cell whose window records: the port's
    counters hold the window's rounds, and the run stays correct."""
    from short_ldpc_decoding_osd_tpu_torch.utils import profiling

    monkeypatch.setattr(trace, "Tracer", program.RecordingTracer)
    small = {"cap_b": 2048, "cap": 64, "check_within": 1, "checked_rounds": 1,
             "warmup_rounds": 1}
    seen = {}
    read = core.read_metrics

    def keep(specs, ctx):
        seen["ctx"] = ctx
        return read(specs, ctx)

    monkeypatch.setattr(core, "read_metrics", keep)
    try:
        line = core.run_cell(ROOT, "ccsds-system-3.0dB", 5, 0.2, False,
                             time.perf_counter(), device=torch.device("cpu"),
                             traffic=small)
        snap = profiling.snapshot()
    finally:
        profiling.reset()
    assert line["correct"], line["checks"]
    units = seen["ctx"].units
    assert snap["counters"]["osd.rows"] == 64 * units
    assert 0 < snap["counters"]["osd.failures"] <= 64 * units
    assert snap["spans"]["round"]["calls"] == units
    ctx = seen["ctx"]
    ctx.profile = snap
    assert 0 < program.osd_rows_useful_pct(ctx) <= 100
