"""The two cells of the ENMS configuration's PR on the CPU at small sizes:
``wimax-enms-phase1-4.0dB`` (ENMS's fused step on WiMAX's extended
matrix) and ``wimax-system-4.0dB`` (the WiMAX two-phase rounds at 4.0 dB)
come out correct; the ENMS step decoding H in its place does not; the
ENMS cell's roofline reader counts the extended matrix's work and stays
at or below 100% on a synthetic trace; and the configuration's file names
its source and cuts nothing."""

import json
import os
import time
import types

import numpy as np
import pytest
import torch

from gpubench import core, roofline, trace
from short_ldpc_decoding_osd_tpu_torch.codes import get_code
from short_ldpc_decoding_osd_tpu_torch.ops import nms_edge

from conftest import ROOT

ENMS_CELL = "wimax-enms-phase1-4.0dB"
SYSTEM_CELL = "wimax-system-4.0dB"
SMALL = {
    ENMS_CELL: {"batch": 1024, "check_within": 2, "checked_steps": 2,
                "warmup_steps": 1},
    SYSTEM_CELL: {"cap_b": 512, "cap": 4, "check_within": 1,
                  "warmup_rounds": 1},
}
SEED = 2**31 + 2929


def run(name, seconds=0.3):
    return core.run_cell(ROOT, name, SEED, seconds, False, time.perf_counter(),
                         device=torch.device("cpu"), traffic=SMALL[name])


@pytest.mark.parametrize("name", list(SMALL))
def test_sound_run_is_correct(name):
    line = run(name)
    cell = core.find_cell(ROOT, name)
    assert line["correct"] and line["failed"] == 0, line["checks"]
    assert set(line["checks"]) == set(cell.limits)
    assert line["metrics"]["setup_s"]["value"] > 0


def test_h_in_enms_place_is_not_correct(monkeypatch):
    """The fused step on H with ENMS's weights, as a set-up that ignored
    the variant decodes: ``counter_mismatch`` above 0."""
    inner = nms_edge.mc_setup

    def on_h(code, params, variant, *args, **kwargs):
        return inner(code, params, "NMS-1", *args, **kwargs)

    monkeypatch.setattr(nms_edge, "mc_setup", on_h)
    line = run(ENMS_CELL)
    assert not line["correct"]
    assert line["checks"]["counter_mismatch"]["value"] > 0


def _summary(step_us):
    """A traced window with one fused step: a kernel of ``step_us``
    launched inside range ``phase1_step``."""
    events = [{"name": trace.WINDOW, "cat": "user_annotation", "ts": 0.0,
               "dur": 1e7},
              {"name": "gpubench.phase1_step", "cat": "user_annotation",
               "ts": 10.0, "dur": 10.0},
              {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 11.0,
               "dur": 2.0, "args": {"correlation": 1}},
              {"name": "k_step", "cat": "kernel", "ts": 15.0, "dur": step_us,
               "args": {"correlation": 1}}]
    return trace.reduce_events(events)


def _ctx(summary, variant="ENMS"):
    cell = core.find_cell(ROOT, ENMS_CELL)
    with np.load(os.path.join(ROOT, cell.config["parity_file"])) as blob:
        h = blob["h"].astype(np.float32)
    # a 262,144-frame step: every frame 4 iterations, 208 of each group of
    # 512 carried 8 more
    carried = 262_144 // 512 * 208
    work = {"h": h, "frame_iters_per_step": 262_144 * 4 + carried * 8,
            "closings_per_step": 262_144 + carried}
    return cell, types.SimpleNamespace(
        kind="phase1", trace=summary, units=1, lead={"units": 1, "window_s": 1.0},
        work=work, config=dict(cell.config, variant=variant))


def test_roofline_counts_the_extended_matrix_and_stays_below_100():
    """The bound counts the extended matrix's 5,104 edges (H's 3,520):
    at the bound's own time the reader reads 100%, at a step of 30 ms a
    few per cent, and it leaves other decoders' steps alone."""
    cell, ctx = _ctx(None)
    w = ctx.work
    h_ext = get_code("wimax_1056_880").extended().h
    bound = roofline.compact_bound_s(h_ext, w["frame_iters_per_step"],
                                     w["closings_per_step"])
    assert bound > 1.4 * roofline.compact_bound_s(
        w["h"], w["frame_iters_per_step"], w["closings_per_step"])
    names = [m["name"] for m in cell.per_layer]
    assert "enms_phase1_roofline" in names and "phase1_roofline" not in names
    for step_us, want in ((1e6 * bound, 100.0), (3e4, 100.0 * bound / 3e-2)):
        _, ctx = _ctx(_summary(step_us))
        got = core.read_metrics(cell.per_layer, ctx)["enms_phase1_roofline"]
        assert got["value"] == pytest.approx(want, rel=1e-3)
        assert got["value"] <= 100.0 * (1 + 1e-6)
    _, ctx = _ctx(_summary(3e4), variant="NMS-1")
    assert core.metric_reader("enms_phase1_roofline")(ctx) is None


def test_config_names_its_source_and_cuts_nothing():
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    entry = {c["name"]: c for c in spec["configs"]}["wimax_1056_880_enms"]
    cfg = json.load(open(os.path.join(ROOT, entry["file"])))
    assert cfg["source"] == entry["source"] and len(entry["source"]) <= 200
    assert "fill_matrix_info.py:131-150" in entry["source"]
    assert "wimax_1056_0.83.alist" in entry["source"]
    assert cfg["reduced"] == entry["reduced"] == []
    assert cfg["variant"] == "ENMS" and cfg["run_dir"] == "runs/r29_enms_wimax"
    with open(os.path.join(ROOT, cfg["run_dir"], "config.json")) as fh:
        run = json.load(fh)
    assert run["variant"] == "ENMS" and run["code_name"] == cfg["code"]
    cells = {w["name"]: w for w in spec["workloads"]}
    assert cells[ENMS_CELL]["config"] == "wimax_1056_880_enms"
    assert cells[SYSTEM_CELL]["config"] == "wimax_1056_880"
    assert cells[ENMS_CELL]["chips"] == cells[SYSTEM_CELL]["chips"] == 1
