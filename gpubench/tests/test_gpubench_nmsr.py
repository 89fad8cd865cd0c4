"""The NMS-r cell, ``ccsds-nmsr-system-3.0dB``, on the CPU at small sizes:
a sound run is correct; planted faults (a captured row changed, the
network's first layer perturbed) and the controls (the reference's TF32
network and bfloat16 messages in the system's place) read over their
limits; its two roofline readers stay below 100% on a synthetic trace;
and a configuration whose variant has no decoder file gives no result."""

import json
import os
import re
import shutil
import time
import types

import numpy as np
import pytest
import torch

from gpubench import control_decoder, core, roofline_nmsr, trace
from gpubench.reference import setup
from short_ldpc_decoding_osd_tpu_torch import system

from conftest import ROOT

NAME = "ccsds-nmsr-system-3.0dB"
SMALL = {"cap_b": 4096, "cap": 512, "check_within": 1, "checked_rounds": 1,
         "warmup_rounds": 1}
SEED = 2**31 + 43


def run(traffic=SMALL):
    return core.run_cell(ROOT, NAME, SEED, 0.2, False, time.perf_counter(),
                         device=torch.device("cpu"), traffic=traffic)


def test_sound_run_is_correct():
    line = run()
    cell = core.find_cell(ROOT, NAME)
    assert line["correct"] and line["failed"] == 0, line["checks"]
    assert set(line["checks"]) == set(cell.limits)
    assert set(line["metrics"]) == {"system_cw_per_s", "setup_s"}


def test_changed_captured_row_fails(monkeypatch):
    """One captured row's LLR moved by one ulp: no frame of the round."""
    inner = system.TwoPhase.capture_round

    def changed(self, i):
        counters, buf = inner(self, i)
        buf["llr"][3, 5] = torch.nextafter(buf["llr"][3, 5], torch.tensor(100.0))
        return counters, buf

    monkeypatch.setattr(system.TwoPhase, "capture_round", changed)
    line = run()
    assert not line["correct"]
    assert line["checks"]["capture_differ"]["value"] >= 1


def test_perturbed_first_layer_fails(monkeypatch):
    """The system's ``nn_w1`` scaled by 1 + 2^-10 (a TF32 ulp) reads over
    the re-decode's gap."""
    inner = system.load_run

    def perturbed(run_dir, device):
        run = inner(run_dir, device)
        run["nms_params"]["nn_w1"] = run["nms_params"]["nn_w1"] * (1.0 + 2.0**-10)
        return run

    monkeypatch.setattr(system, "load_run", perturbed)
    line = run()
    assert not line["correct"]
    assert line["checks"]["redecode_gap"]["value"] > line["checks"]["redecode_gap"]["limit"]


@pytest.mark.parametrize("mode", ["tf32", "bf16"])
def test_controls_fail(mode):
    cell = core.find_cell(ROOT, NAME)
    ref = setup.build(ROOT, cell.config, cell.traffic, torch.device("cpu"))
    args = {"cap_b": SMALL["cap_b"], "cap": SMALL["cap"],
            "iters": int(cell.config["num_iterations"])}
    nums = control_decoder.decoder_numbers(ref, args, SEED, 0, mode)
    over = {k for k, v in nums.items() if v > cell.limits[k]}
    assert "redecode_gap" in over, nums


def _summary(capture_us, redecode_us):
    """A traced window with one round: a kernel of ``capture_us`` launched
    inside range ``capture_round`` and one of ``redecode_us`` inside
    ``redecode``."""
    events = [{"name": trace.WINDOW, "cat": "user_annotation", "ts": 0.0,
               "dur": 1e7}]
    for corr, (name, dur) in enumerate((("capture_round", capture_us),
                                        ("redecode", redecode_us)), 1):
        start = 10.0 + corr * 4e6
        events += [
            {"name": "gpubench." + name, "cat": "user_annotation",
             "ts": start, "dur": 10.0},
            {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": start + 1,
             "dur": 2.0, "args": {"correlation": corr}},
            {"name": "k_" + name, "cat": "kernel", "ts": start + 5,
             "dur": dur, "args": {"correlation": corr}},
        ]
    return trace.reduce_events(events)


def _ctx(summary, variant="NMS-r"):
    cell = core.find_cell(ROOT, NAME)
    with np.load(os.path.join(ROOT, cell.config["parity_file"])) as blob:
        h = blob["h"]
    work = {"h": h, "m": 64, "n": 128, "k": 64, "cap_b": 262144, "cap": 32768,
            "iters": 12, "teps": 1280}
    return cell, types.SimpleNamespace(
        kind="system", trace=summary, units=1, lead={"units": 1, "window_s": 2.0},
        work=work, config=dict(cell.config, variant=variant))


def test_readers_stay_below_100():
    """At the port's round (capture 1.37 s, re-decode 0.175 s) both read
    about 0.05%; at their bounds' own times, 100%."""
    cell, ctx = _ctx(_summary(1.37e6, 1.75e5))
    metrics = core.read_metrics(cell.per_layer, ctx)
    for name in ("nmsr_capture_roofline", "nmsr_redecode_roofline"):
        assert 0.0 < metrics[name]["value"] < 0.1, metrics
    h = ctx.work["h"]
    _, ctx = _ctx(_summary(1e6 * roofline_nmsr.capture_bound_s(h, 262144, 12, 32768),
                           1e6 * roofline_nmsr.redecode_bound_s(h, 32768, 12)))
    metrics = core.read_metrics(cell.per_layer, ctx)
    for name in ("nmsr_capture_roofline", "nmsr_redecode_roofline"):
        assert metrics[name]["value"] == pytest.approx(100.0, rel=1e-3)


def test_readers_skip_another_decoder():
    cell, ctx = _ctx(_summary(1.37e6, 1.75e5), variant="NMS-1")
    metrics = core.read_metrics(cell.per_layer, ctx)
    assert "nmsr_capture_roofline" not in metrics
    assert "nmsr_redecode_roofline" not in metrics


def test_bound_counts_the_least_work():
    """7,168 f32 instructions a CCSDS frame-iteration (NMS-1's edge decode:
    4,352), and the sort network's size by degree."""
    cell, ctx = _ctx(None)
    h = ctx.work["h"]
    assert roofline_nmsr.frame_iteration_ops(h) == 64 * (2 * 19 + 2 * 7) + 7 * 512 + 2 * 64 + 128
    assert roofline_nmsr.capture_bound_s(h, 262144, 12, 32768) == pytest.approx(
        6.781e-4, rel=1e-3)
    with pytest.raises(ValueError, match="regular"):
        roofline_nmsr.frame_iteration_ops(np.array([[1, 1, 0], [1, 1, 1]]))


def test_variant_without_a_file_fails(tmp_path, monkeypatch):
    """A configuration whose variant has no decoder file raises
    ``SpecError`` naming the file it looked for."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "gpubench"), tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name in ("short_ldpc_decoding_osd_tpu_torch", "runs"):
        os.symlink(os.path.join(ROOT, name), tmp_path / name)
    path = tmp_path / "gpubench" / "configs" / "ccsds_128_64_nmsr.json"
    cfg = json.loads(path.read_text())
    path.write_text(json.dumps(dict(cfg, variant="NMS-x")))
    monkeypatch.setattr(core, "BENCH_DIR", str(tmp_path / "gpubench"))
    want = os.path.join(str(tmp_path / "gpubench"), "reference", "variants",
                        "NMS-x.py")
    with pytest.raises(core.SpecError, match=re.escape(want)):
        core.run_cell(str(tmp_path), NAME, 7, 0.1, False, time.perf_counter(),
                      device=torch.device("cpu"), traffic=SMALL)
