"""The Rayleigh two-phase system on the port vs the JAX package (CPU).

``pipeline/rayleigh.py`` is the port's counterpart of
``scripts/rayleigh_two_phase.py`` (record ``runs/r5_rayleigh/``): fading
failures of ``runs/r4_pipeline``'s NMS captured as raw LLR rows, then
walked by the raw-LLR phase-2 step with the AWGN-trained DIA, stopper and
path.  Deep fades give LLRs near zero, which stresses the min/submin ties
and the zero-sign rule of the decoders and the ties of ``prepare``'s stable
|LLR| sort.

Tolerances: walk decisions and detected flags exact; the DIA on JAX's
trajectory within rtol 1e-5 / atol 1e-6; the step's refined values within
``STEP_TOL`` = 1e-4 (1.1e-5 measured on these rows).
"""

import ast
import json
import os

import numpy as np
import pytest

from short_ldpc_decoding_osd_tpu_torch.channel import ChannelSpec
from short_ldpc_decoding_osd_tpu_torch.cli.main import main as cli_main
from short_ldpc_decoding_osd_tpu_torch.codes import get_code
from short_ldpc_decoding_osd_tpu_torch.convert import load_jax_pickle
from short_ldpc_decoding_osd_tpu_torch.mc import harness
from short_ldpc_decoding_osd_tpu_torch.pipeline import rayleigh
from torch_phase2_common import (assert_phase2_matches, failures_first,
                                 load_case, seeded_rows)
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R4 = os.path.join(_ROOT, "runs", "r4_pipeline")
RECORD = os.path.join(_ROOT, "runs", "r5_rayleigh")
SCRIPT = os.path.join(_ROOT, "scripts", "rayleigh_two_phase.py")
STEP_TOL = 1e-4


def test_capture_returns_raw_fading_failures():
    """``run_nms_mc`` with a Rayleigh spec, capture on and trajectories off
    (the capture step, not the fused counters): (N, 1, n) raw LLR rows of
    detected failures, each of which the dense re-decode also flags."""
    code = get_code("ccsds_128_64")
    params = load_jax_pickle(os.path.join(R4, "nms_params.pkl"))
    spec = ChannelSpec.rayleigh_spec(6.0, code.rate, duration=1)
    assert spec.rayleigh and spec.fading_block == 16
    stats, fb = harness.run_nms_mc(
        code, params, "NMS-1", 12, 6.0, batch=256, error_budget=10**9,
        max_frames=1024, seed=515, spec=spec, capture_failures=True,
        capture_limit=64, capture_trajectories=False, device="cpu")
    assert stats.frames == 1024 and stats.detected_failures > 64
    assert not fb.confirmed and fb.trajectories.shape == (64, 1, code.n)
    assert fb.labels.shape == (64, code.n)
    traj = harness.trajectories_for_llrs(code, params, "NMS-1", 12,
                                         fb.trajectories[:, 0], device="cpu")
    assert harness.detected_failure_mask(code, "NMS-1", traj).all()


def test_phase2_matches_jax():
    """48 seeded Rayleigh failure rows (6 dB, 16-bit fade blocks) of
    ``runs/r4_pipeline`` through the port's phase-2 step and JAX's over the
    path's 1,439 TEPs: decisions and detected flags equal."""
    case = load_case(R4)
    assert int(case["mask"].sum()) == 1_439
    code = case["port"]["code"]
    llr, words = seeded_rows(code, 6.0, 256, 6, fade_block=16)
    llr, words, failures = failures_first(case["port"], llr, words, 48)
    assert failures == 48
    assert (np.abs(llr) < 0.05).sum() > 100  # deep fades: near-zero LLRs
    detected, err = assert_phase2_matches(case, llr, words, STEP_TOL)
    assert detected == 48 and err < STEP_TOL


def _script_point_keys():
    """The keys of the point dict ``scripts/rayleigh_two_phase.py`` writes,
    read from its source."""
    with open(SCRIPT) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "point"):
            return [ast.literal_eval(k) for k in node.value.keys]
    raise AssertionError("no point dict in the script")


def test_main_writes_the_scripts_points(tmp_path, capsys):
    """A small ``pipeline.rayleigh`` run (512 frames a step, 1,024 a point,
    16 rows walked) writes ``two_phase_rayleigh.json`` with exactly the JAX
    script's point keys, in its order (the record's too)."""
    out = tmp_path / "rayleigh"
    rayleigh.main(["--run", R4, "--snrs", "6.0,10.0", "--budget", "16",
                   "--out", str(out), "--device", "cpu"],
                  batch=512, max_frames=1024)
    with open(out / "two_phase_rayleigh.json") as fh:
        points = json.load(fh)["points"]
    with open(os.path.join(RECORD, "two_phase_rayleigh.json")) as fh:
        record = json.load(fh)["points"]
    keys = _script_point_keys()
    assert [list(p) for p in points] == [keys, keys]
    assert list(record[0]) == keys
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert printed == points
    for point, snr in zip(points, (6.0, 10.0)):
        assert point["snr_db"] == snr and point["frames"] == 1024
        assert point["fade_block_bits"] == 16 and point["channel"] == "rayleigh"
        assert point["osd_walked"] == 16  # the re-decode confirms every row
        assert 0 <= point["osd_success"] <= point["osd_walked"]
        assert point["fer_osd"] == (16 - point["osd_success"]) / 16
        assert point["fer_total"] == pytest.approx(
            point["fer_nms_detected"] * point["fer_osd"] + point["ufer"])
    assert points[0]["fer_nms_detected"] > points[1]["fer_nms_detected"]


def test_cli_eval_nms_rayleigh(tmp_path):
    """``sldpc-torch eval-nms --channel rayleigh --device cpu`` writes
    ``nms_fer.json`` (as JAX's ``tests/test_cli.py`` drives ``sldpc``) with
    the record's point keys."""
    run_dir = str(tmp_path / "run")
    cli_main(["train-nms", "--steps", "3", "--batch", "16", "--iterations", "3",
              "--run-dir", run_dir, "--device", "cpu"])
    cli_main(["eval-nms", "--snrs", "8.0:8.0:1", "--batch", "128",
              "--error-budget", "1000000000", "--max-frames", "256",
              "--iterations", "3", "--run-dir", run_dir, "--channel", "rayleigh",
              "--fade-duration", "16", "--device", "cpu"])
    with open(os.path.join(run_dir, "nms_fer.json")) as fh:
        point = json.load(fh)["points"][0]
    with open(os.path.join(RECORD, "nms_fer.json")) as fh:
        record = json.load(fh)["points"][0]
    assert point["frames"] == 256 and 0.0 <= point["fer"] <= 1.0
    assert list(point) == list(record)


def test_fade_duration_help_names_the_block(capsys):
    """The block is 16 x ``--fade-duration`` bits
    (``ChannelSpec.rayleigh_spec``), and both command lines say so."""
    assert ChannelSpec.rayleigh_spec(6.0, 0.5, duration=3).fading_block == 48
    for run in (lambda: cli_main(["eval-nms", "--help"]),
                lambda: rayleigh.main(["--help"])):
        with pytest.raises(SystemExit):
            run()
        text = " ".join(capsys.readouterr().out.split())
        assert "fading blocks of 16 x this many bits" in text
