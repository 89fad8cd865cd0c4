"""``sldpc-torch bench`` and ``system.bench`` on the CPU: the line of
``bench.py:main`` (its keys less the four TPU figures, its baseline and
rounding, phase 1 at ``--batch``/``--snr`` and the two-phase system at
3.0 dB) with both phases cut to tiny sizes, the fallback to the numpy
stand-in, and the stand-in's decode against the port's plain
``nms.decode``.

Tolerances: none; syndrome flags, keys and rounded fields exact.
"""

import json
import os

import numpy as np
import pytest
import torch

from short_ldpc_decoding_osd_tpu_torch import system
from short_ldpc_decoding_osd_tpu_torch.cli.main import main as cli_main
from short_ldpc_decoding_osd_tpu_torch.codes import get_code
from short_ldpc_decoding_osd_tpu_torch.ops import nms

from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# bench.py's TPU figures: the one-hot MXU FLOP model and shares of the v5e peak
TPU_KEYS = {"flops_per_frame_model", "effective_tflops", "mfu_pct_vs_bf16_peak",
            "mfu_pct_algorithmic"}
W_CHK = float(np.log1p(np.exp(-0.048)))  # softplus of NMS-1's initial factor


def bench_r05_keys() -> set:
    with open(os.path.join(_ROOT, "BENCH_r05.json")) as fh:
        return set(json.load(fh)["parsed"])


@pytest.fixture
def tiny_phases(monkeypatch):
    """Both phases record their arguments and run at tiny sizes: phase 1
    one step of 1,024 frames, the system one round of 1,024 frames with 64
    capture rows."""
    calls = {}
    phase1, two_phase = system.phase1_throughput, system.run_two_phase

    def tiny_phase1(**kw):
        calls["phase1"] = kw
        calls["phase1_out"] = phase1(batch=1024, steps=1, snr_db=kw["snr_db"],
                                     device=kw["device"])
        return dict(calls["phase1_out"])

    def tiny_two_phase(**kw):
        calls["system"] = kw
        return two_phase(run_dir=kw["run_dir"], frames=1024, cap_b=1024, cap=64,
                         snr_db=kw["snr_db"], device=kw["device"])

    monkeypatch.setattr(system, "phase1_throughput", tiny_phase1)
    monkeypatch.setattr(system, "run_two_phase", tiny_two_phase)
    return calls


def bench_line(capsys, *args) -> dict:
    assert cli_main(["bench", "--device", "cpu", *args]) == 0
    (line,) = capsys.readouterr().out.strip().splitlines()
    return json.loads(line)


def test_bench_prints_bench_py_line(tiny_phases, capsys):
    line = bench_line(capsys, "--snr", "2.5")
    p1 = tiny_phases["phase1"]
    assert (p1["batch"], p1["snr_db"], p1["device"]) == (16384, 2.5,
                                                         torch.device("cpu"))
    assert tiny_phases["system"]["snr_db"] == 3.0
    assert line["device"] == "cpu" and line["snr_db"] == 2.5
    assert line["system_snr_db"] == 3.0
    assert bench_r05_keys() - TPU_KEYS <= set(line)
    assert not TPU_KEYS & set(line)

    rate = tiny_phases["phase1_out"]["value"]
    with open(os.path.join(_ROOT, "runs", "refparity", "refparity.json")) as fh:
        tf_rate = json.load(fh)["ref_tf_codewords_per_s_cpu"]
    assert line["value"] == round(rate, 1)
    assert line["vs_baseline"] == round(rate / tf_rate, 2)
    assert line["baseline_kind"] == "reference_tf2_cpu"
    assert line["baseline_tf_codewords_per_s"] == round(tf_rate, 1) == 827.6
    standin = line["numpy_standin_codewords_per_s"]
    assert standin > 0 and line["vs_numpy_standin"] > 0
    assert line["flops_per_frame_algorithmic"] == 49152.0
    assert line["algorithmic_tflops"] == round(rate * 49152.0 / 1e12, 2)
    assert line["metric"] == "nms_decoded_codewords_per_s_1chip"
    assert line["system_frames"] == 1024 and line["system_osd_rows_walked"] == 64
    assert line["system_fer_nms"] == round(
        line["system_frame_errors"] / line["system_frames"], 6)
    assert set(line["system_split_s"]) == {"phase1_nms_capture_only",
                                           "two_phase_total", "phase2_implied"}


@pytest.mark.parametrize("record", [None, "{}", "not json"],
                         ids=["missing", "no_rate", "not_json"])
def test_bench_falls_back_to_the_numpy_standin(tiny_phases, monkeypatch, capsys,
                                               tmp_path, record):
    path = tmp_path / "refparity.json"
    if record is not None:
        path.write_text(record)
    monkeypatch.setattr(system, "REFPARITY_JSON", str(path))
    line = bench_line(capsys)
    assert line["baseline_kind"] == "numpy_standin_cpu"
    assert line["baseline_tf_codewords_per_s"] is None
    assert line["vs_baseline"] == line["vs_numpy_standin"]
    assert tiny_phases["phase1"]["snr_db"] == 3.0


@pytest.mark.parametrize("failing", ["phase1_throughput", "run_two_phase"])
def test_bench_raises_when_a_phase_fails(monkeypatch, failing):
    def fail(**kw):
        raise RuntimeError(f"{failing} failed")

    monkeypatch.setattr(system, "numpy_nms_throughput", lambda *a, **k: 500.0)
    monkeypatch.setattr(system, "phase1_throughput", lambda **kw: {
        "metric": "nms_decoded_codewords_per_s_1chip", "value": 1.0,
        "unit": "codewords/s", "iters": 12})
    monkeypatch.setattr(system, failing, fail)
    with pytest.raises(RuntimeError, match=f"{failing} failed"):
        system.bench(device="cpu")


def test_numpy_standin_decode_matches_plain_nms():
    """64 seeded 3.0 dB frames of the stand-in's own sampler: its syndrome
    flags == those of ``nms.decode`` at the same factor."""
    code = get_code("ccsds_128_64")
    rng = np.random.default_rng(0)
    sigma = np.sqrt(1.0 / (2.0 * code.rate * 10 ** (3.0 / 10.0)))
    llr = (1.0 + sigma * rng.standard_normal((64, code.n))).astype(np.float32)
    flags = system.numpy_nms_decode(code.h, llr, W_CHK, 12)
    soft = nms.decode(nms.init_params("NMS-1"), code.h, torch.as_tensor(llr), 12)
    stats = nms.frame_stats(soft[-1], torch.zeros(llr.shape, dtype=torch.int32),
                            code.h)
    assert 0 < flags.sum() < len(flags)
    np.testing.assert_array_equal(flags, stats["detected_failure"].numpy())
