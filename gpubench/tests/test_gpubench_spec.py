"""BENCHMARK.json against the files under gpubench/: every cell, metric and
configuration is found by name, and a cell or a decoder can be added by
files alone."""

import json
import os
import re
import shutil
import subprocess
import sys
import time
import types

import pytest
import torch

from gpubench import core

from conftest import ROOT

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = core.find_cell(ROOT, name)
    assert cell.traffic["kind"] in ("system", "phase1")
    assert set(cell.limits) and all(v is not None for v in cell.limits.values())
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer and all(m["moves"] in names for m in cell.per_layer)


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader_found_by_name(name):
    assert callable(core.metric_reader(name))


def test_configs_hold_their_sizes():
    for c in SPEC["configs"]:
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] == []
        with __import__("numpy").load(os.path.join(ROOT, cfg["parity_file"])) as blob:
            assert blob["h"].shape == (cfg["m"], cfg["n"])


def _bench_copy(tmp_path):
    """A root holding BENCHMARK.json and gpubench/, with the port and the
    run directories linked in."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "gpubench"), tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def test_new_cell_needs_files_only(tmp_path, monkeypatch):
    root = _bench_copy(tmp_path)
    for name in ("short_ldpc_decoding_osd_tpu_torch", "runs"):
        os.symlink(os.path.join(ROOT, name), root / name)
    traffic = {"kind": "system", "snr_db": 2.5, "cap_b": 1024, "cap": 32,
               "warmup_rounds": 1, "checked_rounds": 1, "check_within": 1}
    (root / "gpubench" / "traffic" / "ccsds-system-2.5dB.json").write_text(json.dumps(traffic))
    shutil.copy(root / "gpubench" / "checks" / "ccsds-system-3.0dB.json",
                root / "gpubench" / "checks" / "ccsds-system-2.5dB.json")
    spec = json.load(open(root / "BENCHMARK.json"))
    spec["workloads"].append({"name": "ccsds-system-2.5dB", "config": "ccsds_128_64",
                              "traffic": "ccsds-system-2.5dB", "chips": 1,
                              "why": "a new cell"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "ccsds-system-3.0dB" in m.get("workloads", []):
            m["workloads"].append("ccsds-system-2.5dB")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    # the copy's package, not the repository's
    monkeypatch.setattr(core, "BENCH_DIR", str(root / "gpubench"))
    line = core.run_cell(str(root), "ccsds-system-2.5dB", 3, 0.2, False,
                         time.perf_counter(), device=torch.device("cpu"))
    assert line["correct"] and line["attempted"] >= 1
    assert set(line["metrics"]) == {"system_cw_per_s", "setup_s"}


# a second decoder as a later configuration brings it: NMS-r, judged here by
# the port's plain dense decoder (a stand-in, never shipped: the reference
# imports nothing of the port), under numbers of its own
STAND_IN = '''"""NMS-r, a stand-in: the port's plain dense decoder."""
import numpy as np
import torch

from gpubench.reference import decode, sampling
from short_ldpc_decoding_osd_tpu_torch.ops import nms


def weights(nms_params):
    return {k: torch.as_tensor(np.asarray(v, np.float32))
            for k, v in nms_params.items()}


def soft_outputs(llr, ref, iters, slots, round_fn=None):
    h = ref["tables"].h
    edge_cols = nms.edge_columns(h.cpu().numpy().astype(np.uint8))
    traj = nms.decode(ref["weights"], h, llr, iters, "NMS-r", edge_cols)
    return {s: traj[s] for s in slots}


def capture_numbers(ref, cell, index, counters, count, llr, labels):
    iters = cell["iters"]
    llr_all, words = sampling.awgn_round(cell["seed"], index, ref["g"],
                                         cell["cap_b"], ref["sigma"])
    soft = soft_outputs(llr_all, ref, iters, {iters})[iters]
    bit_err, detected = decode.frame_stats(soft, words, ref["tables"].h)
    rows = decode.capture(detected, cell["cap"])
    bad = sum(int(a != b) for a, b in
              zip(counters.tolist(), decode.count(bit_err, detected)))
    bad += int(int(count) != int(detected.sum()))
    bad += int(((llr != llr_all[rows]).any(1)
                | (labels.to(torch.int32) != words[rows]).any(1)).sum())
    return {"capture_differ": bad}


def redecode_numbers(ref, cell, llr, labels, traj, detected):
    iters = cell["iters"]
    soft = soft_outputs(llr, ref, iters, set(range(iters + 1)))
    want = torch.stack([soft[i] for i in range(iters + 1)], 0)
    gap = float(((traj - want).abs() / (1.0 + want.abs())).max())
    _, det = decode.frame_stats(want[iters], labels, ref["tables"].h)
    return {"redecode_gap": gap, "detected_differ": int((det != detected).sum())}
'''


def _nmsr_cell(root):
    """A configuration whose variant is NMS-r and a system cell of it,
    added to the copy at ``root`` by files alone."""
    run_dir = root / "runs_nmsr"
    run_dir.mkdir()
    base = os.path.join(ROOT, "runs", "r4_pipeline")
    for fname in ("dia_model_cnn.pkl", "stopper_params.pkl", "decoding_path.json"):
        shutil.copy(os.path.join(base, fname), run_dir)
    shutil.copy(os.path.join(ROOT, "runs", "r5_variants_nmsr", "nms_params.pkl"),
                run_dir)
    run_cfg = json.load(open(os.path.join(base, "config.json")))
    (run_dir / "config.json").write_text(json.dumps(dict(run_cfg, variant="NMS-r")))
    bench = root / "gpubench"
    cfg = json.load(open(bench / "configs" / "ccsds_128_64.json"))
    cfg.update(name="ccsds_128_64_nmsr", variant="NMS-r", run_dir="runs_nmsr")
    (bench / "configs" / "ccsds_128_64_nmsr.json").write_text(json.dumps(cfg))
    traffic = {"kind": "system", "snr_db": 3.0, "cap_b": 1024, "cap": 32,
               "warmup_rounds": 1, "checked_rounds": 1, "check_within": 1}
    (bench / "traffic" / "ccsds-nmsr-system-3.0dB.json").write_text(json.dumps(traffic))
    limits = json.load(open(bench / "checks" / "ccsds-system-3.0dB.json"))
    del limits["capture_mismatch"], limits["redecode_mismatch"]
    limits |= {"capture_differ": 0, "redecode_gap": 1e-6, "detected_differ": 0}
    (bench / "checks" / "ccsds-nmsr-system-3.0dB.json").write_text(json.dumps(limits))
    spec = json.load(open(root / "BENCHMARK.json"))
    spec["configs"].append({"name": "ccsds_128_64_nmsr",
                            "source": "https://arxiv.org/abs/2404.14165",
                            "file": "gpubench/configs/ccsds_128_64_nmsr.json",
                            "reduced": [], "why": "a second decoder"})
    spec["workloads"].append({"name": "ccsds-nmsr-system-3.0dB",
                              "config": "ccsds_128_64_nmsr",
                              "traffic": "ccsds-nmsr-system-3.0dB", "chips": 1,
                              "why": "a second decoder"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "ccsds-system-3.0dB" in m.get("workloads", []):
            m["workloads"].append("ccsds-nmsr-system-3.0dB")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return "ccsds-nmsr-system-3.0dB"


def test_new_decoder_needs_its_file_only(tmp_path, monkeypatch):
    root = _bench_copy(tmp_path)
    for name in ("short_ldpc_decoding_osd_tpu_torch", "runs"):
        os.symlink(os.path.join(ROOT, name), root / name)
    name = _nmsr_cell(root)
    (root / "gpubench" / "reference" / "variants" / "NMS-r.py").write_text(STAND_IN)
    monkeypatch.setattr(core, "BENCH_DIR", str(root / "gpubench"))
    line = core.run_cell(str(root), name, 7, 0.2, False, time.perf_counter(),
                         device=torch.device("cpu"))
    assert line["correct"] and line["attempted"] >= 1, line["checks"]
    assert set(line["metrics"]) == {"system_cw_per_s", "setup_s"}
    assert {"capture_differ", "redecode_gap", "detected_differ",
            "walk_mismatch"} <= set(line["checks"])


def test_missing_decoder_file_fails(tmp_path, monkeypatch):
    """A cell whose variant has no decoder file gives no result line."""
    root = _bench_copy(tmp_path)
    for name in ("short_ldpc_decoding_osd_tpu_torch", "runs"):
        os.symlink(os.path.join(ROOT, name), root / name)
    name = _nmsr_cell(root)
    monkeypatch.setattr(core, "BENCH_DIR", str(root / "gpubench"))
    want = os.path.join(str(root / "gpubench"), "reference", "variants", "NMS-r.py")
    with pytest.raises(core.SpecError, match=re.escape(want)):
        core.run_cell(str(root), name, 7, 0.1, False, time.perf_counter(),
                      device=torch.device("cpu"))


def test_fused_step_needs_a_counters_rule():
    from gpubench.reference import judge

    ref = {"decoder": types.SimpleNamespace(__file__="NMS-x.py")}
    with pytest.raises(core.SpecError, match="counters rule"):
        judge.reference_counters(ref, {"batch": 1024}, 1)


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]])
def test_config_has_its_decoder_file(name):
    entry = {c["name"]: c for c in SPEC["configs"]}[name]
    cfg = json.load(open(os.path.join(ROOT, entry["file"])))
    dec = core.decoder(cfg["variant"])
    for fn in ("weights", "soft_outputs", "capture_numbers", "redecode_numbers"):
        assert callable(getattr(dec, fn)), fn
    phase1 = [w for w in SPEC["workloads"] if w["config"] == name
              and core.find_cell(ROOT, w["name"]).traffic["kind"] == "phase1"]
    assert not phase1 or callable(dec.counters)


def _run(args, cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "gpubench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, env=env, timeout=300)


def test_run_without_a_card_fails():
    out = _run(["--workload", "ccsds-system-3.0dB", "--seed", "1",
                "--seconds", "1", "--trace", "0"], ROOT)
    assert out.returncode != 0
    assert "{" not in out.stdout and "CUDA" in out.stderr


def test_run_in_a_bare_directory_fails(tmp_path):
    root = _bench_copy(tmp_path)
    out = _run(["--workload", "ccsds-phase1-3.0dB", "--seed", "1",
                "--seconds", "1", "--trace", "0"], root)
    assert out.returncode != 0 and "{" not in out.stdout


def test_no_jax_after_a_cells_imports():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from gpubench import core, control, trace\n"
        "from gpubench.kinds import system, phase1\n"
        "from short_ldpc_decoding_osd_tpu_torch import system as s, convert\n"
        "from short_ldpc_decoding_osd_tpu_torch.osd import engine\n"
        "from short_ldpc_decoding_osd_tpu_torch.ops import nms_edge\n"
        "print(core.forbidden_modules())\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_forbidden_names_compare_whole():
    assert core.forbidden_modules(["short_ldpc_decoding_osd_tpu_torch.ops",
                                   "jaxtyping", "flaxen"]) == []
    assert core.forbidden_modules(["jax.numpy", "short_ldpc_decoding_osd_tpu.ops",
                                   "torch"]) == ["jax", "short_ldpc_decoding_osd_tpu"]


def test_reference_imports_nothing_of_the_port():
    import ast
    ref_dir = os.path.join(ROOT, "gpubench", "reference")
    files = [os.path.join(d, f) for d, _, names in os.walk(ref_dir)
             for f in names if f.endswith(".py")]
    assert os.path.join(ref_dir, "variants", "NMS-1.py") in files
    for fname in files:
        tree = ast.parse(open(fname).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] in ("torch", "numpy", "json", "os",
                                              "pickle", "math", "itertools",
                                              "__future__"), (fname, name)
    variants = sorted(f[:-3] for f in os.listdir(os.path.join(ref_dir, "variants"))
                      if f.endswith(".py"))
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import gpubench.reference.setup, gpubench.reference.judge\n"
            "from gpubench import core\n"
            "for v in %r:\n    core.decoder(v)\n"
            "print(sorted(m for m in sys.modules if m.startswith('short_ldpc')))\n"
            % (ROOT, variants))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _events(spans: dict[str, list[tuple[float, float]]]) -> list[dict]:
    """Chrome-trace events of a 1,000 us window: for every range span
    (name -> [(start, end)]), one kernel of 100 us launched inside it."""
    from gpubench import trace

    events = [{"name": trace.WINDOW, "cat": "user_annotation", "ts": 0.0,
               "dur": 1000.0}]
    corr = 0
    for name, ivals in spans.items():
        for s, e in ivals:
            corr += 1
            events += [
                {"name": "gpubench." + name, "cat": "user_annotation",
                 "ts": s, "dur": e - s},
                {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": s + 1,
                 "dur": 2.0, "args": {"correlation": corr}},
                {"name": "k_" + name, "cat": "kernel", "ts": s + 5,
                 "dur": 100.0, "args": {"correlation": corr}},
            ]
    return events


def _system_ctx(summary):
    import numpy

    cell = core.find_cell(ROOT, "ccsds-system-3.0dB")
    cfg = cell.config
    with numpy.load(os.path.join(ROOT, cfg["parity_file"])) as blob:
        h = blob["h"]
    m, n = h.shape
    work = {"h": h, "m": m, "n": n, "k": n - m, "cap_b": 262144, "cap": 32768,
            "iters": 12, "teps": 1536}
    ctx = types.SimpleNamespace(kind="system", trace=summary, units=2,
                                lead={"units": 4, "window_s": 2e-3}, work=work)
    return cell, ctx


@pytest.mark.parametrize("missing", [None, "capture_round", "prepare", "minima"])
def test_a_range_with_no_call_fails_the_traced_run(missing):
    """A traced run whose range of a reported metric never ran (its tap
    removed, or the function renamed or inlined) raises instead of
    leaving the metric out; with every range there, every metric reads."""
    from gpubench import trace

    spans = {"capture_round": [(10.0, 200.0), (500.0, 690.0)],
             "prepare": [(210.0, 330.0), (700.0, 820.0)],
             "minima": [(340.0, 460.0), (830.0, 950.0)]}
    spans.pop(missing, None)
    summary = trace.reduce_events(_events(spans))
    cell, ctx = _system_ctx(summary)
    if missing is None:
        metrics = core.read_metrics(cell.per_layer, ctx)
        assert set(metrics) == {m["name"] for m in cell.per_layer}
        # 600 us of device time over 2 rounds against 0.5 ms a round untraced
        assert metrics["device_idle_pct.system"]["value"] == pytest.approx(40.0)
        assert metrics["launches_per_round.system"]["value"] == 3.0
        return
    with pytest.raises(trace.RangeMissing, match=missing):
        core.read_metrics(cell.per_layer, ctx)


def test_new_metric_needs_its_file_only(tmp_path, monkeypatch):
    """A reader added as a file sees everything the kind returned: the
    peak memory and the checked rounds' counters and failure counts."""
    root = _bench_copy(tmp_path)
    for name in ("short_ldpc_decoding_osd_tpu_torch", "runs"):
        os.symlink(os.path.join(ROOT, name), root / name)
    readers = {
        "walked_failure_share": (
            "def read(ctx):\n"
            "    if ctx.kind != 'system':\n        return None\n"
            "    cap = ctx.work['cap']\n"
            "    got = sum(min(c['failures'], cap) for c in ctx.counts)\n"
            "    return 100.0 * got / (len(ctx.counts) * cap)\n"),
        "memory_peak": "def read(ctx):\n    return ctx.memory_peak_bytes\n",
    }
    spec = json.load(open(root / "BENCHMARK.json"))
    for name, body in readers.items():
        (root / "gpubench" / "metrics" / (name + ".py")).write_text(body)
        spec["end_to_end"].append({"name": name, "unit": "x", "better": "higher",
                                   "bound": 0.01, "source": "host_clock",
                                   "workloads": ["ccsds-system-3.0dB"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setattr(core, "BENCH_DIR", str(root / "gpubench"))
    small = {"cap_b": 2048, "cap": 64, "check_within": 1, "checked_rounds": 1,
             "warmup_rounds": 1}
    line = core.run_cell(str(root), "ccsds-system-3.0dB", 5, 0.2, False,
                         time.perf_counter(), device=torch.device("cpu"),
                         traffic=small)
    assert line["correct"], line["checks"]
    assert 0 < line["metrics"]["walked_failure_share"]["value"] <= 100
    assert line["metrics"]["memory_peak"]["value"] == line["device"]["memory_peak_bytes"]
