"""The port's recipe side vs the JAX package (CPU): ``osd/engine.py``'s
trajectory step and iteration statistics, ``mc/harness.py``'s CE/BER
lists, ``utils/profiling.py``, ``pipeline/recipe.py`` end to end at a tiny
size (as ``tests/test_recipe_e2e.py`` runs JAX's) and ``cli/main.py``.

Tolerances: walk decisions and detected flags exact; per-row CE rtol 1e-5
(f32 sums of 128 terms in another order), bit-error counts exact; the
host CE/BER lists rtol 1e-12 (the same f64 arithmetic); a port-written
DIA refined by the JAX package rtol 1e-5.
"""

import dataclasses
import json
import os
import pickle
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import short_ldpc_decoding_osd_tpu_torch as port
from short_ldpc_decoding_osd_tpu.codes import get_code as jax_get_code
from short_ldpc_decoding_osd_tpu.mc import harness as jharness
from short_ldpc_decoding_osd_tpu.models import dia as jdia
from short_ldpc_decoding_osd_tpu.osd import engine as jengine
from short_ldpc_decoding_osd_tpu.osd import segments as jseg
from short_ldpc_decoding_osd_tpu.pipeline.recipe import RunDir as JaxRunDir
from short_ldpc_decoding_osd_tpu_torch import convert
from short_ldpc_decoding_osd_tpu_torch.baselines import conventional, fs_osd, pb_osd
from short_ldpc_decoding_osd_tpu_torch.cli.main import main as cli_main
from short_ldpc_decoding_osd_tpu_torch.codes import get_code
from short_ldpc_decoding_osd_tpu_torch.mc import harness
from short_ldpc_decoding_osd_tpu_torch.osd import engine, segments
from short_ldpc_decoding_osd_tpu_torch.pipeline import multicode, rayleigh
from short_ldpc_decoding_osd_tpu_torch.pipeline import recipe as rec
from short_ldpc_decoding_osd_tpu_torch.train import dia_train, stopper_train
from short_ldpc_decoding_osd_tpu_torch.utils.profiling import JsonlLogger, Timer

from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R4 = os.path.join(_ROOT, "runs", "r4_pipeline")
WALK_KEYS = ("success", "strict_success", "complexity", "window_num")


@pytest.fixture(scope="module")
def r4():
    blob = np.load(os.path.join(_ROOT, "runs", "refparity", "failures.npz"))
    run = convert.load_run(R4, "cpu")
    blocks, acc = jseg.build_tep_blocks(run["path"], 64, 6)
    teps, mask, bounds = jseg.pack_tep_chunks(blocks)
    jrun = JaxRunDir(R4)
    return {
        "llr": blob["llr"], "labels": blob["labels"], "port": run,
        "jax_nms": jrun.load_pickle("nms_params.pkl"),
        "jax_dia": jrun.load_pickle("dia_model_cnn.pkl"),
        "jax_fcn": jdia.stopper_engine_params(jrun.load_pickle("stopper_params.pkl")),
        "layout": (teps, mask, acc), "bounds": bounds,
        "tep_layout": segments.TepLayout.build(run["path"], 64, 6, "cpu"),
    }


def _jax_layout(r4):
    teps, mask, acc = r4["layout"]
    return (jnp.asarray(teps), jnp.asarray(mask), jnp.asarray(acc, jnp.int32),
            r4["jax_fcn"])


def test_iteration_lists_match_jax():
    rng = np.random.default_rng(0)
    traj = rng.normal(0.5, 2.0, (30, 13, 128)).astype(np.float32)
    traj[0, 3, :5] = 0.0  # the hard decision of an exact zero is a 1
    labels = (rng.random((30, 128)) < 0.5).astype(np.int32)
    np.testing.assert_allclose(harness.iteration_ce_list(traj, labels),
                               jharness.iteration_ce_list(traj, labels), rtol=1e-12)
    assert (harness.iteration_ber_list(traj, labels)
            == jharness.iteration_ber_list(traj, labels))


def test_with_iteration_stats_rows_match_jax(r4):
    jstep = jengine.make_dl_osd_step_from_llr(
        jdia.make_dia("model_cnn", 128, 13), jax_get_code("ccsds_128_64"),
        "NMS-1", 12, bounds=r4["bounds"], decoder="xla",
        with_iteration_stats=True)
    ref, ref_refined, ref_det, (ref_ce, ref_ber) = jstep(
        r4["jax_nms"], r4["jax_dia"], jnp.asarray(r4["llr"]),
        jnp.asarray(r4["labels"]), *_jax_layout(r4))
    run = r4["port"]
    step = engine.make_dl_osd_step_from_llr(run["dia"], run["code"], "NMS-1", 12,
                                            r4["tep_layout"],
                                            with_iteration_stats=True)
    out, refined, det, (ce, ber) = step(
        run["nms_params"], torch.as_tensor(r4["llr"]),
        torch.as_tensor(r4["labels"]), run["fcn"])
    assert ce.shape == ber.shape == (96, 14)
    np.testing.assert_allclose(ce.numpy(), np.asarray(ref_ce), rtol=1e-5)
    np.testing.assert_array_equal(ber.numpy(), np.asarray(ref_ber))
    np.testing.assert_array_equal(det.numpy(), np.asarray(ref_det))
    for key in WALK_KEYS:
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]), key)


def test_make_dl_osd_step_matches_jax(r4):
    """The trajectory form, on the re-decoded trajectories of refparity."""
    run = r4["port"]
    code = run["code"]
    traj = harness.trajectories_for_llrs(code, run["nms_params"], "NMS-1", 12,
                                         r4["llr"], device="cpu")
    jstep = jengine.make_dl_osd_step(jdia.make_dia("model_cnn", 128, 13),
                                     jnp.asarray(code.h_osd), 64,
                                     bounds=r4["bounds"])
    ref, ref_refined = jstep(r4["jax_dia"], jnp.asarray(traj),
                             jnp.asarray(r4["labels"]), *_jax_layout(r4))
    step = engine.make_dl_osd_step(run["dia"], code.h_osd, 64, r4["tep_layout"])
    out, refined = step(torch.as_tensor(traj), torch.as_tensor(r4["labels"]),
                        run["fcn"])
    np.testing.assert_allclose(refined.numpy(), np.asarray(ref_refined),
                               rtol=1e-5, atol=1e-5)
    for key in WALK_KEYS:
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]), key)


def test_timer_and_jsonl_logger(tmp_path):
    timer = Timer("cpu")
    for _ in range(3):
        with timer.measure("a"):
            sum(range(1000))
    summary = timer.summary()["a"]
    assert summary["n"] == 3 and summary["total_s"] >= summary["mean_s"] > 0
    log = JsonlLogger(str(tmp_path / "m.jsonl"))
    log.log({"x": 1})
    log.log({"x": 2, "t": 5.0})
    lines = [json.loads(s) for s in open(tmp_path / "m.jsonl")]
    assert [r["x"] for r in lines] == [1, 2] and lines[1]["t"] == 5.0
    assert "t" in lines[0]


@pytest.fixture()
def tiny_recipe(monkeypatch):
    """The production recipe with shortened training, as
    ``tests/test_recipe_e2e.py`` shortens JAX's."""
    real_nms, real_dia, real_stop = rec.train_nms, rec.train_dia, rec.train_stopper
    monkeypatch.setattr(rec, "train_nms", lambda code, cfg, **kw: real_nms(
        code, dataclasses.replace(cfg, termination_step=10, batch=64,
                                  num_batches=2, print_interval=5), **kw))
    monkeypatch.setattr(rec, "train_dia", lambda code, t, l, cfg, **kw: real_dia(
        code, t, l, dataclasses.replace(cfg, termination_step=40, batch=16), **kw))
    monkeypatch.setattr(rec, "train_stopper", lambda i, l, cfg, **kw: real_stop(
        i, l, dataclasses.replace(cfg, termination_step=40, batch=64), **kw))
    return rec.RecipeConfig(num_iterations=6, nms_error_budget=40,
                            osd_failure_budget=24, train_failure_target=48,
                            max_frames_per_snr=2048, eval_batch=512,
                            capture_batch=512, decoding_length=8)


def _layout(tree):
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items()}
    assert type(tree) is np.ndarray, type(tree)
    return str(tree.dtype), np.ndim(tree)


def test_run_recipe_end_to_end_small(tmp_path, tiny_recipe):
    cfg = tiny_recipe
    run_dir = str(tmp_path / "run")
    curve = rec.run_recipe(cfg, run_dir, snrs=[2.0, 3.0], log=lambda *_: None,
                           device="cpu")
    pts = curve["points"]
    assert len(pts) == 2
    for p in pts:
        assert p["osd"]["success"] + p["osd"]["fail"] > 0
        assert 0.0 <= p["fer_total"] <= 1.0
        lo, hi = p["fer_total_ci"]
        assert 0.0 <= lo <= hi
        assert len(p["fer_osd_ci"]) == 2
        # CE/BER lists cover T+1 iteration slots + the DIA-refined slot
        assert len(p["ce_list"]) == len(p["ber_list"]) == cfg.num_iterations + 2
    run = rec.RunDir(run_dir)
    for name in ("nms_params.pkl", "train_failures.npz", "decoding_path.json",
                 "dia_model_cnn.pkl", "stopper_params.pkl", "fer_curve.json",
                 "metrics.jsonl", "config.json", "stage_seconds.json",
                 "stopper_validation.json", "dia_model_cnn_train_summary.json"):
        assert run.has(name), name
    stamps = {n: os.path.getmtime(run.path(n)) for n in (
        "nms_params.pkl", "dia_model_cnn.pkl", "stopper_params.pkl")}
    # re-invocation REUSES the trained artifacts (stage skip logic)
    curve2 = rec.run_recipe(cfg, run_dir, snrs=[2.0], log=lambda *_: None,
                            device="cpu")
    assert len(curve2["points"]) == 1
    assert stamps == {n: os.path.getmtime(run.path(n)) for n in stamps}

    # the parameter pickles: plain numpy trees in the JAX package's layout,
    # readable without this package and usable by the JAX package
    for name in stamps:
        with open(run.path(name), "rb") as fh:
            body = fh.read()
        assert b"torch" not in body and b"jax" not in body
        assert _layout(pickle.loads(body)) == _layout(
            convert.load_jax_pickle(os.path.join(R4, name)))
    loaded = convert.load_run(run_dir, "cpu")
    traj = np.random.default_rng(3).normal(0.5, 1.5, (4, 7, 128)).astype(np.float32)
    jax_tree = JaxRunDir(run_dir).load_pickle("dia_model_cnn.pkl")
    want = jdia.make_dia("model_cnn", 128, 7).refine(jax_tree, jnp.asarray(traj))
    with torch.no_grad():
        got = loaded["dia"].refine(torch.as_tensor(traj)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    assert loaded["path"] == run.load_json("decoding_path.json")["path"]


def test_capture_batch_sizing(monkeypatch):
    """Frames a capture step: the config's value, ``eval_batch`` on the
    CPU, and on the card what the route's bytes a frame fit in half the
    free memory (``torch.cuda.mem_get_info`` stubbed), NMS-r sized as its
    edge kernel's route where that holds the code, and elsewhere (dc 11)
    re-sized when the fitted batch changes its route."""
    code = get_code("ccsds_128_64")
    cfg = rec.RecipeConfig(eval_batch=4096)
    assert rec.capture_batch(cfg, code, "cpu") == 4096
    assert rec.capture_batch(dataclasses.replace(cfg, capture_batch=777),
                             code, "cuda") == 777
    sizes = {route: rec.capture_frame_bytes(code.h, "NMS-1", route)
             for route in harness.DECODERS}
    assert sizes["edge"] == sizes["dense"] < sizes["edge_padded"] < sizes["plain"]
    free = {"bytes": 80e9}
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev=None: (free["bytes"], 80e9))
    assert rec.capture_batch(cfg, code, "cuda") == rec.CAPTURE_MAX_FRAMES
    free["bytes"] = 1e8
    b = rec.capture_batch(cfg, code, "cuda")
    assert b % 256 == 0 and b * sizes["edge"] <= 0.5e8 < (b + 256) * sizes["edge"]
    nms_r = dataclasses.replace(cfg, variant="NMS-r")
    assert rec.capture_frame_bytes(code.h, "NMS-r", "edge") == sizes["edge"]
    assert rec.capture_batch(nms_r, code, "cuda") == b
    array = get_code("array_121_60")
    padded = rec.capture_frame_bytes(array.h, "NMS-r", "edge_padded")
    plain = rec.capture_frame_bytes(array.h, "NMS-r", "plain")
    free["bytes"] = 2 * 1.5e9
    b = rec.capture_batch(nms_r, array, "cuda")
    assert b == 1.5e9 // padded // 256 * 256 >= 2048
    free["bytes"] = 2 * 1000 * padded  # too small for the padded layout
    b = rec.capture_batch(nms_r, array, "cuda")
    assert b == max(256, 2 * 1000 * padded // 2 // plain // 256 * 256)


def test_cli_help(capsys):
    with pytest.raises(SystemExit) as exc:
        cli_main(["--help"])
    assert exc.value.code == 0
    text = capsys.readouterr().out
    for cmd in ("train-nms", "eval-nms", "train-dia", "train-stopper", "sweep",
                "baseline", "bench"):
        assert cmd in text
        with pytest.raises(SystemExit) as exc:
            cli_main([cmd, "--help"])
        assert exc.value.code == 0
        assert "--device" in capsys.readouterr().out
    with pytest.raises(SystemExit) as exc:  # --kind is required
        cli_main(["baseline"])
    assert exc.value.code == 2


def test_cli_train_dia_round_trip(tmp_path, capsys):
    """``train-dia`` then ``train-stopper`` on one run directory: the second
    reuses the first's failures, refiner and path."""
    args = ["--device", "cpu", "--run-dir", str(tmp_path), "--iterations", "6",
            "--train-failures", "120", "--batch", "512", "--decoding-length", "8"]
    assert cli_main(["train-dia"] + args) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    run = rec.RunDir(str(tmp_path))
    path = run.load_json("decoding_path.json")["path"]
    assert out == {"decoding_path_len": len(path)} and len(path) == 8
    stamp = os.path.getmtime(run.path("dia_model_cnn.pkl"))
    dia = convert.dia_module("model_cnn", 128, 7, convert.dia_state_from_jax(
        run.load_pickle("dia_model_cnn.pkl"), "cpu"))
    assert dia.head.weight.shape == (1, 2)
    assert cli_main(["train-stopper"] + args) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out == {"decoding_path_len": 8, "stopper": "stopper_params.pkl"}
    assert os.path.getmtime(run.path("dia_model_cnn.pkl")) == stamp
    fcn = convert.stopper_from_jax(run.load_pickle("stopper_params.pkl"), "cpu")
    assert fcn["w1"].shape == (6, 6) and fcn["w2"].shape == (6, 2)


@pytest.mark.parametrize("entry", [
    lambda: dia_train.train_dia(get_code("ccsds_128_64"),
                                np.zeros((2, 13, 128), np.float32),
                                np.zeros((2, 128), np.int32),
                                dia_train.DIATrainConfig()),
    lambda: dia_train.pattern_statistics_sweep(get_code("ccsds_128_64"), None,
                                               np.zeros((2, 13, 128)),
                                               np.zeros((2, 128))),
    lambda: stopper_train.generate_stopper_samples(
        get_code("ccsds_128_64"), None, np.zeros((2, 13, 128)),
        np.zeros((2, 128)), [[0] * 6] * 5),
    lambda: stopper_train.train_stopper(np.zeros((4, 6), np.float32),
                                        np.zeros(4, np.float32),
                                        stopper_train.StopperTrainConfig()),
    lambda: rec.run_recipe(rec.RecipeConfig(), "/nonexistent/never-created"),
    lambda: cli_main(["train-dia", "--run-dir", "/nonexistent/never-created"]),
    lambda: fs_osd.fs_osd(np.zeros((2, 128), np.float32), np.zeros((2, 128)),
                          get_code("ccsds_128_64").g, 64),
    lambda: pb_osd.pb_osd(np.zeros((2, 128), np.float32), np.zeros((2, 128)),
                          get_code("ccsds_128_64").g, 64, snr_db=3.0),
    lambda: conventional.conventional_osd(np.zeros((2, 128), np.float32),
                                          np.zeros((2, 128)),
                                          get_code("ccsds_128_64").g, 64),
    lambda: conventional.miracle_view(np.zeros((2, 128), np.float32),
                                      np.zeros((2, 128)),
                                      get_code("ccsds_128_64").g, 64),
    lambda: cli_main(["baseline", "--kind", "fs", "--run-dir",
                      "/nonexistent/never-created"]),
    lambda: multicode.main(["--codes", "qc_96_48", "--out-root",
                            "/nonexistent/never-created"]),
    lambda: rayleigh.main(["--run", R4, "--out", "/nonexistent/never-created"]),
    lambda: rayleigh.run_points(R4, [6.0]),
    lambda: Timer(),
], ids=["train_dia", "pattern_sweep", "stopper_samples", "train_stopper",
        "run_recipe", "cli", "fs_osd", "pb_osd", "conventional_osd",
        "miracle_view", "cli_baseline", "multicode", "rayleigh",
        "rayleigh_run_points", "timer"])
def test_cuda_default_raises_without_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


def test_port_and_chip_smoke_import_no_jax():
    """A grep over the port's sources and ``chip_smoke.py``: no import of
    jax, jaxlib, flax, optax or the JAX package."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|"
                         r"short_ldpc_decoding_osd_tpu)(\.|\s|$)", re.M)
    files = [os.path.join(_ROOT, "chip_smoke.py")]
    for root, _, names in os.walk(port.__path__[0]):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    for entry in ("multicode.py", "rayleigh.py"):
        assert os.path.join(port.__path__[0], "pipeline", entry) in files
    for name in files:
        with open(name) as fh:
            hits = pattern.findall(fh.read())
        assert not hits, (name, hits)
