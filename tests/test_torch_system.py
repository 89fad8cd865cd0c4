"""The port's slice as a whole vs the JAX package (CPU).

Walk decisions are compared frame for frame on the committed failure sets;
the capture step's count-and-compact half on identical arrays; the port's
sampler (a torch.Generator stream, not JAX's) by its moments."""

import json
import os
import pkgutil
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import short_ldpc_decoding_osd_tpu_torch as port
from short_ldpc_decoding_osd_tpu.codes import get_code as jax_get_code
from short_ldpc_decoding_osd_tpu.models import dia as jdia
from short_ldpc_decoding_osd_tpu.ops import nms as jnms
from short_ldpc_decoding_osd_tpu.osd import engine as jengine
from short_ldpc_decoding_osd_tpu.osd import segments as jseg
from short_ldpc_decoding_osd_tpu.pipeline.recipe import RunDir
from short_ldpc_decoding_osd_tpu_torch import _device, convert, system
from short_ldpc_decoding_osd_tpu_torch.channel import ChannelSpec, sample_batch
from short_ldpc_decoding_osd_tpu_torch.codes import get_code
from short_ldpc_decoding_osd_tpu_torch.mc.harness import count_and_capture
from short_ldpc_decoding_osd_tpu_torch.ops import nms, nms_edge, nms_edge_padded
from short_ldpc_decoding_osd_tpu_torch.osd import engine, segments

from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R4 = os.path.join(_ROOT, "runs", "r4_pipeline")
WALK_KEYS = ("success", "strict_success", "complexity", "window_num")


@pytest.fixture(scope="module")
def r4():
    run = RunDir(R4)
    path = run.load_json("decoding_path.json")["path"]
    blocks, acc = jseg.build_tep_blocks(path, 64, 6)
    teps, mask, bounds = jseg.pack_tep_chunks(blocks)
    return {
        "jax_nms": run.load_pickle("nms_params.pkl"),
        "jax_dia": run.load_pickle("dia_model_cnn.pkl"),
        "jax_fcn": jdia.stopper_engine_params(run.load_pickle("stopper_params.pkl")),
        "port": convert.load_run(R4, "cpu"),
        "teps": teps, "mask": mask, "acc": acc, "bounds": bounds,
        "layout": segments.TepLayout.build(path, 64, 6, "cpu"),
    }


@pytest.fixture(scope="module")
def refparity_jax(r4):
    """The JAX step on ``runs/refparity/failures.npz`` (96 LLR rows)."""
    blob = np.load(os.path.join(_ROOT, "runs", "refparity", "failures.npz"))
    llr, labels = blob["llr"], blob["labels"]
    jcode = jax_get_code("ccsds_128_64")
    jstep = jengine.make_dl_osd_step_from_llr(
        jdia.make_dia("model_cnn", 128, 13), jcode, "NMS-1", 12,
        bounds=r4["bounds"], decoder="xla")
    ref, _, ref_det = jstep(
        r4["jax_nms"], r4["jax_dia"], jnp.asarray(llr), jnp.asarray(labels),
        jnp.asarray(r4["teps"]), jnp.asarray(r4["mask"]),
        jnp.asarray(r4["acc"], jnp.int32), r4["jax_fcn"])
    return llr, labels, ref, ref_det


def test_dl_osd_step_from_llr_matches_jax(r4, refparity_jax):
    llr, labels, ref, ref_det = refparity_jax
    run = r4["port"]
    step = engine.make_dl_osd_step_from_llr(
        run["dia"], run["code"], "NMS-1", 12, r4["layout"])
    got, _, det = step(run["nms_params"], torch.as_tensor(llr),
                       torch.as_tensor(labels), run["fcn"])
    for key in WALK_KEYS:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]), key)
    np.testing.assert_array_equal(det.numpy(), np.asarray(ref_det))


@pytest.mark.parametrize("code_name,variant,device,batch,route", [
    ("ccsds_128_64", "NMS-1", "cuda", 4096, "edge"),
    ("ccsds_128_64", "NMS-r", "cuda", 4096, "edge"),
    ("ccsds_128_64", "NMS-r", "cuda", nms_edge_padded.NMS_R_MIN_BATCH,
     "edge"),
    ("ccsds_128_64", "NMS-r", "cuda", 1024, "edge"),  # the kernel at any batch
    # dc 11: no NMS-r kernel, so the padded layout from NMS_R_MIN_BATCH up
    ("array_121_60", "NMS-r", "cuda", 4096, "edge_padded"),
    ("array_121_60", "NMS-r", "cuda", 1024, "dense"),
    ("ccsds_128_64", "NMS-r", "cpu", 4096, "dense"),
    ("qc_96_48", "NMS-r", "cuda", 4096, "dense"),  # irregular check degree
])
def test_redecode_route_rule(code_name, variant, device, batch, route):
    """NMS-r's phase-2 re-decode takes its edge kernel on CUDA where it
    holds the code, and the padded edge layout where the capture step's
    rule does (JAX's "auto" takes its edge-layout rung)."""
    h = get_code(code_name).h
    assert engine.redecode_route(h, variant, torch.device(device), batch) == route


def test_nms_r_redecode_routes_agree(r4, monkeypatch):
    """The NMS-r phase-2 trajectory on the padded edge layout and on the
    dense decoder, with the trained NMS-r weights of
    ``runs/r5_variants_nmsr``, on the committed failure set: the tolerance
    of ``tests/test_torch_edge_padded.py`` for NMS-r (1e-3 relative to the
    largest output), identical hard decisions and detected flags; and the
    step itself runs on the padded route."""
    blob = np.load(os.path.join(_ROOT, "runs", "refparity", "failures.npz"))
    llr = torch.as_tensor(blob["llr"])
    labels = torch.as_tensor(blob["labels"])
    code = get_code("ccsds_128_64")
    params = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32)
              for k, v in convert.load_jax_pickle(os.path.join(
                  _ROOT, "runs", "r5_variants_nmsr", "nms_params.pkl")).items()}
    trajs = {route: engine.redecode_trajectory(params, code.h, llr, 12, "NMS-r",
                                               route)
             for route in ("edge_padded", "dense")}
    got, ref = trajs["edge_padded"].numpy(), trajs["dense"].numpy()
    assert got.shape == ref.shape == (13,) + tuple(llr.shape)
    assert np.abs(got - ref).max() / max(np.abs(ref).max(), 1.0) < 1e-3
    np.testing.assert_array_equal(got < 0, ref < 0)
    det = {route: nms.frame_stats(t[-1], labels, code.h)["detected_failure"]
           for route, t in trajs.items()}
    assert torch.equal(det["edge_padded"], det["dense"])

    run = r4["port"]
    step = engine.make_dl_osd_step_from_llr(run["dia"], code, "NMS-r", 12,
                                            r4["layout"])
    args = (params, llr, labels, run["fcn"])
    routes = []
    real = engine.redecode_trajectory
    monkeypatch.setattr(engine, "redecode_trajectory",
                        lambda *a: routes.append(a[5]) or real(*a))
    _, _, det_dense = step(*args)  # on the CPU: the dense route
    monkeypatch.setattr(engine, "redecode_route", lambda *a: "edge_padded")
    _, _, det_padded = step(*args)
    assert routes == ["dense", "edge_padded"]
    assert torch.equal(det_dense, det["dense"])
    assert torch.equal(det_padded, det["edge_padded"])


def test_sliding_osd_matches_jax_on_refparity25(r4):
    blob = np.load(os.path.join(_ROOT, "runs", "refparity25",
                                "failures_2.50dB.npz"))
    traj, labels = blob["traj"], blob["labels"]
    jcode = jax_get_code("ccsds_128_64")
    model = jdia.make_dia("model_cnn", 128, 13)
    refined = model.refine_fast(r4["jax_dia"], jnp.asarray(traj))
    jprep = jengine.prepare(refined, jnp.asarray(traj[:, 0]), jnp.asarray(labels),
                            jnp.asarray(jcode.h_osd), 64)
    ref = jengine.sliding_osd(jprep, jnp.asarray(r4["teps"]),
                              jnp.asarray(r4["mask"]), r4["acc"], r4["jax_fcn"],
                              64, bounds=r4["bounds"])
    run = r4["port"]
    t = torch.as_tensor(traj)
    prep = engine.prepare(run["dia"].refine_fast(t), t[:, 0],
                          torch.as_tensor(labels), run["code"].h_osd, 64)
    got = engine.sliding_osd(prep, r4["layout"], run["fcn"], 64)
    for key in WALK_KEYS + ("deep_limit", "windows_evaluated"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]), key)
    np.testing.assert_allclose(got["global_min"].numpy(),
                               np.asarray(ref["global_min"]), rtol=1e-5)


@pytest.mark.parametrize("capacity", [64, 512])
def test_count_and_capture_matches_jax(capacity):
    code = get_code("ccsds_128_64")
    rng = np.random.default_rng(11)
    msgs = rng.integers(0, 2, (2048, code.k))
    words = (msgs @ code.g % 2).astype(np.int32)
    noise = rng.normal(1.0, 0.8, words.shape)
    llr = np.where(words == 0, noise, -noise).astype(np.float32)
    soft = nms_edge.decode_final_edge({"check": torch.tensor([0.1686])}, code.h,
                                      torch.as_tensor(llr), 12)
    counters, cap = count_and_capture(torch.as_tensor(llr), torch.as_tensor(words),
                                      soft, code.h, capacity)
    # the JAX harness's accounting (harness.py:257-281) on the same arrays
    st = jnms.frame_stats(jnp.asarray(soft.numpy()), jnp.asarray(words),
                          jnp.asarray(code.h, jnp.float32))
    want = [2048] + [int(jnp.sum(st[k])) for k in
                     ("frame_error", "bit_errors", "detected_failure",
                      "undetected_error")]
    np.testing.assert_array_equal(counters.numpy(), want)
    order = np.asarray(jnp.argsort(jnp.logical_not(st["detected_failure"]),
                                   stable=True))[:capacity]
    assert int(cap["count"]) == want[3] and want[3] > 64
    np.testing.assert_array_equal(cap["llr"].numpy(), llr[order])
    np.testing.assert_array_equal(cap["labels"].numpy(), words[order])


def test_sampler_moments():
    code = get_code("ccsds_128_64")
    spec = ChannelSpec.awgn(3.0, code.rate)
    gen = torch.Generator().manual_seed(5)
    llr, words = sample_batch(gen, spec, torch.as_tensor(code.g), 20000)
    signed = (llr * (1 - 2 * words)).numpy()  # transmitted-bit-aligned sample
    assert abs(signed.mean() - 1.0) < 0.01
    assert abs(signed.std() - spec.sigma) < 0.01
    assert abs(words.numpy().mean() - 0.5) < 0.01
    synd = (words.numpy().astype(np.int64) @ code.h.T.astype(np.int64)) % 2
    assert not synd.any()
    zeros_llr, zeros = sample_batch(gen, spec, torch.as_tensor(code.g), 10,
                                    all_zeros=True)
    assert not zeros.any() and zeros_llr.shape == (10, 128)


def test_run_two_phase_on_cpu():
    out = system.run_two_phase(frames=2048, cap_b=1024, cap=160, device="cpu")
    assert out["system_frames"] == 2048
    assert out["system_osd_rows_walked"] == 320
    assert 0 < out["system_failures"] <= out["system_frame_errors"]
    assert out["system_osd_success"] <= out["system_failures"]
    assert out["system_osd_success"] >= 0.9 * out["system_failures"]
    assert out["system_capture_overflow"] == 0
    assert set(out["system_stage_s"]) >= {"capture_step_k1", "traj_redecode_k2",
                                          "prepare_sort_ge", "disc_minima_k5"}
    json.dumps(out)


@pytest.mark.parametrize("entry", [
    _device.resolve_device,
    lambda: convert.load_run(R4),
    lambda: convert.from_jax_params({}, {}, {}),
    lambda: system.run_two_phase(frames=1024, cap_b=1024, cap=64),
    lambda: system.bench(batch=1024),
], ids=["resolve_device", "load_run", "from_jax_params", "run_two_phase", "bench"])
def test_cuda_default_raises_without_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


def test_port_imports_nothing_of_jax():
    modules = [m.name for m in pkgutil.walk_packages(port.__path__,
                                                     port.__name__ + ".")]
    script = textwrap.dedent(f"""
        import importlib, sys
        for name in {modules!r}:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax")
                     or m == "short_ldpc_decoding_osd_tpu"
                     or m.startswith("short_ldpc_decoding_osd_tpu."))
        print(len({modules!r}), bad)
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=_ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split(None, 1) == [str(len(modules)), "[]\n"]
    assert len(modules) >= 20
    assert jax.__name__ == "jax"  # this process imported both, as tests may
