"""The port's ``parallel/`` in one process (a world of one) vs the JAX
package and the single-device path (CPU), and ``utils/profiling.trace`` /
``flops_estimate``.

Counters are compared exactly: they count hard decisions, and a world of
one runs the single-device arithmetic.  The sharded OSD steps are held
against JAX's on its 8-device CPU mesh (``tests/test_parallel.py``'s
inputs, the DIA weights carried by ``convert``).  JAX's demotion tests
(``test_multiproc_mesh_raises_instead_of_demoting`` and its kin) test TPU
means; their counterpart here is the pinned rung.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from short_ldpc_decoding_osd_tpu.parallel import device_seeds as jax_device_seeds
from short_ldpc_decoding_osd_tpu.utils.profiling import (
    flops_estimate as jax_flops_estimate)
from short_ldpc_decoding_osd_tpu_torch import convert, parallel
from short_ldpc_decoding_osd_tpu_torch.channel import ChannelSpec
from short_ldpc_decoding_osd_tpu_torch.codes import get_code
from short_ldpc_decoding_osd_tpu_torch.mc import harness
from short_ldpc_decoding_osd_tpu_torch.ops import nms, nms_edge
from short_ldpc_decoding_osd_tpu_torch.osd import segments
from short_ldpc_decoding_osd_tpu_torch.parallel import (
    device_seeds, init_multihost, make_mesh, sharded_dl_osd_step,
    sharded_dl_osd_step_from_llr, sharded_fused_mc_step, sharded_nms_mc_step,
    sharded_nms_train_step, sharded_seed_counters)
from short_ldpc_decoding_osd_tpu_torch.utils import count_dtype
from short_ldpc_decoding_osd_tpu_torch.utils.metrics import DecodeStats
from short_ldpc_decoding_osd_tpu_torch.utils.profiling import (flops_estimate,
                                                               trace)
from torch_parallel_common import (jax_osd_counters, jax_osd_from_llr_counters,
                                   osd_inputs, port_train_reference)
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

JAX_NAMES = ["device_seeds", "sharded_dl_osd_step", "sharded_dl_osd_step_from_llr",
             "init_multihost", "make_mesh", "sharded_fused_mc_step",
             "sharded_nms_mc_step", "sharded_nms_train_step",
             "sharded_seed_counters"]


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(device="cpu")


@pytest.fixture(scope="module")
def code():
    return get_code("ccsds_128_64")


def _kseed(seed, idx):
    return (seed * 100003 + idx) & 0x7FFFFFFF


# --- mesh ---------------------------------------------------------------------

def test_exports_jax_names():
    assert sorted(parallel.__all__) == sorted(JAX_NAMES)
    assert all(callable(getattr(parallel, name)) for name in JAX_NAMES)


def test_world_of_one_mesh(mesh):
    assert (mesh.size, mesh.rank, mesh.group, mesh.axis_name) == (1, 0, None, "mc")
    assert mesh.device == torch.device("cpu")
    assert make_mesh(1, device="cpu") == mesh
    t = torch.arange(3)
    assert mesh.all_reduce_sum(t) is t and t.tolist() == [0, 1, 2]
    with pytest.raises(ValueError, match="requested 2 devices, only 1 visible"):
        make_mesh(2, device="cpu")


def test_init_multihost_single_process_is_a_no_op():
    init_multihost()
    init_multihost("127.0.0.1:1", num_processes=1)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("entry", [
    lambda: make_mesh(),
    lambda: init_multihost("127.0.0.1:1", num_processes=2),
], ids=["make_mesh", "init_multihost"])
def test_cuda_default_raises_without_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


# --- seeds and the counter dtype -------------------------------------------------

def test_device_seeds_match_jax():
    for base in (0, 3, 1000, 2**31 - 1):
        for idx in (0, 1, 7, 12345):
            for n_dev in (1, 2, 4, 8):
                np.testing.assert_array_equal(device_seeds(base, idx, n_dev),
                                              jax_device_seeds(base, idx, n_dev))
                assert device_seeds(base, idx, n_dev).dtype == np.int32
            # one device: the single-device harness seed
            assert int(device_seeds(base, idx, 1)[0]) == _kseed(base, idx)
    # (step, device) -> seed is a bijection
    seeds = np.concatenate([device_seeds(5, i, 4) for i in range(64)])
    assert len(set(seeds.tolist())) == seeds.size


def test_every_step_counts_in_int64(mesh, code):
    assert count_dtype() == torch.int64
    p = nms.init_params("NMS-1")
    spec = ChannelSpec.awgn(3.0, code.rate)
    c = sharded_nms_mc_step(code, "NMS-1", 4, spec, 64, mesh)(
        p, torch.Generator().manual_seed(0))
    assert c.dtype == torch.int64 and c.shape == (5,)
    c, _ = sharded_fused_mc_step(code, "NMS-1", 8, 3.0, 256, mesh, 0)(p, 0)
    assert c.dtype == torch.int64 and c.shape == (5,)
    fn = sharded_seed_counters(mesh, lambda _, s: torch.tensor([s], dtype=torch.int32))
    assert fn(None, device_seeds(0, 0, 1)).dtype == torch.int64


# --- the OSD steps against JAX's sharded steps -----------------------------------

@pytest.fixture(scope="module")
def osd():
    inp = osd_inputs(16)
    dia = convert.dia_module("model_cnn", 128, inp["t"] + 1,
                             convert.dia_state_from_jax(inp["dia"], "cpu"))
    tens = {k: torch.as_tensor(inp[k]) for k in
            ("traj", "labels", "llr", "llr_labels")}
    tens["layout"] = segments.TepLayout.build(inp["path"], 64, 6, "cpu",
                                              chunk=inp["chunk"])
    fcn = {k: torch.as_tensor(v) for k, v in inp["fcn"].items()}
    fcn_llr = {k: torch.as_tensor(v) for k, v in inp["fcn_llr"].items()}
    return inp, dia, tens, fcn, fcn_llr


def test_sharded_dl_osd_step_matches_jax(mesh, code, osd):
    inp, dia, t, fcn, _ = osd
    step = sharded_dl_osd_step(dia, code.h, code.k, mesh, t["layout"])
    got = step(t["traj"], t["labels"], fcn)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), jax_osd_counters(inp, sharded=True))


def test_sharded_from_llr_step_matches_jax(mesh, code, osd):
    inp, dia, t, _, fcn_llr = osd
    step = sharded_dl_osd_step_from_llr(dia, code, "NMS-1", inp["t"], mesh,
                                        t["layout"])
    got = step(nms.init_params("NMS-1"), t["llr"], t["llr_labels"], fcn_llr)
    assert got.dtype == torch.int64
    want = jax_osd_from_llr_counters(inp, sharded=True)
    assert want[1] > 0  # the re-decode confirms some failures
    np.testing.assert_array_equal(got.numpy(), want)


# --- the Monte-Carlo steps --------------------------------------------------------

@pytest.mark.parametrize("name,variant", [
    ("ccsds_128_64", "NMS-1"), ("ccsds_128_64", "ENMS"), ("qc_96_48", "ENMS")])
def test_sharded_nms_mc_step_equals_build_nms_mc_step(mesh, name, variant):
    """ENMS decodes on the extended H: CCSDS's is H itself, qc_96_48's has
    240 rows against 48."""
    code = get_code(name)
    spec = ChannelSpec.awgn(2.5, code.rate)
    p = nms.init_params(variant)
    step = sharded_nms_mc_step(code, variant, 6, spec, 64, mesh)
    single = harness.build_nms_mc_step(code, variant, 6, spec, 64, device="cpu")
    assert step.decoder == single.decoder == "edge"
    got = step(p, torch.Generator().manual_seed(7))
    want, _ = single(p, torch.Generator().manual_seed(7))
    assert torch.equal(got, want) and int(got[0]) == 64


@pytest.mark.parametrize("variant,batch", [
    ("NMS-1", 256), ("NMS-1", 240), ("ENMS", 256)],
    ids=["fused", "step", "fused_enms"])
def test_run_nms_mc_mesh_equals_single_device(mesh, code, variant, batch):
    """A batch that is no multiple of 32 takes the step branch."""
    kw = dict(batch=batch, error_budget=40, seed=3)
    p = nms.init_params(variant)
    single, _ = harness.run_nms_mc(code, p, variant, 8, 3.0, device="cpu", **kw)
    meshed, fb = harness.run_nms_mc(code, p, variant, 8, 3.0, mesh=mesh, **kw)
    assert fb is None and meshed == single and meshed.frames >= 2 * batch


def test_run_nms_mc_mesh_capture_raises(mesh, code):
    with pytest.raises(ValueError, match="single-device"):
        harness.run_nms_mc(code, nms.init_params("NMS-1"), "NMS-1", 8, 3.0,
                           batch=64, capture_failures=True, mesh=mesh)


def test_resume_with_a_mesh(mesh, code, tmp_path):
    kw = dict(batch=256, error_budget=10**6, seed=4, mesh=mesh)
    p = nms.init_params("NMS-1")
    whole, _ = harness.run_nms_mc(code, p, "NMS-1", 6, 2.5, max_frames=768, **kw)
    path = str(tmp_path / "resume.json")
    harness.run_nms_mc(code, p, "NMS-1", 6, 2.5, max_frames=256,
                       resume_path=path, **kw)
    resumed, _ = harness.run_nms_mc(code, p, "NMS-1", 6, 2.5, max_frames=768,
                                    resume_path=path, **kw)
    with open(path) as fh:
        assert json.load(fh)["step_idx"] == 3
    assert resumed == whole


# --- rung pinning (where JAX demotes) ---------------------------------------------

def _refuse(*_, **__):
    raise AssertionError("this rung must not run")


def test_oneshot_rung_never_calls_compact(mesh, code, monkeypatch):
    p = nms.init_params("NMS-1")
    monkeypatch.setattr(nms_edge, "fused_counters_edge_compact", _refuse)
    got, _ = harness.run_nms_mc(code, p, "NMS-1", 8, 3.0, batch=256,
                                max_frames=512, seed=5, rung="oneshot",
                                mesh=mesh)
    want = sum(nms_edge.fused_counters_edge(code, p, "NMS-1", 8, 3.0, 256,
                                            _kseed(5, i), device="cpu").numpy()
               for i in range(2))
    assert (got.frames, got.frame_errors, got.bit_errors) == tuple(
        int(x) for x in want[:3])


def test_xla_rung_calls_no_fused_function(mesh, code, monkeypatch):
    p = nms.init_params("NMS-1")
    kw = dict(batch=128, max_frames=256, seed=5, rung="xla")
    want, _ = harness.run_nms_mc(code, p, "NMS-1", 6, 2.5, device="cpu", **kw)
    monkeypatch.setattr(nms_edge, "fused_counters_edge_compact", _refuse)
    monkeypatch.setattr(nms_edge, "fused_counters_edge", _refuse)
    got, _ = harness.run_nms_mc(code, p, "NMS-1", 6, 2.5, mesh=mesh, **kw)
    assert got == want


@pytest.mark.parametrize("rung", ["bogus", "dense"])
def test_rung_off_the_mesh_ladder_raises(mesh, code, rung):
    with pytest.raises(ValueError, match="rung"):
        harness.run_nms_mc(code, nms.init_params("NMS-1"), "NMS-1", 8, 3.0,
                           batch=256, max_frames=256, rung=rung, mesh=mesh)
    with pytest.raises(ValueError, match="rung"):
        sharded_fused_mc_step(code, "NMS-1", 8, 3.0, 256, mesh, 0, rung=rung)


def test_overflow_redoes_the_step_one_shot_and_stays(mesh, code, monkeypatch):
    """A compact step whose (reduced) overflow counter is non-zero is redone
    one-shot on the same seed, and every later step is one-shot."""
    calls = []
    compact, oneshot = (nms_edge.fused_counters_edge_compact,
                        nms_edge.fused_counters_edge)

    def overflowing_compact(*a, **k):
        calls.append(("compact", k["seed"]))
        c = compact(*a, **k)
        c[5] = 1
        return c

    def spy_oneshot(*a, **k):
        calls.append(("oneshot", k["seed"]))
        return oneshot(*a, **k)

    monkeypatch.setattr(nms_edge, "fused_counters_edge_compact", overflowing_compact)
    monkeypatch.setattr(nms_edge, "fused_counters_edge", spy_oneshot)
    p = nms.init_params("NMS-1")
    stats, _ = harness.run_nms_mc(code, p, "NMS-1", 8, 3.0, batch=256,
                                  max_frames=3 * 256, seed=2, mesh=mesh)
    seeds = [_kseed(2, i) for i in range(3)]
    assert calls == [("compact", seeds[0]), ("oneshot", seeds[0]),
                     ("oneshot", seeds[1]), ("oneshot", seeds[2])]
    total = sum(oneshot(code, p, "NMS-1", 8, 3.0, 256, s, device="cpu").numpy()
                for s in seeds)
    assert stats == DecodeStats(*[int(x) for x in total[:3]], code.n,
                                int(total[3]), int(total[4]))


# --- training ---------------------------------------------------------------------

def test_train_step_world_of_one_equals_single_device(mesh, code):
    spec = ChannelSpec.awgn(2.7, code.rate)
    make_optimizer, step = sharded_nms_train_step(code, "NMS-1", 6, spec, 32, mesh)
    params = {k: v.requires_grad_() for k, v in nms.init_params("NMS-1").items()}
    optimizer = make_optimizer(params)
    losses = []
    for seed in (13, 14):
        losses.append(float(step(params, optimizer,
                                 torch.Generator().manual_seed(seed))))
    want_losses, trail, _ = port_train_reference("NMS-1", 6, 2.7, 32, (13, 14))
    np.testing.assert_allclose(losses, want_losses, rtol=1e-6)
    np.testing.assert_allclose(params["check"].detach().numpy(),
                               trail[-1]["check"], rtol=1e-5, atol=1e-7)


# --- utils/profiling --------------------------------------------------------------

def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with trace(str(tmp_path)) as prof:
        x @ x
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    assert json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in e.key for e in prof.key_averages())


def test_flops_estimate_matches_jax():
    x = np.random.default_rng(0).normal(size=(128, 128)).astype(np.float32)
    got = flops_estimate(lambda a: a @ a, torch.as_tensor(x))
    assert got == 2 * 128**3
    assert got == jax_flops_estimate(lambda a: a @ a, jnp.asarray(x))
    assert flops_estimate(lambda a: a @ a, torch.zeros(2, 3)) is None
