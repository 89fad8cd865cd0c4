"""Port models/dia.py + convert.py vs the JAX package, with the r4 weights.

``refine`` is three tiny convolutions and ``refine_fast`` a 13-tap
contraction; both sum in another order than XLA: 1e-5 (abs + rel)."""

import io
import os
import pickle
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from short_ldpc_decoding_osd_tpu.models import dia as jdia
from short_ldpc_decoding_osd_tpu.osd import engine as jengine
from short_ldpc_decoding_osd_tpu_torch import convert
from short_ldpc_decoding_osd_tpu_torch.osd import engine

from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R4 = os.path.join(_ROOT, "runs", "r4_pipeline")
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def r4():
    with open(os.path.join(R4, "dia_model_cnn.pkl"), "rb") as fh:
        jax_dia = pickle.load(fh)
    with open(os.path.join(R4, "stopper_params.pkl"), "rb") as fh:
        jax_stop = pickle.load(fh)
    return jax_dia, jax_stop, convert.load_run(R4, "cpu")


def _traj(b, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(0.8, 1.5, (b, 13, 128)).astype(np.float32)


def test_refine_matches_jax(r4):
    jax_dia, _, run = r4
    traj = _traj(6, seed=0)
    model = jdia.make_dia("model_cnn", 128, 13)
    ref = np.asarray(model.refine(jax_dia, jnp.asarray(traj)))
    with torch.no_grad():
        got = run["dia"].refine(torch.as_tensor(traj)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_refine_fast_matches_jax(r4):
    jax_dia, _, run = r4
    traj = _traj(32, seed=1)
    model = jdia.make_dia("model_cnn", 128, 13)
    ref = np.asarray(model.refine_fast(jax_dia, jnp.asarray(traj)))
    got = run["dia"].refine_fast(torch.as_tensor(traj)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    taps_ref, bias_ref = model.effective_filter(jax_dia)
    taps, bias = run["dia"].effective_filter()
    np.testing.assert_allclose(taps.numpy(), np.asarray(taps_ref), **TOL)
    np.testing.assert_allclose(float(bias), float(bias_ref), **TOL)


def test_stopper_matches_jax(r4):
    _, jax_stop, run = r4
    rng = np.random.default_rng(2)
    x = rng.gamma(2.0, 2.0, (40, 6)).astype(np.float32)
    ref = np.asarray(jengine.stopper_apply(jdia.stopper_engine_params(jax_stop),
                                           jnp.asarray(x)))
    got = engine.stopper_apply(run["fcn"], torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    with torch.no_grad():
        module = convert.stopper_module(run["fcn"])(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(module, ref, **TOL)
    w = jdia.StopperFcn(6).apply(jax_stop, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(w), **TOL)


def test_nms_params_convert(r4):
    _, _, run = r4
    with open(os.path.join(R4, "nms_params.pkl"), "rb") as fh:
        ref = pickle.load(fh)
    np.testing.assert_array_equal(run["nms_params"]["check"].numpy(),
                                  np.asarray(ref["check"]))


def test_converted_nms_leaves_own_their_memory():
    """An in-place update of a converted leaf leaves its source alone, and
    a read-only source (as unpickled arrays are) converts without torch's
    non-writable warning."""
    import warnings

    source = np.array([0.25, -1.0], np.float32)
    source.flags.writeable = False
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        nms_t, _, _ = convert.from_jax_params(
            {"check": source}, *_tiny_dia_and_stopper(), device="cpu")
    nms_t["check"].add_(1.0)
    np.testing.assert_array_equal(source, [0.25, -1.0])
    np.testing.assert_array_equal(nms_t["check"].numpy(), [1.25, 0.0])


def _tiny_dia_and_stopper():
    with open(os.path.join(R4, "dia_model_cnn.pkl"), "rb") as fh:
        dia = pickle.load(fh)
    with open(os.path.join(R4, "stopper_params.pkl"), "rb") as fh:
        stop = pickle.load(fh)
    return dia, stop


def test_unpickler_loads_r4_without_jax():
    """The chip machine has no jax: every r4 artifact must load with jax
    blocked from import."""
    script = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["jaxlib"] = None
        sys.modules["flax"] = None
        import numpy as np
        from short_ldpc_decoding_osd_tpu_torch import convert
        root = {R4!r}
        nms = convert.load_jax_pickle(root + "/nms_params.pkl")
        dia = convert.load_jax_pickle(root + "/dia_model_cnn.pkl")
        stop = convert.load_jax_pickle(root + "/stopper_params.pkl")
        assert isinstance(nms["check"], np.ndarray), type(nms["check"])
        assert dia["params"]["conv2"]["kernel"].shape == (3, 8, 4)
        assert dia["params"]["head"]["kernel"].shape == (14, 1)
        assert stop["params"]["dense2"]["kernel"].shape == (6, 2)
        run = convert.load_run(root, "cpu")
        assert run["num_iterations"] == 12 and len(run["path"]) == 30
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=_ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_unpickler_refuses_other_jax_globals():
    payload = b"cjax.numpy\nzeros\n."
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        convert.JaxArrayUnpickler(io.BytesIO(payload)).load()
