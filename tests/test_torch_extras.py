"""The port's ``models/extras.py`` and ``convert.extras_*`` vs the JAX
package (CPU), on weights that JAX's ``init`` drew and
``convert.extras_state_from_jax`` carried across.

Tolerances: model outputs rtol 1e-4, atol 1e-5 (f32 matmuls, softmaxes,
LSTM steps and convolutions summed in another order than XLA);
``neighborhood_trajectories`` is a gather and a 0/1 mask, so exact; the
conversion round trip exact.  JAX initialises ``RnnThree.coefficients`` to
zero, which would hide the first LSTM from the output, so the tests draw
them from a seed on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from short_ldpc_decoding_osd_tpu.models import extras as jext
from short_ldpc_decoding_osd_tpu_torch import convert
from short_ldpc_decoding_osd_tpu_torch.codes import get_code
from short_ldpc_decoding_osd_tpu_torch.models import extras, init_flax_

from torch_dia_common import assert_trees_close
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-4, atol=1e-5)
CCSDS = get_code("ccsds_128_64")


def _normal(shape, seed, scale=1.0, loc=0.0):
    return np.random.default_rng(seed).normal(loc, scale, shape).astype(np.float32)


def _jax_init(module, x, seed):
    return jax.tree.map(np.asarray, module.init(jax.random.PRNGKey(seed), x))


def _port(cls_name, tree, *args, **kwargs):
    port = getattr(extras, cls_name)(*args, **kwargs)
    port.load_state_dict(convert.extras_state_from_jax(cls_name, tree, "cpu"))
    return port


def _run(port, x, **kw):
    with torch.no_grad():
        return port(torch.as_tensor(x), **kw).numpy()


# (class name, JAX module, port constructor args, input shape) of every module
HEADS = {
    "SelfAttention": (jext.SelfAttention(16), (16,), (3, 7, 16)),
    "MultiHeadAttention": (jext.MultiHeadAttention(32, 4), (32, 4), (3, 7, 32)),
    "TransformerLayer": (jext.TransformerLayer(64, 8), (64, 8), (4, 13, 64)),
    "TemperatureLayer": (jext.TemperatureLayer(), (), (5, 3)),
    "PredictOutlier": (jext.PredictOutlier(6), (6,), (8, 6)),
}


@pytest.mark.parametrize("name", list(HEADS))
def test_heads_match_jax(name):
    jmod, args, shape = HEADS[name]
    x = _normal(shape, seed=1, scale=2.0)
    tree = _jax_init(jmod, jnp.asarray(x), seed=2)
    want = np.asarray(jmod.apply(tree, jnp.asarray(x)))
    got = _run(_port(name, tree, *args), x)
    np.testing.assert_allclose(got, want, **TOL)


def test_transformer_ignores_training_mode_and_dropout_rng():
    """flax's ``deterministic=True`` default: no dropout even in train mode;
    with ``deterministic=False`` the mask comes from the generator alone."""
    jmod, args, shape = HEADS["TransformerLayer"]
    x = _normal(shape, seed=3)
    tree = _jax_init(jmod, jnp.asarray(x), seed=4)
    port = _port("TransformerLayer", tree, *args).train()
    want = np.asarray(jmod.apply(tree, jnp.asarray(x)))
    np.testing.assert_allclose(_run(port, x), want, **TOL)
    outs = [_run(port, x, deterministic=False,
                 generator=torch.Generator().manual_seed(s)) for s in (5, 5, 6)]
    np.testing.assert_array_equal(outs[0], outs[1])
    assert not np.allclose(outs[0], outs[2]) and not np.allclose(outs[0], want)
    with pytest.raises(ValueError, match="Generator"):
        _run(port, x, deterministic=False)


def test_dropout_is_inverted_with_keep_probability():
    x = torch.ones(200_000)
    out = extras._dropout(x, 0.2, False, torch.Generator().manual_seed(0))
    assert set(out.unique().tolist()) == {0.0, 1.25}
    assert abs(float((out > 0).float().mean()) - 0.8) < 0.01
    assert torch.equal(extras._dropout(x, 0.2, True, None), x)
    assert torch.equal(extras._dropout(x, 1.0, False, None), torch.zeros_like(x))


@pytest.mark.parametrize("loc,scale", [(3.0, 1.0), (0.0, 1e-3)])
def test_layernorm_matches_flax(loc, scale):
    """flax's LayerNorm(epsilon=1e-6) with its E[x^2] - E[x]^2 variance; at
    a variance near 1e-6 torch's default epsilon 1e-5 would differ."""
    x = _normal((6, 64), seed=7, scale=scale, loc=loc)
    ln = fnn.LayerNorm(epsilon=1e-6)
    tree = _jax_init(ln, jnp.asarray(x), seed=0)
    tree["params"]["scale"] = _normal(64, seed=8, loc=1.0)
    tree["params"]["bias"] = _normal(64, seed=9)
    want = np.asarray(ln.apply(tree, jnp.asarray(x)))
    port = extras._LayerNorm(64)
    with torch.no_grad():
        port.scale.copy_(torch.as_tensor(tree["params"]["scale"]))
        port.bias.copy_(torch.as_tensor(tree["params"]["bias"]))
    np.testing.assert_allclose(_run(port, x), want, **TOL)
    if scale < 1e-2:
        torch_ln = torch.nn.functional.layer_norm(
            torch.as_tensor(x), (64,), port.scale.detach(), port.bias.detach())
        assert not np.allclose(torch_ln.numpy(), want, **TOL)


def test_temperature_layer_scales():
    port = extras.TemperatureLayer()
    x = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(port(x), x)
    with torch.no_grad():
        port.temperature.mul_(2.0)
    assert torch.equal(port(x), 2.0 * x)


def test_predict_outlier_l2_matches_jax():
    jmod, args, _ = HEADS["PredictOutlier"]
    tree = _jax_init(jmod, jnp.ones((2, 6)), seed=3)
    port = _port("PredictOutlier", tree, *args)
    got = float(extras.predict_outlier_l2(port).detach())
    np.testing.assert_allclose(got, float(jext.predict_outlier_l2(tree)), rtol=1e-6)
    probs = port(torch.ones(8, 6))
    np.testing.assert_allclose(probs.sum(-1).detach().numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("version", [0, 1, 2, 3])
def test_predict_phase_matches_jax(version):
    length, cap = 30, 31
    jmod = jext.PredictPhase(decoding_length=length, capacity=cap, version=version)
    x = _normal((5, 2 * length - 1), seed=version, scale=3.0)
    tree = _jax_init(jmod, jnp.asarray(x), seed=version)
    want = np.asarray(jmod.apply(tree, jnp.asarray(x)))
    got = _run(_port("PredictPhase", tree, length, cap, version), x)
    assert got.shape == (5, cap)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)


def test_predict_phase_unknown_version():
    with pytest.raises(ValueError, match="version"):
        extras.PredictPhase(30, 31, version=4)


@pytest.mark.parametrize("code_name", ["ccsds_128_64", "qc_96_48", "code1_64_32"])
def test_neighborhood_trajectories_exact(code_name):
    code = get_code(code_name)
    traj = _normal((2, 4, code.n), seed=0, scale=3.0)
    want = np.asarray(jext.neighborhood_trajectories(code.h, jnp.asarray(traj)))
    got = extras.neighborhood_trajectories(code.h, torch.as_tensor(traj)).numpy()
    dv, dc = extras.neighborhood_degrees(code.h)
    assert got.shape == want.shape == (2, code.n, dv, 4, dc)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))
    rows = np.nonzero(code.h[:, 0])[0]
    for slot in range(len(rows)):  # the variable's own value first
        np.testing.assert_array_equal(got[0, 0, slot, :, 0], traj[0, :, 0])


def _refiner(cls_name, code, list_length, seed):
    """A JAX refiner's tree (seeded non-zero ``coefficients``), its port, and
    a (B, T+1, n) trajectory."""
    traj = _normal((2, list_length, code.n), seed=seed, scale=2.0, loc=0.5)
    neigh = jext.neighborhood_trajectories(code.h, jnp.asarray(traj))
    jmod = getattr(jext, cls_name)(n=code.n, list_length=list_length)
    tree = _jax_init(jmod, neigh, seed)
    if "coefficients" in tree["params"]:
        tree["params"]["coefficients"] = _normal(list_length, seed=seed + 1)
    dv, dc = extras.neighborhood_degrees(code.h)
    kwargs = dict(dc=dc) if cls_name == "RnnThree" else dict(dv=dv, dc=dc)
    port = _port(cls_name, tree, code.n, list_length, **kwargs)
    return jmod, tree, port, traj


@pytest.mark.parametrize("cls_name,code_name", [
    ("RnnThree", "ccsds_128_64"), ("RnnThree", "qc_96_48"),
    ("CnvNn", "ccsds_128_64"), ("CnvNn", "code1_64_32"), ("CnvNn", "qc_96_48")])
def test_refiners_match_jax(cls_name, code_name):
    """``refine(h, traj)`` vs JAX's ``refine(params, h, traj)``: CCSDS (dv 5,
    irregular 3-5; CnvNn stride 5), ``code1_64_32`` (dv 3, stride 3),
    ``qc_96_48`` (dv 4: CnvNn's stride 3 over a height not divisible by
    it)."""
    code = get_code(code_name)
    jmod, tree, port, traj = _refiner(cls_name, code, 13, seed=3)
    want = np.asarray(jmod.refine(tree, code.h, jnp.asarray(traj)))
    with torch.no_grad():
        got = port.refine(code.h, torch.as_tensor(traj)).numpy()
    assert got.shape == (2, code.n)
    np.testing.assert_allclose(got, want, **TOL)


def test_refiner_rejects_other_degrees():
    port = extras.CnvNn(64, 5, dv=3, dc=6)
    with pytest.raises(ValueError, match="dv 3, dc 6"):
        port.refine(CCSDS.h, torch.zeros(1, 5, CCSDS.n))


def test_model_rnn_2nd_matches_jax():
    x = _normal((3, 16, 13), seed=4, scale=1.5)
    jmod = jext.ModelRnn2nd(13)
    tree = _jax_init(jmod, jnp.asarray(x), seed=5)
    want = np.asarray(jmod.apply(tree, jnp.asarray(x)))
    np.testing.assert_allclose(_run(_port("ModelRnn2nd", tree, 13), x), want, **TOL)


def test_lstm_cell_step_by_step():
    """Every step's state of flax's ``nn.RNN(OptimizedLSTMCell(9))`` over 13
    steps of 7 inputs, with non-zero recurrent biases."""
    x = _normal((6, 13, 7), seed=6, scale=2.0)
    jmod = fnn.RNN(fnn.OptimizedLSTMCell(9))
    tree = _jax_init(jmod, jnp.asarray(x), seed=7)
    cell = tree["params"]["cell"]
    for g in "ifgo":
        cell["h" + g]["bias"] = _normal(9, seed=ord(g))
    want = np.asarray(jmod.apply(tree, jnp.asarray(x)))
    port = extras._LSTM(7, 9)
    state = convert.extras_state_from_jax(
        "ModelRnn2nd", {"params": {"OptimizedLSTMCell_0": cell}}, "cpu")
    port.load_state_dict({k.split(".", 1)[1]: v for k, v in state.items()})
    got = _run(port, x)
    assert got.shape == want.shape == (6, 13, 9)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.fixture(scope="module")
def trees():
    """Every module's JAX tree (flax init, seed 0) and port constructor args."""
    code = CCSDS
    neigh = jext.neighborhood_trajectories(code.h, jnp.zeros((1, 13, code.n)))
    out = {name: (jmod, _jax_init(jmod, jnp.zeros(shape), 0), args)
           for name, (jmod, args, shape) in HEADS.items()}
    for v in range(4):
        jmod = jext.PredictPhase(30, 31, v)
        out[f"PredictPhase{v}"] = (jmod, _jax_init(jmod, jnp.zeros((1, 59)), v),
                                   (30, 31, v))
    jmod = jext.ModelRnn2nd(13)
    out["ModelRnn2nd"] = (jmod, _jax_init(jmod, jnp.zeros((1, 4, 13)), 0), (13,))
    for name in ("RnnThree", "CnvNn"):
        jmod = getattr(jext, name)(n=code.n, list_length=13)
        out[name] = (jmod, _jax_init(jmod, neigh, 0), (code.n, 13))
    return out


ROUND_TRIP = ["SelfAttention", "MultiHeadAttention", "TransformerLayer",
              "TemperatureLayer", "PredictOutlier", "PredictPhase0",
              "PredictPhase1", "PredictPhase2", "PredictPhase3", "ModelRnn2nd",
              "RnnThree", "CnvNn"]


@pytest.mark.parametrize("key", ROUND_TRIP)
def test_convert_round_trip(trees, key):
    _, tree, args = trees[key]
    name = key.rstrip("0123")
    back = convert.extras_to_jax(_port(name, tree, *args))
    assert_trees_close(back, tree, rtol=0, atol=0)
    assert all(leaf.dtype == np.float32 for leaf in jax.tree.leaves(back))


def test_convert_layouts(trees):
    """Conv (kh, kw, in, out) -> (out, in, kh, kw), Dense transposed, the
    LSTM's gates side by side in i, f, g, o order; unknown names raise."""
    _, tree, _ = trees["RnnThree"]
    state = convert.extras_state_from_jax("RnnThree", tree, "cpu")
    cell = tree["params"]["OptimizedLSTMCell_0"]
    np.testing.assert_array_equal(state["lstm.wi"][:, 7:14].numpy(),
                                  cell["if"]["kernel"])
    np.testing.assert_array_equal(state["lstm.bh"][21:].numpy(), cell["ho"]["bias"])
    np.testing.assert_array_equal(state["head.weight"].numpy(),
                                  tree["params"]["head"]["kernel"].T)
    _, ctree, _ = trees["CnvNn"]
    cstate = convert.extras_state_from_jax("CnvNn", ctree, "cpu")
    np.testing.assert_array_equal(
        cstate["conv1.weight"].numpy(),
        np.transpose(ctree["params"]["conv1"]["kernel"], (3, 2, 0, 1)))
    with pytest.raises(ValueError, match="unknown extras model"):
        convert.extras_state_from_jax("RnnFour", tree, "cpu")


def test_init_flax_extras():
    """flax's defaults: input kernels lecun-normal (std 1/sqrt(fan_in)),
    recurrent kernels orthogonal gate by gate, biases 0, LayerNorm 1/0,
    coefficients 0, temperature 1; reproducible from the seed."""
    model = init_flax_(extras.RnnThree(128, 13), seed=3)
    again = init_flax_(extras.RnnThree(128, 13), seed=3)
    for a, b in zip(model.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)
    assert not model.coefficients.any() and not model.lstm.bh.any()
    wh = model.rnn_2nd.lstm.wh.detach()
    for g in range(4):
        q = wh[:, 13 * g:13 * (g + 1)]
        torch.testing.assert_close(q.T @ q, torch.eye(13), atol=1e-5, rtol=0)
    wi = init_flax_(extras._LSTM(400, 64), seed=1).wi.detach()
    assert abs(float(wi.std()) - 400 ** -0.5) < 0.003
    layer = init_flax_(extras.TransformerLayer(64, 8), seed=0)
    assert torch.equal(layer.norm1.scale, torch.ones(64))
    assert not layer.norm2.bias.any() and not layer.mha.head3.wq.bias.any()
    outlier = extras.PredictOutlier(6)
    with torch.no_grad():
        outlier.temperature.temperature.fill_(3.0)
    assert float(init_flax_(outlier, 0).temperature.temperature.detach()) == 1.0
    conv = init_flax_(extras.CnvNn(128, 13), 0).conv2.weight.detach()
    assert abs(float(conv.std()) - (32 * 3) ** -0.5) < 0.01
