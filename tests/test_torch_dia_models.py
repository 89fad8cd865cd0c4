"""The port's DIA refiners (``models/dia.py``: ``RnnOne``, ``RnnTwo``, the
loss, flax's initialisers) and ``convert.py``'s round trip vs the JAX
package (CPU).

Tolerances: refined outputs rtol 1e-4 (13 recurrent steps of 128-wide f32
matmuls summed in another order than XLA); the loss and its gradients
rtol 1e-5, the gradients also atol 1e-5 of their largest entry (a sum over
thousands of bits); the conversion round trip exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from short_ldpc_decoding_osd_tpu.models import dia as jdia
from short_ldpc_decoding_osd_tpu_torch import convert
from short_ldpc_decoding_osd_tpu_torch.models import dia

from torch_dia_common import N, RUNS, T1, jax_init, port_dia, traj_labels
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

MODELS = ("model_cnn", "model_rnn1", "model_rnn2")


def test_rnn_refine_r4_rnn1_matches_jax():
    tree = convert.load_jax_pickle(os.path.join(RUNS, "r4_rnn1",
                                                "dia_model_rnn1.pkl"))
    run = convert.load_run(os.path.join(RUNS, "r4_rnn1"), "cpu")
    assert isinstance(run["dia"], dia.RnnOne)
    traj, _ = traj_labels(24, seed=0)
    want = np.asarray(jdia.make_dia("model_rnn1", N, T1).refine(tree,
                                                                jnp.asarray(traj)))
    got = run["dia"].refine_fast(torch.as_tensor(traj)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["model_rnn1", "model_rnn2"])
def test_rnn_refine_random_weights_matches_jax(name):
    model, tree = jax_init(name, seed=3)
    traj, _ = traj_labels(16, seed=1)
    want = np.asarray(model.refine(tree, jnp.asarray(traj)))
    port = port_dia(name, tree)
    with torch.no_grad():
        got = port.refine(torch.as_tensor(traj)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(port.refine_fast(torch.as_tensor(traj)).numpy(),
                                  got)


@pytest.mark.parametrize("cell,jax_cell", [
    (dia._LinearGRU, jdia._LinearGRU), (dia._LinearSimpleRNN, jdia._LinearSimpleRNN)])
def test_recurrent_cell_step_by_step(cell, jax_cell):
    """Every step's state, not only the last, on an 8-wide cell over 13
    steps of 5 inputs."""
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (6, 13, 5)).astype(np.float32)
    jmod = jax_cell(8)
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    want = np.asarray(jmod.apply(params, jnp.asarray(x)))
    port = cell(5, 8)
    with torch.no_grad():
        port.wi.copy_(torch.as_tensor(params["params"]["wi"]))
        port.wh.copy_(torch.as_tensor(params["params"]["wh"]))
        got = port(torch.as_tensor(x)).numpy()
    assert got.shape == want.shape == (6, 13, 8)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", MODELS)
def test_dia_loss_and_gradients_match_jax(name):
    model, tree = jax_init(name, seed=5)
    traj, labels = traj_labels(12, seed=4)

    def jax_loss(p):
        return jdia.dia_loss(model.refine(p, jnp.asarray(traj)), jnp.asarray(labels))

    want_loss, want_grads = jax.value_and_grad(jax_loss)(tree)
    port = port_dia(name, tree)
    loss = dia.dia_loss(port.refine(torch.as_tensor(traj)), torch.as_tensor(labels))
    loss.backward()
    got_grads = convert.dia_to_jax({k: p.grad for k, p in port.named_parameters()})
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for (path, g), (_, w) in zip(jax.tree_util.tree_leaves_with_path(got_grads),
                                 jax.tree_util.tree_leaves_with_path(want_grads)):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=str(path))


def test_dia_loss_is_a_sum():
    refined = torch.tensor([[2.0, -1.0], [0.0, 3.0]])
    labels = torch.tensor([[0, 1], [1, 0]])
    want = sum(np.log1p(np.exp(x)) if z == 0 else np.log1p(np.exp(-x))
               for x, z in ((-2.0, 0), (1.0, 1), (0.0, 1), (-3.0, 0)))
    assert float(dia.dia_loss(refined, labels)) == pytest.approx(want, rel=1e-6)


def test_make_dia_list_length_rule():
    """Only the CNN needs 7 slots (its three valid convolutions take 6)."""
    assert isinstance(dia.make_dia("model_rnn1", 16, 4), dia.RnnOne)
    assert isinstance(dia.make_dia("rnn_two", 16, 4), dia.RnnTwo)
    with pytest.raises(ValueError, match="list_length"):
        dia.make_dia("model_cnn", 16, 4)
    with pytest.raises(ValueError, match="unknown DIA model"):
        dia.make_dia("model_rnn3", 16, 13)
    for name in ("cnn", "rnn_one", "rnn_two", "rnn1", "rnn2"):
        assert dia.canonical_dia_name(name) == jdia.canonical_dia_name(name)


@pytest.mark.parametrize("run_name,model_name", [("r4_pipeline", "model_cnn"),
                                                 ("r4_rnn1", "model_rnn1")])
def test_convert_round_trip(run_name, model_name):
    """to_jax_params(from_jax_params(x)) == x leaf for leaf: keys, dtypes,
    shapes and values."""
    root = os.path.join(RUNS, run_name)
    trees = [convert.load_jax_pickle(os.path.join(root, f)) for f in (
        "nms_params.pkl", f"dia_{model_name}.pkl", "stopper_params.pkl")]
    back = convert.to_jax_params(*convert.from_jax_params(*trees, device="cpu"))
    for got, want in zip(back, trees):
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", MODELS)
def test_init_flax_distributions(name):
    """flax's initialisers, drawn on the CPU from the seed: lecun_normal
    kernels (truncated at 2 sigma, variance 1 / fan_in), zero biases,
    glorot_uniform input kernels and orthogonal recurrent kernels."""
    model = dia.init_flax_(dia.make_dia(name, N, T1), 3)
    again = dia.init_flax_(dia.make_dia(name, N, T1), 3)
    for key, val in model.state_dict().items():
        torch.testing.assert_close(again.state_dict()[key], val, rtol=0, atol=0)
        if key.endswith("bias"):
            assert not val.any()
        elif key.endswith(".wh"):
            eye = val @ val.T
            torch.testing.assert_close(eye, torch.eye(val.shape[0]), atol=1e-5,
                                       rtol=0)
        elif key.endswith(".wi"):
            limit = np.sqrt(6.0 / sum(val.shape))
            assert float(val.abs().max()) <= limit
            assert float(val.abs().max()) > 0.9 * limit
        else:
            fan_in = val[0].numel()
            std = np.sqrt(1.0 / fan_in)
            assert float(val.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
            if val.numel() >= 1000:
                assert abs(float(val.std()) / std - 1) < 0.05
