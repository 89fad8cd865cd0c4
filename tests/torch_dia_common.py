"""Shared helpers of the port's DIA tests (``test_torch_dia_models.py``,
``test_torch_dia_train.py``): seeded trajectories, JAX-initialised
refiners and their port twins."""

import os

import jax
import jax.numpy as jnp
import numpy as np

from short_ldpc_decoding_osd_tpu.models import dia as jdia
from short_ldpc_decoding_osd_tpu_torch import convert

RUNS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "runs")
N, T1 = 128, 13


def traj_labels(b, seed, n=N, t=T1):
    rng = np.random.default_rng(seed)
    traj = rng.normal(0.6, 1.5, (b, t, n)).astype(np.float32)
    labels = (rng.random((b, n)) < 0.5).astype(np.int32)
    return traj, labels


def jax_init(name, seed, n=N, t=T1):
    model = jdia.make_dia(name, n, t)
    x = jnp.zeros((2, t, n), jnp.float32)
    if name == "model_cnn":
        x = jnp.zeros((2 * n, t, 1), jnp.float32)
    return model, jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(seed), x))


def port_dia(name, tree, n=N, t=T1):
    return convert.dia_module(name, n, t, convert.dia_state_from_jax(tree, "cpu"))


def assert_trees_close(got, want, **tol):
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, g), (_, w) in zip(flat_got, flat_want):
        np.testing.assert_allclose(g, w, err_msg=str(path), **tol)
