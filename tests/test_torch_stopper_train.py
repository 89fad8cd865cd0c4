"""The port's ``train/stopper_train.py`` vs the JAX package (CPU), on the
committed failure set ``runs/refparity/failures.npz`` with the
``runs/r4_pipeline`` weights and decoding path.

Tolerances: block-minima records rtol 1e-5 (the discrepancies are sums of
128 weighted terms in another order), phases and the summary exact;
``reform_windows`` exact; the loss and its gradients rtol 1e-5; the
stopper's weights after N training steps rtol 1e-4 against a loop built
from JAX's public ``stopper_loss`` and ``staircase_adam``, the validation
counts exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from short_ldpc_decoding_osd_tpu.codes import get_code as jax_get_code
from short_ldpc_decoding_osd_tpu.models import dia as jdia
from short_ldpc_decoding_osd_tpu.train import stopper_train as jstop
from short_ldpc_decoding_osd_tpu.train.optim import staircase_adam
from short_ldpc_decoding_osd_tpu_torch import convert
from short_ldpc_decoding_osd_tpu_torch.codes import get_code
from short_ldpc_decoding_osd_tpu_torch.mc.harness import trajectories_for_llrs
from short_ldpc_decoding_osd_tpu_torch.train import stopper_train

from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R4 = os.path.join(_ROOT, "runs", "r4_pipeline")


@pytest.fixture(scope="module")
def samples():
    """(port records, summary), (JAX records, summary) on refparity's 96
    failures, 40 frames a batch (two full batches and a tail)."""
    blob = np.load(os.path.join(_ROOT, "runs", "refparity", "failures.npz"))
    run = convert.load_run(R4, "cpu")
    code = get_code("ccsds_128_64")
    traj = trajectories_for_llrs(code, run["nms_params"], "NMS-1", 12,
                                 blob["llr"], device="cpu")
    tree = convert.load_jax_pickle(os.path.join(R4, "dia_model_cnn.pkl"))
    want = jstop.generate_stopper_samples(
        jax_get_code("ccsds_128_64"), jdia.make_dia("model_cnn", 128, 13), tree,
        traj, blob["labels"], run["path"], batch=40)
    got = stopper_train.generate_stopper_samples(
        code, run["dia"], traj, blob["labels"], run["path"], batch=40,
        device="cpu")
    return got, want


def test_generate_stopper_samples_matches_jax(samples):
    (rec, summary), (ref, ref_summary) = samples
    assert summary == ref_summary
    assert rec.shape == ref.shape == (summary["success"] + summary["fail"], 31)
    np.testing.assert_array_equal(rec[:, -1], ref[:, -1])
    np.testing.assert_allclose(rec[:, :-1], ref[:, :-1], rtol=1e-5, atol=1e-5)
    assert summary["success"] > 80


def test_reform_windows_matches_jax(samples):
    (rec, _), _ = samples
    for window in (5, 3):
        ins, labs = stopper_train.reform_windows(rec, window)
        ref_ins, ref_labs = jstop.reform_windows(rec, window)
        np.testing.assert_array_equal(ins, ref_ins)
        np.testing.assert_array_equal(labs, ref_labs)
    empty = stopper_train.reform_windows(rec[:0], 5)
    assert empty[0].shape == (0, 6) and empty[1].shape == (0,)


def test_stopper_loss_and_gradients_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 2, (50, 2)).astype(np.float32)
    one_hot = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 50)]
    weights = rng.uniform(0.5, 3, 50).astype(np.float32)

    def jax_loss(x):
        return jstop.stopper_loss(jax.nn.softmax(x, -1), jnp.asarray(one_hot),
                                  jnp.asarray(weights), 10.0)

    want, want_grad = jax.value_and_grad(jax_loss)(jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    got = stopper_train.stopper_loss(torch.softmax(x, -1), torch.as_tensor(one_hot),
                                     torch.as_tensor(weights), 10.0)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), rtol=1e-5,
                               atol=1e-6)


def test_train_stopper_steps_match_jax_loop(samples, monkeypatch):
    """13 steps of 64 windows (wrapping the permuted dataset) from the same
    initial weights, with the class weights, the x10 premature-stop penalty
    and the L2 on ``dense1``."""
    (rec, _), _ = samples
    ins, labs = stopper_train.reform_windows(rec, 5)
    cfg = stopper_train.StopperTrainConfig(batch=64, termination_step=13)
    model = jdia.StopperFcn(6)
    tree = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(4),
                                               jnp.zeros((2, 6))))

    perm = np.random.default_rng(9).permutation(len(ins))
    x_all, y = ins[perm], labs[perm].astype(int)
    counts = np.bincount(y, minlength=2).astype(np.float64)
    w_all = (len(y) / (2.0 * np.maximum(counts, 1)))[y].astype(np.float32)
    oh_all = np.eye(2, dtype=np.float32)[y]
    nb = len(ins) // cfg.batch
    tx = staircase_adam(cfg.learning_rate, cfg.decay_steps, cfg.decay_rate,
                        cfg.clip_norm)
    params, state = tree, tx.init(tree)

    @jax.jit
    def grad_fn(p, x, oh, w):
        def loss(p):
            reg = 0.01 * jnp.sum(jnp.square(p["params"]["dense1"]["kernel"]))
            return jstop.stopper_loss(model.apply(p, x), oh, w, cfg.penalty) + reg
        return jax.value_and_grad(loss)(p)

    for step in range(cfg.termination_step):
        sl = slice((step % nb) * cfg.batch, (step % nb + 1) * cfg.batch)
        loss, grads = grad_fn(params, x_all[sl], oh_all[sl], w_all[sl])
        if step == 0:
            first_loss = float(loss)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    pred = np.asarray(model.apply(params, jnp.asarray(x_all))).argmax(1)

    monkeypatch.setattr(stopper_train, "initial_stopper",
                        lambda *a: convert.stopper_module(
                            convert.stopper_from_jax(tree, "cpu")))
    port, val = stopper_train.train_stopper(ins, labs, cfg, seed=9, device="cpu")
    got = convert.stopper_to_jax({"w1": port.dense1.weight.T,
                                  "w2": port.dense2.weight.T})
    for layer in ("dense1", "dense2"):
        np.testing.assert_allclose(got["params"][layer]["kernel"],
                                   np.asarray(params["params"][layer]["kernel"]),
                                   rtol=1e-4, atol=1e-6)
    assert val == {
        "success": int((pred == y).sum()), "late": int((y > pred).sum()),
        "premature": int((y < pred).sum()), "total": len(ins),
        "final_loss": pytest.approx(float(loss), rel=1e-4),
        "initial_loss": pytest.approx(first_loss, rel=1e-4)}


def test_train_stopper_learns_and_seeds():
    """The port's own initialisation: the loss falls, and one seed gives
    one result."""
    rng = np.random.default_rng(1)
    ins = np.sort(rng.gamma(2.0, 2.0, (600, 5)), axis=1).astype(np.float32)
    ins = np.concatenate([ins, rng.integers(0, 26, (600, 1))], 1).astype(np.float32)
    labs = (ins[:, 0] < 2.0).astype(np.float32)
    cfg = stopper_train.StopperTrainConfig(batch=50, termination_step=120)
    a, val = stopper_train.train_stopper(ins, labs, cfg, device="cpu")
    b, val_b = stopper_train.train_stopper(ins, labs, cfg, device="cpu")
    assert val == val_b
    torch.testing.assert_close(a.dense1.weight, b.dense1.weight, rtol=0, atol=0)
    assert val["final_loss"] < val["initial_loss"]
    assert val["success"] + val["late"] + val["premature"] == val["total"] == 600
