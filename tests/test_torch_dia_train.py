"""The port's ``train/dia_train.py`` vs the JAX package (CPU).

Tolerances: parameters after N training steps rtol 1e-4 against a loop
built from JAX's public ``refine``, ``dia_loss`` and ``staircase_adam``;
the pattern sweep's counters and histograms exact, as is a resumed run
against an uninterrupted one (the same arithmetic on the CPU).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from short_ldpc_decoding_osd_tpu.codes import get_code as jax_get_code
from short_ldpc_decoding_osd_tpu.models import dia as jdia
from short_ldpc_decoding_osd_tpu.train import dia_train as jdia_train
from short_ldpc_decoding_osd_tpu.train.optim import staircase_adam
from short_ldpc_decoding_osd_tpu_torch import convert
from short_ldpc_decoding_osd_tpu_torch.codes import get_code
from short_ldpc_decoding_osd_tpu_torch.mc.harness import trajectories_for_llrs
from short_ldpc_decoding_osd_tpu_torch.train import dia_train

from torch_dia_common import (N, RUNS, T1, assert_trees_close, jax_init,
                              port_dia, traj_labels)
from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("name", ["model_cnn", "model_rnn1"])
def test_train_dia_steps_match_jax_loop(name, monkeypatch):
    """7 steps over 3 in-order batches of 10 (wrapping around), from the
    same converted initial weights."""
    model, tree = jax_init(name, seed=7)
    traj, labels = traj_labels(34, seed=6)
    cfg = dia_train.DIATrainConfig(model=name, batch=10, termination_step=7)
    tx = staircase_adam(cfg.learning_rate, cfg.decay_steps, cfg.decay_rate,
                        cfg.clip_norm)
    params, state = tree, tx.init(tree)
    step_fn = jax.jit(jax.value_and_grad(
        lambda p, x, z: jdia.dia_loss(model.refine(p, x), z)))
    for step in range(cfg.termination_step):
        lo = (step % 3) * 10
        loss, grads = step_fn(params, jnp.asarray(traj[lo:lo + 10]),
                              jnp.asarray(labels[lo:lo + 10]))
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)

    monkeypatch.setattr(dia_train, "initial_model",
                        lambda *a, **k: port_dia(name, tree).train())
    port, history = dia_train.train_dia(get_code("ccsds_128_64"), traj, labels,
                                        cfg, device="cpu")
    assert [r["step"] for r in history] == [7]
    np.testing.assert_allclose(history[-1]["loss"], float(loss), rtol=1e-4)
    assert_trees_close(convert.dia_to_jax(port),
                        jax.tree.map(np.asarray, params), rtol=1e-4, atol=1e-6)


def test_train_dia_resume_equals_uninterrupted(tmp_path):
    code = get_code("ccsds_128_64")
    traj, labels = traj_labels(40, seed=8)
    full = dia_train.DIATrainConfig(batch=8, termination_step=150)
    ref, ref_hist = dia_train.train_dia(code, traj, labels, full,
                                        ckpt_dir=str(tmp_path / "a"), device="cpu")
    part = dataclasses.replace(full, termination_step=100)
    dia_train.train_dia(code, traj, labels, part, ckpt_dir=str(tmp_path / "b"),
                        device="cpu")
    got, hist = dia_train.train_dia(code, traj, labels, full,
                                    ckpt_dir=str(tmp_path / "b"), device="cpu")
    assert [r["step"] for r in ref_hist] == [100, 150]
    assert [r["step"] for r in hist] == [150]  # resumed at 100, no +1
    assert hist == ref_hist[1:]
    for key, val in ref.state_dict().items():
        torch.testing.assert_close(got.state_dict()[key], val, rtol=0, atol=0)


def test_pattern_statistics_sweep_matches_jax():
    """On the committed failure set's trajectories with the r4 CNN."""
    blob = np.load(os.path.join(RUNS, "refparity", "failures.npz"))
    run = convert.load_run(os.path.join(RUNS, "r4_pipeline"), "cpu")
    code = get_code("ccsds_128_64")
    traj = trajectories_for_llrs(code, run["nms_params"], "NMS-1", 12,
                                 blob["llr"], device="cpu")
    labels = blob["labels"]
    tree = convert.load_jax_pickle(os.path.join(RUNS, "r4_pipeline",
                                                "dia_model_cnn.pkl"))
    want = jdia_train.pattern_statistics_sweep(
        jax_get_code("ccsds_128_64"), jdia.make_dia("model_cnn", N, T1), tree,
        traj, labels, batch=40)
    got = dia_train.pattern_statistics_sweep(code, run["dia"], traj, labels,
                                             batch=40, device="cpu")
    for key in ("hist_initial", "hist_final", "hist_refined"):
        assert got[key] == want[key], key
    g, w = got["pattern_counter"], want["pattern_counter"]
    assert (g.counts, g.total, g.swap_sum) == (w.counts, w.total, w.swap_sum)
    assert g.decoding_path(3, 30) == w.decoding_path(3, 30)
