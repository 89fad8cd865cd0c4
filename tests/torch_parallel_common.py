"""Inputs and JAX references shared by the port's ``parallel/`` tests
(``tests/test_torch_parallel.py``, ``tests/test_torch_multiprocess.py``).
Not collected by pytest (no ``test_`` prefix).

The OSD inputs are those of ``tests/test_parallel.py:334-448`` (the same
seeds and draws) at ``b`` rows, as plain numpy, so a process without JAX
can load them; the DIA weights are flax's initial ones, carried to the
port by ``convert``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from short_ldpc_decoding_osd_tpu.codes import get_code as jax_get_code
from short_ldpc_decoding_osd_tpu.models import make_dia
from short_ldpc_decoding_osd_tpu.ops import nms as jnms
from short_ldpc_decoding_osd_tpu.osd import engine as jengine
from short_ldpc_decoding_osd_tpu.osd import segments as jseg
from short_ldpc_decoding_osd_tpu.parallel import (
    make_mesh, sharded_dl_osd_step, sharded_dl_osd_step_from_llr)
from short_ldpc_decoding_osd_tpu.train.optim import staircase_adam
from short_ldpc_decoding_osd_tpu_torch.channel import ChannelSpec, sample_batch
from short_ldpc_decoding_osd_tpu_torch.codes import get_code
from short_ldpc_decoding_osd_tpu_torch.ops import nms
from short_ldpc_decoding_osd_tpu_torch.train.optim import StaircaseAdam

T = 6
PATH = [[0, 0, 0, 0, 0, 0], [1, 0, 0, 0, 0, 0], [0, 1, 0, 0, 0, 0],
        [1, 1, 0, 0, 0, 0], [0, 0, 1, 0, 0, 0]]
CHUNK = 64


def _plain(tree):
    """A flax tree as nested dicts of numpy arrays (picklable without
    flax)."""
    if hasattr(tree, "items"):
        return {k: _plain(v) for k, v in tree.items()}
    return np.asarray(tree)


def _fcn(rng):
    return {"w1": rng.normal(0, 0.3, (6, 6)).astype(np.float32),
            "w2": rng.normal(0, 0.3, (6, 2)).astype(np.float32)}


def osd_inputs(b: int) -> dict:
    """Numpy inputs of both sharded OSD steps at ``b`` rows: ``traj``/
    ``labels``/``fcn`` for the trajectory step (seed 5), ``llr``/
    ``llr_labels``/``fcn_llr`` for the raw-LLR step (seed 9)."""
    code = jax_get_code("ccsds_128_64")
    dia = make_dia("model_cnn", code.n, T + 1).init(
        jax.random.PRNGKey(0), jnp.zeros((code.n, T + 1, 1)))
    blocks, acc = jseg.build_tep_blocks(PATH, code.k)
    teps, mask, bounds = jseg.pack_tep_chunks(blocks, chunk=CHUNK)
    rng = np.random.default_rng(5)
    words = (rng.integers(0, 2, (b, code.k)) @ code.g % 2).astype(np.int8)
    noise = rng.normal(1.0, 0.9, (b, T + 1, code.n))
    traj = np.where(words[:, None, :] == 0, noise, -noise).astype(np.float32)
    fcn = _fcn(rng)
    rng = np.random.default_rng(9)
    llr_words = (rng.integers(0, 2, (b, code.k)) @ code.g % 2).astype(np.int32)
    noise = rng.normal(0.6, 1.0, (b, code.n))  # noisy enough to fail often
    llr = np.where(llr_words == 0, noise, -noise).astype(np.float32)
    return {"t": T, "dia": _plain(dia), "teps": teps, "mask": mask,
            "acc": np.asarray(acc, np.int64), "bounds": bounds, "path": PATH,
            "chunk": CHUNK,
            "traj": traj, "labels": words, "fcn": fcn,
            "llr": llr, "llr_labels": llr_words, "fcn_llr": _fcn(rng)}


def _jax_common(inp):
    model = make_dia("model_cnn", 128, T + 1)
    return (model, jnp.asarray(inp["teps"]), jnp.asarray(inp["mask"]),
            jnp.asarray(inp["acc"], jnp.int32))


def _jfcn(fcn):
    return {k: jnp.asarray(v) for k, v in fcn.items()}


def jax_osd_counters(inp, sharded: bool) -> np.ndarray:
    """JAX's [success, failure, total_teps, total_windows] of the
    trajectory step: ``sharded_dl_osd_step`` on ``make_mesh(8)``, or the
    single-device ``prepare`` + ``sliding_osd`` it equals."""
    code = jax_get_code("ccsds_128_64")
    model, teps, mask, acc = _jax_common(inp)
    traj, labels = jnp.asarray(inp["traj"]), jnp.asarray(inp["labels"])
    if sharded:
        mesh = make_mesh(8)
        with mesh:
            step = sharded_dl_osd_step(model, code.h, code.k, mesh,
                                       bounds=inp["bounds"])
            return np.asarray(step(inp["dia"], traj, labels, teps, mask, acc,
                                   _jfcn(inp["fcn"])))
    refined = model.refine_fast(inp["dia"], traj)
    prep = jengine.prepare(refined, traj[:, 0], labels, jnp.asarray(code.h),
                           code.k)
    out = jengine.sliding_osd(prep, teps, mask, acc, _jfcn(inp["fcn"]), code.k,
                              bounds=inp["bounds"])
    succ = np.asarray(out["success"])
    return np.array([succ.sum(), (~succ).sum(),
                     np.asarray(out["complexity"]).sum(),
                     np.asarray(out["windows_evaluated"]).sum()])


def jax_osd_from_llr_counters(inp, sharded: bool) -> np.ndarray:
    """JAX's [rows, detected, success_detected, total_teps, total_windows]
    of the raw-LLR step: ``sharded_dl_osd_step_from_llr`` on
    ``make_mesh(8)``, or the single-device ``make_dl_osd_step_from_llr``
    (XLA decoder) reduced the same way."""
    code = jax_get_code("ccsds_128_64")
    model, teps, mask, acc = _jax_common(inp)
    llr, labels = jnp.asarray(inp["llr"]), jnp.asarray(inp["llr_labels"])
    args = (jnms.init_params("NMS-1"), inp["dia"], llr, labels, teps, mask,
            acc, _jfcn(inp["fcn_llr"]))
    if sharded:
        mesh = make_mesh(8)
        step = sharded_dl_osd_step_from_llr(model, code, "NMS-1", T, mesh,
                                            bounds=inp["bounds"])
        with mesh:
            return np.asarray(step(*args))
    single = jengine.make_dl_osd_step_from_llr(model, code, "NMS-1", T,
                                               bounds=inp["bounds"],
                                               decoder="xla")
    out, _, det = single(*args)
    det = np.asarray(det)
    return np.array([len(det), det.sum(),
                     (np.asarray(out["success"]) & det).sum(),
                     np.asarray(out["complexity"])[det].sum(),
                     np.asarray(out["window_num"])[det].sum()])


def jax_train_reference(variant: str, num_iterations: int, frames) -> tuple:
    """JAX's NMS training update (``tests/test_parallel.py:496-538``'s
    reference) over the steps' ``(llr, words)`` numpy frames: the losses
    and the parameters after each step."""
    code = jax_get_code("ccsds_128_64")
    train_h = code.extended().h if variant == "ENMS" else code.h
    h = jnp.asarray(train_h, jnp.float32)
    params = jnms.init_params(variant)
    tx = staircase_adam(0.01, 500, 0.95, 5.0)
    opt_state = tx.init(params)
    losses, trail = [], []
    for llr, words in frames:
        def loss_fn(p):
            outs = jnms.decode(p, h, jnp.asarray(llr), num_iterations, variant)
            return jnms.multi_iteration_loss(outs, jnp.asarray(words))

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        losses.append(float(loss))
        trail.append({k: np.asarray(v) for k, v in params.items()})
    return losses, trail


def port_train_reference(variant: str, num_iterations: int, snr_db: float,
                         batch: int, seeds) -> tuple:
    """The port's single-device NMS update, step by step: each step draws
    ``batch`` frames from a CPU generator seeded ``seeds[i]``, takes the
    loss over all of them, its backward and one ``StaircaseAdam`` step.
    Returns the losses, the parameters after each step and the frames
    (numpy) each step drew."""
    code = get_code("ccsds_128_64")
    train_h = code.extended().h if variant == "ENMS" else code.h
    spec = ChannelSpec.awgn(snr_db, code.rate)
    gen_matrix = torch.as_tensor(code.g, dtype=torch.float32)
    params = {k: v.requires_grad_() for k, v in nms.init_params(variant).items()}
    opt = StaircaseAdam(params.values(), 0.01, 500, 0.95, 5.0)
    losses, trail, frames = [], [], []
    for seed in seeds:
        llr, words = sample_batch(torch.Generator().manual_seed(seed), spec,
                                  gen_matrix, batch)
        opt.zero_grad()
        loss = nms.multi_iteration_loss(
            nms.decode(params, train_h, llr, num_iterations, variant), words)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        trail.append({k: v.detach().numpy().copy() for k, v in params.items()})
        frames.append((llr.numpy(), words.numpy()))
    return losses, trail, frames
