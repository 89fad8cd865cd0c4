"""Sharded Monte-Carlo, OSD and training steps over a :class:`Mesh`.

Port of ``short_ldpc_decoding_osd_tpu/parallel/data_parallel.py``.  JAX
shards the frame axis over the mesh and XLA ``psum``s the counters; here
every rank runs the step on its share of the frames and the counters (or
gradients) are summed with :meth:`Mesh.all_reduce_sum`.  Parameters are
replicated.

Every decision that changes what the ranks run next is taken from a value
all ranks share: the global batch (the decoder, the re-decode route) or a
reduced counter (the compact step's overflow, the harness's error
budget).  A decision taken from a rank's own value would let the ranks
issue different collectives and deadlock.

The port does not demote (``mc/ladder.py``): a kernel that fails raises on
its rank.  JAX's transient retry (``ladder.attempt_multiproc``) is a TPU
means and has no counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import full_f32
from ..channel.awgn import ChannelSpec, sample_batch
from ..codes import Code, tables
from ..mc import harness, ladder
from ..ops import nms, nms_edge, nms_edge_padded
from ..osd import engine
from ..osd.segments import TepLayout
from ..train.nms_train import _project_nonneg_
from ..train.optim import StaircaseAdam
from ..utils.dtypes import count_dtype
from .mesh import Mesh

# the rungs a mesh sweep can pin (JAX's SLDPC_MESH_RUNG): the dense rung
# K7 is not on JAX's mesh ladder
MESH_RUNGS = ("compact", "oneshot", "xla")


def _rows(mesh: Mesh, per_device_batch: int) -> slice:
    """This rank's rows of a global sample of ``per_device_batch * size``."""
    return slice(mesh.rank * per_device_batch,
                 (mesh.rank + 1) * per_device_batch)


def sharded_nms_mc_step(code: Code, variant: str, num_iterations: int,
                        spec: ChannelSpec, per_device_batch: int, mesh: Mesh,
                        decoder: str | None = None):
    """``step(params, generator) -> counters`` (5,) int64, summed over the
    mesh: [frames, frame_errors, bit_errors, detected, undetected].

    Every rank draws the whole global sample (``per_device_batch * size``
    frames) from ``generator``, which the caller seeds identically on
    every rank, keeps rows ``[rank * b, (rank + 1) * b)``, decodes and
    counts them.  So the process layout cannot change the frames, as
    JAX's one global sample guarantees.  The decoder is
    ``harness.select_decoder``'s at the global batch (``decoder`` pins
    one), so every rank decodes as the single-device step of ``size * b``
    frames does; ENMS decodes on the extended H."""
    dev = mesh.device
    total = per_device_batch * mesh.size
    decode_h = code.extended().h if variant == "ENMS" else code.h
    chosen = harness.select_decoder(decode_h, variant, total, decoder, dev)
    decode = harness.decode_final_fn(chosen, decode_h, variant,
                                     num_iterations, dev)
    gen_matrix = tables.f32(code.g, dev)
    rows = _rows(mesh, per_device_batch)

    def step(params: dict, generator: torch.Generator) -> torch.Tensor:
        llr, words = sample_batch(generator, spec, gen_matrix, total)
        llr, words = llr[rows], words[rows]
        counters, _ = harness.count_and_capture(llr, words,
                                                decode(params, llr), decode_h)
        return mesh.all_reduce_sum(counters.to(count_dtype()))

    step.decoder = chosen
    return step


def device_seeds(base_seed: int, idx: int, n_dev: int) -> np.ndarray:
    """Per-device int32 kernel seeds for MC step ``idx``.

    Strided by ``n_dev`` so (step, device) -> seed is a bijection: a plain
    ``base + device`` offset would collide step i's device d+1 with step
    i+1's device d (identical (seed, program_id) pairs -> identical frames).
    With one device this reduces to the single-device harness seed
    ``base_seed * 100003 + idx`` exactly."""
    base = np.int64(base_seed) * 100003 + idx
    return ((base * n_dev + np.arange(n_dev, dtype=np.int64)) & 0x7FFFFFFF
            ).astype(np.int32)


def sharded_seed_counters(mesh: Mesh, counters_fn):
    """``fn(params, seeds (size,)) -> counters`` summed over the mesh: rank
    r runs ``counters_fn(params, int(seeds[r]))``.  The bridge that puts the
    fused kernels, which take a seed rather than a generator, on the
    mesh."""

    def fn(params, seeds) -> torch.Tensor:
        counters = counters_fn(params, int(seeds[mesh.rank]))
        return mesh.all_reduce_sum(counters.to(count_dtype()))

    return fn


def sharded_fused_mc_step(code: Code, variant: str, num_iterations: int,
                          snr_db: float, per_device_batch: int, mesh: Mesh,
                          base_seed: int, spec: ChannelSpec | None = None,
                          rung: str | None = None):
    """The fused Monte-Carlo step on every rank of the mesh:
    ``step(params, idx) -> (counters (5,) int64, None)``, the harness's
    step with the parameters passed in.

    Each rank runs K3 (``fused_counters_edge_compact``, t1 = 4,
    ``DEFAULT_COMPACT_SCHEDULE``, groups of ``ladder.ladder_blocks``
    frames) on its seed ``device_seeds(base_seed, idx, size)[rank]``.  When
    the reduced overflow counter is non-zero every rank redoes the step
    one-shot on K4 and the sweep stays on K4: the ladder's rule
    (``mc/ladder.py``), uniform across ranks because it reads a reduced
    value.  ``rung`` pins one of :data:`MESH_RUNGS` in place of JAX's
    ``SLDPC_MESH_RUNG``: ``"compact"`` (raising when compaction does not
    apply), ``"oneshot"`` K4 every step, ``"xla"`` :func:`sharded_nms_mc_step`
    on the plain decoder with the harness's generator seed
    ``base_seed * 1_000_003 + idx``."""
    if rung not in (None,) + MESH_RUNGS:
        raise ValueError(f"unknown mesh rung {rung!r}; expected "
                         + "|".join(MESH_RUNGS))
    spec = spec or ChannelSpec.awgn(snr_db, code.rate)
    batch = per_device_batch
    if rung == "xla":
        xla = sharded_nms_mc_step(code, variant, num_iterations, spec, batch,
                                  mesh, decoder="plain")
        generator = torch.Generator(device=mesh.device)

        def step_xla(params, idx):
            generator.manual_seed(base_seed * 1_000_003 + idx)
            return xla(params, generator), None

        return step_xla
    if (variant == "NMS-r" or batch % 32
            or spec != ChannelSpec.awgn(snr_db, code.rate)):
        raise ValueError("the fused mesh step needs a scalar variant, plain "
                         "AWGN and a batch that is a multiple of 32; pin "
                         "rung='xla'")
    t1 = 4
    cblock, compact_enabled = ladder.ladder_blocks(batch, num_iterations, t1)
    if rung == "compact" and not compact_enabled:
        raise ValueError(f"rung 'compact' does not apply to batch {batch} "
                         f"with {num_iterations} iterations")
    state = {"rung": rung or ("compact" if compact_enabled else "oneshot")}
    compact = sharded_seed_counters(mesh, lambda p, s: (
        nms_edge.fused_counters_edge_compact(
            code, p, variant, num_iterations, snr_db, batch, seed=s, t1=t1,
            block_frames=cblock, schedule=nms_edge.DEFAULT_COMPACT_SCHEDULE,
            device=mesh.device)))
    oneshot = sharded_seed_counters(mesh, lambda p, s: (
        nms_edge.fused_counters_edge(code, p, variant, num_iterations, snr_db,
                                     batch, seed=s, device=mesh.device)))

    def step(params, idx):
        # the scalar weights are read on the host by the kernel wrappers
        params = {k: torch.as_tensor(v).cpu() for k, v in params.items()}
        seeds = device_seeds(base_seed, idx, mesh.size)
        if state["rung"] == "compact":
            c = compact(params, seeds)
            if int(c[5]) == 0:
                return c[:5], None
            state["rung"] = "oneshot"  # overflow: redo one-shot, stay
        return oneshot(params, seeds), None

    return step


def _osd_slice(mesh: Mesh, *tensors):
    """This rank's part of each global batch (``torch.tensor_split``, so an
    uneven batch works), on the mesh's device."""
    return [torch.tensor_split(t, mesh.size)[mesh.rank].to(mesh.device)
            for t in tensors]


def sharded_dl_osd_step_from_llr(model, code: Code, variant: str,
                                 num_iterations: int, mesh: Mesh,
                                 layout: TepLayout, window: int = 5,
                                 soft_margin: float = 0.9,
                                 route: str | None = None):
    """The raw-LLR phase-2 step over ``layout`` with the failure batch
    split over the mesh: ``step(nms_params, llr, labels, fcn_params) ->
    counters`` (5,) int64 = [rows, detected, success_detected, total_teps,
    total_windows], summed over the mesh; the TEP and complexity counts
    are over the rows the re-decode confirms as detected failures.

    Every rank gets the global batch and takes its part.  The re-decode's
    route is ``engine.redecode_route``'s at the global row count (K2 on
    the card), or ``route``; ``model`` carries its own weights."""
    decode_h = code.extended().h if variant == "ENMS" else code.h
    steps = {}

    def step(nms_params, llr, labels, fcn_params):
        chosen = route or engine.redecode_route(decode_h, variant, mesh.device,
                                                llr.shape[0])
        if chosen not in steps:
            steps[chosen] = engine.make_dl_osd_step_from_llr(
                model, code, variant, num_iterations, layout, window=window,
                soft_margin=soft_margin, route=chosen)
        llr, labels = _osd_slice(mesh, llr, labels)
        cdt = count_dtype()
        if llr.shape[0] == 0:
            return mesh.all_reduce_sum(torch.zeros(5, dtype=cdt,
                                                   device=mesh.device))
        out, _, det = steps[chosen](nms_params, llr, labels, fcn_params)
        zero = torch.zeros((), dtype=cdt, device=det.device)
        counters = torch.stack([
            torch.tensor(llr.shape[0], dtype=cdt, device=det.device),
            det.sum(),
            (out["success"] & det).sum(),
            torch.where(det, out["complexity"].to(cdt), zero).sum(),
            torch.where(det, out["window_num"].to(cdt), zero).sum(),
        ])
        return mesh.all_reduce_sum(counters)

    return step


def sharded_nms_train_step(code: Code, variant: str, num_iterations: int,
                           spec: ChannelSpec, per_device_batch: int,
                           mesh: Mesh, learning_rate: float = 0.01,
                           decay_steps: int = 500, decay_rate: float = 0.95,
                           clip_norm: float = 5.0):
    """Data-parallel NMS training step: returns ``(make_optimizer, step)``.

    ``make_optimizer(params)`` is the port's ``StaircaseAdam`` over the
    parameter tensors (JAX's ``tx.init(params)``); ``step(params,
    optimizer, generator) -> loss`` updates ``params`` in place, as
    ``train_nms`` does.  Each rank draws the global sample from
    ``generator`` (seeded identically on every rank), takes its rows, and
    runs the loss and its backward.  The loss
    (``nms.multi_iteration_loss``) is a sum over the frames, so the
    global loss is the sum of the ranks' losses and its gradient the sum
    of theirs: the gradients are summed over the mesh before the clip and
    the Adam step, and the returned loss is the summed loss, what JAX's
    sharded ``value_and_grad`` computes.  NMS-r's weights are projected
    to non-negative values after the update, as in ``train_nms``.  The
    decoder is ``nms_edge_padded.train_select``'s; ENMS trains on the
    extended H."""
    dev = mesh.device
    total = per_device_batch * mesh.size
    train_h = np.asarray(code.extended().h if variant == "ENMS" else code.h)
    h = tables.f32(train_h, dev)
    gen_matrix = tables.f32(code.g, dev)
    edge_cols = nms.edge_columns(train_h) if variant == "NMS-r" else None
    use_edge = nms_edge_padded.train_select(train_h, variant, dev)
    rows = _rows(mesh, per_device_batch)

    def make_optimizer(params: dict) -> StaircaseAdam:
        return StaircaseAdam(params.values(), learning_rate, decay_steps,
                             decay_rate, clip_norm)

    @full_f32()  # the backward pass too
    def step(params: dict, optimizer: StaircaseAdam,
             generator: torch.Generator) -> torch.Tensor:
        llr, words = sample_batch(generator, spec, gen_matrix, total)
        llr, words = llr[rows], words[rows]
        optimizer.zero_grad()
        if use_edge:
            outs = nms_edge_padded.decode_edge_padded(params, train_h, llr,
                                                      num_iterations, variant)
        else:
            outs = nms.decode(params, h, llr, num_iterations, variant,
                              edge_cols)
        loss = nms.multi_iteration_loss(outs, words)
        loss.backward()
        for p in params.values():
            mesh.all_reduce_sum(p.grad)
        optimizer.step()
        _project_nonneg_(params, variant)
        return mesh.all_reduce_sum(loss.detach().clone())

    return make_optimizer, step


def sharded_dl_osd_step(model, h, k: int, mesh: Mesh, layout: TepLayout,
                        window: int = 5, soft_margin: float = 0.9):
    """DIA-OSD evaluation of captured trajectories over ``layout`` with the
    failure batch split over the mesh: ``step(traj, labels, fcn_params) ->
    counters`` (4,) int64 = [success, failure, total_teps,
    total_windows], summed over the mesh.

    ``engine.make_dl_osd_step``'s convention: ``model`` carries its own
    weights.  Every rank gets the global batch and takes its part with
    ``torch.tensor_split``, so an uneven batch works."""
    inner = engine.make_dl_osd_step(model, h, k, layout, window=window,
                                    soft_margin=soft_margin)

    def step(traj, labels, fcn_params):
        traj, labels = _osd_slice(mesh, traj, labels)
        cdt = count_dtype()
        if traj.shape[0] == 0:
            return mesh.all_reduce_sum(torch.zeros(4, dtype=cdt,
                                                   device=mesh.device))
        out, _ = inner(traj, labels, fcn_params)
        succ = out["success"]
        counters = torch.stack([
            succ.sum(), (~succ).sum(), out["complexity"].to(cdt).sum(),
            out["windows_evaluated"].to(cdt).sum()]).to(cdt)
        return mesh.all_reduce_sum(counters)

    return step
