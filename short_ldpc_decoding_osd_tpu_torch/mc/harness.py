"""Single-host Monte-Carlo FER harness: the capture step and the sweep.

Port of ``short_ldpc_decoding_osd_tpu/mc/harness.py``: ``build_nms_mc_step``
(:144-292), ``FailureBatch`` (:95-116), ``trajectories_for_llrs``
(:298-341), ``detected_failure_mask`` (:344-357), ``run_nms_mc`` (:360-592),
``_write_resume`` (:595-608) and the failure set's
per-iteration ``iteration_ce_list``/``iteration_ber_list`` (:611-625).
The step is factored into :func:`sample_batch` (channel) and
:func:`count_and_capture` (counters + the failures-first compaction), so
the second half can be held against JAX on identical arrays.

Capture keeps detected failures (nonzero syndrome) first, IN FRAME ORDER:
the stable ``argsort(~flag)[:capacity]`` of ``harness.py:275-276``.  Rows
past ``count`` are padding (non-failures); failures beyond the capacity are
overflow, which the caller counts (``bench.py:389-397``).

The JAX harness triages fused-kernel errors and demotes to a slower rung
(``_attempt_fused``/``_kernel_error_kind``, ``harness.py:42-92``, and the
ladder's block halving and dense/XLA rungs, ``mc/ladder.py:127-151``).  The
port does not: a kernel that fails to build or launch fails the run, and a
caller reaches another rung or decoder by naming it (``run_nms_mc(rung=)``,
``build_nms_mc_step(decoder=)``); a pinned rung or decoder that cannot take
the code or variant raises.  What the ladder holds as semantics is kept: a
compact step that overflowed is redone one-shot, and the sweep stays
one-shot.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from .._device import resolve_device
from ..channel.awgn import ChannelSpec, sample_batch
from ..codes import Code, tables
from ..ops import mc_dense, nms, nms_dense, nms_edge, nms_edge_padded
from ..utils import profiling
from ..utils.metrics import DecodeStats
from . import ladder

# the decoders of the capture step, JAX's four branches
# (``harness.py:232-256``): edge kernel K1, dense kernel K6, the padded
# edge layout (JAX's edge-layout XLA rung), the plain dense decoder
DECODERS = ("edge", "dense", "edge_padded", "plain")


def count_and_capture(llr: torch.Tensor, words: torch.Tensor,
                      soft_last: torch.Tensor, h, capture_capacity: int = 0):
    """Counters and failure capture for one decoded batch.

    Returns ``counters`` (5,) int64 = [frames, frame_errors, bit_errors,
    detected, undetected] and, when ``capture_capacity`` > 0, ``capture``
    with ``count`` (detected failures in the batch, 0-d), ``llr`` and
    ``labels`` (capacity, n): failures first in frame order."""
    st = nms.frame_stats(soft_last, words, h)
    counters = torch.stack([
        torch.tensor(llr.shape[0], dtype=torch.int64, device=llr.device),
        st["frame_error"].sum(),
        st["bit_errors"].to(torch.int64).sum(),
        st["detected_failure"].sum(),
        st["undetected_error"].sum(),
    ])
    if not capture_capacity:
        return counters, None
    flag = st["detected_failure"]
    order = torch.sort((~flag).to(torch.int8), stable=True).indices
    take = order[:capture_capacity]
    capture = {"count": flag.sum(), "llr": llr[take], "labels": words[take]}
    return counters, capture


def select_decoder(decode_h, variant: str, batch: int,
                   decoder: str | None = None,
                   device: str | torch.device = "cuda") -> str:
    """The capture step's decoder (one of :data:`DECODERS`) for steps of
    ``batch`` frames.

    ``decoder`` pins one and raises when it cannot take the code or the
    variant.  Otherwise a scalar variant takes K1 when it holds the code,
    else K6; NMS-r takes its edge kernel on CUDA where
    ``nms_edge.kernel_holds`` says so (on the CPU the dense decoder stays
    its default); then the padded edge layout where
    ``nms_edge_padded.auto_select`` says so; else the plain dense decoder."""
    edge_ok = nms_edge.kernel_holds(decode_h, variant)
    dense_ok = variant != "NMS-r" and nms_dense.holds(*np.shape(decode_h))
    if decoder is not None:
        ok = {"edge": edge_ok, "dense": dense_ok,
              "edge_padded": nms_edge_padded.supports(decode_h, variant),
              "plain": True}
        if decoder not in ok:
            raise ValueError(f"unknown decoder {decoder!r}; expected "
                             + "|".join(DECODERS))
        if not ok[decoder]:
            raise ValueError(f"decoder {decoder!r} cannot take {variant} on an "
                             f"{tuple(np.shape(decode_h))} parity matrix")
        return decoder
    if edge_ok and (variant != "NMS-r" or torch.device(device).type == "cuda"):
        return "edge"
    if dense_ok:
        return "dense"
    if nms_edge_padded.auto_select(decode_h, variant, device, batch):
        return "edge_padded"
    return "plain"


def build_nms_mc_step(code: Code, variant: str, num_iterations: int,
                      spec: ChannelSpec, batch: int,
                      capture_capacity: int = 0, all_zeros: bool = False,
                      decoder: str | None = None,
                      device: str | torch.device = "cuda"):
    """Build ``step(params, generator) -> (counters, capture)``.

    The decode is :func:`select_decoder`'s: by default the edge kernel
    (``nms_edge.decode_final_edge``: K1 for the scalar variants, NMS-r's
    own on CUDA where it holds the code); else, for NMS-r, the padded edge
    layout on CUDA from ``nms_edge_padded.NMS_R_MIN_BATCH`` frames up or
    the dense ``nms.decode_final``; ``decoder`` pins one of
    :data:`DECODERS`.
    ``generator`` is a ``torch.Generator`` on ``device``; the step's
    ``decoder`` attribute names the branch it runs.  The step is span
    ``capture``, its stages ``capture.sample``, ``capture.decode`` and
    ``capture.compact`` (``utils.profiling``)."""
    dev = resolve_device(device)
    decode_h = code.extended().h if variant == "ENMS" else code.h
    chosen = select_decoder(decode_h, variant, batch, decoder, dev)
    gen_matrix = tables.f32(code.g, dev)
    decode = decode_final_fn(chosen, decode_h, variant, num_iterations, dev)

    def step(params: dict, generator: torch.Generator):
        with profiling.span("capture"):
            with profiling.span("capture.sample"):
                llr, words = sample_batch(generator, spec, gen_matrix, batch,
                                          all_zeros=all_zeros)
            with profiling.span("capture.decode"):
                soft_last = decode(params, llr)
            with profiling.span("capture.compact"):
                return count_and_capture(llr, words, soft_last, decode_h,
                                         capture_capacity)

    step.decoder = chosen
    return step


def decode_final_fn(chosen: str, decode_h, variant: str, num_iterations: int,
                    device: torch.device):
    """``decode(params, llr) -> soft_last`` on the decoder ``chosen`` (one
    of :data:`DECODERS`, as :func:`select_decoder` returns)."""
    if chosen == "edge":
        return lambda params, llr: nms_edge.decode_final_edge(
            params, decode_h, llr, num_iterations, variant)
    if chosen == "dense":
        h_dev = tables.f32(decode_h, device)
        return lambda params, llr: nms_dense.decode_final_dense(
            params, h_dev, llr, num_iterations, variant)
    if chosen == "edge_padded":
        return lambda params, llr: nms_edge_padded.decode_final_edge_padded(
            params, decode_h, llr, num_iterations, variant)
    edge_cols = nms.edge_columns(decode_h) if variant == "NMS-r" else None
    return lambda params, llr: nms.decode_final(params, decode_h, llr,
                                                num_iterations, variant,
                                                edge_cols)


@dataclasses.dataclass
class FailureBatch:
    """Host-side copy of captured decoder failures (detected, syndrome != 0)."""

    trajectories: np.ndarray  # (count, T+1, n) per-iteration soft outputs
    labels: np.ndarray  # (count, n) transmitted codewords
    overflow: int  # failures that did not fit the capture buffer
    # flagged frames that the trajectory re-decode (the dense decoder) does
    # not confirm as detected failures: dropped from the batch, counted here
    mismatches: int = 0
    # False in raw-capture mode (run_nms_mc(capture_trajectories=False)):
    # trajectories then hold only the (count, 1, n) channel LLR rows and the
    # confirming re-decode was skipped
    confirmed: bool = True


def trajectories_for_llrs(code: Code, params: dict, variant: str,
                          num_iterations: int, llrs: np.ndarray,
                          chunk: int = 4096,
                          device: str | torch.device = "cuda") -> np.ndarray:
    """Re-decode captured failure LLRs with the dense decoder
    (``ops/nms.decode``), returning (N, T+1, n) per-iteration soft outputs;
    ``chunk`` rows at a time.  JAX zero-pads the last chunk to a fixed
    compile shape; nothing is compiled here and each row decodes alone, so
    the last chunk keeps its own size."""
    dev = resolve_device(device)
    decode_h = code.extended().h if variant == "ENMS" else code.h
    n_total = len(llrs)
    if n_total == 0:
        return np.zeros((0, num_iterations + 1, code.n), np.float32)
    edge_cols = nms.edge_columns(decode_h) if variant == "NMS-r" else None
    params = {k: torch.as_tensor(v, device=dev) for k, v in params.items()}
    llrs = np.asarray(llrs, np.float32)
    parts = []
    for i in range(0, n_total, chunk):
        x = torch.as_tensor(llrs[i:i + chunk], device=dev)
        outs = nms.decode(params, decode_h, x, num_iterations, variant, edge_cols)
        parts.append(outs.permute(1, 0, 2).cpu().numpy())
    return np.concatenate(parts)


def detected_failure_mask(code: Code, variant: str,
                          trajectories: np.ndarray) -> np.ndarray:
    """Detected-failure flags from re-decoded trajectories: a nonzero
    syndrome of the final iteration's hard decision against the decoding H
    (extended for ENMS), ``nms.frame_stats``'s rule."""
    decode_h = np.asarray(code.extended().h if variant == "ENMS" else code.h,
                          np.int64)
    hard = (trajectories[:, -1] < 0).astype(np.int64)
    return (hard @ decode_h.T % 2).any(axis=1)


def run_nms_mc(code: Code, params: dict, variant: str, num_iterations: int,
               snr_db: float, batch: int = 1024, error_budget: int = 40_000,
               max_frames: int = 10**8, seed: int = 0,
               capture_failures: bool = False, capture_limit: int = 100_000,
               capture_trajectories: bool = True,
               spec: ChannelSpec | None = None, progress: bool = False,
               resume_path: str | None = None, rung: str | None = None,
               device: str | torch.device = "cuda", mesh=None
               ) -> tuple[DecodeStats, FailureBatch | None]:
    """Monte-Carlo FER sweep at one SNR point with error-budget early stop:
    steps of ``batch`` frames until the frame errors exceed
    ``error_budget`` or ``max_frames`` frames were decoded.

    * Fused branch (no capture, a scalar variant (ENMS on its extended
      matrix), the plain AWGN spec of ``snr_db``, ``batch % 32 == 0``):
      each step is kernel K3
      (``fused_counters_edge_compact``, ``DEFAULT_COMPACT_SCHEDULE``,
      t1 = 4, groups of ``ladder.ladder_blocks`` frames) with the step seed
      ``(seed * 100003 + step) & 0x7FFFFFFF``.  A step whose compaction
      overflowed is redone with K4 (``fused_counters_edge``, the same
      frames one-shot) and the sweep stays on K4.  On the CPU the same
      branch runs the kernels' plain twins.
    * Otherwise each step is ``build_nms_mc_step`` with its generator seeded
      ``seed * 1_000_003 + step``.
    * ``rung`` pins one rung of ``ladder.RUNGS`` where JAX would demote:
      ``"compact"`` as the default but raising when compaction does not
      apply; ``"oneshot"`` K4 every step; ``"dense"`` K7
      (``mc_dense.fused_counters``) every step, with the same step seeds;
      ``"xla"`` the plain step (``build_nms_mc_step(decoder="plain")``).  A
      fused rung raises outside the fused branch's conditions, and
      ``"dense"`` for a matrix K7 does not hold (ENMS's extended one): a
      pinned rung never falls back to another, and none decodes H in
      ENMS's place.
    * ``resume_path``: a json file persisting (step, counters); both
      branches derive their frames from the step index, so a resumed sweep
      decodes exactly the frames that would have followed.
    * ``capture_failures``: the detected failures' LLRs (at most
      ``capture_limit``), re-decoded by the dense decoder into a
      :class:`FailureBatch` of confirmed failures (or raw LLR rows when
      ``capture_trajectories`` is False).
    * ``mesh``: a ``parallel.Mesh``; frames split over its ranks and
      ``batch`` counts each rank's frames, on the mesh's device.  The fused
      branch, and ``rung="xla"``, run ``parallel.sharded_fused_mc_step``
      (K3 on every rank on ``device_seeds(seed, step, size)``; ``rung``
      "compact", "oneshot" or "xla"), every other branch
      ``parallel.sharded_nms_mc_step`` with the generator seeded as above.  The counters are summed over the ranks,
      so the early stop is the same on every rank; only rank 0 writes
      ``resume_path``.  Capture raises.  With a world of one the sweep
      equals the sweep without a mesh."""
    if mesh is not None:
        if capture_failures:
            raise ValueError("failure capture requires the single-device path")
        dev = mesh.device
    else:
        dev = resolve_device(device)
    rung = ladder.apply_pinned_rung(rung)
    spec = spec or ChannelSpec.awgn(snr_db, code.rate)
    capacity = min(batch, capture_limit) if capture_failures else 0
    # the kernel wrappers read the weights on the host; only NMS-r's padded
    # and dense decoders need the parameters on the device
    params = {k: torch.as_tensor(v).cpu() for k, v in params.items()}
    fused_ok = (
        not capture_failures
        and variant != "NMS-r"
        and spec == ChannelSpec.awgn(snr_db, code.rate)
        and batch % 32 == 0
    )
    t1 = 4
    cblock, compact_enabled = ladder.ladder_blocks(batch, num_iterations, t1)
    if rung in ("compact", "oneshot", "dense") and not fused_ok:
        raise ValueError(
            f"rung {rung!r} needs the fused branch (no capture, a scalar "
            "variant, plain AWGN, batch % 32 == 0)")
    if rung == "compact" and not compact_enabled:
        raise ValueError(f"rung 'compact' does not apply to batch {batch} "
                         f"with {num_iterations} iterations")
    if rung == "dense":
        mc_dense.check_holds(code, variant)
    if mesh is not None:
        step = _mesh_step(code, params, variant, num_iterations, snr_db, batch,
                          seed, spec, rung, fused_ok, mesh)
    elif fused_ok and rung != "xla":
        state = {"rung": rung or ("compact" if compact_enabled else "oneshot")}

        def _kseed(idx):
            return (seed * 100003 + idx) & 0x7FFFFFFF

        def step(idx):
            if state["rung"] == "dense":
                return mc_dense.fused_counters(
                    code, params, variant, num_iterations, snr_db, batch,
                    seed=_kseed(idx), device=dev).cpu().numpy(), None
            if state["rung"] == "compact":
                c = nms_edge.fused_counters_edge_compact(
                    code, params, variant, num_iterations, snr_db, batch,
                    seed=_kseed(idx), t1=t1, block_frames=cblock,
                    schedule=nms_edge.DEFAULT_COMPACT_SCHEDULE,
                    device=dev).cpu().numpy()
                if c[5] == 0:
                    return c[:5], None
                state["rung"] = "oneshot"  # overflow: redo one-shot, stay
            return nms_edge.fused_counters_edge(
                code, params, variant, num_iterations, snr_db, batch,
                seed=_kseed(idx), device=dev).cpu().numpy(), None
    else:
        built = build_nms_mc_step(code, variant, num_iterations, spec, batch,
                                  capture_capacity=capacity,
                                  decoder="plain" if rung == "xla" else None,
                                  device=dev)
        generator = torch.Generator(device=dev)
        step_params = ({k: v.to(dev) for k, v in params.items()}
                       if variant == "NMS-r" and built.decoder != "edge"
                       else params)

        def step(idx):
            generator.manual_seed(seed * 1_000_003 + idx)
            counters, capture = built(step_params, generator)
            return counters.cpu().numpy(), capture

    writes_resume = resume_path is not None and (mesh is None or mesh.rank == 0)
    stats = DecodeStats(bits_per_frame=code.n)
    llr_list: list[np.ndarray] = []
    label_list: list[np.ndarray] = []
    overflow = captured_total = step_idx = 0
    if resume_path is not None and os.path.exists(resume_path):
        with open(resume_path) as fh:
            saved = json.load(fh)
        if saved.get("seed") == seed and saved.get("snr_db") == snr_db:
            step_idx = saved["step_idx"]
            stats = DecodeStats(**saved["stats"])
    while stats.frames < max_frames and stats.frame_errors <= error_budget:
        c, capture = step(step_idx)
        step_idx += 1
        stats = stats.merge(DecodeStats(
            frames=int(c[0]), frame_errors=int(c[1]), bit_errors=int(c[2]),
            bits_per_frame=code.n, detected_failures=int(c[3]),
            undetected_errors=int(c[4])))
        if capture is not None:
            count = int(capture["count"])
            keep = min(count, capacity, max(0, capture_limit - captured_total))
            overflow += count - keep
            if keep:
                llr_list.append(capture["llr"][:keep].cpu().numpy())
                label_list.append(capture["labels"][:keep].cpu().numpy())
                captured_total += keep
        if progress:
            print(f"  snr={snr_db:.2f} frames={stats.frames} "
                  f"FER={stats.fer:.3e} failures={stats.detected_failures}",
                  flush=True)
        if writes_resume and step_idx % 50 == 0:
            _write_resume(resume_path, seed, snr_db, step_idx, stats)
    if writes_resume:
        _write_resume(resume_path, seed, snr_db, step_idx, stats)
    if not capture_failures:
        return stats, None
    if not llr_list:
        rows = num_iterations + 1 if capture_trajectories else 1
        return stats, FailureBatch(
            trajectories=np.zeros((0, rows, code.n), np.float32),
            labels=np.zeros((0, code.n), np.int32), overflow=overflow,
            confirmed=capture_trajectories)
    llrs, labels = np.concatenate(llr_list), np.concatenate(label_list)
    if not capture_trajectories:
        return stats, FailureBatch(trajectories=llrs[:, None, :], labels=labels,
                                   overflow=overflow, confirmed=False)
    traj = trajectories_for_llrs(code, params, variant, num_iterations, llrs,
                                 device=dev)
    # keep exactly the frames the dense re-decode confirms
    keep = detected_failure_mask(code, variant, traj)
    mismatches = int((~keep).sum())
    if mismatches:
        traj, labels = traj[keep], labels[keep]
    return stats, FailureBatch(trajectories=traj, labels=labels,
                               overflow=overflow, mismatches=mismatches)


def _mesh_step(code, params, variant, num_iterations, snr_db, batch, seed,
               spec, rung, fused_ok, mesh):
    """``run_nms_mc``'s step over a mesh: ``step(idx) -> (counters as
    numpy, None)``, the counters summed over the ranks."""
    from ..parallel import sharded_fused_mc_step, sharded_nms_mc_step

    def placed(decoder):
        # NMS-r's padded and dense decoders take the parameters on the
        # device; the kernel wrappers read them on the host
        if variant == "NMS-r" and decoder != "edge":
            return {k: v.to(mesh.device) for k, v in params.items()}
        return params

    if fused_ok or rung == "xla":
        fused = sharded_fused_mc_step(code, variant, num_iterations, snr_db,
                                      batch, mesh, base_seed=seed, spec=spec,
                                      rung=rung)
        # NMS-r reaches this branch only pinned to rung "xla": the plain decoder
        step_params = placed("plain")
        return lambda idx: (fused(step_params, idx)[0].cpu().numpy(), None)
    sharded = sharded_nms_mc_step(code, variant, num_iterations, spec, batch,
                                  mesh)
    step_params = placed(sharded.decoder)
    generator = torch.Generator(device=mesh.device)

    def step(idx):
        generator.manual_seed(seed * 1_000_003 + idx)
        return sharded(step_params, generator).cpu().numpy(), None

    return step


def _write_resume(path: str, seed: int, snr_db: float, step_idx: int,
                  stats: DecodeStats) -> None:
    with open(path, "wt") as fh:
        json.dump({"seed": seed, "snr_db": snr_db, "step_idx": step_idx,
                   "stats": dataclasses.asdict(stats)}, fh)


def iteration_ce_list(trajectories: np.ndarray, labels: np.ndarray) -> list[float]:
    """Per-iteration cross-entropy over a failure set, summed in f64 on the
    host (``ms_test.py:251-267``; JAX ``mc/harness.py:611-616``)."""
    logits = -trajectories.astype(np.float64)  # (N, T+1, n)
    z = labels[:, None, :].astype(np.float64)
    ce = np.maximum(logits, 0) - logits * z + np.log1p(np.exp(-np.abs(logits)))
    return [float(x) for x in ce.sum(axis=(0, 2))]


def iteration_ber_list(trajectories: np.ndarray, labels: np.ndarray) -> list[float]:
    """Per-iteration bit error rate over a failure set (the reference's BER
    bookkeeping beside the CE list, ``nn_testing.py:205-210``; JAX
    ``mc/harness.py:619-625``)."""
    hard = trajectories <= 0
    err = hard != (labels[:, None, :] > 0)
    denom = max(trajectories.shape[0] * trajectories.shape[2], 1)
    return [float(x) / denom for x in err.sum(axis=(0, 2))]
