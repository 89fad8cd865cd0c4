"""Batched OSD engine: reorder -> GF(2) elimination -> TEP walk -> stopper.

Port of ``short_ldpc_decoding_osd_tpu/osd/engine.py`` (reference
``DL_OSD_Testing_serial/ordered_statistics_decoding.py``):

* the permutation dance (stable |LLR| co-sort, GE column swaps, MRB re-sort)
  is ``ops.gf2ops``, bit-exact against the JAX package; on the card its GE
  is the bit-packed route, the CUDA kernel ``csrc/gf2_ge.cu``;
* candidate re-encoding and the weighted-Hamming discrepancy fold into the
  affine map ``c0 + u_l @ mod2(M @ T^T) + u_m @ T^T`` (``x ^ y = x + y -
  2xy``); over a path's TEPs (``segments.TepLayout``, built once at
  set-up) the CUDA kernel K5 computes it and reduces it to the block minima
  (``ops.osd_disc.block_minima``), elsewhere K5 gives its parity term
  (``ops.osd_disc.lterm``);
* the sliding-window stopper walk is replayed for all frames at once.

The JAX package demotes to a slower path when a fused kernel fails to
compile (``make_dl_osd_step*``); the port does not: a kernel that fails to
build or launch fails the run.
"""

from __future__ import annotations

import dataclasses

import torch

from .._device import full_f32
from ..ops import gf2ops, nms, nms_edge, nms_edge_padded, osd_disc
from ..ops.nms import first_argmin, first_index
from ..utils import profiling
from .segments import TepLayout

_BIG = osd_disc.BIG  # f32-representable "no candidate" discrepancy


@dataclasses.dataclass(frozen=True)
class PreparedBatch:
    """Per-frame quantities in the final (reliability + GE) column order."""

    order_updated: torch.Tensor  # (B, n) DIA-refined / last-iteration inputs
    order_original: torch.Tensor  # (B, n) channel-iteration inputs
    order_labels: torch.Tensor  # (B, n) int8 transmitted bits
    m_matrix: torch.Tensor  # (B, m, k) int8
    swap_len: torch.Tensor  # (B,)
    lrb_ranks: torch.Tensor  # (B, n-k)
    hard_original: torch.Tensor  # (B, n) 0/1 from the original channel
    hard_updated: torch.Tensor  # (B, n) 0/1 from the updated metric
    mag_original: torch.Tensor  # (B, n) |original|
    truth_discrepancy: torch.Tensor  # (B,) weighted dist of label vs hard_original


def prepare(updated: torch.Tensor, original: torch.Tensor,
            labels: torch.Tensor, h, k: int) -> PreparedBatch:
    """Sort by |updated| ascending, run GE, apply the final index order
    (``check_matrix_reorder`` + ``identify_mrb`` + the gathers of
    ``sliding_osd``, ``ordered_statistics_decoding.py:169-185``).

    The GE takes ``gf2ops.identify_mrb_from_perm``'s default route: the
    GE kernel (packed, from ``perm`` and the static ``h``) on the card,
    the dense plain route on the CPU; both give the same answer on a
    full-row-rank ``h`` such as every code's ``h_osd``.

    The sort must be STABLE and carry ``updated``, ``original`` and
    ``labels`` in exactly its order (``engine.py:67-74`` uses ``lax.sort``
    with an iota tiebreak): equal |updated| values do occur, and an unstable
    CUDA sort would reorder them and change the MRB."""
    perm = torch.sort(updated.abs(), dim=1, stable=True).indices
    u_s = torch.gather(updated, 1, perm)
    o_s = torch.gather(original, 1, perm)
    l_s = torch.gather(labels.to(torch.int8), 1, perm)
    mrb = gf2ops.identify_mrb_from_perm(perm, h, k)
    io = mrb["index_order"]
    order_updated = torch.gather(u_s, 1, io)
    order_original = torch.gather(o_s, 1, io)
    order_labels = torch.gather(l_s, 1, io)
    hard_original = (order_original <= 0).to(torch.int8)
    hard_updated = (order_updated <= 0).to(torch.int8)
    mag_original = order_original.abs()
    truth = ((order_labels ^ hard_original).to(torch.float32)
             * mag_original).sum(1)
    return PreparedBatch(
        order_updated=order_updated,
        order_original=order_original,
        order_labels=order_labels,
        m_matrix=mrb["m_matrix"],
        swap_len=mrb["swap_len"],
        lrb_ranks=mrb["lrb_ranks"],
        hard_original=hard_original,
        hard_updated=hard_updated,
        mag_original=mag_original,
        truth_discrepancy=truth,
    )


def _discrepancy_terms(prep: PreparedBatch, k: int):
    """(c0, u_l, u_m, base_mrb) of the affine TEP-discrepancy map."""
    n = prep.hard_original.shape[1]
    m = n - k
    h_l = prep.hard_original[:, :m].to(torch.float32)
    h_m = prep.hard_original[:, m:].to(torch.float32)
    w_l = prep.mag_original[:, :m]
    w_m = prep.mag_original[:, m:]
    base_mrb = prep.hard_updated[:, m:].to(torch.float32)  # (B, k)
    # v = M @ base_mrb (the base LRB estimate), e = v ^ h_l
    v = gf2ops.mod2_matmul(prep.m_matrix, base_mrb[..., None])[..., 0]
    v = v.to(torch.float32)
    e = v + h_l - 2.0 * v * h_l
    f = base_mrb + h_m - 2.0 * base_mrb * h_m
    c0 = (w_l * e).sum(1) + (w_m * f).sum(1)
    u_l = w_l * (1.0 - 2.0 * e)
    u_m = w_m * (1.0 - 2.0 * f)
    return c0, u_l, u_m, base_mrb


@full_f32()
def _tep_discrepancies(prep: PreparedBatch, t_flat: torch.Tensor,
                       k: int) -> torch.Tensor:
    """(B, N) weighted discrepancies ``c0 + u_l @ mod2(M @ T^T) + u_m @ T^T``
    of every TEP row of ``t_flat`` (N, k) int8; the ``u_l``-weighted parity
    term is kernel K5 on CUDA, the rest IEEE f32."""
    with profiling.span("minima.terms"):
        c0, u_l, u_m, _ = _discrepancy_terms(prep, k)
    with profiling.span("minima.k5"):
        lterm = osd_disc.lterm(prep.m_matrix.contiguous(), u_l.contiguous(),
                               t_flat)
    return c0[:, None] + lterm + u_m @ t_flat.T.to(torch.float32)


def _selected_is_label(prep: PreparedBatch, tep_sel: torch.Tensor,
                       k: int) -> torch.Tensor:
    """(B,) strict success: the codeword of each frame's selected TEP (B, k)
    -- MRB ``base xor t``, LRB ``mod2(M @ (base xor t))`` -- equals the
    transmitted word in the final column order."""
    base_mrb = prep.hard_updated[:, -k:].to(torch.float32)
    mrb_c = (base_mrb - tep_sel.to(torch.float32)).abs()
    prods = torch.einsum("bmk,bk->bm", prep.m_matrix.to(torch.float32), mrb_c)
    lrb_c = prods - 2.0 * torch.floor(prods * 0.5)
    cand = torch.cat([lrb_c, mrb_c], 1)
    return (cand == prep.order_labels.to(torch.float32)).all(1)


@full_f32()
def block_discrepancy_minima(prep: PreparedBatch, layout: TepLayout, k: int):
    """Per-block minima (B, P) of the weighted discrepancy over ``layout``'s
    TEPs and the index of the minimizing TEP inside each block (B, P), the
    first on ties; an empty block gives (``_BIG``, 0).

    The minima come out of kernel K5 whole (``osd_disc.block_minima``, no
    (B, N) map; its plain twin on the CPU), its stages spans
    ``minima.terms`` (the affine map's terms) and ``minima.k5`` (the
    launch)."""
    with profiling.span("minima.terms"):
        c0, u_l, u_m, _ = _discrepancy_terms(prep, k)
    with profiling.span("minima.k5"):
        return osd_disc.block_minima(
            prep.m_matrix.contiguous(), u_l.contiguous(), c0.contiguous(),
            u_m.contiguous(), layout.flat, layout.positions, layout.block_of,
            layout.starts, layout.ntot)


@full_f32()
def stopper_apply(fcn_params: dict, x: torch.Tensor) -> torch.Tensor:
    """Sliding-window stopper FCN: Dense(w+1, linear) -> Dense(2, softmax),
    no biases, full f32 (``nn_net.py:136-148``)."""
    hidden = x @ fcn_params["w1"]
    return torch.softmax(hidden @ fcn_params["w2"], dim=-1)


def _check_walk_shape(num_blocks: int, window: int) -> int:
    steps = num_blocks - window + 1
    if steps < 1:
        raise ValueError(
            f"decoding path has {num_blocks} blocks < window {window}; "
            "shorten the window or lengthen the path"
        )
    return steps


def sliding_walk(block_minima: torch.Tensor, fcn_params: dict,
                 window: int = 5, soft_margin: float = 0.9) -> dict:
    """Replay the serial sliding-window walk (``sliding_osd``'s loop,
    ``:191-219``) for every frame at once.

    The window at step kk is ``blocks[kk:kk+window]`` and the running global
    minimum is a prefix minimum, so: one batched FCN over all windows, a
    cummin for the skip rule (kk > 0 and the new block's minimum exceeds the
    global minimum), and first-true reductions.  Equal to the step-by-step
    replay :func:`_sliding_walk_scan`.  Returns per frame ``stop_k``,
    ``deep_limit`` (blocks expanded), ``global_min``, ``windows_evaluated``
    and ``window_num``."""
    batch, num_blocks = block_minima.shape
    steps = _check_walk_shape(num_blocks, window)
    dev = block_minima.device
    idx = (torch.arange(steps, device=dev)[:, None]
           + torch.arange(window, device=dev)[None, :])
    sorted_wins = torch.sort(block_minima[:, idx], dim=2).values
    kks = torch.arange(steps, dtype=torch.float32, device=dev)
    feats = torch.cat(
        [sorted_wins, kks[None, :, None].expand(batch, steps, 1)], 2)
    probs = stopper_apply(fcn_params, feats.reshape(batch * steps, window + 1))
    fire = probs[:, 1].reshape(batch, steps) > soft_margin

    cmin = torch.cummin(block_minima, 1).values  # prefix minima
    # skip(kk>0) = blocks[window-1+kk] > cmin[window+kk-2]
    skip_tail = block_minima[:, window:] > cmin[:, window - 1:-1]
    skip = torch.cat(
        [torch.zeros((batch, 1), dtype=torch.bool, device=dev), skip_tail], 1)
    cand = ~skip & fire
    stop_k = torch.where(cand.any(1), first_index(cand, 1), steps - 1)
    deep_limit = stop_k + window
    evals = torch.gather(torch.cumsum((~skip).to(torch.int64), 1), 1,
                         stop_k[:, None])[:, 0]
    gmin = torch.gather(cmin, 1, (deep_limit - 1)[:, None])[:, 0]
    return {
        "stop_k": stop_k,
        "deep_limit": deep_limit,
        "global_min": gmin,
        "windows_evaluated": evals,
        "window_num": stop_k + 1,
    }


def _sliding_walk_scan(block_minima: torch.Tensor, fcn_params: dict,
                       window: int = 5, soft_margin: float = 0.9) -> dict:
    """Step-by-step replay of the serial walk (the test oracle for
    :func:`sliding_walk`)."""
    batch, num_blocks = block_minima.shape
    steps = _check_walk_shape(num_blocks, window)
    dev = block_minima.device
    win = block_minima[:, :window]
    gmin = win.amin(1)
    stopped = torch.zeros(batch, dtype=torch.bool, device=dev)
    stop_k = torch.full((batch,), -1, dtype=torch.int64, device=dev)
    evals = torch.zeros(batch, dtype=torch.int64, device=dev)
    advanced = torch.zeros(batch, dtype=torch.int64, device=dev)
    for kk in range(steps):
        new_block = block_minima[:, window - 1 + kk]
        win_cur = win if kk == 0 else torch.cat(
            [win[:, 1:], new_block[:, None]], 1)
        skip = (new_block > gmin) if kk > 0 else torch.zeros_like(stopped)
        feats = torch.cat(
            [torch.sort(win_cur, 1).values,
             torch.full((batch, 1), float(kk), device=dev)], 1)
        fire = stopper_apply(fcn_params, feats)[:, 1] > soft_margin
        evaluate = ~stopped & ~skip
        gmin = torch.where(evaluate, torch.minimum(gmin, win_cur.amin(1)), gmin)
        newly = evaluate & fire
        stop_k = torch.where(newly & (stop_k < 0), kk, stop_k)
        advance = ~stopped  # the serial deep_limit advances on skipped steps
        evals = evals + evaluate.to(torch.int64)
        advanced = advanced + advance.to(torch.int64)
        stopped = stopped | newly
        win = torch.where(advance[:, None], win_cur, win)
    stop_k = torch.where(stop_k >= 0, stop_k, advanced - 1)
    return {
        "stop_k": stop_k,
        "deep_limit": stop_k + window,
        "global_min": gmin,
        "windows_evaluated": evals,
        "window_num": stop_k + 1,
    }


@full_f32()
def _prune_keep(prep: PreparedBatch, t_flat: torch.Tensor, threshold_sum: int):
    """``pruned_batch_osd``'s candidate mask (B, N) and the frames (B,) that
    fell back to the first 4 TEPs.

    The divergence of each TEP's estimated LRB from the *updated* hard
    LRB, ``e0 = mod2(M @ base) xor hard_updated[:, :m]``, counted on the
    focus slots ``lrb_ranks >= m - 4 * threshold_sum``, is ``sum(focus *
    e0) + sum_m focus * (1 - 2 e0) * mod2(M @ t)``: the second sum is K5
    with that weight in place of ``u_l``.  It is an integer, exact in f32
    and f64 alike, so ``keep = div <= 2 * threshold_sum`` is bit for bit
    JAX's.  The reference keeps the first 4 TEPs where fewer than 2
    survive (JAX ``osd/engine.py:464-467``)."""
    m = prep.m_matrix.shape[1]
    m_mat = prep.m_matrix.contiguous()
    focus = (prep.lrb_ranks >= m - 4 * threshold_sum).to(torch.float32)
    init_lrb = prep.hard_updated[:, :m].to(torch.float32)
    base_mrb = prep.hard_updated[:, m:].to(torch.float32)
    v = gf2ops.mod2_matmul(m_mat, base_mrb[..., None])[..., 0].to(torch.float32)
    e0 = v + init_lrb - 2.0 * v * init_lrb
    div = ((focus * e0).sum(1)[:, None]
           + osd_disc.lterm(m_mat, (focus * (1.0 - 2.0 * e0)).contiguous(),
                            t_flat))
    keep = div <= 2.0 * threshold_sum
    too_few = keep.sum(1) < 2
    first4 = torch.arange(t_flat.shape[0], device=keep.device) < 4
    return torch.where(too_few[:, None], first4[None, :], keep), too_few


def pruned_batch_osd(prep: PreparedBatch, teps_all: torch.Tensor, k: int,
                     threshold_sum: int = 3, prune: bool = True) -> dict:
    """Batch OSD over every TEP of ``teps_all`` (N, k) at once, with the
    reference's LRB-divergence pruning (JAX ``osd/engine.py:421-488``,
    reference ``execute_osd`` + ``best_estimating``,
    ``ordered_statistics_decoding.py:259-308,121-139``).

    The discrepancies are :func:`_tep_discrepancies` (K5 for the
    ``u_l`` term); with ``prune``, TEPs outside :func:`_prune_keep` take
    ``_BIG`` (a second K5 launch).  The argmin takes the first index on
    ties.  ``success`` is strict: the argmin candidate equals the
    transmitted word.  No (B, m, N) tensor is built on the card.  Returns
    ``success``, ``best_index``, ``num_candidates`` and
    ``min_discrepancy``."""
    t_flat = teps_all.to(torch.int8).contiguous()
    disc = _tep_discrepancies(prep, t_flat, k)
    batch, ntot = disc.shape
    if prune:
        keep, _ = _prune_keep(prep, t_flat, threshold_sum)
        disc = torch.where(keep, disc, _BIG)
        num_candidates = keep.sum(1)
    else:
        num_candidates = torch.full((batch,), ntot, dtype=torch.int64,
                                    device=disc.device)
    best = first_argmin(disc, 1)
    return {
        "success": _selected_is_label(prep, t_flat[best], k),
        "best_index": best,
        "num_candidates": num_candidates,
        "min_discrepancy": disc.amin(1),
    }


def sliding_osd(prep: PreparedBatch, layout: TepLayout, fcn_params: dict,
                k: int, window: int = 5, soft_margin: float = 0.9,
                rel_tol: float = 1e-3) -> dict:
    """Batched DL-OSD evaluation of one failure batch over ``layout``'s
    TEPs.

    ``success`` is the reference's oracle proxy ``global_min ==
    truth_discrepancy`` with a relative tolerance (the two sums are
    different but mathematically equal reductions); ``strict_success``
    checks that the argmin candidate within the expanded blocks equals the
    transmitted codeword.  Also returns the TEP complexity, window counts,
    the walk's global minimum and expanded depth, and the block minima.
    Its stages are spans ``minima``, ``walk`` and ``select`` (the chosen
    TEP and its codeword)."""
    with profiling.span("minima"):
        minima, argmins = block_discrepancy_minima(prep, layout, k)
    with profiling.span("walk"):
        walk = sliding_walk(minima, fcn_params, window=window,
                            soft_margin=soft_margin)
    dev = minima.device
    complexity = layout.acc[walk["deep_limit"]]
    scale = torch.clamp(prep.truth_discrepancy, min=1.0)
    success = (walk["global_min"] - prep.truth_discrepancy).abs() <= rel_tol * scale

    num_blocks = minima.shape[1]
    with profiling.span("select"):
        in_walk = (torch.arange(num_blocks, device=dev)[None, :]
                   < walk["deep_limit"][:, None])
        best_block = first_argmin(torch.where(in_walk, minima, _BIG), 1)
        best_inner = torch.gather(argmins, 1, best_block[:, None])[:, 0]
        tep_sel = layout.flat[layout.starts[best_block] + best_inner]
        strict = _selected_is_label(prep, tep_sel, k)
    return {
        "success": success,
        "strict_success": strict,
        "complexity": complexity,
        "window_num": walk["window_num"],
        "windows_evaluated": walk["windows_evaluated"],
        "global_min": walk["global_min"],
        "deep_limit": walk["deep_limit"],
        "block_minima": minima,
    }


def redecode_route(decode_h, variant: str, device, batch: int) -> str:
    """The phase-2 trajectory re-decode's route for ``batch`` rows: a scalar
    variant takes ``"edge"`` (kernel K2 on CUDA); NMS-r takes ``"edge"``
    too on CUDA where its kernel holds the code
    (``nms_edge.kernel_holds``), else the padded edge layout
    (``"edge_padded"``) where ``nms_edge_padded.auto_select`` says so (CUDA,
    a regular check degree, ``NMS_R_MIN_BATCH`` rows or more), else the
    dense ``nms.decode`` (``"dense"``), as JAX's ``"auto"`` takes its
    edge-layout rung for NMS-r
    (``short_ldpc_decoding_osd_tpu/osd/engine.py:653-671``)."""
    if variant != "NMS-r":
        return "edge"
    if (torch.device(device).type == "cuda"
            and nms_edge.kernel_holds(decode_h, variant)):
        return "edge"
    if nms_edge_padded.auto_select(decode_h, variant, device, batch):
        return "edge_padded"
    return "dense"


def redecode_trajectory(nms_params, decode_h, llr: torch.Tensor,
                        num_iterations: int, variant: str, route: str,
                        edge_cols=None) -> torch.Tensor:
    """(T+1, B, n) trajectory of the phase-2 re-decode on ``route`` (one of
    :func:`redecode_route`'s); ``edge_cols`` is ``nms.edge_columns`` of
    ``decode_h`` for NMS-r on the dense route (computed when None)."""
    if route == "edge":
        return nms_edge.decode_traj_edge(nms_params, decode_h, llr,
                                         num_iterations, variant)
    if route == "edge_padded":
        return nms_edge_padded.decode_edge_padded(nms_params, decode_h, llr,
                                                  num_iterations, variant)
    if route == "dense":
        if edge_cols is None and variant == "NMS-r":
            edge_cols = nms.edge_columns(decode_h)
        return nms.decode(nms_params, decode_h, llr, num_iterations, variant,
                          edge_cols)
    raise ValueError(f"unknown re-decode route {route!r}")


def make_dl_osd_step(model, h, k: int, layout: TepLayout, window: int = 5,
                     soft_margin: float = 0.9):
    """DIA-OSD evaluation of captured trajectories: ``model.refine_fast``
    -> :func:`prepare` (the channel slot 0 as the original metric) ->
    :func:`sliding_osd` over ``layout`` (JAX ``osd/engine.py:558-607``,
    the trajectory form).

    Returns ``step(traj, labels, fcn_params) -> (outputs, refined)``;
    ``model`` carries its own weights."""

    def step(traj, labels, fcn_params):
        refined = model.refine_fast(traj)
        prep = prepare(refined, traj[:, 0], labels, h, k)
        out = sliding_osd(prep, layout, fcn_params, k, window=window,
                          soft_margin=soft_margin)
        return out, refined

    return step


def iteration_stat_rows(traj: torch.Tensor, refined: torch.Tensor,
                        labels: torch.Tensor):
    """Per-row CE and bit-error counts (B, T+2) over the T+1 trajectory
    slots and the DIA-refined slot (last), in f32 on the device (JAX
    ``osd/engine.py:708-726``; the reference's 'CE list'/'BER list',
    ``ms_test.py:251-267``, ``nn_testing.py:205-210``)."""
    stacked = torch.cat([traj, refined[:, None, :]], 1)
    logits = -stacked
    z = labels.to(torch.float32)[:, None, :]
    ce_rows = (torch.clamp(logits, min=0.0) - logits * z
               + torch.log1p(torch.exp(-logits.abs()))).sum(2)
    ber_rows = ((stacked <= 0) != (z > 0)).to(torch.float32).sum(2)
    return ce_rows, ber_rows


def make_dl_osd_step_from_llr(model, code, variant: str, num_iterations: int,
                              layout: TepLayout, window: int = 5,
                              soft_margin: float = 0.9,
                              with_iteration_stats: bool = False,
                              route: str | None = None):
    """Phase-2 step consuming RAW failure LLRs: the (T+1)-slot trajectory
    re-decode, DIA refinement (``model.refine_fast``), OSD preparation and
    the sliding walk over ``layout``.

    Returns ``step(nms_params, llr, labels, fcn_params) -> (outputs,
    refined, detected)``; ``detected`` is the re-decode's
    detected-failure flag (``nms.frame_stats``), so rows the capture flagged
    but the re-decode does not confirm can be excluded by the caller.
    ``model`` carries its own weights (an ``nn.Module``).  With
    ``with_iteration_stats`` the step also returns
    :func:`iteration_stat_rows`' ``(ce_rows, ber_rows)`` as a fourth item.

    The re-decode is :func:`redecode_trajectory` on the route of
    :func:`redecode_route` for the step's rows, or on ``route`` when the
    caller pins one (the mesh pins the route of the global batch).

    The step is span ``phase2``, its stages ``redecode``, ``detect``,
    ``dia``, ``prepare`` and ``osd`` (:func:`sliding_osd`)."""
    decode_h = code.extended().h if variant == "ENMS" else code.h
    edge_cols = nms.edge_columns(decode_h) if variant == "NMS-r" else None
    k = code.k
    h_osd = code.h_osd

    def step(nms_params, llr, labels, fcn_params):
        with profiling.span("phase2"):
            with profiling.span("redecode"):
                outs = redecode_trajectory(
                    nms_params, decode_h, llr, num_iterations, variant,
                    route or redecode_route(decode_h, variant, llr.device,
                                            llr.shape[0]),
                    edge_cols)
            traj = outs.permute(1, 0, 2)  # (B, T+1, n)
            with profiling.span("detect"):
                st = nms.frame_stats(traj[:, -1], labels, decode_h)
            with profiling.span("dia"):
                refined = model.refine_fast(traj)
            with profiling.span("prepare"):
                prep = prepare(refined, llr, labels, h_osd, k)
            with profiling.span("osd"):
                out = sliding_osd(prep, layout, fcn_params, k, window=window,
                                  soft_margin=soft_margin)
            if not with_iteration_stats:
                return out, refined, st["detected_failure"]
            return (out, refined, st["detected_failure"],
                    iteration_stat_rows(traj, refined, labels))

    return step
