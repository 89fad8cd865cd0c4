"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (each raises on failure, so the script never exits 0 after one):

1. the card's name and power limit, the torch/CUDA versions, and the build
   of every kernel under ``short_ldpc_decoding_osd_tpu_torch/csrc/``;
2. every kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it (and a small irregular / odd shape), with
   CUDA-event times of kernel, plain version and, where one PyTorch call
   computes the same function, that call; K5 also at the (m, k) of
   qc_96_48, wimaxlike_384_192 and wimax_1056_880 (synthetic inputs), against
   an f64 evaluation, with its ptxas lines, the count of IMMA instructions
   in its SASS, its launch shapes, and the main path's block minima and
   walk from K5 against those from its plain twin; NMS-r's edge kernels at
   the main path's shapes (final output of the 262,144-frame sample,
   trajectory of its 32,768 captured rows) bit for bit against their twin
   and the benchmark's plain reference, against the padded edge layout,
   timed beside both; NMS-r's phase-2 re-decode at 4,096 captured rows on
   its kernel against the padded edge layout and the dense decoder; the GE
   kernel (bit-packed GF(2) elimination) against its
   plain packed twin and the dense route bit for bit on the main path's
   32,768 captured rows (its perm load), on the same rows with columns
   duplicated across word edges (its dense load), on qc_96_48,
   wimaxlike_384_192 and wimax_1056_880 under random permutations, and
   against the twin alone on rank-deficient input in each of its modes
   (the array codes' raw H; WiMAX's h_osd with six rows duplicated, dense
   load), its launch shapes (ptxas registers and spills, resident frames
   per SM), every shape timed through its wrapper and back to back against
   its bound (the main path also through the dense load, wimax_1056_880
   also at 8,192 frames), and the wrapper's host work split by part;
   the fused Monte-Carlo kernels
   K3, K4, K8a and K8b are compared at 262,144 frames (K3 also with a
   capacity that overflows, and with two stages; the messages its first
   stage saves for resuming against the twin's) and timed at 2,097,152,
   K4 also at T = 0 (sampling, encode and counting alone); one line per
   launch shape of the MC kernel (registers, spills, shared bytes, frames a
   block, resident blocks per SM, G's encode tables in shared memory or
   not); K4 and K3 against their twins on qc_96_48 and wimax_1056_880, so
   that every degree bucket of the iteration body runs, and the encode's
   counters of those K3 runs (``mc.columns_as_bit``,
   ``mc.columns_encoded``: G's unit columns and the others, a launch); K4's
   split on wimax_1056_880 at 262,144 frames and 4.0 dB; then
   (``phase_enms_wimax``) K4 and K3 on the extended matrix ENMS decodes
   wimax_1056_880 on (220 x 1,056, the split bucket 4: 264 segment lanes)
   at 4.0 dB: their launch shapes, both equal to their twins counter for
   counter, ``enms.frames`` and ``split.frames`` a launch, K3 on H in
   ENMS's place beside it, both timed at 262,144; and K1, K6 and K7 at
   the split bucket on a synthetic mask (rows of degree 21 to 40 beside
   rows of 8 to 20) against their twins, so that the dense rung's lane
   map built on the card runs;
3. the two-phase main path at full width: 8 rounds of the 262,144-frame
   capture step plus phase 2 (capture 32,768) at 3.0 dB with the
   ``runs/r4_pipeline`` artifacts, with every launch count reset just
   before and read just after; its NMS FER and OSD success share must agree
   statistically with the JAX package's record (``BENCH_r05.json``), and
   the card's results must equal the port's CPU results on the committed
   failure set (the card's GE is the kernel, the CPU's the dense route),
   and ``osd/path.py``'s MRB error patterns and pattern counter on the card
   equal the CPU's on that set and on 2,048 captured rows;
4. the phase-1 path as ``bench.py`` drives it (``system.Phase1``): 8 steps
   of 2,097,152 frames with K3 (schedule ((4, 0.375),), groups of 1024),
   then 8 with K4, counts reset after the warm-up step and required to be
   exactly 8 launches of the path's kernel; the FER of each must agree with
   the JAX record's ``sample_fer``;
5. a ``run_nms_mc`` sweep at 3.0 dB (error budget 40,000, 262,144 frames a
   step) through K3, with the same FER check;
6. one ``cascade_counters`` call (K8a + K8b) at 2,097,152 frames;
7. one two-phase round and one phase-1 step under ``torch.profiler``: the
   device's busy share and the kernels that take the most device time;
8. the dense rung: K6 against its plain twin bit for bit at 262,144 frames
   (and on ``array_121_60``), K7 against its twin at 262,144 frames
   (counters equal) and against K4 on the same seed at 2,097,152 frames
   (within 4 frame errors), both timed; the capture step pinned to K6
   against the default K1 step (counters, capture count and buffers
   identical; K6's launches counted here); ``run_nms_mc(rung="dense")`` to
   40,000 errors (only K7 launches; FER against the JAX record);
9. the padded edge layout against the plain dense step on the same
   generator (within 4 frame errors, equal frame counts), both timed:
   ``wimax_1056_880`` at 3.75 dB (4,096 frames) and NMS-r on CCSDS at
   3.0 dB (1,024, 2,048, 4,096 and 262,144 frames), NMS-r's default decoder
   by batch held to the rule (its edge kernel at every batch on CCSDS);
10. ``train_nms`` with ``NMSTrainConfig()`` (1,200 steps): the loss must
    fall (the trained factor's loss on the first block's frames below the
    first block's loss); the factor and its 3.0 dB FER are reported;
11. the seven-stage recipe of ``runs/r4_pipeline/config.json`` through
    ``pipeline.recipe``'s stages in ``run_recipe``'s order, in a temporary
    run directory seeded with the JAX run's NMS factor (stage 1 reused):
    the harvest's FER against the record's 47,140 / 262,144; DIA training
    (2,000 steps: the last block's mean loss below the first's) and the
    pattern sweep (the refined MRB zero-error count above the initial
    one); stopper samples and training (the loss falls; walk decisions of
    the trained artifacts card == CPU on refparity); the eval sweep at
    2.0-3.0 dB (6 points, 40,000 NMS errors and 500 OSD frames each), each
    point's ``fer_nms_detected`` and OSD failure share against
    ``fer_curve.json``, T+2 CE/BER entries, K1, K2, GE and K5 launched;
    the written run directory through ``convert.load_run``, its pickles
    numpy trees in the JAX layout; ``sldpc-torch sweep`` at 3.0 dB on it;
    then ``runs/r4_rnn1``'s RnnOne: refine card == CPU on 4,096 harvested
    rows, its 3.0 dB OSD success share against 436 / 500, and 200 steps of
    ``train_dia(model="model_rnn1")`` lowering the loss; each stage's
    seconds (statistics against the records by 99.9% Wilson overlap);
    before it, the capture step's peak bytes a frame on three routes
    beside ``recipe.capture_frame_bytes``;
12. the OSD baselines (``baselines/``): FS-OSD in both scoring modes, PB-OSD,
    conventional OSD at order 3 and the miracle view on the 256 frames of
    ``runs/refparity/base_failures.npz``, every per-frame field on the card
    equal to the port's CPU run, success flags and FS TEP counts equal to
    the record, the PB fields that differ from it printed; the GE kernel's
    dense load on their G-domain inputs (== its plain twin == the dense
    route) and K5 on M = P^T with the 43,744 order-3 TEPs (against the f64
    evaluation and its twin), each timed against its bound, K5 also
    against the fp16 einsum; the host's time to build the static TEP
    tables, and one FS and one PB call under ``torch.profiler``; then
    ``sldpc-torch baseline`` for every kind
    at ``runs/r5_baselines``'s configuration (4 points, 65,536 frames a
    step, 256 failures a point) in a temporary run directory with that
    run's NMS factor, launch counts reset just before and read just after
    (K1, GE and K5 only), each point's ``fer_nms``, each kind's successes
    and the miracle view's ``floor_order3`` against the records by 99.9%
    Wilson overlap, the seconds of every kind and point;
13. ``parallel/`` (the mesh): in a world of one on NCCL, ``run_nms_mc(mesh=)``
    at 3.0 dB (the ``runs/r4_pipeline`` factor, 262,144 frames a step, to
    40,000 errors) equal to ``run_nms_mc`` field for field with only K3
    (and K4 on an overflow) launched, ``sharded_dl_osd_step_from_llr`` on
    the main path's 32,768 captured rows equal to
    ``engine.make_dl_osd_step_from_llr`` with K2, GE and K5 launched, and 3
    steps of ``sharded_nms_train_step`` equal to the single-device update
    (loss rtol 1e-6, parameters 1e-5); then ``parallel.run_multihost`` as
    two gloo processes sharing the card, 4 steps of 262,144 frames a rank,
    its counters exactly the sum of this process's K3 calls on
    ``device_seeds(3000, step, 2)`` (K4 after an overflow, the ladder's
    rule);
14. the reference's experimental modules on the main path's 32,768
    captured rows: ``engine.pruned_batch_osd`` unpruned and pruned
    (``threshold_sum`` 3) and ``experimental.best_estimation_counts`` over
    the path's 1,439 TEPs, counts reset just before and read just after (K5
    alone, exactly 4 launches); the first 1,024 rows against the port's CPU
    run (candidates, successes and the pruning mask equal, the argmin equal
    off near-ties, minima within 1e-5), ``candidate_matrix`` on 256 rows
    equal; ``best_estimation_counts`` equal to the unpruned successes,
    every pruned minimum at or above the unpruned one; K5 at this shape
    against its twin and the f64 evaluation, timed against its bound and
    the fp16 einsum; ``swap_statistics(n_s=0)`` and ``updated_mrb_indices``
    on the refined rows (the GE kernel's dense load alone, 2 launches),
    4,096 rows equal to the CPU's dense route, the dense load timed;
    ``RnnThree.refine`` and ``CnvNn.refine`` on 4,096 captured K2
    trajectories, ``TransformerLayer(64, 8)``, ``PredictOutlier(6)`` and
    the four ``PredictPhase`` versions (flax's initial weights from
    ``init_flax_``), card == CPU within rtol 1e-4, atol 1e-5, each timed,
    softmax rows summing to 1; the phase's seconds;
15. the WiMAX (1056,880) two-phase system of
    ``runs/r5_multicode/wimax_1056_880`` through ``system.TwoPhase`` at the
    JAX package's two records (``runs/r5_wimax_system``): 64 rounds of
    4,096 frames at 3.5 dB and 16 of 32,768 at 4.0 dB, 1,024 capture rows
    a round, counts reset after the warm-up round and required to be
    exactly K1 2R, K2, GE and K5 R; the NMS FER and the OSD success share
    against the record by 99.9% Wilson overlap, the rows walked R x 1,024,
    the stage split and the peak memory; K1 and K2 timed at the path's
    shapes; on one 3.5 dB round's 1,024 prepared rows K5 (the whole path's
    102,912 TEPs in one launch) against its twin 64 rows a call and the
    f64 evaluation, the block minima and walk from K5 against those from
    the twin, its launch shape, its time against its bound and the fp16
    yardstick chained over TEP chunks, the GE kernel against its twin and
    the dense route, timed; walk decisions card == CPU on 32 captured rows
    over the full path (a frame that differs passes only where its two
    best f64 discrepancies tie at f32 precision); then K5's general plan
    (``phase_k5_general``): its IMMA and IGMMA counts, K5 on a round's rows
    against twin, f64 and walk, the path's T and a dense random T timed in
    turns (within 3%), the multicode and two ragged shapes against twin and
    f64, and ``k5.general`` and ``k5.minima_decode`` 1 in a recorded WiMAX
    round, 0 in a CCSDS one (``k5.block_minima`` 1 in both); wherever K5
    runs on a path's rows (the main path, the WiMAX round, the multi-code,
    Rayleigh and NMS-r rows), its block-minima entry against the unfused
    path (``k5_block_minima``: argmins equal but at a 1e-5 tie, minima
    within 2 f32 ulps, both timed); on the main path's and the WiMAX
    round's rows, at both plans and both ways a block closes, the epilogue
    on its own terms (``k5_block_minima_exact``: a dense random T within
    the f64 allowance of its arithmetic, exact ties from duplicated rows,
    frames of signed zeros, an empty block);
16. the multi-code recipe (``pipeline/multicode.py``) for ``qc_96_48``,
    ``array_121_60`` (rank-deficient H, OSD on its 61-row basis),
    ``wimaxlike_384_192`` and ``regular_256_128``: (a) the eval sweep on the
    record's own artifacts (``runs/r5_multicode/<code>``) at its points and
    budgets, each point's ``fer_nms_detected`` and OSD failure share against
    ``fer_curve.json`` by 99.9% Wilson overlap (gaps in sigma, the mean
    complexity beside the record's), launches exactly K1 one a capture
    step and K2, GE and K5 one a point; K1 at the capture shape and K2 at
    the re-decode's == their plain twins bit for bit (degree buckets 0 and
    1), the GE kernel == its twin == the dense route and K5 against its
    twin and the f64 evaluation (walk from K5 == from the twin) on the
    code's captured rows, each timed; (b) ``multicode.main`` in a temporary
    out-root seeded with the record's ``config.json`` and ``nms_params.pkl``
    (stage 1 reused): the harvest FER and the initial MRB zero-error share
    against the record, the refined count above the initial one, the DIA's
    and the stopper's losses falling, every eval point against the record
    with its launches counted, the run directory through ``load_run``;
17. the Rayleigh two-phase system (``pipeline/rayleigh.py`` at its
    defaults: ``runs/r4_pipeline``, 16-bit fade blocks, 2,097,152 frames and
    500 walked rows a point at 6, 8 and 10 dB): each point's NMS FER and OSD
    successes against ``runs/r5_rayleigh/two_phase_rayleigh.json`` by 99.9%
    Wilson overlap, launches K1 one a capture step and K2, GE and K5 one a
    point (no fused counter kernel); ``sldpc-torch eval-nms --channel
    rayleigh`` in a new process against ``nms_fer.json``; K1 on a Rayleigh
    capture step == its twin bit for bit, K2, GE and K5 on its walked rows
    against their plain versions, each timed; walk decisions card == CPU
    on 64 walked rows;
18. the NMS variants (``runs/r5_variants``) through the port's entry
    points: ``sldpc-torch train-nms --variant NMS-3`` and ``--variant
    NMS-r`` (``NMSTrainConfig``'s defaults) and ``eval-nms --variant NMS-r``
    on the record's trained weights, in new processes at once, then
    ``eval-nms`` at 3.0 dB on each trained directory: each training's loss
    on the first block's ring frames below the initial parameters', NMS-r's
    NN weights non-negative and its FER under 0.2 (its gap to the record
    reported), the record's weights inside ``nms_r_trained.json``'s 99.9%
    interval on its edge kernel; K1, K2 and K6 == their plain twins bit
    for bit and K4, K3, K7 at 2,097,152 frames with counters equal to their
    twins' at NMS-2's initial weights and at NMS-3's trained ones (w_vc !=
    w_marg, printed), one ``cascade_counters`` call (K8a, K8b) == its twin,
    each timed; ``run_nms_mc`` at 3.0 dB: NMS-2 and NMS-3 (K3) and NMS-2 at
    ``rung="dense"`` (K7) to 2,097,152 frames, ENMS on its capture route
    (K1) and without capture (K3), the untrained NMS-r (its edge kernel,
    65,536 frames), each against ``variant_fer.json`` by 99.9% Wilson
    overlap, NMS-2 == NMS-3 and CCSDS ENMS == NMS-1 counter for counter
    (row for row on the capture route), the decoders and launches of each
    route; ENMS on ``qc_96_48`` (K3 on the 240 x 96 extended matrix,
    reported); the capture step pinned to K6 == the K1
    step and the raw-LLR phase-2 step (K2) at both weight sets; then
    NMS-r's two-phase system: ``recipe.run_recipe`` on
    ``runs/r4_pipeline``'s config with ``"variant": "NMS-r"`` and the
    record's weights (stage 1 reused; the DIA's and the stopper's losses
    falling, the MRB zero-error count rising, GE and K5 one launch a point,
    NMS-r's capture kernel and nothing else, the 3.0 dB ``fer_nms_detected`` inside
    ``nms_r_trained.json``'s interval), ``system.TwoPhase`` on it at 3.0 dB
    (4 rounds; GE, K5 and NMS-r's re-decode kernel R launches, its capture
    kernel 2R, nothing else; the NMS FER inside the
    record's interval; cw/s, OSD failures/s, stages, peak memory, the OSD
    success share reported), GE and K5 on one round's rows against their
    plain versions, and the walk card == CPU on 64 of them;
19. the port's last entry points as new processes: (a) ``sldpc-torch bench
    --batch 2097152`` (``system.bench``): exit 0, its last line JSON with
    ``BENCH_r05.json``'s keys less the four TPU figures, the card's name,
    the system at 3.0 dB, ``sample_fer`` and ``system_fer_nms`` against
    their records by 99.9% Wilson overlap, 49,152 algorithmic flops a
    frame, the TF baseline, launches exactly K3 9, K1 18, K2 10, GE 10, K5
    10 and nothing else, phase 1's and the system's rates at least half of
    phase 4's and phase 3's in this process (the ``bench_cli`` entries of the
    K1, K2, K3, K5 and GE rows); (b) ``sldpc-torch train-dia`` then
    ``train-stopper`` with ``runs/r4_pipeline/config.json``'s flags on one
    run directory that holds only its ``nms_params.pkl``: the harvest FER
    against the record, the DIA's loss falling, the MRB zero-error count
    rising, 30 patterns, ``train-stopper`` reusing the failures (no K1)
    and the refiner (its pickle untouched) with its loss falling, the
    pickles in the JAX layout, the directory through ``load_run``; each
    process's seconds.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA the script exits 1 and
prints no result.  It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import filecmp
import json
import math
import os
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.autograd import DeviceType

from short_ldpc_decoding_osd_tpu_torch import _kernels, system
from short_ldpc_decoding_osd_tpu_torch.baselines import (common, conventional,
                                                         fs_osd, pb_osd)
from short_ldpc_decoding_osd_tpu_torch._device import full_f32, synchronize
from short_ldpc_decoding_osd_tpu_torch.channel import ChannelSpec, sample_batch
from short_ldpc_decoding_osd_tpu_torch.channel.awgn import sigma_for_snr
from short_ldpc_decoding_osd_tpu_torch.cli.main import main as cli_main
from short_ldpc_decoding_osd_tpu_torch.codes import get_code, tables
from short_ldpc_decoding_osd_tpu_torch.convert import load_jax_pickle, load_run
from short_ldpc_decoding_osd_tpu_torch.mc import harness, ladder
from short_ldpc_decoding_osd_tpu_torch.mc.harness import count_and_capture
from short_ldpc_decoding_osd_tpu_torch.models import extras, init_flax_
from short_ldpc_decoding_osd_tpu_torch.ops import (gf2_bitpack, gf2ops,
                                                   mc_cascade, mc_dense, nms,
                                                   nms_dense, nms_edge,
                                                   nms_edge_padded, osd_disc)
from short_ldpc_decoding_osd_tpu_torch.osd import (engine, experimental, path,
                                                   segments)
from short_ldpc_decoding_osd_tpu_torch.parallel import (
    device_seeds, make_mesh, sharded_dl_osd_step_from_llr, sharded_nms_train_step)
from short_ldpc_decoding_osd_tpu_torch.pipeline import multicode, rayleigh, recipe
from short_ldpc_decoding_osd_tpu_torch.train import (NMSTrainConfig, StaircaseAdam,
                                                     dia_train, nms_train)
from short_ldpc_decoding_osd_tpu_torch.utils.metrics import wilson_interval
from short_ldpc_decoding_osd_tpu_torch.utils import profiling
from short_ldpc_decoding_osd_tpu_torch.utils.profiling import Timer

ROOT = os.path.dirname(os.path.abspath(__file__))
R4 = os.path.join(ROOT, "runs", "r4_pipeline")
R4_RNN = os.path.join(ROOT, "runs", "r4_rnn1")
# H100 SXM data-sheet peaks at 700 W (dense): HBM bytes/s; f32 instructions/s
# outside the tensor cores (67 TFLOP/s counts an FMA as two FLOPs, so an
# add, compare, min or FMA issues at half that rate); int8 tensor-core OP/s
HBM_BPS = 3.35e12
F32_INSTR = 67e12 / 2
INT8_OPS = 1979e12
# 32-bit integer instructions/s: 64 INT32 lanes an SM against the 128 f32
# lanes behind the f32 rate (Hopper architecture white paper)
INT32_OPS = F32_INSTR / 2
Z999 = 3.2905  # two-sided 99.9% normal quantile
# the JAX package's two-phase record at 3.0 dB on the same artifacts
# (BENCH_r05.json: system_fer_nms, system_frames, system_osd_success,
# system_failures)
REF_FER, REF_FRAMES = 0.104169, 2_097_152
REF_OSD_SUCC, REF_FAILURES = 215_746, 218_456
CAP_B, CAP, ROUNDS, ITERS = 262_144, 32_768, 8, 12
# the JAX package's phase-1 record (BENCH_r05.json: sample_fer 0.0958996 of
# 2,097,152 frames = 201,116 frame errors), taken in bf16 mode with 24
# overflow frames; bf16 was validated statistically identical to f32
# (bench.py:34-37).  NMS-1 at its initial factor, 12 iterations, 3.0 dB.
REF_PH1_ERRORS, REF_PH1_FRAMES = 201_116, 2_097_152
PH1_BATCH, PH1_STEPS, MC_B = 2_097_152, 8, 262_144
# frames a step of the run_nms_mc sweeps; of the padded edge layout's steps
SWEEP_B, PADDED_B = 262_144, 4096
# kernel row -> its count in _kernels.LAUNCHES
LAUNCH_KEY = {"K1 nms_edge_final": "nms_edge_final", "K2 nms_edge_traj": "nms_edge_traj",
              "K1r nmsr_edge_final": "nmsr_edge_final",
              "K2r nmsr_edge_traj": "nmsr_edge_traj",
              "K3 mc_compact": "mc_compact", "K4 mc_oneshot": "mc_oneshot",
              "K5 lterm": "lterm", "K6 dense_final": "dense_final",
              "K7 mc_dense": "mc_dense", "K8a cascade_p1": "cascade_p1",
              "K8b cascade_p2": "cascade_p2", "GE ge_packed": "ge_packed"}
# the JAX run's learned NMS-1 factor (runs/r4_pipeline/nms_train_summary.json)
REF_TRAINED_CHECK = 0.16855433583259583
# the phase-2 step's per-frame walk decisions, held card == CPU
WALK_FIELDS = ("success", "strict_success", "complexity", "window_num")


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event timings."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, *unit_times_s: float):
    """(least time in ms, what bounds it): the larger of the compulsory
    bytes over the HBM rate and the busiest unit's operation time (units
    such as the tensor cores and the f32 pipe run concurrently)."""
    t_bytes = nbytes / HBM_BPS
    t_ops = max(unit_times_s)
    if t_ops > t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def edge_ops(h, frame_iters: float, closings: float) -> float:
    """f32 instructions the edge decode needs, whatever the design: per
    frame-iteration 8 per real edge (column add, vc = total - cv, |vc|, the
    min/submin update (2), the sign parity, the outgoing magnitude select,
    the sign apply), 2 per check (the weight on min and submin) and 1 per
    variable (total = w * llr + colsum); each closing column sum (one per
    decision taken) adds 1 per edge and 1 per variable."""
    m, n = h.shape
    edges = int(h.sum())
    return frame_iters * (8 * edges + 2 * m + n) + closings * (edges + n)


def nms_edge_ops(h, batch: int, iters: int) -> float:
    """f32 instructions of ``iters`` iterations on ``batch`` frames."""
    return edge_ops(h, batch * iters, batch)


def compare(name, got, want, rel: bool = False, tol: float = 1e-5):
    """Max abs error; raises past ``tol`` (abs + rel, or rel only)."""
    diff = (got - want).abs()
    scale = want.abs().clamp(min=1.0) if rel else 1.0 + want.abs()
    worst = float((diff / scale).max())
    err = float(diff.max())
    if not math.isfinite(worst) or worst > tol:
        raise AssertionError(f"{name}: kernel vs plain error {worst:.3g} > {tol:g}")
    return err


def counters_err(name, got, want) -> int:
    """Largest lane difference of two counter vectors; raises past 2
    frames (or at any difference in the frames lane)."""
    got, want = got.cpu().to(torch.int64), want.cpu().to(torch.int64)
    diff = int((got - want).abs().max())
    if int(got[0]) != int(want[0]) or diff > 2:
        raise AssertionError(f"{name}: kernel {got.tolist()} vs plain "
                             f"{want.tolist()}")
    if diff:
        log(f"{name}: counters differ by {diff} (<= 2 frames): the card's "
            "logf/cosf and torch's log/cos may differ by an ulp on a "
            "razor-edge frame")
    return diff


def wilson_overlap(name, errors: int, frames: int):
    """Raise unless the 99.9% Wilson interval of errors/frames overlaps
    that of the JAX phase-1 record; return the interval."""
    ci = wilson_interval(errors, frames, Z999)
    ref = wilson_interval(REF_PH1_ERRORS, REF_PH1_FRAMES, Z999)
    if not (ci[0] <= ref[1] and ref[0] <= ci[1]):
        raise AssertionError(f"{name}: FER 99.9% CI {ci} misses the record {ref}")
    return ci


def phase_environment():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} card(s)")
    t0 = time.perf_counter()
    per_source = _kernels.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s wall, per source "
        + json.dumps({k: round(v, 2) for k, v in per_source.items()}))
    for name, text in _kernels.BUILD_LOG.items():
        regs = [ln.strip() for ln in text.splitlines() if "registers" in ln]
        log(f"  {name}.cu ptxas: " + " | ".join(regs))
    return smi


def main_path_inputs(dev):
    """K1/K2/K5 inputs as the main path makes them: one 262,144-frame
    sample, its 32,768-row failure capture, the capture's trajectories and
    its prepared OSD batch."""
    run = load_run(os.path.join(ROOT, "runs", "r4_pipeline"), dev)
    code = run["code"]
    params = {k: v.cpu() for k, v in run["nms_params"].items()}
    gen = torch.Generator(device=dev).manual_seed(2024)
    llr, words = sample_batch(gen, ChannelSpec.awgn(3.0, code.rate),
                              torch.as_tensor(code.g, device=dev), CAP_B)
    soft = nms_edge.decode_final_edge(params, code.h, llr, ITERS)
    _, cap = count_and_capture(llr, words, soft, code.h, CAP)
    traj = nms_edge.decode_traj_edge(params, code.h, cap["llr"], ITERS)
    refined = run["dia"].refine_fast(traj.permute(1, 0, 2))
    prep = engine.prepare(refined, cap["llr"], cap["labels"], code.h_osd, code.k)
    _, u_l, _, _ = engine._discrepancy_terms(prep, code.k)
    layout = segments.TepLayout.build(run["path"], code.k, 6, dev)
    return (run, params, llr, cap, refined, prep, u_l.contiguous(), layout.flat,
            layout)


# K5 beside the main path: (code, frames, m, k, TEPs) at other codes' (m, k)
K5_SHAPES = (("qc_96_48", 4096, 48, 48, 1536),
             ("wimaxlike_384_192", 4096, 192, 192, 1536),
             ("wimax_1056_880", 256, 176, 880, 1536))


def k5_inputs(dev, b, m, k, ntot, seed, u_pool=None):
    """Synthetic 0/1 M (b, m, k) and T (ntot, k), made on the host; u_l
    drawn from ``u_pool`` (the main path's own u_l values) or, without one,
    N(0, 1.5) (signs mixed, sums that cancel)."""
    rng = np.random.default_rng(seed)
    mm = rng.integers(0, 2, (b, m, k)).astype(np.int8)
    u = (rng.normal(0, 1.5, (b, m)) if u_pool is None
         else rng.choice(u_pool, (b, m))).astype(np.float32)
    tt = rng.integers(0, 2, (ntot, k)).astype(np.int8)
    return [torch.as_tensor(a, device=dev) for a in (mm, u, tt)]


def lterm_f64(m_mat, u_l, t_flat, chunk: int = 1024):
    """K5's function evaluated in f64 (the parities exact, the sum to
    ~1e-16), 1,024 frames at a time: what the kernel's f64 sum approaches."""
    t = t_flat.double()
    outs = []
    for s in range(0, m_mat.shape[0], chunk):
        prods = torch.einsum("bmk,nk->bmn", m_mat[s:s + chunk].double(), t)
        outs.append(torch.einsum("bm,bmn->bn", u_l[s:s + chunk].double(),
                                 prods.remainder_(2.0)))
    return torch.cat(outs)


def lterm_twin(m_mat, u_l, t_flat, rows: int | None = None):
    """``osd_disc.lterm_reference``, ``rows`` frames at a time where its
    (B, m, N) f32 parity tensor would not fit the card whole."""
    if rows is None:
        return osd_disc.lterm_reference(m_mat, u_l, t_flat)
    return torch.cat([osd_disc.lterm_reference(m_mat[s:s + rows], u_l[s:s + rows],
                                               t_flat)
                      for s in range(0, m_mat.shape[0], rows)])


def k5_check(label, m_mat, u_l, t_flat, twin_rows: int | None = None,
             f64_rows: int = 1024):
    """K5 against its plain twin (1e-5 relative, the gate) and against the
    f64 evaluation (1e-6 relative), each ``twin_rows`` / ``f64_rows`` frames
    at a time; returns the max abs error vs the twin."""
    b, m, k = m_mat.shape
    shape = f"M ({b}, {m}, {k}) x T ({t_flat.shape[0]}, {k})"
    got = osd_disc.lterm(m_mat, u_l, t_flat)
    want = lterm_twin(m_mat, u_l, t_flat, twin_rows)
    err = compare(f"K5 lterm {label} {shape}", got, want, rel=True)
    exact = lterm_f64(m_mat, u_l, t_flat, f64_rows)
    twin_exact = float(((want.double() - exact).abs()
                        / exact.abs().clamp(min=1.0)).max())
    del want
    err64 = compare(f"K5 lterm {label} {shape} vs f64", got.double(), exact,
                    rel=True, tol=1e-6)
    plan = osd_disc.lterm_plan(b, m, k, t_flat.shape[0])
    log(f"K5 lterm {label} {shape}: max_abs_err vs plain {err:.3g}, vs f64 "
        f"{err64:.3g} (the plain twin's own worst relative error vs f64 "
        f"{twin_exact:.3g}); plan {k5_plan_text(plan)}")
    return err


def k5_plan_text(plan) -> str:
    """A K5 plan in words: resident (kch, tn, frame buffers) or general
    (frame padding, k-slice and stages a ring), tiles and grid."""
    if plan.resident:
        text = (f"resident (kch {plan.kch}, tn {plan.tn}), {plan.nt} TEPs a "
                f"tile x {plan.n_tiles} tiles, {plan.nbuf} frame buffer(s)")
    else:
        text = (f"general (frame {plan.m_pad} x {plan.k_pad}, k-slice "
                f"{plan.stride} bytes, {plan.stages} stages a ring), {plan.nt} "
                f"TEPs a unit x {plan.n_tiles} units a frame")
    return f"{text}, {plan.smem_bytes} dynamic shared bytes, grid {plan.grid}"


def k5_build_lines():
    """K5's ptxas lines (registers, spills, shared bytes, wgmma
    serialisation warnings) and the counts of IMMA (the resident plan's
    mma.sync) and IGMMA (the general plan's wgmma) instructions in the built
    library's SASS."""
    text = _kernels.BUILD_LOG.get("osd_disc", "")
    keep = [ln.strip() for ln in text.splitlines()
            if "Compiling entry" in ln or "registers" in ln or "spill" in ln
            or "smem" in ln or "wgmma" in ln]
    log("K5 osd_disc.cu ptxas: " + " | ".join(keep))
    tool = os.path.join(os.path.dirname(os.path.dirname(_kernels._nvcc())),
                        "bin", "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", _kernels._lib_path("osd_disc")],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    imma = sum(1 for ln in sass.splitlines() if "IMMA" in ln)
    gmma = sum(1 for ln in sass.splitlines() if "IGMMA" in ln)
    log(f"K5 SASS: {imma} IMMA and {gmma} IGMMA instructions in libosd_disc "
        "(cuobjdump)")
    if imma == 0 or gmma == 0:
        raise AssertionError("K5: no IMMA or no IGMMA instruction in the built "
                             "kernels")


def k5_minima(prep, lterm_vals, layout, k):
    """Block minima and first argmins of the main path's discrepancies from
    a given parity term: the unfused path (c0 + lterm + u_m @ T^T, then the
    per-block ``amin`` and ``first_argmin``), ``osd_disc``'s plain twin, on
    the ``segments.TepLayout``'s tables."""
    c0, u_l, u_m, _ = engine._discrepancy_terms(prep, k)
    return osd_disc.block_minima_reference(
        prep.m_matrix, u_l, c0, u_m, layout.flat, layout.block_of,
        layout.starts, layout.ntot, lterm_vals)


def walk_picks(run, prep, minima, argmins, bounds):
    """The walk's decisions from a batch's block minima and first argmins
    (``sliding_osd``'s rule with the run's stopper, window and margin):
    (stop_k, success, chosen TEP's flat index, deep_limit), each (B,)."""
    cfg = run["config"]
    w = engine.sliding_walk(minima, run["fcn"], window=int(cfg.get("window", 5)),
                            soft_margin=float(cfg.get("soft_margin", 0.9)))
    scale = torch.clamp(prep.truth_discrepancy, min=1.0)
    success = (w["global_min"] - prep.truth_discrepancy).abs() <= 1e-3 * scale
    in_walk = (torch.arange(minima.shape[1], device=minima.device)[None, :]
               < w["deep_limit"][:, None])
    best = engine.first_argmin(torch.where(in_walk, minima, engine._BIG), 1)
    inner = torch.gather(argmins, 1, best[:, None])[:, 0]
    starts = torch.as_tensor([s for s, _ in bounds], device=minima.device)
    return w["stop_k"], success, starts[best] + inner, w["deep_limit"]


def k5_walk(run, prep, u_l, layout, label="main path",
            twin_rows: int | None = None):
    """A batch's block minima through K5 (``block_discrepancy_minima``)
    against those from ``lterm_reference`` (``twin_rows`` frames at a time;
    1e-5 relative, the gate), and the frames whose walk differs: stop_k,
    success, chosen TEP (logged).  Returns the (B,) mask of those frames
    and each frame's deeper ``deep_limit`` of the two walks."""
    k = run["code"].k
    m_mat = prep.m_matrix.contiguous()
    t_flat = layout.flat
    got_min, got_arg = engine.block_discrepancy_minima(prep, layout, k)
    ref_min, ref_arg = k5_minima(
        prep, lterm_twin(m_mat, u_l, t_flat, twin_rows), layout, k)
    err = compare(f"K5 block minima ({label})", got_min, ref_min, rel=True)
    picks = [walk_picks(run, prep, minima, argmins, layout.bounds)
             for minima, argmins in ((got_min, got_arg), (ref_min, ref_arg))]
    (sk, sk_ref), (su, su_ref), (tp, tp_ref), (dl, dl_ref) = zip(*picks)
    diffs = {"stop_k": int((sk != sk_ref).sum()),
             "success": int((su != su_ref).sum()),
             "chosen_tep": int((tp != tp_ref).sum())}
    log(f"K5 walk on the {label}'s {m_mat.shape[0]} captured rows: block "
        f"minima vs lterm_reference's max_abs_err {err:.3g}; frames that differ "
        f"{json.dumps(diffs)} (0 expected; a flipped tie is reported here); "
        f"successes {int(su.sum())} (K5) / {int(su_ref.sum())} (plain)")
    return (sk != sk_ref) | (su != su_ref) | (tp != tp_ref), torch.maximum(dl, dl_ref)


# the block-minima entry against the unfused path: argmins may differ only
# where the unfused discrepancies of the two picks are this close (relative
# to the larger of the minimum and 1), minima by this many f32 ulps
K5_MINIMA_TIE = 1e-5
K5_MINIMA_ULPS = 2


def k5_block_minima(label, prep, layout, k, card=None) -> dict:
    """K5's block-minima entry (``engine.block_discrepancy_minima`` on the
    chunked layout: ``osd_disc.block_minima``, its f32 discrepancy formed
    and reduced in the kernel) against the unfused path on the card (K5's
    ``lterm``, then ``c0 + lterm + u_m @ T^T``, the mask and the per-block
    ``amin``/``first_argmin``: :func:`k5_minima`): argmins equal except where
    the unfused discrepancies at the two picks lie within
    :data:`K5_MINIMA_TIE`, minima within :data:`K5_MINIMA_ULPS` f32 ulps.
    Both timed (the whole minima stage, and K5's launch alone) against K5's
    bound; the entry of the kernel row."""
    bounds = layout.bounds
    m_mat = prep.m_matrix.contiguous()
    c0, u_l, u_m, _ = engine._discrepancy_terms(prep, k)
    u_l = u_l.contiguous()
    t_flat = layout.flat
    b, m, _ = m_mat.shape
    ntot = t_flat.shape[0]
    got_min, got_arg = engine.block_discrepancy_minima(prep, layout, k)
    ref_min, ref_arg = k5_minima(prep, osd_disc.lterm(m_mat, u_l, t_flat),
                                 layout, k)
    ref64 = ref_min.double()
    ulp = (torch.nextafter(ref_min.abs(), torch.full_like(ref_min, math.inf))
           - ref_min.abs()).double()
    ulps = float(((got_min.double() - ref64).abs() / ulp).max())
    differ = got_arg != ref_arg
    n_differ, closest_split = int(differ.sum()), 0.0
    if n_differ:
        disc = (c0[:, None] + osd_disc.lterm(m_mat, u_l, t_flat)
                + u_m @ t_flat.T.to(torch.float32)).double()
        rows, blocks = differ.nonzero(as_tuple=True)
        base = layout.starts[blocks]
        at_got = disc[rows, base + got_arg[rows, blocks]]
        at_ref = disc[rows, base + ref_arg[rows, blocks]]
        split = (at_got - at_ref).abs() / at_ref.abs().clamp(min=1.0)
        closest_split = float(split.max())
        del disc
    stage = {"fused_ms": cuda_ms(lambda: engine.block_discrepancy_minima(
                 prep, layout, k), 10),
             "unfused_ms": cuda_ms(lambda: k5_minima(
                 prep, osd_disc.lterm(m_mat, u_l, t_flat), layout, k), 10)}
    args = (m_mat, u_l, c0.contiguous(), u_m.contiguous(), t_flat,
            layout.positions, layout.block_of, layout.starts, layout.ntot)
    kernel = {"block_minima_ms": cuda_ms(lambda: osd_disc.block_minima(*args), 10),
              "lterm_ms": cuda_ms(lambda: osd_disc.lterm(m_mat, u_l, t_flat), 10)}
    # read M, u_l, c0, u_m and T; write the (B, P) minima and argmins
    nbytes = (m_mat.numel() + 4 * (u_l.numel() + b + b * k) + t_flat.numel()
              + 12 * b * len(bounds))
    bms, bound_by = bound_ms(nbytes, 2.0 * b * m * k * ntot / INT8_OPS,
                             1.0 * b * m * ntot / F32_INSTR)
    plan = osd_disc.lterm_plan(b, m, k, ntot, blocks=len(bounds))
    entry = {"shape": f"M ({b}, {m}, {k}) x T ({ntot}, {k}), {len(bounds)} blocks",
             "plan": k5_plan_text(plan), "max_ulps": ulps,
             "argmins_differ": n_differ, "widest_split": closest_split,
             "bound_ms": bms, "bound_by": bound_by} | stage | kernel
    log(f"K5 block minima {label} {entry['shape']}"
        f"{' on ' + card if card else ''}: minima within {ulps:.3g} ulps of "
        f"the unfused path's; argmins differ at {n_differ} (widest split of "
        f"the two picks' unfused discrepancies {closest_split:.3g}); minima "
        f"stage fused {stage['fused_ms']:.4f} ms, unfused "
        f"{stage['unfused_ms']:.4f} ms; K5 block_minima "
        f"{kernel['block_minima_ms']:.4f} ms, lterm {kernel['lterm_ms']:.4f} "
        f"ms; bound {bms:.4f} ms ({bound_by}); plan {entry['plan']}")
    if ulps > K5_MINIMA_ULPS or closest_split >= K5_MINIMA_TIE:
        raise AssertionError(
            f"K5 block minima {label}: {ulps:.3g} ulps from the unfused path "
            f"(at most {K5_MINIMA_ULPS}), argmins split {closest_split:.3g} "
            f"apart (under {K5_MINIMA_TIE} allowed)")
    del got_min, got_arg, ref_min, ref_arg, args
    torch.cuda.empty_cache()
    return entry


def _block_minima_on(m_mat, u_l, c0, u_m, blocks):
    """K5's block-minima entry over the TEP ``blocks`` (host 0/1 arrays)
    packed as the main path packs its path: (minima, argmins, T (N, k)
    int8, the ``segments.TepLayout``)."""
    layout = segments.TepLayout.from_blocks(blocks, m_mat.device)
    minima, argmins = osd_disc.block_minima(
        m_mat, u_l, c0, u_m, layout.flat, layout.positions, layout.block_of,
        layout.starts, layout.ntot)
    return minima, argmins, layout.flat, layout


def _sparse_rows(rng, rows, k):
    """``rows`` TEP rows of 1-3 set columns, as the decoding paths have."""
    t = np.zeros((rows, k), np.int8)
    for r in range(rows):
        t[r, rng.choice(k, rng.integers(1, 4), replace=False)] = 1
    return t


def k5_block_minima_exact(label, prep, k, rows, dense_teps, seed, card=None):
    """K5's block-minima epilogue checked on its own terms, on ``rows`` of
    a batch's prepared frames (their real c0, u_l and u_m):

    * a dense random T (``dense_teps`` rows, blocks of uneven sizes, one
      empty): each block's minimum against the f64 evaluation of d at the
      kernel's pick, within the rounding the epilogue's arithmetic allows
      there (lterm rounded once, two f32 adds, the MRB term's f32 sum over
      n set columns: gamma(n - 1) of its absolute sum), and the pick's f64
      value within the two picks' allowances of the block's f64 minimum;
      the unfused path (K5's lterm, the GEMM) read the same way, and the
      two apart in f32 ulps (the sums' orders differ on a dense T);
    * exact ties from duplicated TEP rows (a block, the same block again,
      the block twice over, one row repeated past a 64-TEP tile): equal
      minima, the first index of each tie; an empty block (``_BIG``, 0);
    * frames whose c0, u_l and u_m are all -0.0 or all +0.0: every block's
      minimum 0 and argmin 0 (-0 ties with +0, the first index wins).

    Returns the entry of the kernel row."""
    rng = np.random.default_rng(seed)
    c0, u_l, u_m, _ = engine._discrepancy_terms(prep, k)
    m_mat = prep.m_matrix[:rows].contiguous()
    c0, u_l, u_m = (t[:rows].contiguous() for t in (c0, u_l, u_m))
    b, m, _ = m_mat.shape
    u32 = 2.0 ** -24

    # the dense T against f64
    sizes = [int(x) for x in rng.multinomial(dense_teps - 1, [0.1, 0.3, 0.15, 0.45])]
    sizes.insert(2, 0)
    sizes[0] += 1
    blocks = [rng.integers(0, 2, (n, k)).astype(np.int8) for n in sizes]
    got_min, got_arg, t_flat, layout = _block_minima_on(m_mat, u_l, c0, u_m, blocks)
    t64 = t_flat.double()
    big_l = lterm_f64(m_mat, u_l, t_flat)
    mrb_abs = u_m.double().abs() @ t64.T
    exact = c0.double()[:, None] + big_l + u_m.double() @ t64.T
    n_set = t64.sum(1)[None, :]
    gamma = (n_set - 1).clamp(min=0) * u32 / (1 - n_set * u32)
    outer = c0.double().abs()[:, None] + big_l.abs()
    # lterm: its f64 sum (m terms) and one rounding; (c0 + l): one rounding;
    # the MRB sum; (a + mrb): one rounding; 1e-3 over for second-order terms
    allow = (1 + 1e-3) * (u32 * big_l.abs()
                          + m * 2.0 ** -53 * u_l.double().abs().sum(1)[:, None]
                          + u32 * outer + gamma * mrb_abs
                          + u32 * (outer + mrb_abs))
    zero_b, zero_bk = torch.zeros_like(c0), torch.zeros_like(u_m)
    _, opt_arg = osd_disc.block_minima_reference(
        None, None, zero_b, zero_bk, t_flat, layout.block_of, layout.starts,
        layout.ntot, exact)
    unf_min, unf_arg = osd_disc.block_minima_reference(
        m_mat, u_l, c0, u_m, t_flat, layout.block_of, layout.starts, layout.ntot,
        osd_disc.lterm(m_mat, u_l, t_flat))
    full = torch.tensor([n > 0 for n in sizes], device=c0.device)
    rows_i = torch.arange(b, device=c0.device)[:, None]
    t_opt = layout.starts[None, :] + opt_arg

    def reading(minima, argmins):
        t_at = layout.starts[None, :] + argmins
        value_err = (minima.double() - exact[rows_i, t_at]).abs() / allow[rows_i, t_at]
        pick_err = ((exact[rows_i, t_at] - exact[rows_i, t_opt])
                    / (allow[rows_i, t_at] + allow[rows_i, t_opt]))
        return (float(value_err[:, full].max()), float(pick_err[:, full].max()))

    kernel_read, unfused_read = reading(got_min, got_arg), reading(unf_min, unf_arg)
    ulp = (torch.nextafter(unf_min.abs(), torch.full_like(unf_min, math.inf))
           - unf_min.abs()).double()
    ulps = float(((got_min.double() - unf_min.double()).abs() / ulp)[:, full].max())
    empty_ok = bool((got_min[:, ~full] == engine._BIG).all()
                    and (got_arg[:, ~full] == 0).all())
    log(f"K5 block minima {label}, dense random T ({b}, {m}, {k}) x "
        f"{t_flat.shape[0]}, blocks {sizes}: kernel minima within "
        f"{kernel_read[0]:.3g} of their f64 allowance at the pick, picks within "
        f"{kernel_read[1]:.3g} of the two picks' allowances; unfused path "
        f"{unfused_read[0]:.3g} / {unfused_read[1]:.3g}; kernel vs unfused "
        f"{ulps:.3g} f32 ulps (sum orders differ); largest MRB term count "
        f"{int(n_set.max())}; empty block (BIG, 0): {empty_ok}")
    del big_l, mrb_abs, exact, allow, t64
    if max(kernel_read) > 1.0 or not empty_ok:
        raise AssertionError(f"K5 block minima {label}: dense T off its f64 "
                             f"allowance {kernel_read}, empty block {empty_ok}")

    # exact ties from duplicated rows, and an empty block
    base = _sparse_rows(rng, 50, k)
    single = np.repeat(_sparse_rows(rng, 1, k), 70, axis=0)
    # the last block fills the layout to ``dense_teps``: one tile of the
    # resident plan, or several and the device keys
    blocks = [_sparse_rows(rng, 37, k), base, base.copy(), np.concatenate([base, base]),
              single, np.zeros((0, k), np.int8),
              _sparse_rows(rng, max(300, dense_teps - 307), k)]
    got_min, got_arg, _, _ = _block_minima_on(m_mat, u_l, c0, u_m, blocks)
    ties = {"repeat_block": bool(torch.equal(got_min[:, 1], got_min[:, 2])
                                 and torch.equal(got_arg[:, 1], got_arg[:, 2])),
            "doubled_block": bool(torch.equal(got_min[:, 1], got_min[:, 3])
                                  and torch.equal(got_arg[:, 1], got_arg[:, 3])),
            "repeated_row": bool((got_arg[:, 4] == 0).all()),
            "empty": bool((got_min[:, 5] == engine._BIG).all()
                          and (got_arg[:, 5] == 0).all())}
    # the same blocks on frames of signed zeros
    sign = torch.where(torch.arange(b, device=c0.device) < b // 2,
                       torch.tensor(-0.0, device=c0.device),
                       torch.tensor(0.0, device=c0.device))
    zmin, zarg, _, _ = _block_minima_on(
        m_mat, sign[:, None].expand(b, m).contiguous(), sign.clone(),
        sign[:, None].expand(b, k).contiguous(), blocks)
    live = [p for p, blk in enumerate(blocks) if len(blk)]
    ties["signed_zero"] = bool((zmin[:, live] == 0).all() and (zarg[:, live] == 0).all()
                               and (zmin[:, 5] == engine._BIG).all())
    log(f"K5 block minima {label}, ties on ({b}, {m}, {k}) x "
        f"{sum(map(len, blocks))} (blocks {[len(x) for x in blocks]}){' on ' + card if card else ''}: "
        f"{json.dumps(ties)}")
    if not all(ties.values()):
        raise AssertionError(f"K5 block minima {label}: ties {ties}")
    torch.cuda.empty_cache()
    return {"dense_allowance_used": kernel_read[0], "dense_pick": kernel_read[1],
            "dense_unfused": list(unfused_read), "dense_ulps_vs_unfused": ulps,
            "ties": ties}


def k5_launch_shape(b, m, k, ntot, label="", blocks=0):
    """Log K5's plan at M (b, m, k) x T (ntot, k) and what the card makes of
    it (registers, local bytes, resident blocks per SM)."""
    plan = osd_disc.lterm_plan(b, m, k, ntot, blocks=blocks)
    occ = osd_disc.lterm_occupancy(plan, torch.cuda.current_device())
    log(f"K5 launch shape {label}({b}, {m}, {k}) x {ntot}"
        f"{f', block minima of {blocks}' if blocks else ''}: "
        f"{k5_plan_text(plan)}; {occ['threads']} threads, "
        f"{occ['registers']} registers and {occ['local_bytes']} local bytes a "
        f"thread, {occ['blocks_per_sm']} resident block(s) per SM on "
        f"{occ['sms']} SMs")


def k5_library(m_mat, u_l, t_flat, teps_a_call: int | None = None):
    """The yardstick, never used by the port: one einsum on the fp16 tensor
    cores (0/1 sums <= k < 2,048 are exact in fp16), mod 2, then the u_l
    reduction; chained over ``teps_a_call`` TEPs at a time where the (B, m,
    N) intermediate would not fit the card whole."""
    m_half = m_mat.half()
    step = teps_a_call or t_flat.shape[0]
    outs = []
    for s in range(0, t_flat.shape[0], step):
        prods = torch.einsum("bmk,nk->bmn", m_half, t_flat[s:s + step].half())
        outs.append(torch.einsum("bm,bmn->bn", u_l, prods.float().remainder_(2.0)))
    return outs[0] if len(outs) == 1 else torch.cat(outs, 1)


def k5_timed(label, m_mat, u_l, t_flat, twin_rows: int | None = None,
             lib_teps: int | None = None) -> dict:
    """K5's timed entry at one shape: ms through the wrapper, its plain twin
    (``twin_rows`` frames at a time) and the library yardstick (held to K5
    first; ``lib_teps`` TEPs a call), against the bound of 2 B m k N int8
    operations, B m N f32 adds and the compulsory bytes."""
    b, m, k = m_mat.shape
    ntot = t_flat.shape[0]
    compare(f"K5 {label} library yardstick", k5_library(m_mat, u_l, t_flat, lib_teps),
            osd_disc.lterm(m_mat, u_l, t_flat), rel=True)
    nbytes = m_mat.numel() + 4 * u_l.numel() + t_flat.numel() + 4 * b * ntot
    # binary MACs on the int8 tensor cores; one f32 FMA per (frame, row, TEP)
    # for the u_l-weighted parity sum
    bms, bound_by = bound_ms(nbytes, 2.0 * b * m * k * ntot / INT8_OPS,
                             1.0 * b * m * ntot / F32_INSTR)
    return {
        "ms": cuda_ms(lambda: osd_disc.lterm(m_mat, u_l, t_flat), 20),
        "plain_ms": cuda_ms(lambda: lterm_twin(m_mat, u_l, t_flat, twin_rows),
                            3, warmup=1),
        "bound_ms": bms, "bound_by": bound_by,
        "library_ms": cuda_ms(lambda: k5_library(m_mat, u_l, t_flat, lib_teps),
                              3, warmup=1),
        "shape": f"M ({b}, {m}, {k}) int8, u_l ({b}, {m}) f32, T ({ntot}, {k}) "
                 f"int8 -> ({b}, {ntot}) f32",
    }


def k5_row(dev, run, prep, u_l, t_flat, layout):
    """K5: the build's ptxas and IMMA lines, the kernel against its twin on
    the main path's input, the ragged (5, 61, 60) x 130 and the other codes'
    shapes (synthetic, u_l from the main path's values), the same shapes
    with N(0, 1.5) weights against f64, the walk on the real batch, the
    block-minima entry against the unfused path (``k5_block_minima``), the
    launch shape of each plan, the epilogue on its own terms at the resident
    plan's two closes (``k5_block_minima_exact``), and the timed row."""
    k5_build_lines()
    m_mat = prep.m_matrix.contiguous()
    err = k5_check("main path", m_mat, u_l, t_flat)
    u_pool = u_l.flatten().cpu().numpy()
    err = max(err, k5_check("ragged", *k5_inputs(dev, 5, 61, 60, 130, 1)))
    for i, (name, b_, m_, k_, n_) in enumerate(K5_SHAPES):
        err = max(err, k5_check(f"{name} (u_l from the main path)",
                                *k5_inputs(dev, b_, m_, k_, n_, 10 + i, u_pool)))
        inputs = k5_inputs(dev, b_, m_, k_, n_, 20 + i)
        got = osd_disc.lterm(*inputs)
        err64 = compare(f"K5 lterm {name} N(0, 1.5) vs f64", got.double(),
                        lterm_f64(*inputs), rel=True, tol=1e-6)
        log(f"K5 lterm {name} M ({b_}, {m_}, {k_}) x T ({n_}, {k_}), u_l "
            f"N(0, 1.5): max_abs_err vs f64 {err64:.3g}")
        del inputs, got
    k5_walk(run, prep, u_l, layout)
    minima = k5_block_minima("main path", prep, layout, run["code"].k)
    minima["exact"] = {
        f"{n} TEPs": k5_block_minima_exact(f"main path rows ({n} TEPs)", prep,
                                           run["code"].k, 512, n, 91 + i)
        for i, n in enumerate((1_200, 6_000))}
    for b_, m_, k_, n_ in ((*m_mat.shape, t_flat.shape[0]),
                           *(s[1:] for s in K5_SHAPES)):
        k5_launch_shape(b_, m_, k_, n_)
    k5_launch_shape(*m_mat.shape, t_flat.shape[0], "main path ",
                    len(layout.bounds))

    row = {
        "name": "K5 lterm", "route": "cuda",
        "source": "short_ldpc_decoding_osd_tpu_torch/csrc/osd_disc.cu",
        "replaces": "short_ldpc_decoding_osd_tpu/ops/osd_disc_pallas.py:40",
        "launches": None, "max_abs_err": err,
    } | k5_timed("main path", m_mat, u_l, t_flat) | {"block_minima": minima}
    log(f"K5 lterm: max_abs_err {err:.3g}, kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    for name, b_, m_, k_, n_ in K5_SHAPES:
        inputs = k5_inputs(dev, b_, m_, k_, n_, 30, u_pool)
        log(f"K5 lterm {name} M ({b_}, {m_}, {k_}) x T ({n_}, {k_}): kernel "
            f"{cuda_ms(lambda: osd_disc.lterm(*inputs), 10):.4f} ms, bound "
            f"{bound_ms(0, 2.0 * b_ * m_ * k_ * n_ / INT8_OPS)[0]:.4f} ms "
            "(operations)")
        del inputs
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return row

# GE beside the main path: (code, frames) on h_osd with random permutations;
# timed also with wimax_1056_880 at 8,192 frames (block mode filling the
# card: a 1.27 GB tail)
GE_CODES = (("qc_96_48", 4096), ("wimaxlike_384_192", 4096),
            ("wimax_1056_880", 1024))
GE_TIMED = GE_CODES + (("wimax_1056_880", 8192),)


def ge_check(label, perm=None, h=None, k=None, h_batch=None, dense_too=True):
    """The GE kernel (perm load, or dense load of ``h_batch``) against its
    plain packed twin and, where ``dense_too``, the port's dense route:
    the reduced tail and col_order bit for bit (the frames where the dense
    route differs are logged where it is not held)."""
    if perm is not None:
        got = gf2_bitpack.reduce_from_perm(perm, h, k)
        twin = gf2_bitpack._reduce_perm_plain(perm, h, k)
        h_batch = gf2ops.permute_columns(perm, h)
    else:
        k = k or h_batch.shape[2]
        got = gf2_bitpack.reduce_dense(h_batch, k)
        twin = gf2_bitpack._reduce_dense_plain(h_batch, k)
    b, m, n = h_batch.shape
    for part, a, w in zip(("tail", "col_order"), got, twin):
        if not torch.equal(a, w):
            raise AssertionError(f"GE {label}: kernel {part} differs from the "
                                 "plain packed twin")
    red, order = gf2ops.batched_row_reduce(h_batch)
    differ = ((red[:, :, n - k:] != got[0]).flatten(1).any(1)
              | (order != got[1]).any(1))
    n_differ = int(differ.sum())
    if dense_too and n_differ:
        raise AssertionError(f"GE {label}: kernel differs from the dense route "
                             f"on {n_differ} frames")
    plan = gf2_bitpack.ge_plan(b, m, n)
    log(f"GE {label} ({b} frames of {m} x {n}, tail {k}): kernel == plain "
        f"packed twin bit for bit; dense route differs on {n_differ} frames"
        f"{'' if dense_too else ' (not held: rank-deficient H)'}; plan "
        f"{plan.mode}, {plan.words} words a column, {plan.cols} columns a "
        f"thread, {plan.threads} threads, grid {plan.grid}")


def back_to_back_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """ms a call of ``fn``, ``reps`` calls launched back to back between two
    CUDA events: the kernel's own time wherever the card, not the host, is
    the slower (the host work of each call overlaps the previous kernel)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def ge_bound(b, m, n, k, load):
    """GE's least time: perm in (int64) or the dense batch in (int8), the
    int8 tail and the int32 order out, against B m^2 nw word XORs on the
    INT32 lanes (at most what the data needs; bytes bound the main path
    even at that count)."""
    nin = 8 * b * n if load == "perm" else b * m * n
    return bound_ms(nin + b * m * k + 4 * b * n,
                    b * m * m * -(-n // 32) / INT32_OPS)


def ge_time(label, fn, b, m, n, k, load):
    """One GE shape: its time through the wrapper (one call between two
    events, host work included) and back to back, against its bound."""
    wrapper = cuda_ms(fn, 10)
    alone = back_to_back_ms(fn)
    bms, by = ge_bound(b, m, n, k, load)
    log(f"GE time {label} ({b} frames of {m} x {n}, {load} load): through the "
        f"wrapper {wrapper:.4f} ms, back to back {alone:.4f} ms, bound "
        f"{bms:.4f} ms ({by}), {alone / bms:.2f}x the bound")
    return {"shape": label, "frames": b, "wrapper_ms": wrapper,
            "back_to_back_ms": alone, "bound_ms": bms, "bound_by": by}


def ge_build_lines(plans):
    """ptxas's registers and spills for the GE kernels the plans launch,
    and what the card makes of each plan (cudaFuncGetAttributes,
    cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    entries, name = {}, None  # each instantiation's spill and register lines
    for ln in _kernels.BUILD_LOG.get("gf2_ge", "").splitlines():
        if "Compiling entry" in ln:
            name = ln
            entries[name] = []
        elif name and ("spill" in ln or "registers" in ln):
            entries[name].append(ln.strip().replace("ptxas info    : ", ""))
    spilling = sum(1 for v in entries.values()
                   if any("spill" in x and not x.startswith("0 bytes stack")
                          for x in v))
    log(f"GE gf2_ge.cu: {len(entries)} kernel instantiations, {spilling} "
        "with a stack frame or spills (ptxas -v)")
    for label, m, n, plan in plans:
        tag = (f"ge_kernelILi{plan.words}ELi{plan.cols}"
               f"ELb{1 if plan.mode == 'warp' else 0}E")
        ptx = " | ".join(next((v for k, v in entries.items() if tag in k), []))
        occ = gf2_bitpack.ge_occupancy(plan, m, n, torch.cuda.current_device())
        log(f"GE launch shape {label} ({m} x {n}): {plan.mode} mode, "
            f"ge_kernel<{plan.words}, {plan.cols}, "
            f"{'true' if plan.mode == 'warp' else 'false'}>, {plan.threads} "
            f"threads a block, {occ['registers']} registers and "
            f"{occ['local_bytes']} local bytes a thread, "
            f"{occ['static_smem_bytes']} static shared bytes, "
            f"{occ['blocks_per_sm']} resident block(s) = "
            f"{occ['frames_per_sm']} frames per SM on {occ['sms']} SMs; "
            f"ptxas: {ptx}")


def ge_host_breakdown(dev, perm, h, k, reps: int = 200):
    """Host microseconds a call of the perm-load wrapper spends before its
    kernel runs, split by part (perf_counter over ``reps`` calls; the
    kernels queue behind, so no part waits on the card)."""
    b, n = perm.shape
    m = h.shape[0]
    hcol = tables.get(h, gf2_bitpack._packed_h_columns, dev)
    plan = gf2_bitpack.ge_plan(b, m, n)
    out = torch.empty((b, m, k), dtype=torch.int8, device=dev)
    order = torch.empty((b, n), dtype=torch.int32, device=dev)
    lib = _kernels.library("gf2_ge")
    args = (perm.data_ptr(), hcol.data_ptr(), hcol.shape[1], 0,
            out.data_ptr(), order.data_ptr(), b, m, n, n - k, 0, plan.words,
            plan.cols, plan.threads, plan.grid, _kernels.stream_handle(dev))

    def per_call(fn):
        synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        us = (time.perf_counter() - t0) * 1e6 / reps
        synchronize(dev)
        return us

    parts = {
        "reduce_from_perm": per_call(
            lambda: gf2_bitpack.reduce_from_perm(perm, h, k)),
        "packed_h_columns": per_call(
            lambda: tables.get(h, gf2_bitpack._packed_h_columns, dev)),
        "ge_plan": per_call(lambda: gf2_bitpack.ge_plan(b, m, n)),
        "two torch.empty": per_call(lambda: (
            torch.empty((b, m, k), dtype=torch.int8, device=dev),
            torch.empty((b, n), dtype=torch.int32, device=dev))),
        "library + stream handle": per_call(lambda: (
            _kernels.library("gf2_ge"), _kernels.stream_handle(dev))),
        "ge_launch (ctypes + launch)": per_call(lambda: lib.ge_launch(*args)),
    }
    rest = parts["reduce_from_perm"] - sum(
        v for key, v in parts.items() if key != "reduce_from_perm")
    log("GE wrapper host work per call (us): " + ", ".join(
        f"{key} {v:.2f}" for key, v in parts.items())
        + f", the rest (checks, the int64 view, the count) {rest:.2f}")


def ge_row(dev, code, perm):
    """The GE kernel: the main path's perm load (the captured rows' sort
    over h_osd), the same rows as a dense batch with columns duplicated
    across word edges (forced column swaps), the other codes' h_osd under
    random permutations, the rank-deficient raw H of the array codes and
    WiMAX's h_osd with six rows duplicated (held to the twin alone; one
    input a mode), each plan's launch shape, every shape timed against its
    bound, the wrapper's host work, then the timed row."""
    h, k = code.h_osd, code.k
    ge_check("main path (perm load)", perm, h, k)
    forced = gf2ops.permute_columns(perm, h)
    for src in (5, 30, 62, 94):  # early, and across each word edge
        forced[:, :, src + 1] = forced[:, :, src]
    ge_check("main path, duplicated columns (dense load)", h_batch=forced, k=k)
    del forced
    gen = torch.Generator(device=dev).manual_seed(8)
    for name, frames in GE_CODES:
        other = get_code(name)
        p = torch.argsort(torch.rand((frames, other.n), generator=gen,
                                     device=dev), dim=1)
        ge_check(f"{name} h_osd", p, other.h_osd, other.k)
    for name in ("array_121_60", "array_121_80"):  # block, warp mode
        other = get_code(name)
        p = torch.argsort(torch.rand((4096, other.n), generator=gen,
                                     device=dev), dim=1)
        ge_check(f"{name} raw H", p, other.h, other.n - other.h.shape[0],
                 dense_too=False)
    wimax = get_code("wimax_1056_880")
    dup = wimax.h_osd.copy()
    dup[120:126] = dup[0:6]  # rank 170 of 176 rows: six steps with neither
    p = torch.argsort(torch.rand((1024, wimax.n), generator=gen, device=dev),
                      dim=1)
    ge_check("wimax_1056_880 h_osd with rows 0-5 copied onto 120-125 "
             "(dense load, block mode, rank-deficient)",
             h_batch=gf2ops.permute_columns(p, dup), k=wimax.k,
             dense_too=False)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    b, n = perm.shape
    m = h.shape[0]
    plans = [("main path", m, n, gf2_bitpack.ge_plan(b, m, n))]
    for name in ("qc_96_48", "wimaxlike_384_192", "wimax_1056_880"):
        hm, hn = get_code(name).h_osd.shape
        plans.append((name, hm, hn, gf2_bitpack.ge_plan(1, hm, hn)))
    hm, hn = get_code("array_121_60").h.shape
    plans.append(("array_121_60 raw H", hm, hn, gf2_bitpack.ge_plan(1, hm, hn)))
    ge_build_lines(plans)

    fn = lambda: gf2_bitpack.reduce_from_perm(perm, h, k)  # noqa: E731
    main = ge_time("main path", fn, b, m, n, k, "perm")
    dense = gf2ops.permute_columns(perm, h)
    ge_time("main path (osd/path.py's route)",
            lambda: gf2_bitpack.reduce_dense(dense, k), b, m, n, k, "dense")
    del dense
    shapes = []
    for name, frames in GE_TIMED:
        other = get_code(name)
        p = torch.argsort(torch.rand((frames, other.n), generator=gen,
                                     device=dev), dim=1)
        hm = other.h_osd.shape[0]
        shapes.append(ge_time(
            f"{name} h_osd",
            lambda: gf2_bitpack.reduce_from_perm(p, other.h_osd, other.k),
            frames, hm, other.n, other.k, "perm"))
        del p
        torch.cuda.empty_cache()
    ge_host_breakdown(dev, perm, h, k)
    row = {
        "name": "GE ge_packed", "route": "cuda",
        "source": "short_ldpc_decoding_osd_tpu_torch/csrc/gf2_ge.cu",
        # not a Pallas kernel: JAX runs the packed GE in XLA
        "replaces": "short_ldpc_decoding_osd_tpu/ops/gf2_bitpack.py:143",
        "launches": None, "max_abs_err": 0,
        "ms": cuda_ms(fn, 20),
        "back_to_back_ms": main["back_to_back_ms"],
        "plain_ms": cuda_ms(lambda: gf2_bitpack._reduce_perm_plain(perm, h, k),
                            3, warmup=1),
        "dense_route_ms": cuda_ms(lambda: gf2ops.batched_row_reduce(
            gf2ops.permute_columns(perm, h)), 3, warmup=1),
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        # no single PyTorch call computes a GF(2) elimination
        "library_ms": None,
        "shape": f"perm ({b}, {n}) int64 over h_osd ({m}, {n}) -> tail "
                 f"({b}, {m}, {k}) int8 + col_order ({b}, {n}) int32",
        "other_shapes": shapes,
    }
    log(f"GE ge_packed: kernel {row['ms']:.4f} ms through the wrapper, "
        f"{row['back_to_back_ms']:.4f} ms back to back, plain packed twin "
        f"{row['plain_ms']:.4f} ms, dense route {row['dense_route_ms']:.4f} ms,"
        f" bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return row


def nms_r_redecode(dev, run, cap):
    """NMS-r's phase-2 re-decode at 4,096 captured CCSDS rows with the
    trained NMS-r weights of ``runs/r5_variants_nmsr``: the step's route is
    NMS-r's edge kernel, and against the padded edge layout and the dense
    decoder (other f32 orders) its detected flags are identical and its
    last-iteration hard decisions differ on at most 4 frames (the padded
    layout's gate in ``phase_padded``).  The trajectory error is logged:
    over 12 NMS-r iterations on failing frames the f32 summation orders
    drift apart (1.06e-2 relative to the largest output between the padded
    and the dense route on an H100, 4.5e-3 on the CPU), and a soft value
    near 0 can change sign."""
    code = run["code"]
    llr = cap["llr"][:4096].contiguous()
    labels = cap["labels"][:4096]
    trained = load_jax_pickle(os.path.join(ROOT, "runs", "r5_variants_nmsr",
                                           "nms_params.pkl"))
    params = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32)
              for k, v in trained.items()}
    route = engine.redecode_route(code.h, "NMS-r", llr.device, llr.shape[0])
    if route != "edge":
        raise AssertionError(f"NMS-r re-decode at 4096 rows took {route!r}")
    trajs = {r: engine.redecode_trajectory(params, code.h, llr, ITERS, "NMS-r", r)
             for r in ("edge", "edge_padded", "dense")}
    for other in ("edge_padded", "dense"):
        got, ref = trajs["edge"], trajs[other]
        diff = (got - ref).abs()
        rel = float(diff.max() / ref.abs().max().clamp(min=1.0))
        beyond = int((diff > 1e-3 * ref.abs().clamp(min=1.0)).sum())
        det = [nms.frame_stats(t[-1], labels, code.h)["detected_failure"]
               for t in (got, ref)]
        frames_differ = int(((got[-1] < 0) != (ref[-1] < 0)).any(1).sum())
        same_det = torch.equal(*det)
        log(f"NMS-r re-decode, {llr.shape[0]} captured CCSDS rows, trained "
            f"weights: route {route}; kernel vs {other} trajectory error "
            f"{rel:.3g} relative to the largest output ({beyond} of "
            f"{diff.numel()} values beyond 1e-3 of their own size, "
            f"{int(((got < 0) != (ref < 0)).sum())} sign flips over all "
            f"{ITERS + 1} slots); frames whose last-iteration hard decisions "
            f"differ: {frames_differ}; detected flags equal {same_det} "
            f"({int(det[0].sum())} detected)")
        if not (same_det and frames_differ <= 4):
            raise AssertionError(f"NMS-r re-decode: the kernel and {other} differ")


def nmsr_kernel_rows(dev, llr, cap):
    """NMS-r's edge kernels at the main path's shapes, the final output of
    the 262,144-frame sample and the trajectory of its 32,768 captured
    rows, with the trained NMS-r weights of ``runs/r5_variants_nmsr``: each
    bit for bit against its plain twin and against the benchmark's plain
    reference (``gpubench/reference/variants/NMS-r.py``, the judge), the
    largest gap to the reference over every row, ties included, and the
    rows the reference finds near a tie logged; against the padded edge
    layout (another f32 order) its last hard decisions differ on at most
    1 frame in 1,000 and its detected flags likewise; each timed by CUDA
    events beside the twin and the padded layout, against
    ``gpubench.roofline_nmsr``'s least work.  Returns the kernel rows."""
    from gpubench import core as bench_core, roofline_nmsr
    from gpubench.reference import codes as ref_codes, decode as ref_decode

    code = get_code("ccsds_128_64")
    trained = load_jax_pickle(os.path.join(ROOT, "runs", "r5_variants_nmsr",
                                           "nms_params.pkl"))
    params = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32)
              for k, v in trained.items()}
    weights = nms_edge.nmsr_weights(params)
    judge = bench_core.decoder("NMS-r")
    ref = {"tables": ref_decode.Tables(code.h, *ref_codes.edges(code.h), dev),
           "weights": judge.weights(trained)}
    rows = []
    for name, traj, x, shape in (
            ("K1r nmsr_edge_final", False, llr,
             f"llr ({CAP_B}, 128) f32 -> ({CAP_B}, 128), T=12"),
            ("K2r nmsr_edge_traj", True, cap["llr"].contiguous(),
             f"llr ({CAP}, 128) f32 -> (13, {CAP}, 128)")):
        fn = nms_edge.decode_traj_edge if traj else nms_edge.decode_final_edge
        padded_fn = (nms_edge_padded.decode_edge_padded if traj
                     else nms_edge_padded.decode_final_edge_padded)
        got = fn(params, code.h, x, ITERS, "NMS-r")
        twin = nms_edge._decode_nmsr_plain(x, code.h, ITERS, weights, traj)
        slots = set(range(ITERS + 1)) if traj else {ITERS}
        soft, crossed = judge.decode_rows(x, ref, ITERS, slots)
        want = (torch.stack([soft[i] for i in range(ITERS + 1)]) if traj
                else soft[ITERS])
        padded = padded_fn(params, code.h, x, ITERS, "NMS-r")
        last = [t[-1] if traj else t for t in (got, want, padded)]
        bits = [torch.equal(got.view(torch.int32), t.view(torch.int32))
                for t in (twin, want)]
        gap_ref = float(((got - want).abs() / (1.0 + want.abs())).max())
        gap_pad = ((got - padded).abs() / (1.0 + padded.abs()))
        labels = torch.zeros_like(last[0], dtype=torch.int32)
        det = [nms.frame_stats(t, labels, code.h)["detected_failure"]
               for t in (last[0], last[2])]
        frames_differ = int(((last[0] < 0) != (last[2] < 0)).any(1).sum())
        det_differ = int((det[0] != det[1]).sum())
        b = x.shape[0]
        log(f"{name}: == twin {bits[0]}, == reference {bits[1]} (largest gap "
            f"to the reference {gap_ref:.3g} over all {b} rows, "
            f"{int(crossed.sum())} near a tie); against the padded layout: "
            f"gap {float(gap_pad.max()):.3g} (median "
            f"{float(gap_pad.median()):.3g}), last hard decisions differ on "
            f"{frames_differ} frames, detected flags on {det_differ}")
        if not all(bits):
            raise AssertionError(f"{name}: kernel differs from its twin or the "
                                 "reference")
        if max(frames_differ, det_differ) > b // 1000:
            raise AssertionError(f"{name}: kernel and padded layout part on "
                                 f"{frames_differ} / {det_differ} frames")
        del got, twin, soft, want, padded, last, gap_pad
        torch.cuda.empty_cache()
        n_slots = ITERS + 1 if traj else 1
        ops = roofline_nmsr.decode_ops(code.h, b * ITERS, b)
        ms, bound_by = bound_ms(4 * b * code.n * (1 + n_slots), ops / F32_INSTR)
        row = {
            "name": name, "route": "cuda",
            "source": "short_ldpc_decoding_osd_tpu_torch/csrc/nms_edge.cu",
            "replaces": "ops/nms_edge_padded._check_update_neural_edge (no TPU "
                        "kernel: JAX decodes NMS-r in XLA)",
            "launches": None, "max_abs_err": 0.0, "reference_gap": gap_ref,
            "ms": cuda_ms(lambda: fn(params, code.h, x, ITERS, "NMS-r"), 20),
            "plain_ms": cuda_ms(lambda: nms_edge._decode_nmsr_plain(
                x, code.h, ITERS, weights, traj), 3, warmup=1),
            "padded_ms": cuda_ms(lambda: padded_fn(params, code.h, x, ITERS,
                                                   "NMS-r"), 2, warmup=1),
            "bound_ms": ms, "bound_by": bound_by, "library_ms": None,
            "shape": shape,
        }
        log(f"{name}: kernel {row['ms']:.4f} ms, twin {row['plain_ms']:.4f} ms, "
            f"padded {row['padded_ms']:.4f} ms, bound {ms:.4f} ms ({bound_by}; "
            f"{100 * ms / row['ms']:.2f}% of it)")
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


def phase_kernels(dev):
    run, params, llr, cap, refined, prep, u_l, t_flat, layout = \
        main_path_inputs(dev)
    code = run["code"]
    weights = nms.scalar_weights(params, "NMS-1")
    rows = []

    def edge_row(name, traj, source_line, x, h_batch_note):
        fn = nms_edge.decode_traj_edge if traj else nms_edge.decode_final_edge
        got = fn(params, code.h, x, ITERS)
        want = nms_edge._decode_edge_plain(x, code.h, ITERS, weights, traj)
        err = compare(name, got, want)
        if not torch.equal(got, want):  # the shared body keeps it bit-exact
            raise AssertionError(f"{name}: kernel differs from its plain twin")
        # the irregular qc_96_48 code (check degrees {6, 7}, dummy edges)
        qc = get_code("qc_96_48")
        xq = torch.randn((4096, qc.n), generator=torch.Generator(device=dev)
                         .manual_seed(3), device=dev) * 0.8 + 1.0
        got_q = fn(params, qc.h, xq, ITERS)
        want_q = nms_edge._decode_edge_plain(xq, qc.h, ITERS, weights, traj)
        err = max(err, compare(name + " qc_96_48", got_q, want_q))
        if not torch.equal(got_q < 0, want_q < 0):
            raise AssertionError(f"{name} qc_96_48: hard decisions differ")
        b = x.shape[0]
        slots = ITERS + 1 if traj else 1
        nbytes = 4 * b * code.n * (1 + slots)
        ms, bound_by = bound_ms(nbytes, nms_edge_ops(code.h, b, ITERS) / F32_INSTR)
        row = {
            "name": name, "route": "cuda",
            "source": "short_ldpc_decoding_osd_tpu_torch/csrc/nms_edge.cu",
            "replaces": source_line,
            "launches": None, "max_abs_err": err,
            "ms": cuda_ms(lambda: fn(params, code.h, x, ITERS), 20),
            "plain_ms": cuda_ms(lambda: nms_edge._decode_edge_plain(
                x, code.h, ITERS, weights, traj), 5, warmup=1),
            "bound_ms": ms, "bound_by": bound_by, "library_ms": None,
            "shape": h_batch_note,
        }
        log(f"{name}: max_abs_err {err:.3g}, kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, bound {ms:.4f} ms ({bound_by})")
        rows.append(row)

    edge_row("K1 nms_edge_final", False,
             "short_ldpc_decoding_osd_tpu/ops/nms_edge_pallas.py:330",
             llr, f"llr ({CAP_B}, 128) f32 -> ({CAP_B}, 128), T=12")
    edge_row("K2 nms_edge_traj", True,
             "short_ldpc_decoding_osd_tpu/ops/nms_edge_pallas.py:406",
             cap["llr"].contiguous(), f"llr ({CAP}, 128) f32 -> (13, {CAP}, 128)")

    rows.append(k5_row(dev, run, prep, u_l, t_flat, layout))
    rows.append(ge_row(dev, code, torch.sort(refined.abs(), dim=1,
                                             stable=True).indices))
    rows += nmsr_kernel_rows(dev, llr, cap)
    nms_r_redecode(dev, run, cap)

    # the GPU's prepare (stable sort, the GE kernel) bit-exact against the
    # same function on the CPU (the dense GE route)
    ref = engine.prepare(*(t[:4096].cpu() for t in (
        refined, cap["llr"], cap["labels"])), code.h_osd, code.k)
    for field in ("order_updated", "order_original", "order_labels", "m_matrix",
                  "swap_len", "lrb_ranks", "hard_original", "hard_updated",
                  "mag_original"):
        if not torch.equal(getattr(prep, field)[:4096].cpu(), getattr(ref, field)):
            raise AssertionError(f"prepare.{field}: GPU differs from CPU")
    compare("prepare.truth_discrepancy", prep.truth_discrepancy[:4096].cpu(),
            ref.truth_discrepancy, rel=True)
    log("prepare: GPU == CPU bit for bit on 4096 captured rows")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return rows


def set_launches(rows, launches, keys):
    for row in rows:
        if LAUNCH_KEY[row["name"]] in keys:
            row["launches"] = launches[LAUNCH_KEY[row["name"]]]


def mc_row(name, fn, plain, err, ops, nbytes, shape):
    """A fused Monte-Carlo kernel's row: ``fn``/``plain`` run the kernel and
    its plain twin at 2,097,152 frames; ``ops`` f32 instructions and
    ``nbytes`` compulsory bytes give the bound."""
    bms, bound_by = bound_ms(nbytes, ops / F32_INSTR)
    row = {
        "name": name, "route": "cuda",
        "source": "short_ldpc_decoding_osd_tpu_torch/csrc/mc_fused.cu",
        "replaces": {
            "K3": "short_ldpc_decoding_osd_tpu/ops/nms_edge_pallas.py:691",
            "K4": "short_ldpc_decoding_osd_tpu/ops/nms_edge_pallas.py:497",
            "K8a": "short_ldpc_decoding_osd_tpu/ops/mc_cascade.py:125",
            "K8b": "short_ldpc_decoding_osd_tpu/ops/mc_cascade.py:158",
        }[name.split()[0]],
        "launches": None, "max_abs_err": err,
        "ms": cuda_ms(fn, 10),
        "plain_ms": cuda_ms(plain, 2, warmup=1),
        "bound_ms": bms, "bound_by": bound_by,
        # no single PyTorch call computes a fused Monte-Carlo step
        "library_ms": None,
        "shape": shape,
    }
    log(f"{name}: max_abs_err {err}, kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, bound {bms:.4f} ms ({bound_by})")
    return row


def phase_mc_kernels(dev):
    """K4, K3, K8a and K8b against their plain twins at 262,144 frames
    (counters equal, or within 2 frames with the reason printed), then
    timed at 2,097,152 frames: NMS-1 at its initial factor, 12 iterations,
    3.0 dB, as the phase-1 path runs them."""
    code = get_code("ccsds_128_64")
    params = nms.init_params("NMS-1")
    h, t1, seed = code.h, 4, 11
    mc = nms_edge.mc_setup(code, params, "NMS-1", 3.0, seed, dev)
    big = PH1_BATCH
    rows = []

    # K4
    for stage in (False, True):
        log_launch_shape("ccsds_128_64", mc, stage)
    err = counters_err("K4", nms_edge.fused_counters_edge(
        code, params, "NMS-1", ITERS, 3.0, MC_B, seed, device=dev),
        nms_edge._mc_frames_plain(mc, ITERS, MC_B)[0][:5])
    rows.append(mc_row(
        "K4 mc_oneshot",
        lambda: nms_edge.fused_counters_edge(code, params, "NMS-1", ITERS, 3.0,
                                             big, seed, device=dev),
        lambda: nms_edge._mc_frames_plain(mc, ITERS, big),
        err, nms_edge_ops(h, big, ITERS), 8 * 5,
        f"{big} hash frames, T={ITERS} -> (5,) int64"))
    # T = 0 (sample, encode, one column sum, count) splits the iterations off
    k4_split("ccsds_128_64", code, params, 3.0, big, seed, dev)

    # K8a: the unconverged share at t1 of the 2M frames sizes K3's and K8's
    # bounds (work that depends on the data is counted as this data needs)
    c1_big, flags_big = mc_cascade.phase1(mc, t1, big)
    unconv_big = big - int(c1_big[0])
    log(f"unconverged at t1={t1}: {unconv_big} of {big} frames "
        f"({unconv_big / big:.5f})")
    c1k, fk = mc_cascade.phase1(mc, t1, MC_B)
    c1p, fp, _ = nms_edge._mc_frames_plain(mc, t1, MC_B, stage=True)
    flag_diff = int((fk != fp).sum())
    err = max(counters_err("K8a", c1k, c1p[:5]), flag_diff)
    if flag_diff > 2:
        raise AssertionError(f"K8a: {flag_diff} per-frame flags differ")
    # the messages K3's first stage saves for its unconverged frames, which
    # its next launch resumes from: the twin's, row for row
    _, sk, mk = nms_edge._mc_frames_kernel(mc, t1, MC_B, stage=True, keep=True)
    _, sp, mp = nms_edge._mc_frames_plain(mc, t1, MC_B, stage=True, keep=True)
    saved = (sk != 0) & (sp != 0)
    row_diff = int((sk != sp).sum()) + int((mk[saved] != mp[saved]).any(1).sum())
    log(f"K3 saved messages: {int(saved.sum())} unconverged frames at t1={t1} of "
        f"{MC_B}, {row_diff} rows differ from the twin's")
    if row_diff > 2:
        raise AssertionError(f"K3 saved messages: {row_diff} rows differ")
    del sk, mk, sp, mp, saved
    rows.append(mc_row(
        "K8a cascade_p1", lambda: mc_cascade.phase1(mc, t1, big),
        lambda: nms_edge._mc_frames_plain(mc, t1, big, stage=True),
        err, edge_ops(h, big * t1, big), 4 * big,
        f"{big} hash frames, t1={t1} -> (5,) int64 + flags ({big},) int32"))

    # K8b on the ids the cascade would hand it
    frac = unconv_big / big
    ids_small = mc_cascade.fixed_capacity_ids(
        fk, mc_cascade.capacity(1 - int(c1k[0]) / MC_B, MC_B, 512))
    err = counters_err("K8b", mc_cascade.phase2(mc, ITERS, ids_small),
                       nms_edge._mc_frames_plain(mc, ITERS, len(ids_small),
                                                 ids_small)[0][:5])
    ids_big = mc_cascade.fixed_capacity_ids(
        flags_big, mc_cascade.capacity(frac, big, 512))
    rows.append(mc_row(
        "K8b cascade_p2", lambda: mc_cascade.phase2(mc, ITERS, ids_big),
        lambda: nms_edge._mc_frames_plain(mc, ITERS, len(ids_big), ids_big),
        err, edge_ops(h, unconv_big * ITERS, unconv_big), 4 * len(ids_big),
        f"ids ({len(ids_big)},) int32 ({unconv_big} flagged, -1 padded), "
        f"T={ITERS} -> (5,) int64"))
    del flags_big, ids_big

    # K3: bench's schedule, the harness's default, one that overflows and a
    # two-stage one, each against the literal rule
    err = 0
    with profiling.recording(record=profiling.Record()) as rec:
        for schedule, block in ((((t1, 0.375),), 1024),
                                (nms_edge.DEFAULT_COMPACT_SCHEDULE, 512),
                                (((t1, 0.25),), 1024),
                                (((t1, 0.5), (2, 0.25)), 512)):
            rows_s, final = nms_edge.build_rows_schedule(schedule, block, ITERS)
            got = nms_edge.fused_counters_edge_compact(
                code, params, "NMS-1", ITERS, 3.0, MC_B, seed,
                block_frames=block, schedule=schedule, device=dev)
            want = nms_edge._compact_plain(mc, MC_B, block, rows_s, final)
            err = max(err, counters_err(f"K3 {schedule} / {block}", got, want))
            log(f"K3 {schedule} in groups of {block}: {got.tolist()} "
                f"(overflow {int(got[5])})")
            if schedule == ((t1, 0.25),) and not int(got[5]) > 0:
                raise AssertionError("K3: the small capacity did not overflow")
    encode_counters("ccsds_128_64", mc, rec, launches=9)
    rows_s, final = nms_edge.build_rows_schedule(((t1, 0.375),), 1024, ITERS)
    rows.append(mc_row(
        "K3 mc_compact",
        lambda: nms_edge.fused_counters_edge_compact(
            code, params, "NMS-1", ITERS, 3.0, big, seed, block_frames=1024,
            schedule=((t1, 0.375),), device=dev),
        lambda: nms_edge._compact_plain(mc, big, 1024, rows_s, final),
        err, edge_ops(h, big * t1 + unconv_big * (ITERS - t1), big + unconv_big),
        8 * 6, f"{big} hash frames, groups of 1024, schedule ((4, 384),), "
               f"T={ITERS} -> (6,) int64"))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return rows


def log_launch_shape(name, mc, stage):
    """One line per launch shape of ``mc_frames``: the plan and what the
    card makes of it (registers, spills, shared bytes, resident blocks, G's
    encode tables in shared memory or read from global memory)."""
    plan = mc.plan
    occ = nms_edge.mc_occupancy(plan, mc.k, stage, mc.encode.numel(),
                                mc.device.index or 0)
    dc, dv = nms_edge.BUCKETS[plan.bucket][:2]
    where = "shared" if occ["table_shared"] else "global"
    split = ""
    if plan.bucket == nms_edge.SPLIT_BUCKET:
        split = (f", split: {nms_edge.split_lanes(mc.h)} segment lanes of "
                 f"{nms_edge.SPLIT_SLOTS} slots")
    log(f"mc_frames launch shape, {name} {'STAGE' if stage else 'COUNT'}: "
        f"bucket {plan.bucket} (dc <= {dc}, dv <= {dv}{split}), "
        f"{plan.warps} warp(s) a frame, {plan.frames} frames a block "
        f"({occ['threads']} threads), "
        f"{occ['registers']} registers and {occ['local_bytes']} local bytes a "
        f"thread, {occ['smem_bytes']} shared bytes a block, "
        f"{occ['blocks_per_sm']} resident blocks per SM "
        f"({occ['blocks_per_sm'] * plan.frames} frames) on {occ['sms']} SMs; "
        f"G's encode tables ({4 * mc.encode.numel()} bytes: "
        f"{mc.h.shape[1] - mc.parity_columns} unit columns, "
        f"{mc.parity_columns} parity columns) in {where} memory")


def encode_counters(name, mc, rec, launches: int):
    """The encode's counters of ``launches`` ``mc_frames`` launches recorded
    in ``rec``: G's unit columns and the others, once a launch."""
    n, p = mc.h.shape[1], mc.parity_columns
    got = rec.snapshot()["counters"]
    bits, encoded = got.get("mc.columns_as_bit"), got.get("mc.columns_encoded")
    log(f"{name} encode counters over {launches} mc_frames launches: "
        f"mc.columns_as_bit {bits}, mc.columns_encoded {encoded}, share read "
        f"as a bit {bits / (bits + encoded):.4f} ({n - p} of {n})")
    if (bits, encoded) != (launches * (n - p), launches * p):
        raise AssertionError(f"{name}: encode counters {got}, want "
                             f"{launches} x ({n - p}, {p})")


def k4_split(name, code, params, snr, batch, seed, dev):
    """K4 at T = 0 (sample, encode, one column sum, count) against K4 at
    T = ITERS: the fixed work of a frame against its iterations."""
    t0_ms = cuda_ms(lambda: nms_edge.fused_counters_edge(
        code, params, "NMS-1", 0, snr, batch, seed, device=dev), 10)
    k4_ms = cuda_ms(lambda: nms_edge.fused_counters_edge(
        code, params, "NMS-1", ITERS, snr, batch, seed, device=dev), 10)
    log(f"K4 split {name} at {batch} frames, {snr} dB: T=0 {t0_ms:.4f} ms, "
        f"T={ITERS} {k4_ms:.4f} ms: sampling, encode and counting "
        f"{100 * t0_ms / k4_ms:.1f}%, {(k4_ms - t0_ms) / ITERS:.4f} ms an "
        "iteration")
    return t0_ms, k4_ms


def phase_mc_other_codes(dev):
    """K4 and K3 (default schedule, groups of 512) against their plain twins
    on the irregular qc_96_48 (check degrees {6, 7}: dummy edges) and on
    wimax_1056_880 (dc 20, n 1,056: a frame on a group of warps), so that
    every degree bucket of the packaged codes launches in an MC kernel; K1
    and K2 bit for bit against their twin on the extended matrices ENMS
    decodes on (buckets 3 and 4)."""
    params = nms.init_params("NMS-1")
    weights = nms.scalar_weights(params, "NMS-1")
    for name in ("qc_96_48", "wimaxlike_384_192", "wimax_1056_880"):
        h_ext = get_code(name).extended().h
        x = torch.randn((1024, h_ext.shape[1]), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(3)) + 1.0
        plan = nms_edge.matrix_plan(h_ext)
        for traj, fn in ((False, nms_edge.decode_final_edge),
                         (True, nms_edge.decode_traj_edge)):
            if not torch.equal(fn(params, h_ext, x, ITERS),
                               nms_edge._decode_edge_plain(x, h_ext, ITERS,
                                                           weights, traj)):
                raise AssertionError(f"K{2 if traj else 1} on the extended "
                                     f"{name} differs from its plain twin")
        log(f"K1, K2 on the extended {name} {h_ext.shape} (bucket "
            f"{plan.bucket}, {plan.warps} warps a frame): bit for bit with "
            "their twin")
    for name, snr, batch in (("qc_96_48", 3.0, 65_536),
                             ("wimax_1056_880", 3.75, 8192)):
        code = get_code(name)
        mc = nms_edge.mc_setup(code, params, "NMS-1", snr, 5, dev)
        for stage in (False, True):
            log_launch_shape(name, mc, stage)
        k4 = nms_edge.fused_counters_edge(code, params, "NMS-1", ITERS, snr,
                                          batch, 5, device=dev)
        counters_err(f"K4 {name}", k4,
                     nms_edge._mc_frames_plain(mc, ITERS, batch)[0][:5])
        rows_s, final = nms_edge.build_rows_schedule(
            nms_edge.DEFAULT_COMPACT_SCHEDULE, 512, ITERS)
        with profiling.recording(record=profiling.Record()) as rec:
            k3 = nms_edge.fused_counters_edge_compact(
                code, params, "NMS-1", ITERS, snr, batch, 5, block_frames=512,
                schedule=nms_edge.DEFAULT_COMPACT_SCHEDULE, device=dev)
        counters_err(f"K3 {name}", k3,
                     nms_edge._compact_plain(mc, batch, 512, rows_s, final))
        log(f"{name} {snr} dB, {batch} frames: K4 {k4.tolist()}, K3 "
            f"{k3.tolist()} (overflow {int(k3[5])}), both equal to their twins")
        encode_counters(name, mc, rec, launches=2)
        # G's encode tables read from global memory, where a code's tables
        # would not fit beside its frames: the same counters
        with patched(nms_edge, "mc_occupancy", lambda occ: lambda *a: {
                **occ(*a), "table_shared": 0}):
            k4g = nms_edge.fused_counters_edge(code, params, "NMS-1", ITERS,
                                               snr, batch, 5, device=dev)
            k3g = nms_edge.fused_counters_edge_compact(
                code, params, "NMS-1", ITERS, snr, batch, 5, block_frames=512,
                schedule=nms_edge.DEFAULT_COMPACT_SCHEDULE, device=dev)
        if not (torch.equal(k4g, k4) and torch.equal(k3g, k3)):
            raise AssertionError(f"{name}: K4/K3 with G's encode tables in "
                                 f"global memory {k4g.tolist()} / "
                                 f"{k3g.tolist()}")
        log(f"{name}: K4 and K3 with G's encode tables read from global "
            "memory equal to the shared-memory runs")
        if name == "wimax_1056_880":
            # the wimax-phase1-4.0dB cell's step size and SNR
            k4_split(name, code, params, 4.0, 262_144, 5, dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


ENMS_RUN = os.path.join(ROOT, "runs", "r29_enms_wimax")


SPLIT_SIGMA = float(np.float32(0.8))  # K7's channel on the split mask


def split_mask(n: int = 60) -> np.ndarray:
    """A synthetic (12, n) mask of the split bucket: rows of degree 40,
    36, 30, 24, 22 and 21 (twice), each on two lanes, beside rows of 20
    (twice), 16, 12 and 8 on one; each row's columns run on from the
    previous row's (mod n), so a column has degree 4 or 5."""
    degrees = [40, 21, 36, 24, 22, 30, 20, 8, 12, 20, 16, 21]
    h = np.zeros((len(degrees), n), np.uint8)
    col = 0
    for row, d in enumerate(degrees):
        h[row, (col + np.arange(d)) % n] = 1
        col += d
    return h


def split_mask_kernels(dev, batch: int = 65_536):
    """K1, K6 and K7 at the split bucket on :func:`split_mask`: K1 and K6
    bit for bit against their twins (the dense rung builds its lane map on
    the card), K7's counters against its twin's (G of zeros: the all-zero
    codeword), ``split.frames`` a launch."""
    h = split_mask()
    plan = nms_edge.matrix_plan(h)
    if plan.bucket != nms_edge.SPLIT_BUCKET:
        raise AssertionError(f"split mask: plan {plan}")
    params = nms.init_params("NMS-1")
    weights = nms.scalar_weights(params, "NMS-1")
    x = torch.randn((batch, h.shape[1]), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(5)) + 1.0
    mask = torch.tensor(h, dtype=torch.float32, device=dev)
    g = torch.zeros((8, h.shape[1]), dtype=torch.float32, device=dev)
    with profiling.recording(record=profiling.Record()) as rec:
        k1 = nms_edge.decode_final_edge(params, h, x, ITERS)
        k6 = nms_dense.decode_final_dense(params, mask, x, ITERS)
        k7 = mc_dense.mc_fused(weights, 9, mask, g, ITERS, batch, SPLIT_SIGMA)
    if not torch.equal(k1, nms_edge._decode_edge_plain(x, h, ITERS, weights,
                                                       False)):
        raise AssertionError("K1 on the split mask differs from its twin")
    if not torch.equal(k6, nms_dense._decode_dense_plain(mask, x, ITERS,
                                                         weights)):
        raise AssertionError("K6 on the split mask differs from its twin")
    counters_err("K7 split mask", k7, mc_dense._mc_dense_plain(
        weights, 9, mask, g, ITERS, batch, SPLIT_SIGMA, 1.0))
    frames = rec.snapshot()["counters"].get("split.frames")
    if frames != 3 * batch:
        raise AssertionError(f"split mask: split.frames {frames}")
    log(f"split mask {h.shape} (bucket {plan.bucket}, "
        f"{nms_edge.split_lanes(h)} lanes, {plan.warps} warp(s) a frame): K1 "
        f"and K6 bit for bit with their twins, K7 {k7.tolist()} with its "
        f"twin's; split.frames {frames}")


def phase_enms_wimax(dev, batch: int = 65_536, timed: int = 262_144):
    """K4 and K3 on the matrix ENMS decodes WiMAX (1056,880) on, its
    extended H (220 x 1,056: 176 checks of degree 20, 44 of degree 36;
    the split bucket, each check of 36 on two lanes), at the
    wimax-enms-phase1-4.0dB cell's SNR, groups and schedule: their launch
    shapes, K4 and K3 against their plain twins (K3 against the literal
    rule and against the chain of STAGE, rank and resumed COUNT twins)
    counter for counter, ``enms.frames`` and ``split.frames`` a launch,
    and both timed at the cell's 262,144 frames against their bound; then
    :func:`split_mask_kernels`.  The weights are ``runs/r29_enms_wimax``'s
    where it holds them, else ENMS's initial ones."""
    code = get_code("wimax_1056_880")
    if os.path.exists(os.path.join(ENMS_RUN, "nms_params.pkl")):
        params = {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in
                  load_jax_pickle(os.path.join(ENMS_RUN, "nms_params.pkl")).items()}
        label = "r29_enms_wimax weights"
    else:
        params, label = nms.init_params("ENMS"), "initial weights"
    snr, block, seed = 4.0, 512, 7
    mc = nms_edge.mc_setup(code, params, "ENMS", snr, seed, dev)
    if (mc.h.shape != code.extended().h.shape
            or mc.plan.bucket != nms_edge.SPLIT_BUCKET):
        raise AssertionError(f"ENMS WiMAX: matrix {mc.h.shape}, plan {mc.plan}")
    for stage in (False, True):
        log_launch_shape("wimax_1056_880 ENMS", mc, stage)
    rows_s, final = nms_edge.build_rows_schedule(
        nms_edge.DEFAULT_COMPACT_SCHEDULE, block, ITERS)
    with profiling.recording(record=profiling.Record()) as rec:
        k4 = nms_edge.fused_counters_edge(code, params, "ENMS", ITERS, snr,
                                          batch, seed, device=dev)
        k3 = nms_edge.fused_counters_edge_compact(
            code, params, "ENMS", ITERS, snr, batch, seed, block_frames=block,
            schedule=nms_edge.DEFAULT_COMPACT_SCHEDULE, device=dev)
    counters_equal("K4 ENMS wimax", k4,
                   nms_edge._mc_frames_plain(mc, ITERS, batch)[0][:5])
    counters_equal("K3 ENMS wimax", k3, nms_edge._compact_plain(
        mc, batch, block, rows_s, final))
    counters_equal("K3 ENMS wimax (chain of twins)", k3,
                   nms_edge._compact_chain(mc, batch, block, rows_s, final,
                                           frames_fn=nms_edge._mc_frames_plain,
                                           rank_fn=nms_edge._group_rank_plain))
    counts = rec.snapshot()["counters"]
    frames = counts.get("enms.frames")
    want = 2 * batch + batch // block * rows_s[0][1]
    if frames != want or counts.get("split.frames") != want:
        raise AssertionError(f"enms.frames {frames}, split.frames "
                             f"{counts.get('split.frames')}, want {want}")
    log(f"ENMS wimax_1056_880 {mc.h.shape} at {snr} dB ({label}), {batch} "
        f"frames: K4 {k4.tolist()}, K3 {k3.tolist()} (overflow {int(k3[5])}), "
        f"each equal to its twin counter for counter; enms.frames and "
        f"split.frames {frames}")
    k3_h = nms_edge.fused_counters_edge_compact(
        code, params, "NMS-1", ITERS, snr, batch, seed, block_frames=block,
        schedule=nms_edge.DEFAULT_COMPACT_SCHEDULE, device=dev)
    log(f"ENMS wimax_1056_880: K3 on H in ENMS's place {k3_h.tolist()} "
        f"({code.h.shape}): {'equal' if torch.equal(k3_h, k3) else 'differs'}")
    torch.cuda.empty_cache()
    k4_ms = cuda_ms(lambda: nms_edge.fused_counters_edge(
        code, params, "ENMS", ITERS, snr, timed, seed, device=dev), 5)
    k3_ms = cuda_ms(lambda: nms_edge.fused_counters_edge_compact(
        code, params, "ENMS", ITERS, snr, timed, seed, block_frames=block,
        schedule=nms_edge.DEFAULT_COMPACT_SCHEDULE, device=dev), 5)
    k4_bound = bound_ms(8 * 5, nms_edge_ops(mc.h, timed, ITERS) / F32_INSTR)[0]
    # K3's bound with every carried row taken (the most its schedule runs)
    carried = timed // block * rows_s[0][1]
    k3_bound = bound_ms(8 * 6, edge_ops(mc.h, timed * rows_s[0][0]
                                        + carried * final,
                                        timed + carried) / F32_INSTR)[0]
    log(f"ENMS wimax_1056_880 timed at {timed} frames: K4 {k4_ms:.4f} ms "
        f"(bound {k4_bound:.4f}), K3 {k3_ms:.4f} ms (bound at full rows "
        f"{k3_bound:.4f}), {timed / k3_ms * 1e3:.0f} frames/s through K3")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    split_mask_kernels(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_dense_kernels(dev):
    """K6 and K7 against their plain twins (bit for bit, counters equal),
    K7 against K4 on the same seed, and both timed: K6 at the main path's
    262,144 frames with the trained factor (as K1), K7 at 2,097,152 frames
    with NMS-1 at its initial factor (as K4)."""
    run = load_run(os.path.join(ROOT, "runs", "r4_pipeline"), dev)
    code = run["code"]
    params = {k: v.cpu() for k, v in run["nms_params"].items()}
    llr, _ = sample_batch(torch.Generator(device=dev).manual_seed(2024),
                          ChannelSpec.awgn(3.0, code.rate),
                          torch.as_tensor(code.g, device=dev), CAP_B)
    h = torch.as_tensor(code.h, dtype=torch.float32, device=dev)
    weights = nms.scalar_weights(params, "NMS-1")
    rows = []

    got = nms_dense.decode_final_dense(params, h, llr, ITERS)
    want = nms_dense._decode_dense_plain(h, llr, ITERS, weights)
    err = compare("K6", got, want)
    if not torch.equal(got, want):
        raise AssertionError("K6 differs from its plain twin")
    same_as_k1 = torch.equal(got, nms_edge.decode_final_edge(params, code.h, llr,
                                                             ITERS))
    arr = get_code("array_121_60")
    ha = torch.as_tensor(arr.h, dtype=torch.float32, device=dev)
    xa = torch.randn((65_536, arr.n), generator=torch.Generator(device=dev)
                     .manual_seed(3), device=dev) * 0.8 + 1.0
    got_a = nms_dense.decode_final_dense(params, ha, xa, ITERS)
    if not torch.equal(got_a, nms_dense._decode_dense_plain(ha, xa, ITERS, weights)):
        raise AssertionError("K6 array_121_60: kernel differs from its plain twin")
    del want, got_a
    log(f"K6: bit for bit with its plain twin at {CAP_B} frames and on "
        f"array_121_60 (65,536 frames); equal to K1 bit for bit: {same_as_k1}")
    ms, bound_by = bound_ms(4 * CAP_B * code.n * 2,
                            nms_edge_ops(code.h, CAP_B, ITERS) / F32_INSTR)
    row = {
        "name": "K6 dense_final", "route": "cuda",
        "source": "short_ldpc_decoding_osd_tpu_torch/csrc/nms_dense.cu",
        "replaces": "short_ldpc_decoding_osd_tpu/ops/nms_pallas.py:46",
        "launches": None, "max_abs_err": err,
        "ms": cuda_ms(lambda: nms_dense.decode_final_dense(params, h, llr, ITERS),
                      20),
        "plain_ms": cuda_ms(lambda: nms_dense._decode_dense_plain(
            h, llr, ITERS, weights), 2, warmup=1),
        "bound_ms": ms, "bound_by": bound_by,
        # no single PyTorch call computes a min-sum decode
        "library_ms": None,
        "shape": f"h (64, 128) f32, llr ({CAP_B}, 128) f32 -> ({CAP_B}, 128), T=12",
    }
    log(f"K6 dense_final: max_abs_err {err:.3g}, kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, bound {ms:.4f} ms ({bound_by})")
    rows.append(row)

    ccsds = get_code("ccsds_128_64")
    p0 = nms.init_params("NMS-1")
    w0 = nms.scalar_weights(p0, "NMS-1")
    sigma = float(np.float32(sigma_for_snr(3.0, ccsds.rate)))
    hc = torch.as_tensor(ccsds.h, dtype=torch.float32, device=dev)
    gc = torch.as_tensor(ccsds.g, dtype=torch.float32, device=dev)
    seed, big = 11, PH1_BATCH
    got = mc_dense.fused_counters(ccsds, p0, "NMS-1", ITERS, 3.0, MC_B, seed,
                                  device=dev)
    want = mc_dense._mc_dense_plain(w0, seed, hc, gc, ITERS, MC_B, sigma, 1.0)
    if not torch.equal(got, want):
        raise AssertionError(f"K7: kernel {got.tolist()} vs plain {want.tolist()}")
    k7 = mc_dense.fused_counters(ccsds, p0, "NMS-1", ITERS, 3.0, big, seed,
                                 device=dev).tolist()
    k4 = nms_edge.fused_counters_edge(ccsds, p0, "NMS-1", ITERS, 3.0, big, seed,
                                      device=dev).tolist()
    log(f"K7 vs K4, seed {seed}, {big} frames: K7 {k7}, K4 {k4}, "
        f"|frame errors K7 - K4| = {abs(k7[1] - k4[1])}")
    if k7[0] != k4[0] or abs(k7[1] - k4[1]) > 4:
        raise AssertionError(f"K7 {k7} and K4 {k4} differ by more than 4 frame "
                             "errors")
    bms, bound_by = bound_ms(8 * 5, nms_edge_ops(ccsds.h, big, ITERS) / F32_INSTR)
    row = {
        "name": "K7 mc_dense", "route": "cuda",
        "source": "short_ldpc_decoding_osd_tpu_torch/csrc/nms_dense.cu",
        "replaces": "short_ldpc_decoding_osd_tpu/ops/mc_pallas.py:131",
        "launches": None, "max_abs_err": 0,
        "ms": cuda_ms(lambda: mc_dense.fused_counters(
            ccsds, p0, "NMS-1", ITERS, 3.0, big, seed, device=dev), 10),
        "plain_ms": cuda_ms(lambda: mc_dense._mc_dense_plain(
            w0, seed, hc, gc, ITERS, big, sigma, 1.0), 1, warmup=0),
        "bound_ms": bms, "bound_by": bound_by,
        # no single PyTorch call computes a fused Monte-Carlo step
        "library_ms": None,
        "shape": f"{big} hash frames, h (64, 128) + G (64, 128) f32, T={ITERS} "
                 "-> (5,) int64",
    }
    log(f"K7 mc_dense: counters equal to the plain twin at {MC_B} frames, kernel "
        f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound {bms:.4f} ms "
        f"({bound_by})")
    rows.append(row)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return rows


def phase_dense_capture(dev, rows):
    """The capture step pinned to K6 against the default (K1) step on the
    same generator: 8 rounds of 262,144 frames, capture 32,768, trained
    factor, 3.0 dB.  Counters, capture count and buffers must be identical;
    K6's launches are counted over the pinned step's rounds."""
    run = load_run(os.path.join(ROOT, "runs", "r4_pipeline"), dev)
    code = run["code"]
    params = {k: v.cpu() for k, v in run["nms_params"].items()}
    spec = ChannelSpec.awgn(3.0, code.rate)
    default = harness.build_nms_mc_step(code, "NMS-1", ITERS, spec, CAP_B,
                                        capture_capacity=CAP, device=dev)
    pinned = harness.build_nms_mc_step(code, "NMS-1", ITERS, spec, CAP_B,
                                       capture_capacity=CAP, decoder="dense",
                                       device=dev)
    if default.decoder != "edge":
        raise AssertionError(f"default decoder {default.decoder} is not K1")
    gen = torch.Generator(device=dev)
    ref = []
    for i in range(ROUNDS):
        gen.manual_seed(77 * 1_000_003 + i)
        ref.append(default(params, gen))
    synchronize(dev)
    _kernels.reset_launches()
    outs = []
    for i in range(ROUNDS):
        gen.manual_seed(77 * 1_000_003 + i)
        outs.append(pinned(params, gen))
    synchronize(dev)
    launches = dict(_kernels.LAUNCHES)
    want = dict.fromkeys(launches, 0) | {"dense_final": ROUNDS}
    if launches != want:
        raise AssertionError(f"K6 capture step launches {launches} != {want}")
    set_launches(rows, launches, ("dense_final",))
    total = torch.zeros(5, dtype=torch.int64)
    for (c1, cap1), (c6, cap6) in zip(ref, outs):
        if not torch.equal(c1, c6):
            raise AssertionError(f"capture step: K6 {c6.tolist()} vs K1 {c1.tolist()}")
        for key in ("count", "llr", "labels"):
            if not torch.equal(cap1[key], cap6[key]):
                raise AssertionError(f"capture step: K6 and K1 {key} differ")
        total += c6.cpu()
    log(f"capture step pinned to K6 == default K1 step over {ROUNDS} rounds: "
        f"counters {total.tolist()}, capture count and buffers identical; "
        f"launches {launches}")


def phase_sweep_dense(dev, rows):
    """``run_nms_mc(rung="dense")`` at 3.0 dB to 40,000 errors: only K7."""
    code = get_code("ccsds_128_64")
    _kernels.reset_launches()
    t0 = time.perf_counter()
    stats, _ = harness.run_nms_mc(code, nms.init_params("NMS-1"), "NMS-1", ITERS,
                                  3.0, batch=SWEEP_B, error_budget=40_000,
                                  rung="dense", device=dev)
    seconds = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    set_launches(rows, launches, ("mc_dense",))
    ci = wilson_overlap("run_nms_mc(rung='dense')", stats.frame_errors,
                        stats.frames)
    log("sweep dense: " + json.dumps(stats.to_dict() | {
        "fer_999_ci": ci, "seconds": seconds, "launches": launches}))
    if launches["mc_dense"] < 1 or sum(launches.values()) != launches["mc_dense"]:
        raise AssertionError(f"run_nms_mc(rung='dense') launches {launches}")


def phase_padded(dev):
    """The padded edge layout against the plain dense step on the same
    generator: wimax_1056_880 (NMS-1, 3.75 dB, 4,096 frames) and NMS-r on
    CCSDS (3.0 dB, untrained NN weights) at 1,024 frames (``run_nms_mc``'s
    default batch), 2,048, 4,096 and 262,144 (the capture step's), each side
    timed by CUDA events: the measurement behind NMS-r's default decoder on
    CUDA where its edge kernel does not hold the code, the plain dense step
    below ``NMS_R_MIN_BATCH`` frames and the padded layout from there up.
    Gate: within 4 frame errors, equal frame counts, and the default
    decoder of each measured batch is the rule's: on CCSDS NMS-r's edge
    kernel at every batch."""
    faster, default = {}, {}
    for name, variant, snr, frames in (("wimax_1056_880", "NMS-1", 3.75, PADDED_B),
                                       ("ccsds_128_64", "NMS-r", 3.0, 1024),
                                       ("ccsds_128_64", "NMS-r", 3.0, 2048),
                                       ("ccsds_128_64", "NMS-r", 3.0, PADDED_B),
                                       ("ccsds_128_64", "NMS-r", 3.0, CAP_B)):
        code = get_code(name)
        params = {k: v.to(dev) for k, v in
                  nms.init_params(variant, code.h, seed=0).items()}
        spec = ChannelSpec.awgn(snr, code.rate)
        out = {}
        for decoder in ("edge_padded", "plain"):
            step = harness.build_nms_mc_step(code, variant, ITERS, spec, frames,
                                             decoder=decoder, device=dev)
            ms = cuda_ms(lambda: step(params, torch.Generator(device=dev)
                                      .manual_seed(4)),
                         2 if frames > PADDED_B else 10, warmup=2)
            c, _ = step(params, torch.Generator(device=dev).manual_seed(5))
            out[decoder] = (c.cpu().tolist(), ms)
            del step, c
            torch.cuda.empty_cache()
        (cp, tp), (cd, td) = out["edge_padded"], out["plain"]
        log(f"padded edge layout, {name} {variant} {snr} dB, {frames} frames: "
            f"padded {cp} in {tp:.4f} ms, plain dense {cd} in {td:.4f} ms "
            f"(plain / padded {td / tp:.3f}), |frame errors| diff "
            f"{abs(cp[1] - cd[1])}")
        if cp[0] != cd[0] or abs(cp[1] - cd[1]) > 4:
            raise AssertionError(f"{name} {variant}: padded {cp} vs plain {cd}")
        if variant == "NMS-r":
            faster[frames] = "edge_padded" if tp < td else "plain"
            default[frames] = harness.select_decoder(code.h, variant, frames,
                                                     device=dev)
    log(f"NMS-r on CUDA: default decoder by batch {default}; faster by batch "
        f"{faster}")
    rule = {b: "edge" for b in default}
    if default != rule:
        raise AssertionError(f"NMS-r default decoders {default} != the rule {rule}")


def phase_train(dev):
    """``train_nms`` with ``NMSTrainConfig()`` on the card.  Gate: the loss
    falls, measured on identical frames: the trained factor's mean loss over
    the first block's ring batches is below the first block's loss (the
    blocks' own losses come from different ring batches and vary by a few
    percent between blocks)."""
    code = get_code("ccsds_128_64")
    cfg = NMSTrainConfig()
    records = []
    t0 = time.perf_counter()
    params, _ = nms_train.train_nms(code, cfg, log_fn=records.append, device=dev)
    synchronize(dev)
    seconds = time.perf_counter() - t0
    first_block = range(cfg.print_interval)
    trained = {k: v.detach() for k, v in params.items()}
    trained_loss = nms_train.ring_loss(code, cfg, trained, first_block, device=dev)
    init_loss = nms_train.ring_loss(code, cfg, nms.init_params("NMS-1"),
                                    first_block, device=dev)
    stats, _ = harness.run_nms_mc(code, {k: v.cpu() for k, v in trained.items()},
                                  "NMS-1", ITERS, 3.0, batch=SWEEP_B,
                                  error_budget=40_000, device=dev)
    check = float(trained["check"][0])
    log("train: " + json.dumps({
        "steps": cfg.termination_step, "seconds": seconds,
        "first_block": records[0], "last_block": records[-1],
        "block_loss_means": [round(r["loss_mean"], 3) for r in records],
        "first_block_frames_loss_init": init_loss,
        "first_block_frames_loss_trained": trained_loss,
        "check": check, "check_jax_run": REF_TRAINED_CHECK,
        "w_chk": float(torch.nn.functional.softplus(torch.tensor(check))),
        "fer_3db": stats.fer, "fer_3db_frames": stats.frames,
        "fer_3db_errors": stats.frame_errors}))
    if not trained_loss < records[0]["loss_mean"]:
        raise AssertionError(f"training loss did not fall: {trained_loss} on the "
                             f"first block's frames vs {records[0]['loss_mean']}")


def phase_phase1(dev, rows):
    """``bench.py``'s phase-1 headline on the card (``system.Phase1``):
    compact, then one-shot; each with counts reset after the warm-up step
    and required to be exactly ``PH1_STEPS`` launches of its kernel, and
    its FER held against the JAX record.  Returns the K3 run's fields."""
    seconds, outs = {}, {}
    for kernel, key in (("compact", "mc_compact"), ("oneshot", "mc_oneshot")):
        phase1 = system.Phase1(batch=PH1_BATCH, kernel=kernel, device=dev)
        phase1.step(0)  # warm-up
        synchronize(dev)
        _kernels.reset_launches()
        out = phase1.measure(PH1_STEPS)
        launches = dict(_kernels.LAUNCHES)
        want = dict.fromkeys(launches, 0) | {key: PH1_STEPS}
        log(f"phase-1 {kernel} launches over {PH1_STEPS} timed steps: "
            f"{launches}")
        if launches != want:
            raise AssertionError(f"phase-1 {kernel} launches {launches} != {want}")
        set_launches(rows, launches, (key,))
        ci = wilson_overlap(f"phase-1 {kernel}", out["timed_frame_errors"],
                            out["timed_frames"])
        out["fer_999_ci"] = ci
        seconds[kernel], outs[kernel] = out["seconds"], out
        log("phase1: " + json.dumps(out))
    log(f"phase-1 K3/K4 time ratio: {seconds['compact'] / seconds['oneshot']:.4f}; "
        "FERs agree with BENCH_r05.json's sample_fer (99.9% Wilson overlap)")
    return outs["compact"]


def phase_sweep(dev):
    """``run_nms_mc`` at 3.0 dB to an error budget of 40,000 on the card."""
    code = get_code("ccsds_128_64")
    _kernels.reset_launches()
    t0 = time.perf_counter()
    stats, _ = harness.run_nms_mc(code, nms.init_params("NMS-1"), "NMS-1", ITERS,
                                  3.0, batch=SWEEP_B, error_budget=40_000,
                                  device=dev)
    seconds = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    ci = wilson_overlap("run_nms_mc", stats.frame_errors, stats.frames)
    log("sweep: " + json.dumps(stats.to_dict() | {
        "fer_999_ci": ci, "seconds": seconds, "launches": launches}))
    if not launches["mc_compact"] > 0:
        raise AssertionError(f"run_nms_mc did not run K3: {launches}")


def phase_cascade(dev, rows):
    """One ``cascade_counters`` call at 2,097,152 frames after a warm-up
    call (which calibrates the capacity), counts reset between."""
    code = get_code("ccsds_128_64")
    params = nms.init_params("NMS-1")
    mc_cascade.cascade_counters(code, params, "NMS-1", ITERS, 3.0, PH1_BATCH, 5,
                                device=dev)
    synchronize(dev)
    _kernels.reset_launches()
    t0 = time.perf_counter()
    c = mc_cascade.cascade_counters(code, params, "NMS-1", ITERS, 3.0, PH1_BATCH,
                                    5, device=dev).tolist()
    seconds = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    set_launches(rows, launches, ("cascade_p1", "cascade_p2"))
    log("cascade: " + json.dumps({"counters": c, "fer": c[1] / c[0],
                                  "seconds": seconds, "launches": launches}))
    if c[0] != PH1_BATCH or not (launches["cascade_p1"] and launches["cascade_p2"]):
        raise AssertionError(f"cascade: counters {c}, launches {launches}")


def phase_main_path(dev, rows):
    """The entry point ``run_two_phase`` spelled out, so that the launch
    counts bracket exactly the timed rounds: reset after the warm-up, read
    before the per-stage split (which calls K2 and K5 on its own).  Returns
    the measured fields."""
    two_phase = system.TwoPhase(cap_b=CAP_B, cap=CAP, snr_db=3.0, device=dev)
    two_phase.full_round(10**6)  # warm-up
    synchronize(dev)
    _kernels.reset_launches()
    out = two_phase.measure(ROUNDS)
    launches = dict(_kernels.LAUNCHES)
    out["system_stage_s"] = two_phase.stage_times(ROUNDS)
    want = dict.fromkeys(launches, 0) | {
        "nms_edge_final": 2 * ROUNDS, "nms_edge_traj": ROUNDS, "lterm": ROUNDS,
        "ge_packed": ROUNDS}
    log(f"main path launches over {ROUNDS} timed rounds: {launches} "
        f"(expected {want})")
    set_launches(rows, launches, ("nms_edge_final", "nms_edge_traj", "lterm",
                                  "ge_packed"))
    if launches != want:
        raise AssertionError(f"main-path launches {launches} != {want}")

    frames, errors = out["system_frames"], out["system_frame_errors"]
    failures, succ = out["system_failures"], out["system_osd_success"]
    fer_ci = wilson_interval(errors, frames, Z999)
    ref_fer_ci = wilson_interval(round(REF_FER * REF_FRAMES), REF_FRAMES, Z999)
    share_ci = wilson_interval(succ, failures, Z999)
    ref_share_ci = wilson_interval(REF_OSD_SUCC, REF_FAILURES, Z999)
    fer99 = wilson_interval(errors, frames, 2.5758)
    log(f"frames {frames}, NMS FER {errors / frames:.6f} (99% Wilson "
        f"{fer99[0]:.6f}-{fer99[1]:.6f}), failures {failures}, OSD successes "
        f"{succ} ({succ / failures:.5f}), strict {out['system_osd_strict_success']}, "
        f"unconfirmed {out['system_osd_unconfirmed']}, capture overflow "
        f"{out['system_capture_overflow']}")
    split = out["system_split_s"]
    log(f"phase 1 {split['phase1_nms_capture_only']:.4f} s, phase 2 "
        f"{split['phase2_implied']:.4f} s, total {split['two_phase_total']:.4f} s, "
        f"system {out['system_codewords_per_s']:.1f} cw/s, OSD "
        f"{out['system_osd_failures_per_s']:.1f} failures/s "
        f"on {torch.cuda.get_device_name(0)}")
    log("stages (s): " + json.dumps(out["system_stage_s"]))
    stages = out["system_stage_s"]
    staged = sum(v for k, v in stages.items() if k != "sliding_osd_total")
    for stage in ("prepare_sort_ge", "disc_minima_k5"):
        log(f"{stage} stage: {1e3 * stages[stage]:.4f} ms of a staged round's "
            f"{1e3 * staged:.4f} ms")
    log("system: " + json.dumps(out))
    if not (fer_ci[0] <= ref_fer_ci[1] and ref_fer_ci[0] <= fer_ci[1]):
        raise AssertionError(f"NMS FER CI {fer_ci} misses the record {ref_fer_ci}")
    if not (share_ci[0] <= ref_share_ci[1] and ref_share_ci[0] <= share_ci[1]):
        raise AssertionError(
            f"OSD success share CI {share_ci} misses the record {ref_share_ci}")
    log("statistics agree with BENCH_r05.json (99.9% Wilson intervals overlap)")
    return out


def profile(dev, label: str, fn, watch=()):
    """``fn`` once under ``torch.profiler`` after a warm-up call: the
    device's busy share (device time over the same call's unprofiled wall
    time), the kernels that take the most device time, and those whose name
    holds a ``watch`` string."""
    fn()  # warm-up
    synchronize(dev)
    t0 = time.perf_counter()
    fn()
    synchronize(dev)
    wall_ms = (time.perf_counter() - t0) * 1e3
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        fn()
        synchronize(dev)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        log(f"profile of {label}: {wall_ms:.2f} ms wall; the profiler saw no "
            "device time, so the device busy share is not measured")
        return
    log(f"profile of {label}: {wall_ms:.2f} ms wall (unprofiled), device busy "
        f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%), "
        f"{sum(e.count for e in kernels)} device operations")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  {e.key[:100]}")
    for e in kernels:
        if any(w in e.key for w in watch):
            log(f"  {label}, {e.key[:100]}: {e.self_device_time_total / 1e3:.3f}"
                f" ms over {e.count} launch(es)")


def phase_profile(dev, cap_b: int = CAP_B, cap: int = CAP):
    """One two-phase round and one phase-1 K3 step under the profiler."""
    two_phase = system.TwoPhase(cap_b=cap_b, cap=cap, device=dev)
    profile(dev, "one round", lambda: two_phase.full_round(1),
            watch=("::ge_kernel<",))
    del two_phase
    phase1 = system.Phase1(batch=PH1_BATCH, device=dev)
    profile(dev, "one phase-1 K3 step", lambda: phase1.step(1))


def phase_card_vs_cpu(dev, run_dir=R4, label="r4_pipeline", rows=None):
    """Walk decisions on the committed failure set (or on ``rows``, an
    (llr, labels) pair) with ``run_dir``'s artifacts: card == CPU, frame
    for frame."""
    if rows is None:
        blob = np.load(os.path.join(ROOT, "runs", "refparity", "failures.npz"))
        rows, label = (blob["llr"], blob["labels"]), f"refparity, {label}"
    results = []
    for d in (dev, torch.device("cpu")):
        run = load_run(run_dir, d)
        code = run["code"]
        layout = segments.TepLayout.build(run["path"], code.k, 6, d)
        step = engine.make_dl_osd_step_from_llr(run["dia"], code, run["variant"],
                                                run["num_iterations"], layout)
        out, _, det = step({k: v.cpu() for k, v in run["nms_params"].items()},
                           torch.as_tensor(rows[0], device=d),
                           torch.as_tensor(rows[1], device=d), run["fcn"])
        results.append({k: out[k].cpu() for k in WALK_FIELDS} | {
            "detected": det.cpu()})
    for key, val in results[0].items():
        if not torch.equal(val, results[1][key]):
            raise AssertionError(f"{key}: card differs from CPU ({label})")
    log(f"card vs CPU walk ({len(rows[0])} rows, {label}): card == CPU frame "
        f"for frame; {int(results[0]['success'].sum())} successes")


def phase_path(dev):
    """``osd/path.py`` on the card against the CPU: MRB error patterns and
    swap_len (the GE kernel's dense load on the card, the dense route on
    the CPU) row for row on the committed failure set and on the main
    path's first 2,048 captured rows, the pattern counters fed from either
    side equal, and the pre-GE MRB bit-error histograms equal."""
    blob = np.load(os.path.join(ROOT, "runs", "refparity", "failures.npz"))
    run, _, _, cap, refined, *_ = main_path_inputs(dev)
    code = run["code"]
    sets = {"refparity": (torch.as_tensor(blob["llr"], device=dev),
                          torch.as_tensor(blob["labels"], device=dev)),
            "main path rows": (refined[:2048].contiguous(),
                               cap["labels"][:2048].contiguous())}
    counters = {}
    for label, (upd, lab) in sets.items():
        _kernels.reset_launches()
        card = path.mrb_error_patterns(upd, lab, code.h_osd, code.k)
        synchronize(dev)
        launches = _kernels.LAUNCHES["ge_packed"]
        cpu = path.mrb_error_patterns(upd.cpu(), lab.cpu(), code.h_osd, code.k)
        for part, a, w in zip(("patterns", "swap_len"), card, cpu):
            if not torch.equal(a.cpu(), w):
                raise AssertionError(f"path {label}: {part} card != CPU")
        hist = [path.mrb_bit_error_histogram(x, y, code.k)
                for x, y in ((upd, lab), (upd.cpu(), lab.cpu()))]
        if hist[0] != hist[1] or launches != 1:
            raise AssertionError(f"path {label}: histograms {hist}, GE "
                                 f"launches {launches}")
        for side, (pat, swap) in (("card", card), ("cpu", cpu)):
            pc = counters.setdefault(side, path.PatternCounter(code.k))
            pc.update(pat, swap)
        log(f"path: {label} ({upd.shape[0]} rows): patterns and swap_len card "
            f"== CPU row for row (1 GE launch), MRB bit-error histogram "
            f"{dict(sorted(hist[0].items()))}")
    if counters["card"].counts != counters["cpu"].counts or (
            counters["card"].swap_sum != counters["cpu"].swap_sum):
        raise AssertionError("path: the pattern counters differ")
    cfg = run["config"]
    log(f"path: PatternCounter card == CPU over {counters['card'].total} rows "
        f"({len(counters['card'].counts)} patterns, swap_sum "
        f"{counters['card'].swap_sum}); its decoding path "
        f"({cfg['threshold_sum']}, {cfg['decoding_length']}) starts "
        f"{counters['card'].decoding_path(cfg['threshold_sum'], cfg['decoding_length'])[:6]}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# the JAX package's records of the flagship recipe (runs/r4_pipeline/):
# train_failures_meta.json, decoding_path.json, stopper_samples_summary.json
REF_HARVEST_ERRORS, REF_HARVEST_FRAMES = 47_140, 262_144
REF_MRB_ZERO_REFINED, REF_MRB_ZERO_INITIAL = 15_255, 6_633
REF_SAMPLES = {"success": 19_592, "fail": 338, "undetected": 70}
# runs/r4_rnn1/fer_curve.json at 3.0 dB: OSD successes of 500 walked failures
REF_RNN_OSD_SUCC, REF_RNN_OSD_N = 436, 500
# RnnOne.refine card vs CPU (tests/test_torch_dia_models.py states rtol 1e-4)
RNN_RTOL = 1e-4


def recipe_config(run_dir):
    """The ``RecipeConfig`` of a run directory's ``config.json``."""
    with open(os.path.join(run_dir, "config.json")) as fh:
        cfg = json.load(fh)
    cfg["frame_portions"] = tuple(cfg.get("frame_portions", ()))
    return recipe.RecipeConfig(**cfg)


def overlap999(name, got, want):
    """Raise unless the 99.9% Wilson intervals of two (successes, trials)
    pairs overlap; return both intervals."""
    a, b = wilson_interval(*got, Z999), wilson_interval(*want, Z999)
    if not (a[0] <= b[1] and b[0] <= a[1]):
        raise AssertionError(f"{name}: {got} (99.9% CI {a}) misses the record "
                             f"{want} ({b})")
    return a, b


# the eval sweep's kernels that launch once a point (fewer rows than
# recipe.OSD_CHUNK a point)
SWEEP_ONCE = ("nms_edge_traj", "ge_packed", "lterm")


def share_text(label, got, want):
    """99.9% Wilson overlap of two (events, trials) pairs (raises on a miss)
    and the gap in standard errors, as text."""
    overlap999(label, got, want)
    (a, n), (b, m) = got, want
    return (f"{a}/{n} = {a / n:.5f} (record {b}/{m} = {b / m:.5f}, "
            f"{gap_sigma(got, want):+.2f} sigma)")


def sweep_vs_record(label, curve, rec) -> list[str]:
    """Each eval point's ``fer_nms_detected`` and OSD failure share held to
    the record's by 99.9% Wilson overlap; one text a point, with the mean
    complexity beside the record's."""
    texts = []
    for point in curve["points"]:
        snr = round(point["snr_db"], 2)
        ref = rec["curve"][snr]
        osd, ref_osd = point["osd"], ref["osd"]
        nms_text = share_text(
            f"{label} {snr} dB fer_nms_detected",
            (round(point["fer_nms_detected"] * point["frames"]), point["frames"]),
            (round(ref["fer_nms_detected"] * ref["frames"]), ref["frames"]))
        osd_text = share_text(
            f"{label} {snr} dB OSD failure share",
            (osd["fail"], osd["success"] + osd["fail"]),
            (ref_osd["fail"], ref_osd["success"] + ref_osd["fail"]))
        texts.append(f"{snr:.1f} dB: fer_nms_detected {nms_text}; OSD failures "
                     f"{osd_text}; unconfirmed {point['osd_unconfirmed']}; mean "
                     f"complexity {osd['complexity']:.1f} (record "
                     f"{ref_osd['complexity']:.1f})")
    return texts


def sweep_launches(label, launches, curve, cap_b) -> dict:
    """An eval sweep's launches: K1 one a capture step, K2, GE and K5 one a
    point (each point walks fewer than ``recipe.OSD_CHUNK`` rows), nothing
    else; returns them."""
    points = curve["points"]
    if any(p["frames"] % cap_b for p in points):
        raise AssertionError(f"{label}: frames not whole steps of {cap_b}")
    want = {"nms_edge_final": sum(p["frames"] // cap_b for p in points)}
    want |= {key: len(points) for key in SWEEP_ONCE}
    got = {key: n for key, n in launches.items() if n}
    if got != want:
        raise AssertionError(f"{label} eval sweep: launches {got}, expected {want}")
    return want


def numpy_tree_layout(tree):
    """A pickle tree's key layout with (dtype, shape) leaves; raises on a
    leaf that is not a numpy array."""
    if isinstance(tree, dict):
        return {k: numpy_tree_layout(v) for k, v in tree.items()}
    if not isinstance(tree, np.ndarray):
        raise AssertionError(f"parameter leaf of type {type(tree).__name__}")
    return (str(tree.dtype), tree.shape)


def numpy_layouts(run_dir):
    """A run directory's three parameter pickles as ``numpy_tree_layout``s."""
    return {name: numpy_tree_layout(load_jax_pickle(os.path.join(run_dir, name)))
            for name in ("nms_params.pkl", "dia_model_cnn.pkl",
                         "stopper_params.pkl")}


def capture_memory(dev):
    """Peak card bytes a frame of one capture step, measured against
    ``recipe.capture_frame_bytes`` on three routes."""
    code = get_code("ccsds_128_64")
    for variant, decoder, batch in (("NMS-1", "edge", CAP_B),
                                    ("NMS-r", "edge_padded", 16_384),
                                    ("NMS-1", "plain", 4096)):
        params = nms.init_params(variant, code.h)
        step = harness.build_nms_mc_step(
            code, variant, ITERS, ChannelSpec.awgn(2.7, code.rate), batch,
            capture_capacity=min(batch, 20_000), decoder=decoder, device=dev)
        gen = torch.Generator(device=dev)
        params = {k: v.to(dev) for k, v in params.items()} if variant == "NMS-r" else params
        gen.manual_seed(5)
        step(params, gen)  # warm-up
        synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        gen.manual_seed(6)
        out = step(params, gen)
        synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) - base
        del out
        model = recipe.capture_frame_bytes(code.h, variant, decoder)
        log(f"capture memory {variant} {decoder} at {batch} frames: "
            f"{peak / batch:.1f} B a frame measured, {model} B modelled")


def phase_recipe(dev):
    """The seven-stage recipe of ``runs/r4_pipeline/config.json`` on the
    card through ``pipeline.recipe``'s stages, in ``run_recipe``'s order,
    with the JAX run's NMS factor seeded so stage 1 is reused (the trainer
    is phase 10's); then the RNN refiner of ``runs/r4_rnn1``; then the
    ``sldpc-torch sweep`` command line on the finished run directory."""
    torch.cuda.empty_cache()
    capture_memory(dev)
    torch.cuda.empty_cache()
    cfg = recipe_config(R4)
    seconds = {}
    timer = Timer(dev)

    def staged(name, fn):
        with timer.measure(name):
            out = fn()
        seconds[name] = timer.records[name][-1]
        return out

    with tempfile.TemporaryDirectory() as tmp:
        run = recipe.RunDir(tmp)
        run.save_json("config.json", dataclasses.asdict(cfg))
        shutil.copy(os.path.join(R4, "nms_params.pkl"), run.path("nms_params.pkl"))
        nms_params = recipe.stage_train_nms(cfg, run, log, dev)
        cap_b = recipe.capture_batch(cfg, get_code(cfg.code_name), dev)
        log(f"recipe: capture batch {cap_b} frames a step")
        fb = staged("harvest_failures",
                    lambda: recipe.stage_harvest_failures(cfg, run, nms_params, log, dev))
        meta = run.load_json("train_failures_meta.json")
        overlap999("harvest FER", (meta["detected_failures"], meta["frames"]),
                   (REF_HARVEST_ERRORS, REF_HARVEST_FRAMES))
        log("recipe harvest: " + json.dumps(meta | {
            "kept": len(fb.trajectories), "overflow": fb.overflow,
            "mismatches": fb.mismatches,
            "record": [REF_HARVEST_ERRORS, REF_HARVEST_FRAMES]}))

        model, path_ = staged("train_dia_and_path",
                              lambda: recipe.stage_train_dia_and_path(cfg, run, fb, log, dev))
        summary = run.load_json("dia_model_cnn_train_summary.json")
        hist = summary["history"]
        paths = run.load_json("decoding_path.json")
        zero_refined = paths["hist_refined"].get("0", 0)
        zero_initial = paths["hist_initial"].get("0", 0)
        with open(os.path.join(R4, "decoding_path.json")) as fh:
            ref_path = json.load(fh)["path"]
        shared = sum(p in ref_path for p in path_)
        log("recipe dia: " + json.dumps({
            "train_seconds": summary["elapsed_s"],
            "first_block": hist[0], "last_block": hist[-1],
            "mrb_zero_refined": zero_refined, "mrb_zero_initial": zero_initial,
            "record_zero_refined": REF_MRB_ZERO_REFINED,
            "record_zero_initial": REF_MRB_ZERO_INITIAL,
            "path_len": len(path_), "patterns_shared_with_jax": shared,
            "path_head": path_[:6]}))
        if not hist[-1]["loss_mean"] < hist[0]["loss_mean"]:
            raise AssertionError(f"DIA loss did not fall: {hist[0]} -> {hist[-1]}")
        if not zero_refined > zero_initial:
            raise AssertionError(f"refined MRB zero-error count {zero_refined} <= "
                                 f"initial {zero_initial}")

        fcn = staged("train_stopper", lambda: recipe.stage_train_stopper(
            cfg, run, model, fb, path_, log, dev))
        samples = run.load_json("stopper_samples_summary.json")
        val = run.load_json("stopper_validation.json")
        with open(os.path.join(R4, "stopper_validation.json")) as fh:
            ref_val = json.load(fh)
        log("recipe stopper: " + json.dumps({
            "samples": {k: samples[k] for k in REF_SAMPLES},
            "record_samples": REF_SAMPLES, "validation": val,
            "record_validation": ref_val}))
        if not val["final_loss"] < val["initial_loss"]:
            raise AssertionError(f"stopper loss did not fall: {val}")
        phase_card_vs_cpu(dev, tmp, "the port-trained recipe")

        snrs = np.linspace(2.0, 3.0, 6)
        _kernels.reset_launches()
        curve = staged("eval_sweep", lambda: recipe.stage_eval_sweep(
            cfg, run, nms_params, model, fcn, path_, snrs, log, dev))
        launches = sweep_launches("recipe", dict(_kernels.LAUNCHES), curve, cap_b)
        ref = {"curve": {round(p["snr_db"], 2): p for p in read_json(
            os.path.join(R4, "fer_curve.json"))["points"]}}
        for point, text in zip(curve["points"], sweep_vs_record("recipe", curve, ref)):
            if not len(point["ce_list"]) == len(point["ber_list"]) == ITERS + 2:
                raise AssertionError(f"CE/BER lists of {len(point['ce_list'])}, "
                                     f"{len(point['ber_list'])} entries")
            log(f"recipe sweep {text}, frames {point['frames']}, fer_total "
                f"{point['fer_total']:.4g}")
        log(f"recipe sweep launches: {launches}")

        written = load_run(tmp, dev)
        layouts, ref_layouts = numpy_layouts(tmp), numpy_layouts(R4)
        if layouts != ref_layouts:
            raise AssertionError(f"run-dir pickles {layouts} != JAX's {ref_layouts}")
        log(f"recipe run dir: loads through convert.load_run on the card "
            f"({type(written['dia']).__name__}, {len(written['path'])} patterns); "
            "its pickles hold numpy float32 trees in the JAX key layout")

        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "short_ldpc_decoding_osd_tpu_torch.cli.main",
             "sweep", "--run-dir", tmp, "--snrs", "3.0:3.0:1",
             "--max-frames", str(cfg.max_frames_per_snr)],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        seconds["cli_sweep_3db"] = time.perf_counter() - t0
        if cli.returncode != 0:
            raise AssertionError(f"sldpc-torch sweep failed: {cli.stderr[-2000:]}")
        log(f"sldpc-torch sweep (cached stages, 3.0 dB): {cli.stdout.strip().splitlines()[-1][:400]}")

        rnn_seconds = phase_rnn(dev, fb)
    seconds |= rnn_seconds
    log(f"recipe stage seconds on {torch.cuda.get_device_name(0)}: "
        + json.dumps(seconds))


def phase_rnn(dev, fb):
    """``runs/r4_rnn1``'s RnnOne on the card: refine == CPU on 4,096
    harvested rows; its two-phase decode at 3.0 dB against the record; 200
    steps of ``train_dia(model="model_rnn1")`` on the harvested failures."""
    seconds = {}
    card, cpu = load_run(R4_RNN, dev), load_run(R4_RNN, "cpu")
    rows = np.ascontiguousarray(fb.trajectories[:4096])
    with torch.no_grad():
        got = card["dia"].refine(torch.as_tensor(rows, device=dev)).cpu().numpy()
        want = cpu["dia"].refine(torch.as_tensor(rows)).numpy()
    err = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0)))
    np.testing.assert_allclose(got, want, rtol=RNN_RTOL, atol=RNN_RTOL)
    log(f"rnn: RnnOne.refine on 4,096 rows, card == CPU (max error {err:.3g}, "
        f"rtol {RNN_RTOL})")

    cfg = recipe_config(R4_RNN)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        curve = recipe.stage_eval_sweep(
            cfg, recipe.RunDir(tmp), {k: v.cpu() for k, v in card["nms_params"].items()},
            card["dia"], card["fcn"], card["path"], [3.0], log, dev)
        synchronize(dev)
        seconds["rnn_eval_3db"] = time.perf_counter() - t0
    osd = curve["points"][0]["osd"]
    overlap999("RnnOne OSD success share at 3.0 dB",
               (osd["success"], osd["success"] + osd["fail"]),
               (REF_RNN_OSD_SUCC, REF_RNN_OSD_N))
    log(f"rnn: 3.0 dB OSD {osd['success']} of {osd['success'] + osd['fail']} "
        f"(record {REF_RNN_OSD_SUCC} of {REF_RNN_OSD_N})")

    code = get_code("ccsds_128_64")
    t0 = time.perf_counter()
    _, hist = dia_train.train_dia(code, fb.trajectories, fb.labels,
                                  dia_train.DIATrainConfig(model="model_rnn1",
                                                           termination_step=200),
                                  device=dev)
    synchronize(dev)
    seconds["rnn_train_200"] = time.perf_counter() - t0
    log(f"rnn: train_dia(model_rnn1) 200 steps: {hist}")
    if not hist[-1]["loss_mean"] < hist[0]["loss_mean"]:
        raise AssertionError(f"RnnOne loss did not fall: {hist}")
    return seconds


# runs/r5_baselines: the JAX package's baseline records on CCSDS (128,64),
# NMS-1 with that directory's trained factor, 12 iterations (the key of its
# baseline_failures_*.json); the command line that reproduces them
R5_BASE = os.path.join(ROOT, "runs", "r5_baselines")
BASE_KINDS = ("miracle", "fs", "pb", "conventional")  # miracle first: it captures
BASE_SNRS = ("2.00", "2.50", "3.00", "3.50")
BASE_ARGS = ["--snrs", "2.0:3.5:4", "--failure-budget", "128", "--batch",
             "65536", "--seed", "0", "--order", "3", "--beta", "0.1",
             "--d-min", "14", "--tau-psc", "30"]
# launches of one four-kind sweep of 4 points: GE once a kind and point, K5
# twice a point for FS and PB (uw_l + uh_l, uw_l + v_p), once for
# conventional OSD (uw_l), never for the miracle view
BASE_GE_LAUNCHES, BASE_K5_LAUNCHES = 16, 20


def read_json(path):
    with open(path) as fh:
        return json.load(fh)


def baseline_runs(dev):
    """Every baseline on ``base_failures.npz``'s 256 frames on ``dev``: FS in
    both modes, PB at the record's ``osd_snr``, conventional OSD at order 3
    and the miracle view; per-frame outputs on the host, and the card's
    seconds of each (closed by a synchronisation)."""
    code = get_code("ccsds_128_64")
    blob = np.load(os.path.join(ROOT, "runs", "refparity", "base_failures.npz"))
    llr = torch.as_tensor(blob["llr"], device=dev)
    labels = torch.as_tensor(blob["labels"], device=dev)
    fs_kw = dict(order_limit=3, beta=0.1, d_min=14, tau_psc=30, device=dev)
    calls = {
        "fs_intended": lambda: fs_osd.fs_osd(llr, labels, code.g, code.k,
                                             score_tau_e_codeword=True, **fs_kw),
        "fs_literal": lambda: fs_osd.fs_osd(llr, labels, code.g, code.k,
                                            score_tau_e_codeword=False, **fs_kw),
        "pb": lambda: pb_osd.pb_osd(llr, labels, code.g, code.k,
                                    snr_db=float(blob["osd_snr"]), device=dev),
        "conventional": lambda: conventional.conventional_osd(
            llr, labels, code.g, code.k, order_limit=3, device=dev),
        "miracle": lambda: {"hist": conventional.miracle_view(
            llr, labels, code.g, code.k, device=dev)},
    }
    outs, seconds = {}, {}
    for name, fn in calls.items():
        synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        synchronize(dev)
        seconds[name] = time.perf_counter() - t0
        outs[name] = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
                      for k, v in out.items()}
    return blob, outs, seconds


def baselines_parity(dev, card):
    """(a) The 256 parity frames: every per-frame field on the card equal to
    the port's CPU run in this process; success flags and FS TEP counts
    equal to the ``.npz``; the PB cost fields that differ from the ``.npz``
    (a TPU record of the JAX package) printed."""
    blob, gpu, gpu_s = baseline_runs(dev)
    blob, cpu, cpu_s = baseline_runs(torch.device("cpu"))
    for name, fields in gpu.items():
        for key, val in fields.items():
            if not np.array_equal(np.asarray(val), np.asarray(cpu[name][key])):
                frames = (np.flatnonzero(val != cpu[name][key]).tolist()
                          if isinstance(val, np.ndarray) and val.ndim else [])
                raise AssertionError(f"baselines {name}.{key}: card differs from "
                                     f"CPU at frames {frames[:20]}")
    record = {("fs_intended", "success"): "fs_success_intended",
              ("fs_literal", "success"): "fs_success_literal",
              ("fs_intended", "num_teps"): "fs_num_teps",
              ("fs_literal", "num_teps"): "fs_num_teps_literal",
              ("pb", "success"): "pb_success"}
    for (name, key), field in record.items():
        if not np.array_equal(gpu[name][key], blob[field]):
            raise AssertionError(f"baselines {name}.{key} differs from the "
                                 f".npz's {field}")
    pb_diff = {key: np.flatnonzero(gpu["pb"][key] != blob[field]).tolist()
               for key, field in (("num_teps", "pb_cost"),
                                  ("maintained_list", "pb_maintained"),
                                  ("suc_evals", "pb_suc_evals"),
                                  ("improvements", "pb_improvements"))}
    log(f"baselines parity (256 frames of base_failures.npz, 3.0 dB): card == "
        f"CPU on every field of FS (both modes), PB, conventional OSD and the "
        f"miracle view; success flags and FS TEP counts == the .npz; PB fields "
        f"that differ from the .npz (a TPU record): {json.dumps(pb_diff)} "
        f"(expected num_teps/maintained_list/suc_evals at [36, 126, 128, 145, "
        f"194], improvements at none)")
    log("baselines parity successes: " + json.dumps({
        name: int(out["success"].sum()) for name, out in gpu.items()
        if "success" in out}) + f"; miracle histogram "
        f"{dict(sorted(gpu['miracle']['hist'].items()))}")
    log(f"baselines parity seconds on {card} (each "
        f"closed by a synchronisation): {json.dumps(gpu_s)}; on the host's "
        f"CPU {json.dumps(cpu_s)}")


def baselines_kernels(dev, card):
    """(b) GE's dense load and K5 at the baselines' shapes: the 256 frames'
    G-domain inputs (GE == its plain twin == the dense route bit for bit)
    and M = P^T with the order-3 TEPs (K5 against the f64 evaluation and its
    plain twin), each timed against its bound; K5 also against the fp16
    einsum."""
    code = get_code("ccsds_128_64")
    blob = np.load(os.path.join(ROOT, "runs", "refparity", "base_failures.npz"))
    llr = torch.as_tensor(blob["llr"], device=dev)
    labels = torch.as_tensor(blob["labels"], device=dev)
    b, n, k = llr.shape[0], code.n, code.k
    order = torch.sort(-llr.abs(), dim=-1, stable=True).indices
    g_sorted = gf2ops.permute_columns(order, code.g)
    ge_check("baselines G-domain (dense load)", h_batch=g_sorted, k=n - k)
    plan = gf2_bitpack.ge_plan(b, k, n)
    ge_build_lines([("baselines G-domain", k, n, plan)])
    ge = ge_time(f"baselines G-domain on {card}", lambda: gf2_bitpack.reduce_dense(
        g_sorted, n - k), b, k, n, n - k, "dense")
    ge["plain_ms"] = cuda_ms(lambda: gf2_bitpack._reduce_dense_plain(
        g_sorted, n - k), 3, warmup=1)
    ge["dense_route_ms"] = cuda_ms(lambda: gf2ops.batched_row_reduce(g_sorted),
                                   3, warmup=1)
    ge["ms"] = ge.pop("wrapper_ms")
    ge["library_ms"] = None
    ge["shape"] = (f"G-domain ({b}, {k}, {n}) int8 -> tail ({b}, {k}, {n - k}) "
                   f"int8 + col_order ({b}, {n}) int32")

    prep = common.prepare_g_domain(llr, labels, code.g, k)
    terms = common.candidate_distance_terms(prep, k)
    m_mat = prep["p_matrix"].transpose(1, 2).contiguous()
    u_l = terms["uw_l"]
    t_flat = torch.as_tensor(fs_osd.sequential_tep_matrix(k, 3)[0], device=dev)
    err = k5_check("baselines (M = P^T, order-3 TEPs)", m_mat, u_l, t_flat)
    ntot = t_flat.shape[0]
    k5_launch_shape(b, n - k, k, ntot, "baselines ")
    k5 = {"max_abs_err": err} | k5_timed("baselines", m_mat, u_l, t_flat)
    k5["shape"] = (f"M ({b}, {n - k}, {k}) int8 = P^T, u_l ({b}, {n - k}) f32, "
                   f"T ({ntot}, {k}) int8 -> ({b}, {ntot}) f32")
    log(f"K5 lterm baselines on {card}: kernel {k5['ms']:.4f} ms, plain "
        f"{k5['plain_ms']:.4f} ms, library (fp16 einsum) "
        f"{k5['library_ms']:.4f} ms, bound {k5['bound_ms']:.4f} ms "
        f"({k5['bound_by']}), {k5['ms'] / k5['bound_ms']:.2f}x the bound")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return ge, k5


def baselines_profile(dev, card):
    """Where a baseline call's time goes: the host-built static TEP tables
    timed alone, then one FS and one PB call on the 256 parity frames under
    the profiler (the device's busy share of the call's wall time)."""
    code = get_code("ccsds_128_64")
    k = code.k
    teps = pb_osd.weight_limited_teps(k, 3)
    host = {}
    for name, fn in (
            ("fs sequential_tep_matrix", lambda: fs_osd.sequential_tep_matrix(k, 3)),
            ("pb weight_limited_teps", lambda: pb_osd.weight_limited_teps(k, 3)),
            ("pb _tep_push_counts", lambda: pb_osd._tep_push_counts(teps, k, 3)),
            ("conventional full_tep_matrix",
             lambda: conventional.full_tep_matrix(k, 3))):
        t0 = time.perf_counter()
        fn()
        host[name] = time.perf_counter() - t0
    log(f"baselines host TEP tables (s, order 3, k = 64; the host of {card}): "
        + json.dumps(host))
    blob = np.load(os.path.join(ROOT, "runs", "refparity", "base_failures.npz"))
    llr = torch.as_tensor(blob["llr"], device=dev)
    labels = torch.as_tensor(blob["labels"], device=dev)
    watch = ("lterm_kernel", "ge_kernel")
    profile(dev, f"one fs_osd call (256 frames) on {card}", lambda: fs_osd.fs_osd(
        llr, labels, code.g, k, device=dev), watch=watch)
    profile(dev, f"one pb_osd call (256 frames) on {card}", lambda: pb_osd.pb_osd(
        llr, labels, code.g, k, snr_db=float(blob["osd_snr"]), device=dev),
        watch=watch)


class _PointClock:
    """A stdout stand-in that stamps each JSON line the baseline command
    prints (one a point, printed after the point's results were read back
    to the host) and passes the text on."""

    def __init__(self, out):
        self.out, self.stamps, self.lines = out, [], []

    def write(self, text):
        for line in text.splitlines():
            if line.startswith("{"):
                self.stamps.append(time.perf_counter())
                self.lines.append(json.loads(line))
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def baselines_cli(dev, card):
    """(c) ``sldpc-torch baseline`` for every kind at the configuration of
    ``runs/r5_baselines`` in a temporary run directory holding that run's
    ``nms_params.pkl``, with every launch count reset just before and read
    just after; each point's ``fer_nms``, each kind's success count and the
    miracle view's ``floor_order3`` against the records by 99.9% Wilson
    overlap; avg_teps and maintained_list printed beside the records."""
    seconds = {}
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copy(os.path.join(R5_BASE, "nms_params.pkl"),
                    os.path.join(tmp, "nms_params.pkl"))
        synchronize(dev)
        _kernels.reset_launches()
        for kind in BASE_KINDS:
            clock = _PointClock(sys.stdout)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(clock):
                rc = cli_main(["baseline", "--kind", kind, "--run-dir", tmp,
                               "--device", str(dev)] + BASE_ARGS)
            synchronize(dev)
            total = time.perf_counter() - t0
            if rc != 0 or len(clock.stamps) != 4:
                raise AssertionError(f"sldpc-torch baseline --kind {kind}: rc "
                                     f"{rc}, {len(clock.stamps)} points")
            ends = [t0] + clock.stamps
            seconds[kind] = {"total": total, "points": {
                f"{line['snr_db']:.2f}": ends[i + 1] - ends[i]
                for i, line in enumerate(clock.lines)}}
        launches = dict(_kernels.LAUNCHES)
        cache = {snr: read_json(os.path.join(tmp, f"baseline_failures_{snr}dB.json"))
                 for snr in BASE_SNRS}
        results = {kind: read_json(os.path.join(tmp, f"baseline_{kind}.json"))
                   for kind in BASE_KINDS}
    ref_key = read_json(os.path.join(R5_BASE, "baseline_failures_2.00dB.json"))["key"]
    if cache["2.00"]["key"] != ref_key:
        raise AssertionError(f"capture key {cache['2.00']['key']} != the "
                             f"record's {ref_key}")
    log(f"baselines CLI launches (4 kinds x 4 points): {launches}")
    stray = {k: v for k, v in launches.items()
             if k not in ("nms_edge_final", "ge_packed", "lterm") and v}
    if (stray or launches["nms_edge_final"] < 4
            or launches["ge_packed"] != BASE_GE_LAUNCHES
            or launches["lterm"] != BASE_K5_LAUNCHES):
        raise AssertionError(f"baselines CLI launches {launches}: expected K1 >= "
                             f"4, GE {BASE_GE_LAUNCHES}, K5 {BASE_K5_LAUNCHES}, "
                             "nothing else")
    for snr in BASE_SNRS:
        got = cache[snr]["stats"]
        ref = read_json(os.path.join(R5_BASE, f"baseline_failures_{snr}dB.json"))
        overlap999(f"baseline {snr} dB fer_nms",
                   (got["detected_failures"], got["frames"]),
                   (ref["stats"]["detected_failures"], ref["stats"]["frames"]))
        log(f"baseline capture {snr} dB: fer_nms {cache[snr]['fer_nms']:.6f} of "
            f"{got['frames']} frames (record {ref['fer_nms']:.6f} of "
            f"{ref['stats']['frames']})")
    for kind in BASE_KINDS:
        ref_points = read_json(os.path.join(R5_BASE, f"baseline_{kind}.json"))["points"]
        for point, ref in zip(results[kind]["points"], ref_points):
            snr = f"{point['snr_db']:.2f}"
            if kind == "miracle":
                frames = sum(point["hist"].values())
                ref_frames = sum(ref["hist"].values())
                overlap999(f"miracle {snr} dB floor_order3",
                           (round(point["floor_order3"] * frames), frames),
                           (round(ref["floor_order3"] * ref_frames), ref_frames))
                line = (f"floor_order3 {point['floor_order3']:.6f} (record "
                        f"{ref['floor_order3']:.6f}), hist {point['hist']}")
            else:
                frames = point["success"] + point["fail"]
                overlap999(f"{kind} {snr} dB successes",
                           (point["success"], frames),
                           (ref["success"], ref["success"] + ref["fail"]))
                line = (f"success {point['success']}/{frames} (record "
                        f"{ref['success']}/{ref['success'] + ref['fail']})")
                for key in ("avg_teps", "maintained_list", "suc_evals", "num_teps"):
                    if key in point:
                        line += f", {key} {point[key]} (record {ref[key]})"
            point_s = seconds[kind]["points"][snr]
            log(f"baseline {kind} {snr} dB: {line}, {point_s:.3f} s")
    log(f"baselines CLI seconds on {card} (each point "
        f"ends where its results were read back; miracle's include the NMS "
        f"capture): {json.dumps(seconds)}")
    return launches


def phase_baselines(dev, rows, card):
    """The OSD baselines on the card: (a) the 256 parity frames card == CPU
    and against the record, (b) GE and K5 at the baselines' shapes, (c)
    ``sldpc-torch baseline`` for every kind at ``runs/r5_baselines``'s
    configuration (this slice's path, its launches counted); between (b)
    and (c), where a call's time goes (host TEP tables, device busy share)."""
    baselines_parity(dev, card)
    ge, k5 = baselines_kernels(dev, card)
    baselines_profile(dev, card)
    launches = baselines_cli(dev, card)
    for row in rows:
        if row["name"] == "GE ge_packed":
            row["baselines"] = ge | {"launches": launches["ge_packed"]}
        elif row["name"] == "K5 lterm":
            row["baselines"] = k5 | {"launches": launches["lterm"]}
        elif row["name"] == "K1 nms_edge_final":
            row["baselines"] = {"launches": launches["nms_edge_final"]}


MESH_STEPS, MESH_TRAIN_B, MESH_TRAIN_STEPS = 4, 1024, 3


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_sweep_launches(launches):
    """Raise unless the mesh sweep launched K3 and nothing but K3 and K4."""
    others = {k: v for k, v in launches.items()
              if k not in ("mc_compact", "mc_oneshot") and v}
    if not launches["mc_compact"] or others:
        raise AssertionError(f"mesh sweep launches {launches}: K3 (and K4 on "
                             "an overflow) only")


def mesh_world_of_one(dev):
    """The three world-of-one checks, inside an NCCL group of one rank."""
    out = {}
    mesh = make_mesh()
    probe = torch.arange(5, dtype=torch.int64, device=dev)
    dist.all_reduce(probe)  # NCCL itself, which the mesh skips at size 1
    if probe.tolist() != list(range(5)) or mesh.size != 1:
        raise AssertionError(f"NCCL world of one: {probe.tolist()}, {mesh}")
    run = load_run(R4, dev)
    code = run["code"]
    params = {k: v.cpu() for k, v in run["nms_params"].items()}
    kw = dict(batch=SWEEP_B, error_budget=40_000, device=dev)
    harness.run_nms_mc(code, params, "NMS-1", ITERS, 3.0, max_frames=SWEEP_B,
                       **kw)  # warm-up: the timed sweeps start alike
    sweeps = {}
    for label, extra in (("single", {}), ("mesh", {"mesh": mesh})):
        synchronize(dev)
        _kernels.reset_launches()
        t0 = time.perf_counter()
        stats, _ = harness.run_nms_mc(code, params, "NMS-1", ITERS, 3.0,
                                      **kw, **extra)
        seconds = time.perf_counter() - t0
        sweeps[label] = (stats, dict(_kernels.LAUNCHES), seconds)
    (single, _, s_single), (meshed, launches, s_mesh) = (sweeps["single"],
                                                         sweeps["mesh"])
    if meshed != single:
        raise AssertionError(f"mesh sweep {meshed} != single-device {single}")
    mesh_sweep_launches(launches)
    steps = meshed.frames // SWEEP_B
    out["sweep"] = {"stats": meshed.to_dict(), "steps": steps,
                    "s_per_step_mesh": s_mesh / steps,
                    "s_per_step_single": s_single / steps, "launches": launches}

    run_, _, _, cap, *_, layout = main_path_inputs(dev)
    single_step = engine.make_dl_osd_step_from_llr(run_["dia"], code, "NMS-1",
                                                   ITERS, layout)
    o, _, det = single_step(params, cap["llr"], cap["labels"], run_["fcn"])
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    want = torch.stack([torch.tensor(cap["llr"].shape[0], device=dev), det.sum(),
                        (o["success"] & det).sum(),
                        torch.where(det, o["complexity"], zero).sum(),
                        torch.where(det, o["window_num"], zero).sum()]).tolist()
    sharded = sharded_dl_osd_step_from_llr(run_["dia"], code, "NMS-1", ITERS,
                                           mesh, layout)
    synchronize(dev)
    _kernels.reset_launches()
    t0 = time.perf_counter()
    got = sharded(params, cap["llr"], cap["labels"], run_["fcn"]).tolist()
    seconds = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    if got != want:
        raise AssertionError(f"sharded OSD step {got} != single-device {want}")
    if not all(launches[k] for k in ("nms_edge_traj", "ge_packed", "lterm")):
        raise AssertionError(f"sharded OSD step launches {launches}: K2, GE "
                             "and K5 each at least once")
    out["osd_from_llr"] = {"counters": got, "seconds": seconds,
                           "launches": launches}

    spec = ChannelSpec.awgn(2.7, code.rate)
    make_optimizer, train = sharded_nms_train_step(code, "NMS-1", ITERS, spec,
                                                   MESH_TRAIN_B, mesh)
    p_mesh = {k: v.to(dev).requires_grad_()
              for k, v in nms.init_params("NMS-1").items()}
    p_single = {k: v.detach().clone().requires_grad_() for k, v in p_mesh.items()}
    opt_mesh, opt_single = make_optimizer(p_mesh), StaircaseAdam(
        p_single.values(), 0.01, 500, 0.95, 5.0)
    gen_matrix = torch.as_tensor(code.g, dtype=torch.float32, device=dev)
    generator = torch.Generator(device=dev)
    losses, step_s = [], []
    for i in range(MESH_TRAIN_STEPS):
        generator.manual_seed(31 + i)
        synchronize(dev)
        t0 = time.perf_counter()
        loss_mesh = float(train(p_mesh, opt_mesh, generator))
        step_s.append(time.perf_counter() - t0)
        generator.manual_seed(31 + i)
        llr, words = sample_batch(generator, spec, gen_matrix, MESH_TRAIN_B)
        with full_f32():
            opt_single.zero_grad()
            loss = nms.multi_iteration_loss(
                nms.decode(p_single, code.h, llr, ITERS), words)
            loss.backward()
            opt_single.step()
        losses.append((loss_mesh, float(loss.detach())))
        for k in p_mesh:
            a, b = p_mesh[k].detach().cpu(), p_single[k].detach().cpu()
            if not torch.allclose(a, b, rtol=1e-5, atol=1e-7):
                raise AssertionError(f"train step {i}: {k} {a} vs {b}")
        if not math.isclose(*losses[-1], rel_tol=1e-6):
            raise AssertionError(f"train step {i}: loss {losses[-1]}")
    out["train"] = {"losses_mesh_single": losses, "s_per_step": step_s,
                    "check": p_mesh["check"].detach().cpu().tolist()}
    return out


def _run_two_ranks(port: int, out_json: str):
    """Two ``run_multihost`` processes (gloo, one card): rank 0's point and
    the wall seconds of both."""
    cmd = [sys.executable, "-m",
           "short_ldpc_decoding_osd_tpu_torch.parallel.run_multihost",
           "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
           "--backend", "gloo", "--device", "cuda", "--snrs", "3.0:3.0:1",
           "--per-device-batch", str(SWEEP_B), "--error-budget", str(10**9),
           "--max-frames", str(MESH_STEPS * 2 * SWEEP_B),
           "--iterations", str(ITERS), "--out", out_json]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, os.environ.get("PYTHONPATH", "")]))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd + ["--process-id", str(r)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    wall = time.perf_counter() - t0
    for p, text in zip(procs, logs):
        if p.returncode != 0:
            raise AssertionError(f"mesh rank failed (exit {p.returncode}):\n"
                                 + text[-3000:])
    with open(out_json) as fh:
        point = json.load(fh)["points"][0]
    return point, wall


def mesh_two_ranks(dev, code, params, seed: int = 3000):
    """``parallel.run_multihost`` as two gloo processes sharing the card
    (NCCL refuses two ranks on one device) against this process's K3 calls
    on the same seeds."""
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="mesh_") as tmp:
        point, wall = _run_two_ranks(port, os.path.join(tmp, "two.json"))
    cblock, _ = ladder.ladder_blocks(SWEEP_B, ITERS)
    rung, want = "compact", np.zeros(5, np.int64)
    for idx in range(MESH_STEPS):
        seeds = [int(s) for s in device_seeds(seed, idx, 2)]
        if rung == "compact":
            c = sum(nms_edge.fused_counters_edge_compact(
                code, params, "NMS-1", ITERS, 3.0, SWEEP_B, seed=s,
                block_frames=cblock, schedule=nms_edge.DEFAULT_COMPACT_SCHEDULE,
                device=dev).cpu().numpy() for s in seeds)
            if c[5] == 0:
                want += c[:5]
                continue
            rung = "oneshot"
        want += sum(nms_edge.fused_counters_edge(
            code, params, "NMS-1", ITERS, 3.0, SWEEP_B, seed=s,
            device=dev).cpu().numpy() for s in seeds)
    got = [point[k] for k in ("frames", "frame_errors", "bit_errors",
                              "detected_failures", "undetected_errors")]
    if got != want.tolist() or (point["devices"], point["hosts"]) != (2, 2):
        raise AssertionError(f"two gloo ranks {got} ({point['devices']} "
                             f"devices) != summed K3 calls {want.tolist()}")
    return {"counters": got, "rung_after": rung, "wall_s": wall,
            "frames_per_s_rank0": point["frames_per_s"]}


def phase_mesh(dev, rows, smi):
    """``parallel/`` on the card: a world of one on NCCL (the sweep, the
    raw-LLR OSD step and the train step, each against the single-device
    path), then two gloo processes sharing the card.  The kernel rows of
    the mesh path get its launches under ``mesh``."""
    t0 = time.perf_counter()
    torch.cuda.set_device(torch.cuda.current_device())
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        out = mesh_world_of_one(dev)
    finally:
        dist.destroy_process_group()
    if dist.is_initialized():
        raise AssertionError("the NCCL group outlived the mesh phase")
    code = get_code("ccsds_128_64")
    out["two_gloo_ranks"] = mesh_two_ranks(dev, code, nms.init_params("NMS-1"))
    out["seconds"] = time.perf_counter() - t0
    log("mesh: " + json.dumps(out | {"card": smi}))
    launches = out["sweep"]["launches"] | {
        k: out["osd_from_llr"]["launches"][k]
        for k in ("nms_edge_traj", "ge_packed", "lterm")}
    for row in rows:
        key = LAUNCH_KEY[row["name"]]
        if launches[key]:
            row["mesh"] = {"launches": launches[key]}


# phase 14: rows held card == CPU (pruned OSD, candidates), swap statistics
# and extras models
EXP_CPU_ROWS, EXP_CAND_ROWS, EXP_ROWS = 1024, 256, 4096
EXP_TOL = dict(rtol=1e-4, atol=1e-5)  # the extras models, card vs CPU


def prep_rows(prep, rows: int, device):
    """The first ``rows`` frames of a PreparedBatch on ``device``."""
    return engine.PreparedBatch(**{f.name: getattr(prep, f.name)[:rows].to(device)
                                   for f in dataclasses.fields(prep)})


def host_ms(dev, fn):
    """(result, host ms of one call closed by a synchronisation)."""
    synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    synchronize(dev)
    return out, (time.perf_counter() - t0) * 1e3


def only_launched(label, want: dict):
    """Raise unless the launch counts since the last reset are ``want``
    (and 0 for every other kernel)."""
    got = {key: n for key, n in _kernels.LAUNCHES.items() if n}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")


def experimental_pruned(dev, prep, t_path, k, ts):
    """(2)-(5): ``pruned_batch_osd`` unpruned and pruned (``threshold_sum``
    ``ts``) and ``best_estimation_counts`` on every captured row, after one
    warm-up of each, K5 alone launched 4 times; the first rows against the
    port's CPU run; the consistency gates; the statistics."""
    b, ntot = prep.m_matrix.shape[0], t_path.shape[0]
    for prune in (False, True):  # first-call costs stay out of the timed calls
        engine.pruned_batch_osd(prep, t_path, k, ts, prune=prune)
    experimental.best_estimation_counts(prep, t_path, k)
    synchronize(dev)
    _kernels.reset_launches()
    full, ms_full = host_ms(dev, lambda: engine.pruned_batch_osd(
        prep, t_path, k, ts, prune=False))
    pruned, ms_pruned = host_ms(dev, lambda: engine.pruned_batch_osd(
        prep, t_path, k, ts, prune=True))
    (correct, failed), ms_bec = host_ms(
        dev, lambda: experimental.best_estimation_counts(prep, t_path, k))
    launches = _kernels.LAUNCHES["lterm"]
    only_launched("pruned OSD + best_estimation_counts", {"lterm": 4})

    keep, fell = engine._prune_keep(prep, t_path, ts)
    if correct != int(full["success"].sum()) or correct + failed != b:
        raise AssertionError(f"best_estimation_counts {correct}/{failed} vs the "
                             f"unpruned successes {int(full['success'].sum())}")
    if not (pruned["min_discrepancy"] >= full["min_discrepancy"]).all():
        raise AssertionError("a pruned minimum lies below the unpruned one")
    if not ((pruned["num_candidates"] <= ntot).all()
            and (full["num_candidates"] == ntot).all()):
        raise AssertionError("num_candidates beyond the TEP count")
    if not torch.equal(pruned["num_candidates"], keep.sum(1)):
        raise AssertionError("num_candidates differs from the pruning mask")

    n = EXP_CPU_ROWS
    cpu, t_cpu = prep_rows(prep, n, "cpu"), t_path.cpu()
    keep_cpu, _ = engine._prune_keep(cpu, t_cpu, ts)
    if not torch.equal(keep[:n].cpu(), keep_cpu):
        raise AssertionError("pruning mask: card differs from CPU")
    disc_cpu = engine._tep_discrepancies(cpu, t_cpu, k)
    ties = 0
    for name, out, mask in (("unpruned", full, None), ("pruned", pruned, keep_cpu)):
        want = engine.pruned_batch_osd(cpu, t_cpu, k, ts, prune=mask is not None)
        got = {key: v[:n].cpu() for key, v in out.items()}
        for key in ("success", "num_candidates"):
            if not torch.equal(got[key], want[key]):
                raise AssertionError(f"pruned_batch_osd {name} {key}: card "
                                     "differs from CPU")
        np.testing.assert_allclose(got["min_discrepancy"].numpy(),
                                   want["min_discrepancy"].numpy(), rtol=1e-5)
        d = disc_cpu if mask is None else torch.where(mask, disc_cpu, engine._BIG)
        two = torch.topk(d, 2, dim=1, largest=False).values
        clear = (two[:, 1] - two[:, 0]) > 1e-5 * two[:, 0].abs().clamp(min=1.0)
        if not torch.equal(got["best_index"][clear], want["best_index"][clear]):
            raise AssertionError(f"pruned_batch_osd {name} best_index: card "
                                 "differs from CPU off the ties")
        ties += int((~clear).sum())
    c = EXP_CAND_ROWS
    cand = experimental.candidate_matrix(prep_rows(prep, c, dev), t_path, k)
    if not torch.equal(cand.cpu(), experimental.candidate_matrix(
            prep_rows(prep, c, "cpu"), t_cpu, k)):
        raise AssertionError("candidate_matrix: card differs from CPU")
    stats = {
        "rows": b, "teps": ntot, "threshold_sum": ts,
        "strict_success_unpruned": int(full["success"].sum()),
        "strict_success_pruned": int(pruned["success"].sum()),
        "best_estimation_counts": [correct, failed],
        "mean_candidates_kept": float(pruned["num_candidates"].double().mean()),
        "fell_back_to_first_4": int(fell.sum()),
        "ms": {"unpruned": ms_full, "pruned": ms_pruned,
               "best_estimation_counts": ms_bec},
        "k5_launches": launches,
        "card_vs_cpu_rows": n, "near_ties_not_held": ties,
        "candidate_matrix_rows": c}
    log("experimental pruned OSD: " + json.dumps(stats))
    return stats


def experimental_k5(dev, prep, t_path, card):
    """K5 at the pruned OSD's shape (M (B, 64, 64) x the path's 1,439 TEPs)
    against its twin and the f64 evaluation, timed against its bound and
    the fp16 einsum."""
    _, u_l, _, _ = engine._discrepancy_terms(prep, prep.m_matrix.shape[2])
    m_mat, u_l = prep.m_matrix.contiguous(), u_l.contiguous()
    err = k5_check("experimental (the path's TEPs, unchunked)", m_mat, u_l, t_path)
    row = {"max_abs_err": err} | k5_timed("experimental", m_mat, u_l, t_path)
    log(f"K5 lterm experimental on {card}: kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, library (fp16 einsum) "
        f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}), {row['ms'] / row['bound_ms']:.2f}x the bound")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return row


def experimental_swaps(dev, refined, code, card):
    """(6): ``swap_statistics(n_s=0)`` and ``updated_mrb_indices`` on every
    refined row, the GE kernel's dense load alone launched (twice); 4,096
    rows against the CPU's dense route; the dense load at this shape
    against its twin and the dense route, timed against its bound."""
    k, b = code.k, refined.shape[0]
    experimental.swap_statistics(refined, code.h_osd, k, n_s=0)  # warm-up
    synchronize(dev)
    _kernels.reset_launches()
    (hist, initial), ms_swap = host_ms(
        dev, lambda: experimental.swap_statistics(refined, code.h_osd, k, n_s=0))
    mrb, ms_mrb = host_ms(
        dev, lambda: experimental.updated_mrb_indices(refined, code.h_osd, k))
    launches = _kernels.LAUNCHES["ge_packed"]
    only_launched("swap statistics", {"ge_packed": 2})
    if sum(hist.values()) != b:
        raise AssertionError(f"swap histogram sums to {sum(hist.values())} != {b}")
    n = EXP_ROWS
    few = refined[:n]
    hist_n, initial_n = experimental.swap_statistics(few, code.h_osd, k, n_s=0)
    hist_c, initial_c = experimental.swap_statistics(few.cpu(), code.h_osd, k, n_s=0)
    mrb_c = experimental.updated_mrb_indices(few.cpu(), code.h_osd, k)
    if (hist_n != hist_c or not np.array_equal(initial_n, initial_c)
            or not np.array_equal(initial[:n], initial_c)
            or not np.array_equal(mrb[:n], mrb_c)):
        raise AssertionError("swap statistics: card differs from the CPU's "
                             "dense route")

    _, h_p = gf2ops.reliability_sort(refined, code.h_osd)
    ge_check(f"experimental swap statistics ({b} rows, dense load)",
             h_batch=h_p, k=k)
    m, nn = h_p.shape[1:]
    ge = ge_time(f"experimental dense load on {card}",
                 lambda: gf2_bitpack.reduce_dense(h_p, k), b, m, nn, k, "dense")
    ge["ms"] = ge.pop("wrapper_ms")
    ge["plain_ms"] = cuda_ms(lambda: gf2_bitpack._reduce_dense_plain(h_p, k),
                             3, warmup=1)
    ge["library_ms"] = None
    ge["shape"] = (f"reliability-permuted H ({b}, {m}, {nn}) int8 -> tail ({b}, "
                   f"{m}, {k}) int8 + col_order ({b}, {nn}) int32")
    stats = {"rows": b, "histogram": {str(key): v for key, v in sorted(hist.items())},
             "pulled_frames": int((initial >= 0).sum()),
             "ms": {"swap_statistics": ms_swap, "updated_mrb_indices": ms_mrb},
             "ge_launches": launches, "card_vs_cpu_rows": n}
    log("experimental swap statistics: " + json.dumps(stats))
    return ge | {"launches": launches}


def extras_pair(dev, module, seed, **extra):
    """``module`` with flax's initial weights (``init_flax_``, ``seed``) on
    the CPU, and a copy of it on the card."""
    cpu = init_flax_(module, seed).eval()
    with torch.no_grad():
        for name, val in extra.items():
            getattr(cpu, name).copy_(val)
    return cpu, copy.deepcopy(cpu).to(dev)


def held(label, card_fn, cpu_fn, chunk: int | None = None):
    """Card == CPU within EXP_TOL on the first EXP_ROWS rows (the CPU side
    ``chunk`` rows at a time); returns the card's output and its ms a call."""
    rows = EXP_ROWS
    with torch.no_grad():
        got = card_fn(slice(0, rows)).cpu()
        step = chunk or rows
        want = torch.cat([cpu_fn(slice(s, min(s + step, rows)))
                          for s in range(0, rows, step)])
        np.testing.assert_allclose(got.numpy(), want.numpy(), **EXP_TOL,
                                   err_msg=label)
        ms = cuda_ms(lambda: card_fn(slice(0, rows)), 5)
    err = float((got - want).abs().max())
    log(f"extras {label}: card == CPU on {rows} rows (max abs error {err:.3g}), "
        f"{ms:.4f} ms a call on the card")
    return got, ms


def experimental_extras(dev, params, cap, code):
    """(7): ``RnnThree.refine`` and ``CnvNn.refine`` on 4,096 captured K2
    trajectories, then TransformerLayer(64, 8), PredictOutlier(6) and the
    four PredictPhase versions, card == CPU, softmax rows summing to 1."""
    traj = nms_edge.decode_traj_edge(params, code.h, cap["llr"][:EXP_ROWS].contiguous(),
                                     ITERS).permute(1, 0, 2).contiguous()
    traj_cpu = traj.cpu()
    dv, dc = extras.neighborhood_degrees(code.h)
    ll = traj.shape[1]
    gen = torch.Generator().manual_seed(7)
    ms = {}
    # flax's zero coefficients would hide RnnThree's first LSTM: draw them
    rnn = extras_pair(dev, extras.RnnThree(code.n, ll, dc=dc), 7,
                      coefficients=torch.randn(ll, generator=gen))
    cnv = extras_pair(dev, extras.CnvNn(code.n, ll, dv=dv, dc=dc), 8)
    for label, (cpu, card) in (("RnnThree.refine", rnn), ("CnvNn.refine", cnv)):
        _, ms[label] = held(f"{label} ((13, 128) trajectories, dv {dv}, dc {dc})",
                            lambda s, m=card: m.refine(code.h, traj[s]),
                            lambda s, m=cpu: m.refine(code.h, traj_cpu[s]),
                            chunk=1024)
    x = torch.randn((EXP_ROWS, ll, 64), generator=gen)
    cpu, card = extras_pair(dev, extras.TransformerLayer(64, 8), 9)
    xd = x.to(dev)
    _, ms["TransformerLayer(64, 8)"] = held(
        "TransformerLayer(64, 8) (4,096 x 13 x 64)", lambda s: card(xd[s]),
        lambda s: cpu(x[s]))
    heads = [("PredictOutlier(6)", extras.PredictOutlier(6), 6)] + [
        (f"PredictPhase(30, 31, version {v})", extras.PredictPhase(30, 31, v), 59)
        for v in range(4)]
    for i, (label, module, width) in enumerate(heads):
        x = torch.randn((EXP_ROWS, width), generator=gen) * 2.0
        xd = x.to(dev)
        cpu, card = extras_pair(dev, module, 10 + i)
        got, ms[label] = held(label, lambda s, m=card, a=xd: m(a[s]),
                              lambda s, m=cpu, a=x: m(a[s]))
        worst = float((got.double().sum(-1) - 1.0).abs().max())
        if worst > 1e-5:
            raise AssertionError(f"{label}: a softmax row sums {worst:.3g} from 1")
    return ms


def phase_experimental(dev, rows, smi):
    """14: ``engine.pruned_batch_osd`` and ``osd/experimental.py`` on the main
    path's 32,768 captured rows and the path's 1,439 TEPs (K5 and the GE
    kernel's dense load), and ``models/extras.py`` on the card against the
    CPU.  The K5 and GE rows get the phase's shapes under ``experimental``."""
    t0 = time.perf_counter()
    run, params, _, cap, refined, prep, _, _, _ = main_path_inputs(dev)
    code = run["code"]
    blocks, _ = segments.build_tep_blocks(run["path"], code.k, 6)
    t_path = torch.as_tensor(np.concatenate(blocks), device=dev).to(torch.int8)
    stats = experimental_pruned(dev, prep, t_path, code.k,
                                int(run["config"]["threshold_sum"]))
    k5 = experimental_k5(dev, prep, t_path, smi) | {"launches": stats["k5_launches"]}
    ge = experimental_swaps(dev, refined, code, smi)
    extras_ms = experimental_extras(dev, params, cap, code)
    for row in rows:
        if row["name"] == "K5 lterm":
            row["experimental"] = k5
        elif row["name"] == "GE ge_packed":
            row["experimental"] = ge
    seconds = time.perf_counter() - t0
    log("experimental: " + json.dumps({"seconds": seconds, "extras_ms": extras_ms,
                                       "card": smi}))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# phase 15: the WiMAX (1056,880) two-phase system at the JAX package's two
# records (runs/r5_wimax_system/bench_{3.5,4.0}dB.json), which name no cap:
# cap = 1,024 rows a round at both points; cap_b = 32,768 at 4.0 dB (the
# bench's documented setting) and 262,144 / 64 = 4,096 at 3.5 dB, whose
# record walked 65,536 rows (64 rounds of 1,024)
WIMAX_RUN = os.path.join(ROOT, "runs", "r5_multicode", "wimax_1056_880")
# (snr, cap_b, cap, TwoPhase seeds): the 3.5 dB point also on a second
# seed, an independent reading of its statistics
WIMAX_POINTS = ((3.5, 4_096, 1_024, (77, 78)), (4.0, 32_768, 1_024, (77,)))
# where a (B, m, N) tensor would not fit the card whole: the twin's f32
# parities 64 rows at a time (4.6 GB), the f64 evaluation 16 (2.3 GB), the
# fp16 yardstick 8,192 TEPs a call (8.9 GB with its f32 copy)
WIMAX_TWIN_ROWS, WIMAX_F64_ROWS, WIMAX_LIB_TEPS = 64, 16, 8_192
WIMAX_CPU_ROWS = 32  # captured rows walked on the card and on the CPU
# two best discrepancies whose f64 values lie within this relative gap tie
# at f32 precision (K5's gate against its twin)
NEAR_TIE = 1e-5


def wimax_step(tp, llr, labels):
    """A ``TwoPhase``'s own phase-2 step on captured rows, as ``measure``
    runs it: (walk outputs, refined reliabilities, detected)."""
    with torch.no_grad():
        return tp.phase2(tp.nms_params, llr, labels, tp.fcn)


def gap_sigma(got, want) -> float:
    """How many standard errors apart two (successes, trials) shares lie."""
    (a, n), (b, m) = got, want
    p, q = a / n, b / m
    var = p * (1 - p) / n + q * (1 - q) / m
    return (p - q) / math.sqrt(var) if var else 0.0


def ties_only(label, prep, differ, deep, t_flat, bounds, k) -> int:
    """Raise unless each frame of the (B,) mask ``differ`` has its two best
    discrepancies over the blocks below its ``deep`` limit within NEAR_TIE
    of each other, evaluated in f64; return the count of such frames."""
    rows = differ.nonzero()[:, 0].tolist()
    if not rows:
        return 0
    c0, u_l, u_m, _ = engine._discrepancy_terms(prep, k)
    gaps = []
    for r, d in zip(rows, deep[differ].tolist()):
        t = t_flat[:bounds[d - 1][1]]
        disc = (c0[r].double() + t.double() @ u_m[r].double()
                + lterm_f64(prep.m_matrix[r:r + 1], u_l[r:r + 1], t)[0])
        two = torch.topk(disc, 2, largest=False).values
        gaps.append(float((two[1] - two[0]) / two[0].abs().clamp(min=1.0)))
    log(f"{label}: frames that differ {rows}, relative f64 gaps of their two "
        f"best discrepancies {gaps}")
    if max(gaps) > NEAR_TIE:
        raise AssertionError(f"{label}: frames differ off an f32 tie")
    return len(rows)


def wimax_record(snr):
    return read_json(os.path.join(ROOT, "runs", "r5_wimax_system",
                                  f"bench_{snr:.1f}dB.json"))


def wimax_vs_record(label, rec, errors, frames, succ, failures) -> str:
    """The NMS FER and the OSD success share against the record: each
    99.9% Wilson interval must overlap the record's; both gaps in standard
    errors, as text."""
    rec_errors = round(rec["system_fer_nms"] * rec["system_frames"])
    fer_ci, _ = overlap999(f"{label} NMS FER", (errors, frames),
                           (rec_errors, rec["system_frames"]))
    share_ci, _ = overlap999(f"{label} OSD success share", (succ, failures),
                             (rec["system_osd_success"], rec["system_failures"]))
    return (f"NMS FER {errors / frames:.6f} (99.9% CI {fer_ci[0]:.6f}-"
            f"{fer_ci[1]:.6f}; record {rec['system_fer_nms']}; "
            f"{gap_sigma((errors, frames), (rec_errors, rec['system_frames'])):+.2f}"
            f" sigma), OSD {succ} of {failures} ({succ / failures:.5f}, 99.9% CI "
            f"{share_ci[0]:.5f}-{share_ci[1]:.5f}; record "
            f"{rec['system_osd_success']} of {rec['system_failures']}; "
            f"{gap_sigma((succ, failures), (rec['system_osd_success'], rec['system_failures'])):+.2f}"
            f" sigma)")


def wimax_point(dev, snr, cap_b, cap, seed):
    """One record point through ``TwoPhase`` as ``run_two_phase`` drives
    it: a warm-up round, then ``measure`` with the launch counts reset just
    before and read just after (K1 2R, K2, GE and K5 R each, nothing
    else), ``stage_times``, the peak memory; the statistics against the
    record by 99.9% Wilson overlap, the rows walked R x cap."""
    rec = wimax_record(snr)
    rounds = rec["system_frames"] // cap_b
    if rounds * cap != rec["system_osd_rows_walked"]:
        raise AssertionError(f"wimax {snr} dB: {rounds} rounds of {cap} rows do "
                             f"not make the record's rows walked")
    tp = system.TwoPhase(WIMAX_RUN, cap_b, cap, snr, dev, seed)
    decode = (tp.capture_step.decoder,
              engine.redecode_route(tp.code.h, tp.variant, dev, cap))
    if decode != ("edge", "edge"):
        raise AssertionError(f"wimax capture / re-decode routes {decode}")
    tp.full_round(10**6)  # warm-up
    synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _kernels.reset_launches()
    out = tp.measure(rounds)
    launches = {"nms_edge_final": 2 * rounds, "nms_edge_traj": rounds,
                "ge_packed": rounds, "lterm": rounds}
    only_launched(f"wimax system {snr} dB", launches)
    out["system_stage_s"] = tp.stage_times(rounds)
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    out["launches"] = launches
    out["seed"] = seed
    log(f"wimax system {snr:.1f} dB: " + json.dumps(out))
    label = f"wimax {snr} dB seed {seed}"
    versus = wimax_vs_record(label, rec, out["system_frame_errors"],
                             out["system_frames"], out["system_osd_success"],
                             out["system_failures"])
    if out["system_osd_rows_walked"] != rounds * cap:
        raise AssertionError(f"wimax {snr} dB: rows walked "
                             f"{out['system_osd_rows_walked']}")
    stages = out["system_stage_s"]
    staged = sum(v for key, v in stages.items() if key != "sliding_osd_total")
    log(f"wimax system {snr:.1f} dB seed {seed} vs its record: {versus}, capture "
        f"overflow {out['system_capture_overflow']} (record "
        f"{rec['system_capture_overflow']}), {rounds} rounds, staged round "
        f"{1e3 * staged:.2f} ms (K5 stage {1e3 * stages['disc_minima_k5']:.2f}),"
        f" peak memory {out['peak_memory_bytes'] / 2**30:.2f} GiB, "
        f"{torch.cuda.get_device_name(0)}")
    return tp, rounds, out


def edge_entry(label, name, params, variant, h, x, traj, launches):
    """K1 (``traj`` False) or K2 on the rows ``x`` == its plain twin
    (``_decode_edge_plain``) bit for bit (``torch.equal``, as ``edge_row``),
    timed against its bound: the kernel row's entry for one path."""
    fn = nms_edge.decode_traj_edge if traj else nms_edge.decode_final_edge
    weights = nms.scalar_weights(params, variant)
    plan = nms_edge.matrix_plan(h)
    b, n = x.shape
    got = fn(params, h, x, ITERS, variant)
    want = nms_edge._decode_edge_plain(x, h, ITERS, weights, traj)
    err = compare(f"{label} {name}", got, want)
    if not torch.equal(got, want):
        raise AssertionError(f"{label} {name}: kernel differs from its plain twin")
    del got, want
    slots = ITERS + 1 if traj else 1
    bms, by = bound_ms(4 * b * n * (1 + slots), nms_edge_ops(h, b, ITERS) / F32_INSTR)
    ms = cuda_ms(lambda: fn(params, h, x, ITERS, variant), 10)
    plain_ms = cuda_ms(lambda: nms_edge._decode_edge_plain(
        x, h, ITERS, weights, traj), 3, warmup=0)
    log(f"{label} {name} ({b}, {n}), bucket {plan.bucket}, {plan.warps} warps a "
        f"frame: == its plain twin bit for bit, {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bms:.4f} ms ({by}), {ms / bms:.2f}x the bound")
    torch.cuda.empty_cache()
    return {
        "shape": (f"llr ({b}, {n}) f32 -> "
                  + (f"({slots}, {b}, {n})" if traj else f"({b}, {n})")
                  + f", T={ITERS}, bucket {plan.bucket}, {plan.warps} warps a frame"),
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
        "bound_by": by, "library_ms": None, "launches": launches}


def wimax_edge_times(dev, tp, buf, rounds):
    """K1 at the point's capture shape (cap_b, 1,056) and K2 at the
    re-decode's (cap, 1,056), each == its plain twin bit for bit on the
    trained factor (``edge_entry``); returns each kernel's entry for its
    row."""
    code = tp.code
    gen = torch.Generator(device=dev).manual_seed(5)
    llr, _ = sample_batch(gen, ChannelSpec.awgn(tp.snr_db, code.rate),
                          torch.as_tensor(code.g, device=dev), tp.cap_b)
    label = f"wimax system {tp.snr_db:.1f} dB"
    return {
        "K1 nms_edge_final": edge_entry(label, "K1 nms_edge_final", tp.nms_params,
                                        tp.variant, code.h, llr, False,
                                        2 * rounds),
        "K2 nms_edge_traj": edge_entry(label, "K2 nms_edge_traj", tp.nms_params,
                                       tp.variant, code.h,
                                       buf["llr"].contiguous(), True, rounds)}


# bytes one call of K5's plain twin, its f64 evaluation or the fp16
# yardstick may build on the card: past it they run in chunks
K5_CHUNK_BYTES = 2**31


def k5_chunks(b, m, ntot):
    """(twin rows, f64 rows, yardstick TEPs) a call for M (b, m, .) x T
    (ntot, .) under :data:`K5_CHUNK_BYTES`: the twin's f32 parities and
    their copy, the f64 products (8 B each), the yardstick's fp16 products
    and their f32 copy (6 B); None where the whole fits."""
    rows = max(1, K5_CHUNK_BYTES // (8 * m * ntot))
    teps = max(256, K5_CHUNK_BYTES // (6 * b * m))
    return (None if rows >= b else rows, min(b, rows),
            None if teps >= ntot else teps)


def k5_entry(label, run, prep, layout, card, twin_rows=None, f64_rows=1024,
             lib_teps=None):
    """K5 on a batch's prepared rows over its path's TEPs: against its twin
    and the f64 evaluation, the block minima and walk from K5 against those
    from the twin (a differing frame passes only at an f64 tie,
    ``ties_only``), the block-minima entry against the unfused path
    (``k5_block_minima``), its launch shapes, timed against its bound and
    the fp16 yardstick; the kernel row's entry for one path."""
    k = run["code"].k
    bounds = layout.bounds
    m_mat = prep.m_matrix.contiguous()
    u_l = engine._discrepancy_terms(prep, k)[1].contiguous()
    t_flat = layout.flat
    err = k5_check(label, m_mat, u_l, t_flat, twin_rows, f64_rows)
    differ, deep = k5_walk(run, prep, u_l, layout, label, twin_rows)
    ties = ties_only(f"K5 vs its twin, {label} walk", prep, differ, deep, t_flat,
                     bounds, k)
    minima = k5_block_minima(label, prep, layout, k, card)
    k5_launch_shape(*m_mat.shape, t_flat.shape[0], f"{label} ")
    k5_launch_shape(*m_mat.shape, t_flat.shape[0], f"{label} ", len(bounds))
    k5 = {"max_abs_err": err, "walk_ties": ties} | k5_timed(
        label, m_mat, u_l, t_flat, twin_rows, lib_teps) | {
            "block_minima": minima}
    if lib_teps:
        k5["library"] = (f"fp16 einsum + mod 2 + einsum chained over "
                         f"{lib_teps} TEPs a call")
    log(f"K5 lterm {label} on {card}: kernel {k5['ms']:.4f} ms, plain "
        f"{k5['plain_ms']:.4f} ms ({twin_rows or m_mat.shape[0]} rows a call), "
        f"library {k5['library_ms']:.4f} ms ({lib_teps or t_flat.shape[0]} TEPs "
        f"a call), bound {k5['bound_ms']:.4f} ms ({k5['bound_by']}), "
        f"{k5['ms'] / k5['bound_ms']:.2f}x the bound")
    del u_l, m_mat
    torch.cuda.empty_cache()
    return k5


def ge_entry(label, perm, h, k, card):
    """The GE kernel's perm load of ``perm`` over ``h`` == its plain packed
    twin == the dense route, timed against its bound; the kernel row's
    entry for one path."""
    ge_check(f"{label} (perm load)", perm, h, k)
    b, n = perm.shape
    m = h.shape[0]
    ge = ge_time(f"{label} on {card}",
                 lambda: gf2_bitpack.reduce_from_perm(perm, h, k),
                 b, m, n, k, "perm")
    ge["ms"] = ge.pop("wrapper_ms")
    ge["plain_ms"] = cuda_ms(lambda: gf2_bitpack._reduce_perm_plain(perm, h, k),
                             3, warmup=1)
    ge["library_ms"] = None
    ge["shape"] = (f"perm ({b}, {n}) int64 over h_osd ({m}, {n}) -> tail ({b}, "
                   f"{m}, {k}) int8 + col_order ({b}, {n}) int32")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return ge


def system_kernels(dev, label, tp, buf, card, twin_rows, f64_rows, lib_teps):
    """K5 and GE on one round's prepared rows of a ``TwoPhase``: K5 against
    its twin (``twin_rows`` rows a call) and the f64 evaluation, the block
    minima and walk from K5 against those from the twin, its launch shape,
    timed against its bound and the fp16 yardstick (``lib_teps`` TEPs a
    call) (``k5_entry``); the GE kernel == its twin == the dense route on
    the round's perm load, timed (``ge_entry``)."""
    code = tp.code
    k = code.k
    llr, labels = buf["llr"], buf["labels"]
    refined = wimax_step(tp, llr, labels)[1]
    prep = engine.prepare(refined, llr, labels, code.h_osd, k)
    run = {"code": code, "fcn": tp.fcn,
           "config": {"window": tp.window, "soft_margin": tp.soft_margin}}
    k5 = k5_entry(label, run, prep, tp.layout, card,
                  twin_rows, f64_rows, lib_teps)
    perm = torch.sort(refined.abs(), dim=1, stable=True).indices
    ge = ge_entry(f"{label}, one round's rows", perm, code.h_osd, k, card)
    return k5, ge


def wimax_card_vs_cpu(tp, buf, rows: int):
    """Walk decisions on the first ``rows`` captured rows through the
    phase-2 step, the card against the port's CPU run (its plain route:
    K2's and K5's twins, the dense GE route) over the full path: equal, or
    the frames that differ tie at f32 (``ties_only``); returns the count
    of those."""
    cpu = system.TwoPhase(WIMAX_RUN, tp.cap_b, tp.cap, tp.snr_db, "cpu")
    llr, labels = buf["llr"][:rows], buf["labels"][:rows]
    outs = []
    for side in (tp, cpu):
        out, refined, det = wimax_step(side, llr.to(side.device),
                                       labels.to(side.device))
        outs.append({key: out[key].cpu() for key in WALK_FIELDS + ("deep_limit",)}
                    | {"detected": det.cpu()})
    card, host = outs
    differ = torch.zeros(rows, dtype=torch.bool)
    for key in WALK_FIELDS + ("detected",):
        differ |= card[key] != host[key]
    k = cpu.code.k
    if differ.any():  # the CPU step's own refined values, prepared
        prep = engine.prepare(refined, llr.cpu(), labels.cpu(), cpu.code.h_osd, k)
        ties = ties_only("wimax card vs CPU walk", prep, differ, torch.maximum(
            card["deep_limit"], host["deep_limit"]), cpu.layout.flat,
            cpu.layout.bounds, k)
    else:
        ties = 0
    log(f"wimax card vs CPU ({tp.snr_db:.1f} dB, the first {rows} captured rows "
        f"of a round, {int(card['detected'].sum())} detected, the full path's "
        f"{tp.layout.ntot} TEPs): walk decisions equal on "
        f"{rows - ties} rows, {ties} rows differing at an f32 tie; successes "
        f"{int(card['success'].sum())} (card) / {int(host['success'].sum())} "
        f"(CPU)")
    return ties


def phase_wimax_system(dev, rows, smi):
    """15: the WiMAX (1056,880) system of ``runs/r5_multicode/wimax_1056_880``
    at both records (``wimax_point``; 3.5 dB on two seeds, each and pooled
    against the record); at each point K1/K2 at the path's shapes == their
    plain twins; at 3.5 dB K5 and GE on one round's rows against their
    plain versions, and card == CPU walk decisions.  The K1, K2, K5 and GE
    rows get the phase's entries under ``wimax_system``."""
    t0 = time.perf_counter()
    launches, edge = {}, {}
    for snr, cap_b, cap, seeds in WIMAX_POINTS:
        point = f"{snr:.1f} dB"
        tp, runs = None, []
        for seed in seeds:  # the first seed's system goes on to the checks
            got, rounds, out = wimax_point(dev, snr, cap_b, cap, seed)
            tp = tp or got
            runs.append(out)
        del got
        if len(runs) > 1:  # the seeds' readings pooled
            total = {key: sum(out[key] for out in runs) for key in (
                "system_frame_errors", "system_frames", "system_osd_success",
                "system_failures")}
            log(f"wimax system {point} seeds {list(seeds)} pooled vs its record: "
                + wimax_vs_record(f"wimax {snr} dB pooled", wimax_record(snr),
                                  *total.values()))
        launches[point] = rounds
        _, buf = tp.capture_round(rounds + 1)
        for name, entry in wimax_edge_times(dev, tp, buf, rounds).items():
            edge.setdefault(name, {})[point] = entry
        if snr == WIMAX_POINTS[0][0]:
            k5, ge = system_kernels(dev, "wimax system", tp, buf, smi,
                                    WIMAX_TWIN_ROWS, WIMAX_F64_ROWS,
                                    WIMAX_LIB_TEPS)
            ties = wimax_card_vs_cpu(tp, buf, WIMAX_CPU_ROWS)
        del tp, buf
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    for row in rows:
        if row["name"] == "K5 lterm":
            row["wimax_system"] = k5 | {"launches": launches}
        elif row["name"] == "GE ge_packed":
            row["wimax_system"] = ge | {"launches": launches}
        elif row["name"] in edge:
            row["wimax_system"] = edge[row["name"]]
    log("wimax system: " + json.dumps({
        "seconds": time.perf_counter() - t0, "card_vs_cpu_rows": WIMAX_CPU_ROWS,
        "card_vs_cpu_ties": ties, "card": smi}))


# K5's general plan off the WiMAX round: the multicode eval steps' shapes
# (captured rows, the path's padded TEPs), then two ragged ones (m not a
# multiple of 16, k not of 16; N not a multiple of the 64-TEP tile)
K5_GENERAL_SHAPES = (("multicode wimaxlike_384_192", 400, 192, 192, 58_368),
                     ("multicode regular_256_128", 200, 128, 128, 8_192))
K5_RAGGED = ((5, 61, 100, 130), (3, 170, 300, 1_000))
K5_SAME_TIME = 0.03  # the path's T against a dense random T


def k5_f64_only(label, inputs, f64_rows: int = 1024):
    """K5 on N(0, 1.5) weights against the f64 evaluation alone (1e-6)."""
    m_mat, _, t_flat = inputs
    got = osd_disc.lterm(*inputs)
    err = compare(f"K5 lterm {label} N(0, 1.5) vs f64", got.double(),
                  lterm_f64(*inputs, f64_rows), rel=True, tol=1e-6)
    log(f"K5 lterm {label} M {tuple(m_mat.shape)} x T {tuple(t_flat.shape)}, "
        f"u_l N(0, 1.5): max_abs_err vs f64 {err:.3g}")


def k5_recorded_general(tp, i: int) -> dict:
    """``k5.general`` and ``k5.block_minima`` counted in one recorded full
    round of ``tp``."""
    with profiling.recording(record=profiling.Record()) as rec:
        tp.full_round(i)
    torch.cuda.synchronize()
    counters = rec.snapshot()["counters"]
    return {key: counters.get(key, 0)
            for key in ("k5.general", "k5.block_minima", "k5.minima_decode")}


def phase_k5_general(dev, rows, smi):
    """K5's general plan (frame-stationary, TEPs by TMA into wgmma): the
    build's ptxas and IMMA/IGMMA lines; on one WiMAX 3.5 dB round's 1,024
    prepared rows over the path's 102,912 padded TEPs, K5 against its twin
    (1e-5) and the f64 evaluation (1e-6), the walk, its launch shape and
    times (``k5_entry``); the same shape timed with the path's T and with a
    dense random 0/1 T in turns, the medians within 3% (the kernel skips
    nothing by content); wimaxlike's and regular's multicode shapes and two
    ragged ones against the f64 evaluation on N(0, 1.5) weights, and against
    twin and f64 on weights drawn from the round's u_l, the first two timed
    against their bounds; ``k5.general`` 1 in a recorded WiMAX round and 0
    in a CCSDS one, ``k5.block_minima`` 1 in both, ``k5.minima_decode`` as
    ``k5.general``; the block-minima epilogue on its own terms on 256 of the
    round's rows (``k5_block_minima_exact``).
    The K5 row gets the entries under ``k5_general``."""
    t0 = time.perf_counter()
    k5_build_lines()
    tp = system.TwoPhase(WIMAX_RUN, 4_096, 1_024, 3.5, dev, 77)
    tp.full_round(0)
    _, buf = tp.capture_round(1)
    code = tp.code
    refined = wimax_step(tp, buf["llr"], buf["labels"])[1]
    prep = engine.prepare(refined, buf["llr"], buf["labels"], code.h_osd, code.k)
    run = {"code": code, "fcn": tp.fcn,
           "config": {"window": tp.window, "soft_margin": tp.soft_margin}}
    entry = {"wimax_system": k5_entry(
        "wimax system (general plan)", run, prep, tp.layout,
        smi, WIMAX_TWIN_ROWS, WIMAX_F64_ROWS, WIMAX_LIB_TEPS)}
    # the round's own weights: the twin's f32 sum holds 1e-5 on them (on
    # N(0, 1.5) weights, whose sums cancel, only the f64 evaluation does)
    u_pool = engine._discrepancy_terms(prep, code.k)[1].flatten().cpu().numpy()
    entry["wimax_system"]["block_minima"]["exact"] = k5_block_minima_exact(
        "wimax round rows (general plan)", prep, code.k, 256, 4_096, 95, smi)
    del refined, prep
    t_path = tp.layout.flat
    ntot = t_path.shape[0]
    m_mat, u_l, t_dense = k5_inputs(dev, 1_024, tp.code.h_osd.shape[0],
                                    tp.code.k, ntot, 40)
    times = {"path": [], "dense": []}
    for which in ("path", "dense", "dense", "path"):
        t_flat = t_path if which == "path" else t_dense
        times[which].append(cuda_ms(lambda: osd_disc.lterm(m_mat, u_l, t_flat), 5))
    path_ms, dense_ms = (statistics.median(times[w]) for w in ("path", "dense"))
    gap = abs(path_ms - dense_ms) / min(path_ms, dense_ms)
    log(f"K5 general plan at M (1024, {m_mat.shape[1]}, {tp.code.k}) x "
        f"{ntot} on {smi}: the path's T {path_ms:.4f} ms, a dense random T "
        f"{dense_ms:.4f} ms (turns {json.dumps(times)}), {100 * gap:.2f}% apart")
    if gap > K5_SAME_TIME:
        raise AssertionError(f"K5: the path's T and a dense T {100 * gap:.2f}% "
                             "apart: the kernel's time depends on T's bits")
    entry["content"] = {"path_ms": path_ms, "dense_ms": dense_ms, "gap": gap}
    del m_mat, u_l, t_dense
    for i, (name, b_, m_, k_, n_) in enumerate(K5_GENERAL_SHAPES):
        twin_rows, f64_rows, lib_teps = k5_chunks(b_, m_, n_)
        k5_f64_only(name, k5_inputs(dev, b_, m_, k_, n_, 60 + i), f64_rows)
        inputs = k5_inputs(dev, b_, m_, k_, n_, 41 + i, u_pool)
        err = k5_check(f"{name} (u_l from the WiMAX round)", *inputs, twin_rows,
                       f64_rows)
        k5_launch_shape(b_, m_, k_, n_, f"{name} ")
        entry[name] = {"max_abs_err": err} | k5_timed(
            name, *inputs, twin_rows, lib_teps)
        log(f"K5 lterm {name} on {smi}: kernel {entry[name]['ms']:.4f} ms, "
            f"bound {entry[name]['bound_ms']:.4f} ms "
            f"({entry[name]['bound_by']}), plain {entry[name]['plain_ms']:.4f} "
            f"ms, library {entry[name]['library_ms']:.4f} ms")
        del inputs
    for i, shape in enumerate(K5_RAGGED):
        k5_f64_only("ragged", k5_inputs(dev, *shape, 70 + i))
        k5_check("ragged (u_l from the WiMAX round)",
                 *k5_inputs(dev, *shape, 50 + i, u_pool))
        k5_launch_shape(*shape, "ragged ")
    counts = {"wimax": k5_recorded_general(tp, 2)}
    del tp, buf
    torch.cuda.empty_cache()
    counts["ccsds"] = k5_recorded_general(system.TwoPhase(R4, device=dev), 0)
    log(f"K5 k5.general and k5.block_minima counted in a recorded round: "
        f"{json.dumps(counts)}")
    if counts != {"wimax": {"k5.general": 1, "k5.block_minima": 1,
                            "k5.minima_decode": 1},
                  "ccsds": {"k5.general": 0, "k5.block_minima": 1,
                            "k5.minima_decode": 0}}:
        raise AssertionError(f"K5 counters {counts}: expected k5.general and "
                             "k5.minima_decode 1 (WiMAX) and 0 (CCSDS), "
                             "k5.block_minima 1 in both")
    for row in rows:
        if row["name"] == "K5 lterm":
            row["k5_general"] = entry
    log("k5 general: " + json.dumps({
        "seconds": time.perf_counter() - t0, "card": smi}))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# runs/r5_multicode: the JAX package's multi-code records (NMS-1, 12
# iterations, model_cnn, (3, 30, 6), window 5, soft margin 0.9), in the
# phase's order; the SNR of each code's kernel checks (2.5 dB, or
# MC_KERNEL_SNR's), an eval point where a step captures its OSD budget
MC_ROOT = os.path.join(ROOT, "runs", "r5_multicode")
MULTICODE = ("qc_96_48", "array_121_60", "wimaxlike_384_192", "regular_256_128")
MC_KERNEL_SNR = {"wimaxlike_384_192": 2.0}


def multicode_record(name):
    """One code's record directory: its ``RecipeConfig`` (== the port's
    ``multicode.code_plan``), SNR points, harvest meta, fer curve by SNR and
    decoding-path histograms."""
    d = os.path.join(MC_ROOT, name)
    cfg = recipe_config(d)
    plan_cfg, snrs = multicode.code_plan(name)
    if dataclasses.asdict(plan_cfg) != dataclasses.asdict(cfg):
        raise AssertionError(f"{name}: the record's config.json is not the plan's")
    curve = {round(p["snr_db"], 2): p
             for p in read_json(os.path.join(d, "fer_curve.json"))["points"]}
    if sorted(curve) != [round(float(x), 2) for x in snrs]:
        raise AssertionError(f"{name}: record points {sorted(curve)} != plan {snrs}")
    return {"dir": d, "config": cfg, "snrs": snrs, "curve": curve,
            "harvest": read_json(os.path.join(d, "train_failures_meta.json")),
            "path": read_json(os.path.join(d, "decoding_path.json"))}


@contextlib.contextmanager
def patched(module, name, wrap):
    """While open, ``module.<name>`` is ``wrap(the original)``."""
    plain = getattr(module, name)
    setattr(module, name, wrap(plain))
    try:
        yield
    finally:
        setattr(module, name, plain)


def counted_eval_sweeps(seen: list):
    """While open, each ``recipe.stage_eval_sweep`` call runs with the launch
    counts reset just before it and appends them, read just after, to
    ``seen``."""
    def wrap(plain):
        def counted(*args, **kwargs):
            _kernels.reset_launches()
            out = plain(*args, **kwargs)
            seen.append(dict(_kernels.LAUNCHES))
            return out
        return counted
    return patched(recipe, "stage_eval_sweep", wrap)


def multicode_records_sweep(dev, name, rec):
    """(a) The record's own artifacts (``load_run``, numpy-only) through
    ``recipe.stage_eval_sweep`` at its points and budgets; the statistics
    against ``fer_curve.json``, the launches counted.  Returns the run, the
    capture batch and the sweep's summary."""
    run = load_run(rec["dir"], dev)
    cfg, code = rec["config"], run["code"]
    params = {k: v.cpu() for k, v in run["nms_params"].items()}
    cap_b = recipe.capture_batch(cfg, code, dev)
    with tempfile.TemporaryDirectory() as tmp:
        _kernels.reset_launches()
        t0 = time.perf_counter()
        curve = recipe.stage_eval_sweep(cfg, recipe.RunDir(tmp), params, run["dia"],
                                        run["fcn"], run["path"], rec["snrs"], log,
                                        dev)
        synchronize(dev)
        seconds = time.perf_counter() - t0
    launches = sweep_launches(f"multicode {name} (record artifacts)",
                              dict(_kernels.LAUNCHES), curve, cap_b)
    texts = sweep_vs_record(f"multicode {name} (record artifacts)", curve, rec)
    return run, cap_b, {"seconds": seconds, "launches": launches,
                        "points": texts}


def path_kernels(dev, label, run, spec, batch, rows, launches, card, seed):
    """K1 at a path's capture shape (``batch``, n) on one step drawn from
    ``spec``, K2 at its re-decode shape on that step's first ``rows``
    failures, then the GE kernel and K5 on those rows refined and prepared
    over ``h_osd`` with the run's path: each against its plain versions and
    timed (``edge_entry``, ``ge_entry``, ``k5_entry``; K5's checks chunked
    by ``k5_chunks``).  ``launches`` holds the path's counts.  Returns each
    kernel's entry and the rows (llr, labels)."""
    code = run["code"]
    params = {k: v.cpu() for k, v in run["nms_params"].items()}
    gen = torch.Generator(device=dev).manual_seed(seed)
    llr, words = sample_batch(gen, spec, torch.as_tensor(code.g, device=dev), batch)
    entries = {"K1 nms_edge_final": edge_entry(
        label, "K1 nms_edge_final", params, "NMS-1", code.h, llr, False,
        launches["nms_edge_final"])}
    soft = nms_edge.decode_final_edge(params, code.h, llr, ITERS)
    _, cap = count_and_capture(llr, words, soft, code.h, rows)
    rows = min(int(cap["count"]), rows)
    x, labels = cap["llr"][:rows].contiguous(), cap["labels"][:rows]
    del llr, words, soft, cap
    entries["K2 nms_edge_traj"] = edge_entry(
        label, "K2 nms_edge_traj", params, "NMS-1", code.h, x, True,
        launches["nms_edge_traj"])
    with torch.no_grad():
        traj = nms_edge.decode_traj_edge(params, code.h, x, ITERS)
        refined = run["dia"].refine_fast(traj.permute(1, 0, 2))
    del traj
    perm = torch.sort(refined.abs(), dim=1, stable=True).indices
    entries["GE ge_packed"] = ge_entry(f"{label}, {rows} captured rows", perm,
                                       code.h_osd, code.k, card) | {
        "launches": launches["ge_packed"]}
    prep = engine.prepare(refined, x, labels, code.h_osd, code.k)
    layout = segments.TepLayout.build(
        run["path"], code.k, int(run["config"].get("num_segments", 6)), dev)
    entries["K5 lterm"] = k5_entry(
        label, run, prep, layout, card,
        *k5_chunks(rows, code.h_osd.shape[0], layout.flat.shape[0])) | {
        "launches": launches["lterm"], "teps": layout.ntot}
    del prep, layout
    torch.cuda.empty_cache()
    return entries, (x, labels)


def multicode_retrain(dev, name, rec):
    """(b) ``pipeline.multicode`` for the code in a temporary out-root whose
    run directory holds only the record's ``config.json`` and
    ``nms_params.pkl`` (stage 1 reused): the harvest FER and the initial MRB
    zero-error share against the record, the refined count above the
    initial one, the DIA's and the stopper's losses falling, every eval
    point against ``fer_curve.json`` with its launches counted, the run
    directory through ``load_run``; returns the summary."""
    with tempfile.TemporaryDirectory() as root:
        d = os.path.join(root, name)
        os.makedirs(d)
        for artifact in ("config.json", "nms_params.pkl"):
            shutil.copy(os.path.join(rec["dir"], artifact), d)
        seen = []
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with counted_eval_sweeps(seen):
            multicode.main(["--codes", name, "--out-root", root, "--device", "cuda"])
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        pickle_ref = os.path.join(rec["dir"], "nms_params.pkl")
        if (os.path.exists(os.path.join(d, "nms_train_summary.json"))
                or not filecmp.cmp(os.path.join(d, "nms_params.pkl"), pickle_ref,
                                   shallow=False)):
            raise AssertionError(f"multicode {name}: stage 1 was retrained")
        summary = read_json(os.path.join(root, "summary.json"))
        if list(summary) != [name]:
            raise AssertionError(f"multicode {name}: summary.json holds {list(summary)}")

        meta, ref_meta = read_json(os.path.join(d, "train_failures_meta.json")), rec["harvest"]
        harvest = share_text(f"multicode {name} harvest FER",
                             (meta["detected_failures"], meta["frames"]),
                             (ref_meta["detected_failures"], ref_meta["frames"]))
        paths, ref_paths = read_json(os.path.join(d, "decoding_path.json")), rec["path"]
        initial, refined = paths["hist_initial"], paths["hist_refined"]
        ref_initial = ref_paths["hist_initial"]
        zero = share_text(f"multicode {name} initial MRB zero-error share",
                          (initial.get("0", 0), sum(initial.values())),
                          (ref_initial.get("0", 0), sum(ref_initial.values())))
        if not refined.get("0", 0) > initial.get("0", 0):
            raise AssertionError(f"multicode {name}: refined MRB zero-error count "
                                 f"{refined.get('0', 0)} <= initial {initial.get('0', 0)}")
        hist = read_json(os.path.join(d, "dia_model_cnn_train_summary.json"))["history"]
        if not hist[-1]["loss_mean"] < hist[0]["loss_mean"]:
            raise AssertionError(f"multicode {name}: DIA loss did not fall: "
                                 f"{hist[0]} -> {hist[-1]}")
        val = read_json(os.path.join(d, "stopper_validation.json"))
        if not val["final_loss"] < val["initial_loss"]:
            raise AssertionError(f"multicode {name}: stopper loss did not fall: {val}")

        curve = read_json(os.path.join(d, "fer_curve.json"))
        cfg = recipe_config(d)
        cap_b = recipe.capture_batch(cfg, get_code(name), dev)
        if len(seen) != 1:
            raise AssertionError(f"multicode {name}: {len(seen)} eval sweeps")
        launches = sweep_launches(f"multicode {name} (retrained)", seen[0], curve,
                                  cap_b)
        texts = sweep_vs_record(f"multicode {name} (retrained)", curve, rec)
        written = load_run(d, dev)
        if numpy_layouts(d) != numpy_layouts(rec["dir"]):
            raise AssertionError(f"multicode {name}: run-dir pickles differ from "
                                 "the JAX layout")
        stages = read_json(os.path.join(d, "stage_seconds.json"))
        out = {
            "seconds": seconds, "stage_seconds": stages, "peak_memory_bytes": peak,
            "capture_batch": cap_b, "launches": launches, "harvest": harvest,
            "harvested": sum(initial.values()),
            "mrb_zero_initial": zero,
            "mrb_zero_refined": [refined.get("0", 0),
                                 ref_paths["hist_refined"].get("0", 0)],
            "dia_loss": [hist[0]["loss_mean"], hist[-1]["loss_mean"]],
            "stopper_loss": [val["initial_loss"], val["final_loss"]],
            "path_len": len(written["path"]), "points": texts}
    return out


def phase_multicode(dev, rows, smi):
    """16: the multi-code recipe of ``runs/r5_multicode`` for each code of
    :data:`MULTICODE`: (a) its eval sweep on the record's artifacts, (b)
    ``pipeline.multicode`` retrained with stage 1 reused, each held to the
    record; K1, K2, GE and K5 at the code's shapes on its real rows against
    their plain versions, timed; the kernel rows get ``multicode_<code>``
    entries."""
    t0 = time.perf_counter()
    for name in MULTICODE:
        rec = multicode_record(name)
        run, cap_b, sweep = multicode_records_sweep(dev, name, rec)
        snr = MC_KERNEL_SNR.get(name, 2.5)
        entries, _ = path_kernels(
            dev, f"multicode {name} {snr:.1f} dB", run,
            ChannelSpec.awgn(snr, run["code"].rate), cap_b,
            rec["config"].osd_failure_budget, sweep["launches"], smi, 16)
        del run
        torch.cuda.empty_cache()
        retrained = multicode_retrain(dev, name, rec)
        for row in rows:
            if row["name"] in entries:
                row[f"multicode_{name}"] = entries[row["name"]]
        log(f"multicode {name}: " + json.dumps({
            "capture_batch": cap_b, "record_artifacts": sweep,
            "retrained": retrained, "card": smi}))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    log(f"multicode: {time.perf_counter() - t0:.1f} s")


R5_RAYLEIGH = os.path.join(ROOT, "runs", "r5_rayleigh")
RAYLEIGH_CPU_ROWS = 64  # walked rows whose decisions are held card == CPU
# the eval-nms record's command line (docs/ROUND5.md §5)
RAYLEIGH_CLI = ["eval-nms", "--channel", "rayleigh", "--snrs", "4.0:8.0:3",
                "--max-frames", "65536"]


def counted_rayleigh_points(seen: list):
    """While open, ``rayleigh.run_points`` reads the launch counts at the
    end of each point (its log call) into ``seen`` with the point, then
    resets them."""
    def wrap(plain):
        def counted(*args, log=print, **kwargs):
            def log_point(line):
                seen.append((json.loads(line), dict(_kernels.LAUNCHES)))
                _kernels.reset_launches()
                log(line)
            return plain(*args, log=log_point, **kwargs)
        return counted
    return patched(rayleigh, "run_points", wrap)


def rayleigh_points(dev):
    """``pipeline.rayleigh`` at its defaults: each point's NMS FER and OSD
    successes of walked against ``two_phase_rayleigh.json`` by 99.9% Wilson
    overlap; each point's launches K1 one a capture step, K2, GE and K5 one,
    no fused counter kernel.  Returns the launches summed over the points."""
    rec = {round(p["snr_db"], 1): p for p in read_json(
        os.path.join(R5_RAYLEIGH, "two_phase_rayleigh.json"))["points"]}
    seen = []
    with tempfile.TemporaryDirectory() as tmp, counted_rayleigh_points(seen):
        _kernels.reset_launches()
        rayleigh.main(["--run", R4, "--out", tmp])
        written = read_json(os.path.join(tmp, "two_phase_rayleigh.json"))["points"]
    if [p for p, _ in seen] != written or len(written) != len(rec):
        raise AssertionError("rayleigh: the written points are not the run's")
    total = {}
    for point, launches in seen:
        ref = rec[round(point["snr_db"], 1)]
        want = {"nms_edge_final": point["frames"] // rayleigh.BATCH}
        want |= {key: 1 for key in SWEEP_ONCE}
        got = {key: n for key, n in launches.items() if n}
        if got != want or point["frames"] != ref["frames"]:
            raise AssertionError(f"rayleigh {point['snr_db']} dB: launches {got} "
                                 f"(expected {want}), frames {point['frames']}")
        fer = share_text(f"rayleigh {point['snr_db']} dB fer_nms_detected",
                         (round(point["fer_nms_detected"] * point["frames"]),
                          point["frames"]),
                         (round(ref["fer_nms_detected"] * ref["frames"]),
                          ref["frames"]))
        osd = share_text(f"rayleigh {point['snr_db']} dB OSD successes of walked",
                         (point["osd_success"], point["osd_walked"]),
                         (ref["osd_success"], ref["osd_walked"]))
        log(f"rayleigh {point['snr_db']:.1f} dB: {point['time_s']} s, frames "
            f"{point['frames']}, launches {got}, fer_nms_detected {fer}, OSD "
            f"successes {osd}, fer_total {point['fer_total']:.5g} (record "
            f"{ref['fer_total']:.5g}), {torch.cuda.get_device_name(0)}")
        for key, n in got.items():
            total[key] = total.get(key, 0) + n
    return total


def rayleigh_cli():
    """``sldpc-torch eval-nms --channel rayleigh`` in a new process on a run
    directory holding ``runs/r4_pipeline``'s NMS factor: each point's frame
    errors against ``nms_fer.json``; returns its seconds."""
    rec = {round(p["snr_db"], 1): p for p in read_json(
        os.path.join(R5_RAYLEIGH, "nms_fer.json"))["points"]}
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copy(os.path.join(R4, "nms_params.pkl"), tmp)
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "short_ldpc_decoding_osd_tpu_torch.cli.main",
             *RAYLEIGH_CLI, "--run-dir", tmp],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        if cli.returncode != 0:
            raise AssertionError(f"sldpc-torch eval-nms failed: {cli.stderr[-2000:]}")
        points = read_json(os.path.join(tmp, "nms_fer.json"))["points"]
    if sorted(round(p["snr_db"], 1) for p in points) != sorted(rec):
        raise AssertionError(f"eval-nms rayleigh points {points}")
    for point in points:
        ref = rec[round(point["snr_db"], 1)]
        text = share_text(f"eval-nms rayleigh {point['snr_db']} dB frame errors",
                          (point["frame_errors"], point["frames"]),
                          (ref["frame_errors"], ref["frames"]))
        log(f"rayleigh eval-nms {point['snr_db']:.1f} dB: frame errors {text}")
    log(f"rayleigh eval-nms: {seconds:.1f} s in a new process")
    return seconds


def rayleigh_kernels(dev, launches, card):
    """K1 on one 6 dB Rayleigh capture step's frames (65,536) == its plain
    twin bit for bit; K2, the GE kernel and K5 on that step's first 500
    failures (the walked rows) against their plain versions, each timed
    (``path_kernels``); walk decisions card == CPU on 64 of them.  Returns
    each kernel's entry."""
    run = load_run(R4, dev)
    spec = ChannelSpec.rayleigh_spec(6.0, run["code"].rate, duration=1)
    entries, (x, labels) = path_kernels(dev, "rayleigh 6.0 dB", run, spec,
                                        rayleigh.BATCH, 500, launches, card,
                                        rayleigh.SEED)
    phase_card_vs_cpu(dev, R4, "rayleigh 6.0 dB walked rows",
                      (x[:RAYLEIGH_CPU_ROWS], labels[:RAYLEIGH_CPU_ROWS]))
    return entries


def phase_rayleigh(dev, rows, smi):
    """17: the Rayleigh two-phase system (``pipeline.rayleigh`` at its
    defaults on ``runs/r4_pipeline``, 16-bit fade blocks) against
    ``runs/r5_rayleigh``'s records, ``sldpc-torch eval-nms --channel
    rayleigh`` in a new process, and K1, K2, GE and K5 on Rayleigh rows; the
    kernel rows get ``rayleigh`` entries."""
    t0 = time.perf_counter()
    launches = rayleigh_points(dev)
    cli_seconds = rayleigh_cli()
    entries = rayleigh_kernels(dev, launches, smi)
    for row in rows:
        if row["name"] in entries:
            row["rayleigh"] = entries[row["name"]]
    log("rayleigh: " + json.dumps({
        "seconds": time.perf_counter() - t0, "launches": launches,
        "eval_nms_seconds": cli_seconds, "card_vs_cpu_rows": RAYLEIGH_CPU_ROWS,
        "card": smi}))


R5_VARIANTS = os.path.join(ROOT, "runs", "r5_variants")
NMSR_RUN = os.path.join(ROOT, "runs", "r5_variants_nmsr")
# frames of each scalar variant's evaluation point, of the untrained NMS-r
# point (the record's 16,384 fail but 7), of the trained NMS-r's eval-nms
VARIANT_FRAMES, NMS_R_INIT_FRAMES, NMS_R_CLI_FRAMES = 2_097_152, 65_536, 262_144
VARIANT_SEED = 15
# the retrained NMS-r must decode: far below the untrained net's 0.9996
NMS_R_MAX_FER = 0.2
# rounds of the NMS-r two-phase system (262,144 frames and 32,768 capture
# rows a round, as the main path); its walked rows held card == CPU
NMS_R_ROUNDS, NMS_R_CPU_ROWS = 4, 64
# the refined values of the NMS-r walk, card against CPU: the phase-2
# tolerance of the multi-code and Rayleigh CPU tests (STEP_TOL)
NMS_R_REFINED_TOL = 1e-4
# sldpc-torch in a new process that also prints one "probe: {json}" line:
# the decoder of each capture step it built and its launch counts
CLI_PROBE = """import json, sys
import chip_smoke
from short_ldpc_decoding_osd_tpu_torch import _kernels
from short_ldpc_decoding_osd_tpu_torch.cli.main import main
built = []
with chip_smoke.recorded_decoders(built):
    rc = main(sys.argv[1:])
print("probe: " + json.dumps({"decoders": built, "launches": {
    k: n for k, n in _kernels.LAUNCHES.items() if n}}))
sys.exit(rc)
"""


def variant_records():
    """``variant_fer.json``'s points by variant and ``nms_r_trained.json``'s
    (frame errors, frames)."""
    recs = {p["variant"]: (p["frame_errors"], p["frames"]) for p in read_json(
        os.path.join(R5_VARIANTS, "variant_fer.json"))["points"]}
    (trained,) = read_json(os.path.join(R5_VARIANTS, "nms_r_trained.json"))["points"]
    return recs, (trained["frame_errors"], trained["frames"])


def timed_once(fn):
    """(``fn()``, its CUDA-event milliseconds): one call of a slow plain
    twin, its result the comparison's and its time the row's."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def counters_equal(label, got, want):
    got, want = got.cpu().to(torch.int64), want.cpu().to(torch.int64)
    if not torch.equal(got, want):
        raise AssertionError(f"{label}: kernel {got.tolist()} vs plain "
                             f"{want.tolist()}")
    return got.tolist()


def variant_weight_sets(nms3_dir):
    """The two weight sets of the kernel checks: NMS-2's initial
    parameters, and the NMS-3 factor the card trained (``nms3_dir``), whose
    w_vc and w_marg differ."""
    trained = recipe.host_params(load_jax_pickle(os.path.join(nms3_dir,
                                                              "nms_params.pkl")))
    sets = {"NMS-2 init": (nms.init_params("NMS-2"), "NMS-2"),
            "NMS-3 trained": (trained, "NMS-3")}
    w_vc, w_chk, w_marg = nms.scalar_weights(trained, "NMS-3")
    log(f"NMS-3 trained on the card: (w_vc, w_chk, w_marg) = ({w_vc:.6f}, "
        f"{w_chk:.6f}, {w_marg:.6f}); w_vc - w_marg = {w_vc - w_marg:+.6f}")
    if w_vc == w_marg:
        raise AssertionError("NMS-3 trained: w_vc == w_marg")
    return sets


def dense_entry(label, params, variant, h, x):
    """K6 on the rows ``x`` == its plain twin bit for bit (and compared with
    K1), timed against its bound."""
    hd = torch.as_tensor(np.asarray(h), dtype=torch.float32, device=x.device)
    weights = nms.scalar_weights(params, variant)
    got = nms_dense.decode_final_dense(params, hd, x, ITERS, variant)
    want, plain_ms = timed_once(lambda: nms_dense._decode_dense_plain(
        hd, x, ITERS, weights))
    err = compare(f"{label} K6", got, want)
    if not torch.equal(got, want):
        raise AssertionError(f"{label} K6: kernel differs from its plain twin")
    same_k1 = torch.equal(got, nms_edge.decode_final_edge(params, h, x, ITERS,
                                                          variant))
    del got, want
    b, n = x.shape
    bms, by = bound_ms(4 * b * n * 2, nms_edge_ops(h, b, ITERS) / F32_INSTR)
    ms = cuda_ms(lambda: nms_dense.decode_final_dense(params, hd, x, ITERS,
                                                      variant), 10)
    log(f"{label} K6 dense_final ({b}, {n}): == its plain twin bit for bit, "
        f"== K1 {same_k1}, {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bms:.4f} ms ({by}), {ms / bms:.2f}x the bound")
    return {"shape": f"h (64, 128) f32, llr ({b}, {n}) f32 -> ({b}, {n}), T={ITERS}",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": None, "launches": None}


def mc_entry(label, name, fn, want, plain_ms, ops, nbytes, shape):
    """A fused Monte-Carlo kernel at a weight set: ``fn()``'s counters equal
    to its twin's ``want`` (``plain_ms`` to compute), timed."""
    counters_equal(f"{label} {name}", fn(), want)
    bms, by = bound_ms(nbytes, ops / F32_INSTR)
    ms = cuda_ms(fn, 5)
    log(f"{label} {name}: counters {want.tolist()} == its plain twin's, "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by}), "
        f"{ms / bms:.2f}x the bound")
    return {"shape": shape, "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None, "launches": None}


def cascade_twin(mc, t1, batch, block=512):
    """``mc_cascade.cascade_counters`` written out over the plain twins
    (the calibration, the capacity and its doubling retry alike)."""
    calib = min(batch, 131_072)
    c1 = nms_edge._mc_frames_plain(mc, t1, calib, stage=True)[0]
    cap = mc_cascade.capacity(1.0 - float(c1[0]) / calib, batch, block)
    while True:
        c1, flags, _ = nms_edge._mc_frames_plain(mc, t1, batch, stage=True)
        ids = mc_cascade.fixed_capacity_ids(flags, cap)
        c2 = nms_edge._mc_frames_plain(mc, ITERS, len(ids), ids)[0]
        if int(batch - c1[0] - c2[0]) <= 0 or cap >= batch:
            return (c1 + c2)[:5]
        cap = min(batch, 2 * cap)


def variant_kernels(dev, label, params, variant, seed, cascade):
    """18(a) at one weight set: K1 (262,144 frames), K2 (the 32,768 first
    failures of that step) and K6 (262,144) == their plain twins bit for
    bit; K4, K3 and K7 at 2,097,152 frames with counters equal to their
    twins'; with ``cascade`` one ``cascade_counters`` call (K8a, K8b) ==
    its twin, its launches counted; each timed.  Returns each row's
    entry."""
    code = get_code("ccsds_128_64")
    h, big, t1 = code.h, PH1_BATCH, 4
    llr, words = sample_batch(torch.Generator(device=dev).manual_seed(seed),
                              ChannelSpec.awgn(3.0, code.rate),
                              torch.as_tensor(code.g, device=dev), CAP_B)
    out = {"K1 nms_edge_final": edge_entry(label, "K1 nms_edge_final", params,
                                           variant, h, llr, False, None)}
    soft = nms_edge.decode_final_edge(params, h, llr, ITERS, variant)
    _, cap = count_and_capture(llr, words, soft, h, CAP)
    out["K2 nms_edge_traj"] = edge_entry(label, "K2 nms_edge_traj", params,
                                         variant, h, cap["llr"].contiguous(),
                                         True, None)
    out["K6 dense_final"] = dense_entry(label, params, variant, h, llr)
    del llr, words, soft, cap
    torch.cuda.empty_cache()

    mc = nms_edge.mc_setup(code, params, variant, 3.0, seed, dev)
    c1, flags = mc_cascade.phase1(mc, t1, big)
    unconv = big - int(c1[0])
    del flags
    want, plain_ms = timed_once(lambda: nms_edge._mc_frames_plain(mc, ITERS, big)[0][:5])
    out["K4 mc_oneshot"] = mc_entry(
        label, "K4 mc_oneshot", lambda: nms_edge.fused_counters_edge(
            code, params, variant, ITERS, 3.0, big, seed, device=dev),
        want, plain_ms, nms_edge_ops(h, big, ITERS), 8 * 5,
        f"{big} hash frames, T={ITERS} -> (5,) int64")
    rows_s, final = nms_edge.build_rows_schedule(((t1, 0.375),), 1024, ITERS)
    want, plain_ms = timed_once(lambda: nms_edge._compact_plain(
        mc, big, 1024, rows_s, final))
    out["K3 mc_compact"] = mc_entry(
        label, "K3 mc_compact", lambda: nms_edge.fused_counters_edge_compact(
            code, params, variant, ITERS, 3.0, big, seed, block_frames=1024,
            schedule=((t1, 0.375),), device=dev),
        want, plain_ms,
        edge_ops(h, big * t1 + unconv * (ITERS - t1), big + unconv), 8 * 6,
        f"{big} hash frames, groups of 1024, schedule ((4, 384),), T={ITERS} "
        "-> (6,) int64")
    hc = torch.as_tensor(code.h, dtype=torch.float32, device=dev)
    gc = torch.as_tensor(code.g, dtype=torch.float32, device=dev)
    sigma = float(np.float32(sigma_for_snr(3.0, code.rate)))
    want, plain_ms = timed_once(lambda: mc_dense._mc_dense_plain(
        mc.weights, seed, hc, gc, ITERS, big, sigma, 1.0))
    out["K7 mc_dense"] = mc_entry(
        label, "K7 mc_dense", lambda: mc_dense.fused_counters(
            code, params, variant, ITERS, 3.0, big, seed, device=dev),
        want, plain_ms, nms_edge_ops(h, big, ITERS), 8 * 5,
        f"{big} hash frames, h (64, 128) + G (64, 128) f32, T={ITERS} -> (5,) int64")
    if cascade:
        out |= variant_cascade(dev, label, code, params, variant, mc, seed, t1,
                               unconv)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def variant_cascade(dev, label, code, params, variant, mc, seed, t1, unconv):
    """One ``cascade_counters`` call (2,097,152 frames) == its twin, its
    launches counted; K8a and K8b each timed against its twin part."""
    big, h = PH1_BATCH, code.h
    want, twin_ms = timed_once(lambda: cascade_twin(mc, t1, big))
    _kernels.reset_launches()
    got = mc_cascade.cascade_counters(code, params, variant, ITERS, 3.0, big, seed,
                                      t1=t1, device=dev)
    launches = {k: n for k, n in _kernels.LAUNCHES.items() if n}
    counters_equal(f"{label} cascade", got, want)
    if set(launches) != {"cascade_p1", "cascade_p2"}:
        raise AssertionError(f"{label} cascade launched {launches}")
    log(f"{label} cascade_counters: {want.tolist()} == its twin's ({twin_ms:.1f} "
        f"ms), launches {launches}")
    _, flags = mc_cascade.phase1(mc, t1, big)
    ids = mc_cascade.fixed_capacity_ids(
        flags, mc_cascade.capacity(unconv / big, big, 512))
    p1_plain = timed_once(lambda: nms_edge._mc_frames_plain(mc, t1, big,
                                                            stage=True))[1]
    p2_want, p2_plain = timed_once(lambda: nms_edge._mc_frames_plain(
        mc, ITERS, len(ids), ids)[0][:5])
    out = {
        "K8a cascade_p1": mc_entry(
            label, "K8a cascade_p1", lambda: mc_cascade.phase1(mc, t1, big)[0],
            nms_edge._mc_frames_plain(mc, t1, big, stage=True)[0][:5], p1_plain,
            edge_ops(h, big * t1, big), 4 * big,
            f"{big} hash frames, t1={t1} -> (5,) int64 + flags ({big},) int32"),
        "K8b cascade_p2": mc_entry(
            label, "K8b cascade_p2", lambda: mc_cascade.phase2(mc, ITERS, ids),
            p2_want, p2_plain, edge_ops(h, unconv * ITERS, unconv), 4 * len(ids),
            f"ids ({len(ids)},) int32 ({unconv} flagged, -1 padded), T={ITERS} "
            "-> (5,) int64")}
    for name, key in (("K8a cascade_p1", "cascade_p1"),
                      ("K8b cascade_p2", "cascade_p2")):
        out[name]["launches"] = launches[key]
    return out


@contextlib.contextmanager
def recorded_decoders(seen: list):
    """While open, the decoder of every capture step
    ``harness.build_nms_mc_step`` builds is appended to ``seen``."""
    def wrap(plain):
        def build(*args, **kwargs):
            step = plain(*args, **kwargs)
            seen.append(step.decoder)
            return step
        return build
    with patched(harness, "build_nms_mc_step", wrap):
        yield


def variant_point(dev, label, code, params, variant, frames, batch, **extra):
    """One ``run_nms_mc`` point at 3.0 dB with its launches and capture-step
    decoders recorded: (stats, failures, decoders, launches)."""
    decoders = []
    _kernels.reset_launches()
    t0 = time.perf_counter()
    with recorded_decoders(decoders):
        stats, fb = harness.run_nms_mc(code, params, variant, ITERS, 3.0,
                                       batch=batch, error_budget=10**9,
                                       max_frames=frames, seed=VARIANT_SEED,
                                       device=dev, **extra)
    synchronize(dev)
    launches = {k: n for k, n in _kernels.LAUNCHES.items() if n}
    log(f"variants {label}: {stats.frame_errors}/{stats.frames} frame errors "
        f"(FER {stats.fer:.6f}), bit errors {stats.bit_errors}, decoders "
        f"{decoders}, launches {launches}, {time.perf_counter() - t0:.2f} s")
    return stats, fb, decoders, launches


def expect_route(label, decoders, launches, want_decoders, want_keys):
    """The point's capture-step decoders are ``want_decoders`` and its
    launches exactly the kernels ``want_keys``."""
    if decoders != want_decoders or set(launches) != set(want_keys):
        raise AssertionError(f"variants {label}: decoders {decoders}, launches "
                             f"{launches}; expected {want_decoders}, {want_keys}")


def variant_points(dev, recs, weight_sets):
    """18(b): the evaluation points at 3.0 dB through ``run_nms_mc`` (seed
    15), their routes, the records and the two identities; then the capture
    step pinned to K6 and the raw-LLR phase-2 step (K2) at the two weight
    sets.  Returns the launches by kernel."""
    code = get_code("ccsds_128_64")
    steps = VARIANT_FRAMES // SWEEP_B
    total = {}

    def count(launches):
        for key, n in launches.items():
            total[key] = total.get(key, 0) + n

    results = {}
    for name, rung in (("NMS-2", None), ("NMS-3", None), ("NMS-2", "dense")):
        label = name + (" rung=dense" if rung else "")
        stats, _, decoders, launches = variant_point(
            dev, label, code, nms.init_params(name), name, VARIANT_FRAMES, SWEEP_B,
            rung=rung)
        if rung:  # K7 every step
            expect_route(label, decoders, launches, [], ["mc_dense"])
            if launches["mc_dense"] != steps:
                raise AssertionError(f"variants {label}: {launches}")
        else:  # K3, and K4 from an overflowed step on
            expect_route(label, decoders, launches, [], ["mc_compact"]
                         + (["mc_oneshot"] if "mc_oneshot" in launches else []))
        count(launches)
        results[label] = stats
    if results["NMS-2"] != results["NMS-3"]:
        raise AssertionError(f"NMS-2 {results['NMS-2']} != NMS-3 {results['NMS-3']}")
    log(f"variants: NMS-2 == NMS-3 counter for counter at their initial "
        f"parameters ({results['NMS-2'].frame_errors} frame errors, "
        f"{results['NMS-2'].bit_errors} bit errors)")

    p1 = nms.init_params("NMS-1")
    captured = {}
    for name in ("ENMS", "NMS-1"):
        stats, fb, decoders, launches = variant_point(
            dev, f"{name} capture route", code, p1, name, VARIANT_FRAMES, SWEEP_B,
            capture_failures=True, capture_trajectories=False)
        expect_route(name, decoders, launches, ["edge"], ["nms_edge_final"])
        count(launches)
        captured[name] = (stats, fb)
    (se, fe), (s1, f1) = captured["ENMS"], captured["NMS-1"]
    if not (se == s1 and np.array_equal(fe.trajectories, f1.trajectories)
            and np.array_equal(fe.labels, f1.labels)):
        raise AssertionError("CCSDS ENMS differs from NMS-1 on the capture route")
    log(f"variants: CCSDS ENMS == NMS-1 frame for frame on the capture route "
        f"({se.frame_errors} frame errors, {len(fe.labels)} failure rows "
        f"captured, equal)")
    del captured, fe, f1
    fused = {}
    for name in ("ENMS", "NMS-1"):
        stats, _, decoders, launches = variant_point(
            dev, name, code, p1, name, VARIANT_FRAMES, SWEEP_B)
        # the fused branch: K3, and K4 from an overflowed step on
        expect_route(name, decoders, launches, [], ["mc_compact"]
                     + (["mc_oneshot"] if "mc_oneshot" in launches else []))
        count(launches)
        fused[name] = stats
    if fused["ENMS"] != fused["NMS-1"]:
        raise AssertionError("CCSDS ENMS differs from NMS-1 on the fused branch")
    results["ENMS"] = fused["ENMS"]
    stats, _, decoders, launches = variant_point(
        dev, "NMS-r untrained", code, nms.init_params("NMS-r", code.h), "NMS-r",
        NMS_R_INIT_FRAMES, NMS_R_INIT_FRAMES)
    expect_route("NMS-r untrained", decoders, launches, ["edge"],
                 ["nmsr_edge_final"])
    results["NMS-r"] = stats
    for name in ("NMS-2", "NMS-3", "ENMS", "NMS-r"):
        s = results[name]
        log(f"variants {name} vs variant_fer.json: "
            + share_text(f"variants {name} FER", (s.frame_errors, s.frames),
                         recs[name]))

    qc = get_code("qc_96_48")
    shapes = []

    def wrap(plain):
        def setup(*args, **kwargs):
            mc = plain(*args, **kwargs)
            shapes.append(mc.h.shape)
            return mc
        return setup
    with patched(nms_edge, "mc_setup", wrap):
        stats, _, decoders, launches = variant_point(
            dev, "ENMS qc_96_48", qc, p1, "ENMS", 4 * NMS_R_INIT_FRAMES,
            NMS_R_INIT_FRAMES)
    expect_route("ENMS qc_96_48", decoders, launches, [], ["mc_compact"]
                 + (["mc_oneshot"] if "mc_oneshot" in launches else []))
    if set(shapes) != {qc.extended().h.shape}:
        raise AssertionError(f"ENMS qc_96_48 decoded on {set(shapes)}")
    count(launches)
    log(f"variants ENMS qc_96_48 (reported, no record): K3 on the extended "
        f"{qc.extended().h.shape} matrix, FER {stats.fer:.6f} of {stats.frames}")

    for label, (params, variant) in weight_sets.items():
        count(variant_pinned_k6(dev, label, code, params, variant))
        count(variant_phase2(dev, label, code, params, variant))
    return total


def variant_pinned_k6(dev, label, code, params, variant):
    """The capture step pinned to K6 against the default (K1) step on the
    same generators, 2 steps of 262,144 frames: counters, capture count and
    buffers identical.  Returns the pinned step's launches."""
    spec = ChannelSpec.awgn(3.0, code.rate)
    steps = {d: harness.build_nms_mc_step(code, variant, ITERS, spec, CAP_B,
                                          capture_capacity=CAP, decoder=d,
                                          device=dev)
             for d in ("dense", None)}
    if steps[None].decoder != "edge":
        raise AssertionError(f"{label}: default decoder {steps[None].decoder}")
    outs = {}
    for d, step in steps.items():
        gen = torch.Generator(device=dev)
        _kernels.reset_launches()
        outs[d] = []
        for i in range(2):
            gen.manual_seed(VARIANT_SEED * 1_000_003 + i)
            outs[d].append(step(params, gen))
        launches = {k: n for k, n in _kernels.LAUNCHES.items() if n}
        if d == "dense":
            pinned = launches
    for (c_k6, b_k6), (c_k1, b_k1) in zip(outs["dense"], outs[None]):
        if not (torch.equal(c_k6, c_k1) and all(torch.equal(b_k6[k], b_k1[k])
                                                for k in b_k1)):
            raise AssertionError(f"{label}: the K6-pinned capture step differs "
                                 "from the K1 step")
    if pinned != {"dense_final": 2}:
        raise AssertionError(f"{label}: K6-pinned step launched {pinned}")
    log(f"variants {label}: the capture step pinned to K6 == the K1 step over 2 "
        f"steps ({outs[None][0][0].tolist()} ...), launches {pinned}")
    return pinned


def variant_phase2(dev, label, code, params, variant):
    """The raw-LLR phase-2 step (``make_dl_osd_step_from_llr``) at the
    weight set on one capture step's failures with the r4 artifacts: its
    re-decode is K2 (one launch, with GE and K5).  Returns its launches."""
    run = load_run(R4, dev)
    layout = segments.TepLayout.build(run["path"], code.k, 6, dev)
    step = harness.build_nms_mc_step(code, variant, ITERS,
                                     ChannelSpec.awgn(3.0, code.rate), CAP_B,
                                     capture_capacity=CAP, device=dev)
    _, buf = step(params, torch.Generator(device=dev).manual_seed(VARIANT_SEED))
    phase2 = engine.make_dl_osd_step_from_llr(run["dia"], code, variant, ITERS,
                                              layout)
    _kernels.reset_launches()
    with torch.no_grad():
        out, _, det = phase2(params, buf["llr"], buf["labels"], run["fcn"])
    launches = {k: n for k, n in _kernels.LAUNCHES.items() if n}
    if launches != {"nms_edge_traj": 1, "ge_packed": 1, "lterm": 1}:
        raise AssertionError(f"{label} phase 2 launched {launches}")
    rows = min(int(buf["count"]), CAP)
    log(f"variants {label}: raw-LLR phase 2 on {rows} captured failures, "
        f"{int(det[:rows].sum())} confirmed, {int(out['success'][:rows].sum())} "
        f"OSD successes, launches {launches}")
    return launches


def cli_process(args, out_dir, name, every: list):
    """``sldpc-torch <args>`` in a new process (with the probe), its output
    to ``out_dir/<name>.log``, appended to ``every``: (Popen, log path,
    start time)."""
    path = os.path.join(out_dir, f"{name}.log")
    with open(path, "w") as fh:
        proc = subprocess.Popen([sys.executable, "-c", CLI_PROBE, *args],
                                cwd=ROOT, stdout=fh, stderr=subprocess.STDOUT,
                                text=True)
    every.append(proc)
    return proc, path, time.perf_counter()


@contextlib.contextmanager
def stopped_at_exit():
    """Yields a list for ``cli_process``; on leaving, each of its processes
    still running is killed and reaped."""
    every = []
    try:
        yield every
    finally:
        for proc in every:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def cli_wait(label, started, timeout=900):
    """Wait for a ``cli_process``; raise on a failure; (its output lines,
    its probe, its seconds)."""
    proc, path, t0 = started
    rc = proc.wait(timeout=timeout)
    seconds = time.perf_counter() - t0
    with open(path) as fh:
        lines = fh.read().splitlines()
    if rc != 0:
        raise AssertionError(f"{label}: exit {rc}: " + "\n".join(lines[-30:]))
    probe = json.loads(next(ln for ln in reversed(lines)
                            if ln.startswith("probe: "))[len("probe: "):])
    log(f"{label}: {seconds:.1f} s in a new process, probe {json.dumps(probe)}")
    return lines, probe, seconds


def eval_point(label, run_dir, probe, rec):
    """The one point an eval-nms process wrote; against ``rec`` (frame
    errors, frames) by 99.9% Wilson overlap when one is given."""
    (point,) = read_json(os.path.join(run_dir, "nms_fer.json"))["points"]
    got = (point["frame_errors"], point["frames"])
    text = (share_text(label, got, rec) if rec else
            f"{got[0]}/{got[1]} = {got[0] / got[1]:.5f}")
    log(f"{label}: frame errors {text} (decoders {probe['decoders']}, launches "
        f"{probe['launches']})")
    return point


def variant_training(dev, tmp, trained_rec):
    """18(c, d): ``sldpc-torch train-nms --variant NMS-3`` and ``--variant
    NMS-r`` at the ``NMSTrainConfig`` defaults and ``eval-nms --variant
    NMS-r`` on a copy of ``runs/r5_variants_nmsr``, three new processes at
    once; then ``eval-nms`` at 3.0 dB on each trained run directory (two
    at once).  Gates: the record's NMS-r inside ``nms_r_trained.json``'s
    99.9% interval on its edge kernel; each training's loss on the first
    block's ring frames below the initial parameters' loss there, NMS-r's
    NN weights non-negative, its retrained FER under ``NMS_R_MAX_FER`` (its
    gap to the record reported).  Returns the run directories, seconds,
    losses and points."""
    dirs = {v: os.path.join(tmp, v) for v in ("NMS-3", "NMS-r", "record NMS-r")}
    shutil.copytree(NMSR_RUN, dirs["record NMS-r"])
    evals = {"NMS-3": ["--batch", str(SWEEP_B), "--max-frames", str(PH1_BATCH)],
             "NMS-r": ["--batch", str(NMS_R_INIT_FRAMES), "--max-frames",
                       str(NMS_R_CLI_FRAMES)]}
    code = get_code("ccsds_128_64")
    with stopped_at_exit() as every:
        def eval_nms(variant, run_dir, name):
            return cli_process(["eval-nms", "--variant", variant, "--run-dir",
                                run_dir, "--snrs", "3.0:3.0:1", "--device",
                                "cuda", *evals[variant]], tmp, name, every)

        started = {f"train-nms {v}": cli_process(
            ["train-nms", "--variant", v, "--run-dir", dirs[v], "--device",
             "cuda"], tmp, f"train_{v}", every) for v in ("NMS-3", "NMS-r")}
        started["eval-nms record NMS-r"] = eval_nms("NMS-r", dirs["record NMS-r"],
                                                    "eval_record")
        done = {label: cli_wait(label, s) for label, s in started.items()}
        probe = done["eval-nms record NMS-r"][1]
        points = {"record NMS-r": eval_point(
            "eval-nms NMS-r (the record's weights) vs nms_r_trained.json",
            dirs["record NMS-r"], probe, trained_rec)}
        if (probe["decoders"] != ["edge"]
                or set(probe["launches"]) != {"nmsr_edge_final"}):
            raise AssertionError(f"eval-nms NMS-r route {probe}")

        started = {f"eval-nms {v}": eval_nms(v, dirs[v], f"eval_{v}")
                   for v in ("NMS-3", "NMS-r")}
        losses = {}
        for v in ("NMS-3", "NMS-r"):  # while the evaluations run
            cfg = NMSTrainConfig(variant=v)
            trained = load_jax_pickle(os.path.join(dirs[v], "nms_params.pkl"))
            first = range(cfg.print_interval)
            losses[v] = [nms_train.ring_loss(code, cfg, nms.init_params(v, code.h),
                                             first, device=dev),
                         nms_train.ring_loss(code, cfg, trained, first, device=dev)]
            log(f"train-nms {v}: loss on the first block's ring frames "
                f"{losses[v][0]:.3f} at the initial parameters, "
                f"{losses[v][1]:.3f} trained; parameters " + json.dumps(
                    {k: np.asarray(a).ravel().round(6).tolist()
                     for k, a in trained.items()}))
            if not losses[v][1] < losses[v][0]:
                raise AssertionError(f"train-nms {v}: the loss did not fall "
                                     f"{losses[v]}")
            if v == "NMS-r" and not all((np.asarray(trained[k]) >= 0).all()
                                        for k in ("nn_w1", "nn_w2")):
                raise AssertionError("train-nms NMS-r: a negative NN weight")
        done |= {label: cli_wait(label, s) for label, s in started.items()}
    for v, route in (("NMS-3", ([], {"mc_compact", "mc_oneshot"})),
                     ("NMS-r", (["edge"], {"nmsr_edge_final"}))):
        probe = done[f"eval-nms {v}"][1]
        if probe["decoders"] != route[0] or not set(probe["launches"]) <= route[1]:
            raise AssertionError(f"eval-nms {v} route {probe}")
        points[v] = eval_point(f"eval-nms {v} (trained on the card)", dirs[v],
                               probe, None)
    got = (points["NMS-r"]["frame_errors"], points["NMS-r"]["frames"])
    gap = gap_sigma(got, trained_rec)
    log(f"eval-nms NMS-r retrained on the card: FER {got[0] / got[1]:.5f} "
        f"against the record's {trained_rec[0] / trained_rec[1]:.5f} (another "
        f"RNG stream trains another net): {gap:+.2f} sigma, reported")
    if not got[0] / got[1] < NMS_R_MAX_FER:
        raise AssertionError(f"NMS-r retrained FER {got[0] / got[1]} is not under "
                             f"{NMS_R_MAX_FER}")
    return {"dirs": dirs, "seconds": {label: d[2] for label, d in done.items()},
            "losses": losses, "points": points, "nms_r_gap_sigma": gap}


def nms_r_recipe(dev, tmp, trained_rec):
    """18(e), the recipe: ``runs/r4_pipeline``'s config with ``"variant":
    "NMS-r"`` and the record's NMS-r weights (stage 1 reused) through
    ``recipe.run_recipe``: stages 2-5 retrained on the card.  Gates: stage
    1 reused; the DIA's and the stopper's losses fall and the MRB
    zero-error count rises; the eval sweep launches GE and K5 once a point,
    NMS-r's capture kernel at least once a point and nothing else (its
    phase 2 re-decodes on the dense decoder, as JAX's sweep); the 3.0 dB
    point's ``fer_nms_detected`` inside
    ``nms_r_trained.json``'s 99.9% interval.  Returns the run directory and
    a summary."""
    d = os.path.join(tmp, "nms_r_system")
    os.makedirs(d)
    cfg = dataclasses.replace(recipe_config(R4), variant="NMS-r")
    shutil.copy(os.path.join(NMSR_RUN, "nms_params.pkl"), d)
    seen = []
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with counted_eval_sweeps(seen):
        curve = recipe.run_recipe(cfg, d, snrs=np.linspace(2.0, 3.0, 6), log=log,
                                  device=dev)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    if (os.path.exists(os.path.join(d, "nms_train_summary.json"))
            or not filecmp.cmp(os.path.join(d, "nms_params.pkl"),
                               os.path.join(NMSR_RUN, "nms_params.pkl"),
                               shallow=False)):
        raise AssertionError("NMS-r recipe: stage 1 was retrained")
    paths = read_json(os.path.join(d, "decoding_path.json"))
    zero = [paths["hist_initial"].get("0", 0), paths["hist_refined"].get("0", 0)]
    hist = read_json(os.path.join(d, "dia_model_cnn_train_summary.json"))["history"]
    val = read_json(os.path.join(d, "stopper_validation.json"))
    if not zero[1] > zero[0]:
        raise AssertionError(f"NMS-r recipe: MRB zero-error count {zero}")
    if not hist[-1]["loss_mean"] < hist[0]["loss_mean"]:
        raise AssertionError(f"NMS-r recipe: DIA loss {hist[0]} -> {hist[-1]}")
    if not val["final_loss"] < val["initial_loss"]:
        raise AssertionError(f"NMS-r recipe: stopper loss {val}")
    want = {key: len(curve["points"]) for key in ("ge_packed", "lterm")}
    if (len(seen) != 1 or seen[0]["nmsr_edge_final"] < len(curve["points"])
            or {k: n for k, n in seen[0].items()
                if n and k != "nmsr_edge_final"} != want):
        raise AssertionError(f"NMS-r eval sweep launches {seen}, expected {want} "
                             "and NMS-r's capture kernel")
    texts = []
    for point in curve["points"]:
        osd = point["osd"]
        got = (round(point["fer_nms_detected"] * point["frames"]), point["frames"])
        texts.append(
            f"{point['snr_db']:.1f} dB: fer_nms_detected {got[0]}/{got[1]} = "
            f"{got[0] / got[1]:.5f}, OSD {osd['success']} of "
            f"{osd['success'] + osd['fail']} (strict {osd['strict_success']}), "
            f"mean complexity {osd['complexity']:.1f}, fer_total "
            f"{point['fer_total']:.4g}")
    last = curve["points"][-1]
    texts.append("3.0 dB vs nms_r_trained.json: " + share_text(
        "NMS-r recipe 3.0 dB fer_nms_detected",
        (round(last["fer_nms_detected"] * last["frames"]), last["frames"]),
        trained_rec))
    meta = read_json(os.path.join(d, "train_failures_meta.json"))
    out = {"seconds": seconds, "stage_seconds": read_json(
        os.path.join(d, "stage_seconds.json")), "peak_memory_bytes": peak,
        "harvest": f"{meta['detected_failures']}/{meta['frames']} at "
                   f"{cfg.training_snr} dB", "mrb_zero_initial_refined": zero,
        "dia_loss": [hist[0]["loss_mean"], hist[-1]["loss_mean"]],
        "stopper_loss": [val["initial_loss"], val["final_loss"]],
        "eval_launches": want, "points": texts}
    log("NMS-r recipe: " + json.dumps(out))
    return d, out


def nms_r_card_vs_cpu(tp, buf, rows: int):
    """The walk of a ``TwoPhase``'s own phase-2 step on the first ``rows``
    captured rows, the card against the port's CPU run: stop index,
    success and chosen TEP equal, refined values within
    ``NMS_R_REFINED_TOL``; returns the largest refined difference."""
    cpu = system.TwoPhase(tp.run_dir, tp.cap_b, tp.cap, tp.snr_db, "cpu")
    picks, refined = [], []
    for side in (tp, cpu):
        llr = buf["llr"][:rows].to(side.device)
        labels = buf["labels"][:rows].to(side.device)
        ref = wimax_step(side, llr, labels)[1]
        prep = engine.prepare(ref, llr, labels, side.code.h_osd, side.code.k)
        minima, argmins = engine.block_discrepancy_minima(prep, side.layout,
                                                          side.code.k)
        run = {"fcn": side.fcn, "config": {"window": side.window,
                                           "soft_margin": side.soft_margin}}
        picks.append([t.cpu() for t in walk_picks(run, prep, minima, argmins,
                                                  side.layout.bounds)[:3]])
        refined.append(ref.cpu())
    err = compare("NMS-r walk: refined values, card vs CPU", refined[0],
                  refined[1], rel=True, tol=NMS_R_REFINED_TOL)
    differ = {name: int((a != b).sum())
              for name, a, b in zip(("stop_k", "success", "chosen_tep"), *picks)}
    log(f"NMS-r card vs CPU walk ({rows} captured rows, re-decode route "
        f"{engine.redecode_route(tp.code.h, tp.variant, tp.device, rows)} on "
        f"both): frames that differ {json.dumps(differ)}, refined values "
        f"within {err:.3g}; successes {int(picks[0][1].sum())} (card) / "
        f"{int(picks[1][1].sum())} (CPU)")
    if any(differ.values()):
        raise AssertionError("NMS-r walk: card differs from CPU")
    return err


def nms_r_system(dev, run_dir, trained_rec, card):
    """18(e), the system: ``system.TwoPhase`` on the NMS-r run directory at
    3.0 dB (``cap_b`` 262,144, ``cap`` 32,768): the capture and re-decode
    on NMS-r's edge kernels, a warm-up round, ``measure`` with the launch
    counts reset just before and read just after (GE, K5 and the re-decode
    kernel R each, the capture kernel 2R, nothing else), ``stage_times``,
    the peak memory; the NMS FER inside
    ``nms_r_trained.json``'s interval, the OSD success share reported (no
    JAX record).  Then GE and K5 on one round's rows against their plain
    versions (``system_kernels``) and the walk card == CPU on 64 rows."""
    tp = system.TwoPhase(run_dir, CAP_B, CAP, 3.0, dev)
    routes = (tp.capture_step.decoder,
              engine.redecode_route(tp.code.h, tp.variant, dev, CAP))
    if routes != ("edge", "edge"):
        raise AssertionError(f"NMS-r system routes {routes}")
    tp.full_round(10**6)  # warm-up
    synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _kernels.reset_launches()
    out = tp.measure(NMS_R_ROUNDS)
    launches = {"ge_packed": NMS_R_ROUNDS, "lterm": NMS_R_ROUNDS,
                "nmsr_edge_final": 2 * NMS_R_ROUNDS,
                "nmsr_edge_traj": NMS_R_ROUNDS}
    only_launched("NMS-r system", launches)
    out["system_stage_s"] = tp.stage_times(NMS_R_ROUNDS)
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    out["launches"] = launches
    log("NMS-r system: " + json.dumps(out))
    errors, frames = out["system_frame_errors"], out["system_frames"]
    succ, failures = out["system_osd_success"], out["system_failures"]
    stages = out["system_stage_s"]
    staged = sum(v for key, v in stages.items() if key != "sliding_osd_total")
    log(f"NMS-r system 3.0 dB on {card}: {out['system_codewords_per_s']:.1f} cw/s, "
        f"{out['system_osd_failures_per_s']:.1f} OSD failures/s, NMS FER "
        + share_text("NMS-r system NMS FER", (errors, frames), trained_rec)
        + f"; OSD successes {succ} of {failures} ({succ / failures:.5f}; the JAX "
        f"package has no NMS-r two-phase record), strict "
        f"{out['system_osd_strict_success']}, unconfirmed "
        f"{out['system_osd_unconfirmed']}, overflow "
        f"{out['system_capture_overflow']}; staged round {1e3 * staged:.2f} ms "
        "(" + ", ".join(f"{k} {1e3 * v:.2f}" for k, v in stages.items())
        + f"), peak memory {out['peak_memory_bytes'] / 2**30:.2f} GiB")
    _, buf = tp.capture_round(NMS_R_ROUNDS + 1)
    rows = min(int(buf["count"]), CAP)
    k5, ge = system_kernels(dev, "NMS-r system", tp, buf, card,
                            *k5_chunks(CAP, tp.code.h_osd.shape[0],
                                       tp.layout.flat.shape[0]))
    refined_err = nms_r_card_vs_cpu(tp, buf, NMS_R_CPU_ROWS)
    del tp, buf
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {"system": out, "buffer_failures": rows,
            "card_vs_cpu_refined_err": refined_err}, k5, ge


def phase_variants(dev, rows, smi):
    """18: the NMS variants through the port's entry points (``run_nms_mc``,
    ``sldpc-torch train-nms``/``eval-nms --variant``, ``recipe.run_recipe``,
    ``system.TwoPhase``) against ``runs/r5_variants``: (c, d) the trainings
    and CLI evaluations (``variant_training``), (a) the kernels at NMS-2's
    initial and NMS-3's trained weights (``variant_kernels``), (b) the
    evaluation points and identities (``variant_points``), (e) NMS-r's
    two-phase system (``nms_r_recipe``, ``nms_r_system``).  The kernel rows
    get ``variants`` entries, GE and K5 ``nms_r_system`` entries."""
    t0 = time.perf_counter()
    recs, trained_rec = variant_records()
    seconds = {}
    with tempfile.TemporaryDirectory() as tmp:
        trained = variant_training(dev, tmp, trained_rec)
        seconds["c_d_processes"] = time.perf_counter() - t0
        sets = variant_weight_sets(trained["dirs"]["NMS-3"])
        entries, launches = {}, {}
        t1 = time.perf_counter()
        for label, (params, variant) in sets.items():
            weights = nms.scalar_weights(params, variant)
            for name, entry in variant_kernels(dev, label, params, variant,
                                               VARIANT_SEED,
                                               cascade=variant == "NMS-3").items():
                n = entry.pop("launches")  # the cascade call's, else None
                if n is not None:
                    launches[LAUNCH_KEY[name]] = n
                entries.setdefault(name, {})[label] = entry | {"weights": weights}
        seconds["a_kernels"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        launches |= variant_points(dev, recs, sets)
        seconds["b_points"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        run_dir, recipe_out = nms_r_recipe(dev, tmp, trained_rec)
        seconds["e_recipe"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        system_out, k5, ge = nms_r_system(dev, run_dir, trained_rec, smi)
        seconds["e_system"] = time.perf_counter() - t1
    for row in rows:
        name = row["name"]
        if name in entries:
            row["variants"] = entries[name] | {
                "launches": launches.get(LAUNCH_KEY[name], 0)}
        elif name == "K5 lterm":
            row["nms_r_system"] = k5 | {"launches": NMS_R_ROUNDS}
        elif name == "GE ge_packed":
            row["nms_r_system"] = ge | {"launches": NMS_R_ROUNDS}
        elif name in ("K1r nmsr_edge_final", "K2r nmsr_edge_traj"):
            row["launches"] = system_out["system"]["launches"][LAUNCH_KEY[name]]
    seconds["total"] = time.perf_counter() - t0
    log("variants: " + json.dumps({
        "seconds": seconds, "process_seconds": trained["seconds"],
        "training_losses": trained["losses"],
        "nms_r_retrained_gap_sigma": trained["nms_r_gap_sigma"],
        "path_launches": launches, "nms_r_system": system_out,
        "card": smi}))


# 19: sldpc-torch bench's line holds BENCH_r05.json's keys less the four
# TPU figures (the one-hot MXU FLOP model and the shares of the v5e's peak)
TPU_BENCH_KEYS = {"flops_per_frame_model", "effective_tflops",
                  "mfu_pct_vs_bf16_peak", "mfu_pct_algorithmic"}
# launches of one bench process: K3 a phase-1 step (warm-up + 8); the
# system's warm-up round, 8 capture-only and 8 full rounds, and the stage
# round (one full round timed by its spans: K5 once)
BENCH_CLI_LAUNCHES = {"mc_compact": 1 + PH1_STEPS,
                      "nms_edge_final": 1 + 2 * ROUNDS + 1,
                      "nms_edge_traj": 1 + ROUNDS + 1, "ge_packed": 1 + ROUNDS + 1,
                      "lterm": 1 + ROUNDS + 1}


def cli_json(label, lines):
    """The JSON line a ``cli_process`` printed last (before its probe
    line); raises unless it parses."""
    body = [ln for ln in lines if not ln.startswith("probe: ")]
    try:
        return json.loads(body[-1])
    except (IndexError, ValueError) as exc:
        raise AssertionError(f"{label}: last line is not JSON: {body[-3:]}") from exc


def r4_cli_flags():
    """``runs/r4_pipeline/config.json`` as ``train-dia``/``train-stopper``
    flags."""
    cfg = read_json(os.path.join(R4, "config.json"))
    return ["--code", cfg["code_name"], "--variant", cfg["variant"],
            "--iterations", str(cfg["num_iterations"]),
            "--training-snr", str(cfg["training_snr"]),
            "--dia-model", cfg["dia_model"],
            "--train-failures", str(cfg["train_failure_target"]),
            "--decoding-length", str(cfg["decoding_length"]),
            "--threshold-sum", str(cfg["threshold_sum"]),
            "--window", str(cfg["window"]), "--soft-margin", str(cfg["soft_margin"]),
            "--segments", str(cfg["num_segments"]), "--batch", str(cfg["eval_batch"]),
            "--seed", str(cfg["seed"])]


def bench_cli(tmp, in_process):
    """19(a): ``sldpc-torch bench --batch 2097152`` in a new process.
    Gates: exit 0 and a JSON last line with ``bench.py``'s keys less the
    TPU figures; the card's name; the system at 3.0 dB; ``sample_fer`` and
    ``system_fer_nms`` inside the records' 99.9% intervals; 49,152
    algorithmic flops a frame; the TF baseline; the launches exactly
    ``BENCH_CLI_LAUNCHES``; phase 1's and the system's rates at least half
    of this run's in-process ones (else another path ran)."""
    with stopped_at_exit() as every:
        lines, probe, seconds = cli_wait("sldpc-torch bench", cli_process(
            ["bench", "--batch", str(PH1_BATCH), "--device", "cuda"], tmp,
            "bench", every))
    line = cli_json("sldpc-torch bench", lines)
    log("sldpc-torch bench line: " + json.dumps(line))
    keys = set(read_json(os.path.join(ROOT, "BENCH_r05.json"))["parsed"])
    missing = keys - TPU_BENCH_KEYS - set(line)
    if missing or TPU_BENCH_KEYS & set(line):
        raise AssertionError(f"bench line: missing {sorted(missing)}, TPU keys "
                             f"{sorted(TPU_BENCH_KEYS & set(line))}")
    name = torch.cuda.get_device_name(0)
    want = {"device": name, "system_snr_db": 3.0, "batch": PH1_BATCH,
            "flops_per_frame_algorithmic": 49152.0,
            "baseline_kind": "reference_tf2_cpu"}
    got = {k: line[k] for k in want}
    if got != want:
        raise AssertionError(f"bench line {got} != {want}")
    ph1 = share_text("bench sample_fer", (round(line["sample_fer"] * line["batch"]),
                                          line["batch"]),
                     (REF_PH1_ERRORS, REF_PH1_FRAMES))
    nms_fer = share_text("bench system_fer_nms", (line["system_frame_errors"],
                                                  line["system_frames"]),
                         (round(REF_FER * REF_FRAMES), REF_FRAMES))
    launches = probe["launches"]
    if launches != BENCH_CLI_LAUNCHES:
        raise AssertionError(f"bench launches {launches} != {BENCH_CLI_LAUNCHES}")
    ratios = {"value": line["value"] / in_process["value"],
              "system_codewords_per_s": line["system_codewords_per_s"]
              / in_process["system_codewords_per_s"]}
    log(f"sldpc-torch bench on {name}: {seconds:.1f} s; value "
        f"{line['value']} cw/s (in process {in_process['value']:.1f}), system "
        f"{line['system_codewords_per_s']} cw/s (in process "
        f"{in_process['system_codewords_per_s']:.1f}), vs_baseline "
        f"{line['vs_baseline']}, numpy stand-in "
        f"{line['numpy_standin_codewords_per_s']} cw/s; sample_fer {ph1}; "
        f"system_fer_nms {nms_fer}; launches {launches}")
    if min(ratios.values()) < 0.5:
        raise AssertionError(f"bench process rates against in-process: {ratios}")
    return line, launches, seconds


def train_cli(dev, tmp):
    """19(b): ``sldpc-torch train-dia`` then ``train-stopper`` in new
    processes on one run directory that holds only
    ``runs/r4_pipeline/nms_params.pkl``, with ``config.json``'s flags.
    ``phase_recipe``'s gates: harvest FER against the record, the DIA's
    block loss falling, the refined MRB zero-error count above the initial
    one, 30 patterns; ``train-stopper`` reusing ``train-dia``'s failures and
    refiner (no K1 launch, the refiner's pickle untouched) with its
    validation loss falling; the pickles in the JAX layout; the run
    directory, with ``config.json`` copied in, through ``load_run``."""
    run_dir = os.path.join(tmp, "train_cli")
    os.makedirs(run_dir)
    shutil.copy(os.path.join(R4, "nms_params.pkl"), run_dir)
    run = recipe.RunDir(run_dir)
    flags = [*r4_cli_flags(), "--run-dir", run_dir, "--device", "cuda"]
    out = {}
    with stopped_at_exit() as every:
        lines, probe, out["train-dia"] = cli_wait("sldpc-torch train-dia", cli_process(
            ["train-dia", *flags], tmp, "train_dia", every))
        printed = cli_json("train-dia", lines)
        meta = run.load_json("train_failures_meta.json")
        hist = run.load_json("dia_model_cnn_train_summary.json")["history"]
        paths = run.load_json("decoding_path.json")
        zero = (paths["hist_initial"].get("0", 0), paths["hist_refined"].get("0", 0))
        harvest = share_text("train-dia harvest FER", (meta["detected_failures"],
                                                       meta["frames"]),
                             (REF_HARVEST_ERRORS, REF_HARVEST_FRAMES))
        log(f"train-dia: printed {printed}; harvest {harvest}; DIA block loss "
            f"{hist[0]['loss_mean']:.2f} -> {hist[-1]['loss_mean']:.2f}; MRB "
            f"zero-error {zero[0]} -> {zero[1]} (record {REF_MRB_ZERO_INITIAL} -> "
            f"{REF_MRB_ZERO_REFINED}); launches {probe['launches']}")
        if printed != {"decoding_path_len": 30} or len(paths["path"]) != 30:
            raise AssertionError(f"train-dia printed {printed}")
        if not hist[-1]["loss_mean"] < hist[0]["loss_mean"]:
            raise AssertionError(f"train-dia: DIA loss did not fall {hist[0]} -> "
                                 f"{hist[-1]}")
        if not zero[1] > zero[0]:
            raise AssertionError(f"train-dia: MRB zero-error count {zero}")
        if not probe["launches"].get("nms_edge_final"):
            raise AssertionError(f"train-dia harvest without K1: {probe}")
        stamp = os.path.getmtime(run.path("dia_model_cnn.pkl"))

        lines, probe, out["train-stopper"] = cli_wait(
            "sldpc-torch train-stopper", cli_process(["train-stopper", *flags], tmp,
                                                     "train_stopper", every))
    printed = cli_json("train-stopper", lines)
    val = run.load_json("stopper_validation.json")
    log(f"train-stopper: printed {printed}; validation {json.dumps(val)}; "
        f"launches {probe['launches']}")
    if printed != {"decoding_path_len": 30, "stopper": "stopper_params.pkl"}:
        raise AssertionError(f"train-stopper printed {printed}")
    if os.path.getmtime(run.path("dia_model_cnn.pkl")) != stamp:
        raise AssertionError("train-stopper retrained the DIA")
    if "nms_edge_final" in probe["launches"] or not probe["launches"].get("lterm"):
        raise AssertionError(f"train-stopper launches {probe['launches']}: the "
                             "harvest must be reused and the samples run K5")
    if not val["final_loss"] < val["initial_loss"]:
        raise AssertionError(f"train-stopper: loss did not fall {val}")
    layouts, ref_layouts = numpy_layouts(run_dir), numpy_layouts(R4)
    if layouts != ref_layouts:
        raise AssertionError(f"train CLI pickles {layouts} != JAX's {ref_layouts}")
    # only run_recipe writes config.json (in JAX as in the port): the
    # config the flags came from completes the run directory
    shutil.copy(os.path.join(R4, "config.json"), run_dir)
    written = load_run(run_dir, dev)
    log(f"train CLI run dir: loads through convert.load_run on the card "
        f"({type(written['dia']).__name__}, {len(written['path'])} patterns), "
        "pickles in the JAX key layout")
    return out


def phase_entry_points(dev, rows, smi, in_process):
    """19: the port's last entry points as new processes: (a) ``sldpc-torch
    bench`` (``bench_cli``), its launches the ``bench_cli`` entries of the
    K1, K2, K3, K5 and GE rows; (b) ``train-dia`` then ``train-stopper``
    (``train_cli``).  ``in_process`` holds phase 4's K3 ``value`` and
    phase 3's ``system_codewords_per_s``."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()  # the processes size their captures by free memory
    with tempfile.TemporaryDirectory() as tmp:
        line, launches, bench_seconds = bench_cli(tmp, in_process)
        train_seconds = train_cli(dev, tmp)
    for row in rows:
        key = LAUNCH_KEY[row["name"]]
        if key in launches:
            row["bench_cli"] = {"launches": launches[key]}
    log("entry points: " + json.dumps({
        "process_seconds": {"bench": bench_seconds} | train_seconds,
        "seconds": time.perf_counter() - t0,
        "bench": {k: line[k] for k in (
            "value", "system_codewords_per_s", "vs_baseline",
            "numpy_standin_codewords_per_s", "system_osd_failures_per_s")},
        "card": smi}))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = phase_environment()
    rows = phase_kernels(dev) + phase_mc_kernels(dev) + phase_dense_kernels(dev)
    phase_mc_other_codes(dev)
    phase_enms_wimax(dev)
    phase_card_vs_cpu(dev)
    phase_path(dev)
    system_out = phase_main_path(dev, rows)
    phase1_out = phase_phase1(dev, rows)
    phase_sweep(dev)
    phase_cascade(dev, rows)
    phase_profile(dev)
    phase_dense_capture(dev, rows)
    phase_sweep_dense(dev, rows)
    phase_padded(dev)
    phase_train(dev)
    phase_recipe(dev)
    phase_baselines(dev, rows, smi)
    phase_mesh(dev, rows, smi)
    phase_experimental(dev, rows, smi)
    phase_wimax_system(dev, rows, smi)
    phase_k5_general(dev, rows, smi)
    phase_multicode(dev, rows, smi)
    phase_rayleigh(dev, rows, smi)
    phase_variants(dev, rows, smi)
    phase_entry_points(dev, rows, smi, {
        "value": phase1_out["value"],
        "system_codewords_per_s": system_out["system_codewords_per_s"]})
    rows.sort(key=lambda row: row["name"])
    if any(row["launches"] is None or row["launches"] < 1 for row in rows):
        raise AssertionError("a kernel row has no launch on its path")
    if len(rows) != len(LAUNCH_KEY):
        raise AssertionError(f"{len(rows)} kernel rows, expected {len(LAUNCH_KEY)}")
    log(json.dumps({"kernels": rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
