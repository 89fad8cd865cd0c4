"""The two-phase system on the port: the main path end to end.

Port of ``bench.py:199-419`` (``system_two_phase_throughput``).  One round:

1. capture step (``mc.harness.build_nms_mc_step``): AWGN sample -> kernel
   K1 (``decode_final_edge``) -> ``frame_stats`` -> stable failures-first
   compaction into a ``cap``-row buffer;
2. phase 2 (``osd.engine.make_dl_osd_step_from_llr``): kernel K2
   (``decode_traj_edge``) -> ``frame_stats`` on the last slot (detected
   flags) -> ``ConvBitwise.refine_fast`` -> ``engine.prepare`` (its GF(2)
   elimination the GE kernel, ``ops/gf2_bitpack.py``) ->
   ``engine.sliding_osd``, whose discrepancy parity term is kernel K5.

:func:`run_two_phase` returns the fields of ``bench.py``'s ``system_*``
keys, plus the NMS frame-error count, strict OSD successes and a per-stage
time split from one extra round with a synchronisation between stages.
:class:`TwoPhase` holds one loaded system and runs single rounds.

:func:`phase1_throughput` is the port of ``bench.py:104-196``
(``tpu_nms_throughput``), the phase-1 headline: the fused Monte-Carlo
counters, kernel K3 (``"compact"``) or K4 (``"oneshot"``), at 2,097,152
frames a step with NMS-1 at its initial factor; :class:`Phase1` holds the
step and its timed loop.
"""

from __future__ import annotations

import os
import time

import torch

from ._device import resolve_device, synchronize
from .channel.awgn import ChannelSpec
from .codes import get_code
from .convert import load_run
from .mc.harness import build_nms_mc_step
from .ops import nms, nms_edge
from .osd import engine, segments

DEFAULT_RUN = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "runs", "r4_pipeline")


class TwoPhase:
    """A run directory's two-phase system, loaded on ``device``."""

    def __init__(self, run_dir: str | None = None, cap_b: int = 262_144,
                 cap: int = 32_768, snr_db: float = 3.0,
                 device: str | torch.device = "cuda", seed: int = 77):
        self.device = dev = resolve_device(device)
        self.run_dir = run_dir or DEFAULT_RUN
        self.cap_b, self.cap, self.snr_db, self.seed = cap_b, cap, snr_db, seed
        run = load_run(self.run_dir, dev)
        self.code, self.variant = run["code"], run["variant"]
        self.iters = run["num_iterations"]
        self.dia, self.fcn = run["dia"], run["fcn"]
        cfg = run["config"]
        # scalar weights are read on the host by the kernel wrappers: keeping
        # them there avoids a device round trip per call
        self.nms_params = {k: v.cpu() for k, v in run["nms_params"].items()}
        blocks, acc = segments.build_tep_blocks(
            run["path"], self.code.k, int(cfg.get("num_segments", 6)))
        teps, mask, self.bounds = segments.pack_tep_chunks(blocks)
        self.teps = torch.as_tensor(teps, device=dev)
        self.mask = torch.as_tensor(mask, device=dev)
        self.acc = torch.as_tensor(acc, dtype=torch.int64, device=dev)
        self.window = int(cfg.get("window", 5))
        self.soft_margin = float(cfg.get("soft_margin", 0.9))
        self.capture_step = build_nms_mc_step(
            self.code, self.variant, self.iters,
            ChannelSpec.awgn(snr_db, self.code.rate), cap_b,
            capture_capacity=cap, device=dev)
        self.phase2 = engine.make_dl_osd_step_from_llr(
            self.dia, self.code, self.variant, self.iters, window=self.window,
            soft_margin=self.soft_margin, bounds=self.bounds)
        self.generator = torch.Generator(device=dev)

    def capture_round(self, i: int):
        """Phase 1 of round ``i``: (counters, capture buffer)."""
        self.generator.manual_seed(self.seed * 1_000_003 + i)
        return self.capture_step(self.nms_params, self.generator)

    def full_round(self, i: int):
        """Both phases of round ``i``: (counters, captured count, success,
        strict success, detected), the last three per buffer row."""
        counters, buf = self.capture_round(i)
        out, _, detected = self.phase2(self.nms_params, buf["llr"], buf["labels"],
                                       self.teps, self.mask, self.acc, self.fcn)
        return (counters, buf["count"], out["success"], out["strict_success"],
                detected)

    def stage_times(self, i: int) -> dict:
        """Seconds per stage of round ``i``, each stage closed by a
        synchronisation (the chain of ``make_dl_osd_step_from_llr``, spelled
        out so each stage can be timed)."""
        code, dev = self.code, self.device
        decode_h = code.extended().h if self.variant == "ENMS" else code.h
        walk = dict(window=self.window, soft_margin=self.soft_margin)
        times = {}

        def timed(name, fn):
            synchronize(dev)
            t0 = time.perf_counter()
            out = fn()
            synchronize(dev)
            times[name] = time.perf_counter() - t0
            return out

        _, buf = timed("capture_step_k1", lambda: self.capture_round(i))
        route = engine.redecode_route(decode_h, self.variant, dev,
                                      buf["llr"].shape[0])
        traj = timed("traj_redecode_k2", lambda: engine.redecode_trajectory(
            self.nms_params, decode_h, buf["llr"], self.iters, self.variant,
            route).permute(1, 0, 2))
        timed("frame_stats", lambda: nms.frame_stats(traj[:, -1], buf["labels"],
                                                     decode_h))
        refined = timed("dia_refine_fast", lambda: self.dia.refine_fast(traj))
        prep = timed("prepare_sort_ge", lambda: engine.prepare(
            refined, buf["llr"], buf["labels"], code.h_osd, code.k))
        minima, _ = timed("disc_minima_k5", lambda: engine.block_discrepancy_minima(
            prep, self.teps, self.mask, code.k, self.bounds))
        timed("stopper_walk", lambda: engine.sliding_walk(minima, self.fcn, **walk))
        timed("sliding_osd_total", lambda: engine.sliding_osd(
            prep, self.teps, self.mask, self.acc, self.fcn, code.k,
            bounds=self.bounds, **walk))
        return times

    def measure(self, rounds: int) -> dict:
        """``rounds`` rounds of phase 1 alone, then ``rounds`` full rounds,
        each loop timed on the host clock and closed by a device
        synchronisation; returns ``bench.py``'s ``system_*`` fields.  Call
        it after a warm-up round: the loops launch K1 ``2 * rounds`` times
        and K2, GE and K5 ``rounds`` times each."""
        dev, cap = self.device, self.cap
        t0 = time.perf_counter()
        for i in range(rounds):
            last = self.capture_round(i)[0]
        synchronize(dev)
        del last
        t_phase1 = time.perf_counter() - t0

        t0 = time.perf_counter()
        results = [self.full_round(i) for i in range(rounds)]
        synchronize(dev)
        t_total = time.perf_counter() - t0

        frames_done = frame_errors = failures = 0
        succ = strict = unconfirmed = overflow = 0
        for counters, count, s, s_strict, d in results:
            c = counters.cpu().numpy()
            valid = min(int(count), cap)  # failure rows sort first in the buffer
            sv, ssv, dv = (x[:valid].cpu().numpy() for x in (s, s_strict, d))
            frames_done += int(c[0])
            frame_errors += int(c[1])
            failures += int(c[3])
            overflow += max(0, int(c[3]) - cap)
            succ += int((sv & dv).sum())
            strict += int((ssv & dv).sum())
            unconfirmed += int((~dv).sum())

        return {
            "system_codewords_per_s": frames_done / t_total,
            "system_frames": frames_done,
            "system_snr_db": self.snr_db,
            "system_frame_errors": frame_errors,
            "system_fer_nms": frame_errors / max(frames_done, 1),
            "system_failures": failures,
            "system_osd_rows_walked": rounds * cap,
            "system_osd_failures_per_s": failures / max(t_total - t_phase1, 1e-9),
            "system_osd_success": succ,
            "system_osd_strict_success": strict,
            "system_osd_unconfirmed": unconfirmed,
            "system_capture_overflow": overflow,
            "system_split_s": {
                "phase1_nms_capture_only": t_phase1,
                "two_phase_total": t_total,
                "phase2_implied": t_total - t_phase1,
            },
            "system_run_dir": self.run_dir,
            "device": str(dev),
        }


def run_two_phase(run_dir: str | None = None, frames: int = 2_097_152,
                  cap_b: int = 262_144, cap: int = 32_768,
                  snr_db: float = 3.0, device: str | torch.device = "cuda",
                  seed: int = 77) -> dict:
    """Run ``frames // cap_b`` rounds (at least one) of the two-phase system
    and return its counters and times (seconds on the host clock, each
    closed by a device synchronisation), with a per-stage split from one
    more round."""
    system = TwoPhase(run_dir, cap_b, cap, snr_db, device, seed)
    system.full_round(10**6)  # warm-up: kernel build, allocator, library handles
    synchronize(system.device)
    rounds = max(1, frames // cap_b)
    out = system.measure(rounds)
    out["system_stage_s"] = system.stage_times(rounds)
    return out


class Phase1:
    """The phase-1 fused Monte-Carlo step of ``bench.py``'s headline on
    ``device`` (its ``BENCH_*`` knobs are the parameters): CCSDS (128,64),
    NMS-1 at its initial factor, ``batch`` hash frames a step,
    kernel K3 with ``schedule=((t1, frac),)`` in groups of ``block_frames``
    (``"compact"``) or kernel K4 (``"oneshot"``)."""

    def __init__(self, batch: int = 2_097_152, kernel: str = "compact",
                 t1: int = 4, frac: float = 0.375, block_frames: int = 1024,
                 iters: int = 12, snr_db: float = 3.0,
                 device: str | torch.device = "cuda"):
        if kernel not in ("compact", "oneshot"):
            raise ValueError(f"kernel must be 'compact' or 'oneshot', got {kernel!r}")
        self.device = resolve_device(device)
        self.batch, self.kernel, self.t1, self.frac = batch, kernel, t1, frac
        self.block_frames, self.iters, self.snr_db = block_frames, iters, snr_db
        self.code = get_code("ccsds_128_64")
        self.params = nms.init_params("NMS-1")

    def step(self, seed: int) -> torch.Tensor:
        """Counters of one step on the device: (6,) int64 for "compact"
        (lane 5 = overflow), (5,) for "oneshot"."""
        if self.kernel == "compact":
            return nms_edge.fused_counters_edge_compact(
                self.code, self.params, "NMS-1", self.iters, self.snr_db,
                self.batch, seed=seed, block_frames=self.block_frames,
                schedule=((self.t1, self.frac),), device=self.device)
        return nms_edge.fused_counters_edge(
            self.code, self.params, "NMS-1", self.iters, self.snr_db,
            self.batch, seed=seed, device=self.device)

    def measure(self, steps: int) -> dict:
        """``steps`` steps (seeds 1..steps) on the host clock, closed by a
        device synchronisation; ``bench.py``'s fields (``sample_fer`` and
        ``compact_overflow`` from the last step, as there) plus the summed
        counters of all timed steps.  Call it after a warm-up step."""
        total = torch.zeros(6, dtype=torch.int64, device=self.device)
        t0 = time.perf_counter()
        for i in range(steps):
            last = self.step(1 + i)
            total[: len(last)] += last
        synchronize(self.device)
        seconds = time.perf_counter() - t0
        c, tot = last.cpu().tolist(), total.cpu().tolist()
        out = {
            "metric": "nms_decoded_codewords_per_s_1chip",
            "value": steps * self.batch / seconds,
            "unit": "codewords/s",
            "device": (torch.cuda.get_device_name(self.device)
                       if self.device.type == "cuda" else str(self.device)),
            "batch": self.batch,
            "iters": self.iters,
            "kernel": self.kernel,
            "snr_db": self.snr_db,
            "sample_fer": c[1] / self.batch,
            "steps": steps,
            "seconds": seconds,
            "timed_frames": tot[0],
            "timed_frame_errors": tot[1],
            "timed_bit_errors": tot[2],
            "timed_detected": tot[3],
            "timed_undetected": tot[4],
        }
        if self.kernel == "compact":
            out |= {"t1": self.t1, "compact_overflow": c[5],
                    "timed_compact_overflow": tot[5],
                    "block_frames": self.block_frames, "frac": self.frac}
        return out


def phase1_throughput(batch: int = 2_097_152, steps: int = 8,
                      kernel: str = "compact", t1: int = 4, frac: float = 0.375,
                      block_frames: int = 1024, iters: int = 12,
                      snr_db: float = 3.0,
                      device: str | torch.device = "cuda") -> dict:
    """One warm-up step, then ``steps`` timed steps of :class:`Phase1`;
    returns decoded codewords/s (``value``) with ``bench.py``'s fields."""
    phase1 = Phase1(batch, kernel, t1, frac, block_frames, iters, snr_db, device)
    phase1.step(0)  # warm-up: kernel build, allocator
    synchronize(phase1.device)
    return phase1.measure(steps)
