"""What decides ``correct``, driven on the CPU at small sizes: every cell
of a sound run comes out correct with the result line's keys; the
controls (the reference one precision below in the system's place) and
the faults a cell can have come out not correct.

The faults, planted in the port underneath a whole run: a step that
returns its state unchanged (every round or step hands back the first
one's result); half of the batch left out, the rest counted double; an
answer altered where it is produced (one walk decision, one counter);
and a preparation that holds the channel magnitudes in bfloat16, which
the later stages would take from it on both sides.  No cell spans chips,
so no exchange between chips can be left out."""

import dataclasses
import time

import pytest
import torch

from gpubench import control, core
from gpubench.reference import setup
from short_ldpc_decoding_osd_tpu_torch import system
from short_ldpc_decoding_osd_tpu_torch.mc import harness
from short_ldpc_decoding_osd_tpu_torch.ops import nms_edge
from short_ldpc_decoding_osd_tpu_torch.osd import engine

from conftest import ROOT

SMALL = {
    "ccsds-system-3.0dB": {"cap_b": 2048, "cap": 64, "check_within": 2,
                           "checked_rounds": 2, "warmup_rounds": 1},
    "ccsds-phase1-3.0dB": {"batch": 4096, "check_within": 2,
                           "checked_steps": 2, "warmup_steps": 1},
    "wimax-system-3.5dB": {"cap_b": 128, "cap": 4, "check_within": 1,
                           "warmup_rounds": 1},
    "wimax-phase1-4.0dB": {"batch": 1024, "check_within": 2,
                           "checked_steps": 2, "warmup_steps": 1},
}
SEED = 2**31 + 41


def run(name, seconds=0.3):
    return core.run_cell(ROOT, name, SEED, seconds, False, time.perf_counter(),
                         device=torch.device("cpu"), traffic=SMALL[name])


@pytest.mark.parametrize("name", SMALL)
def test_sound_run_is_correct(name):
    line = run(name)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] and line["failed"] == 0, line["checks"]
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())
    assert line["metrics"]["setup_s"]["value"] > 0


def _first_result(fn):
    """``fn`` that hands back its first call's result on every call."""
    first = []

    def stuck(*args, **kwargs):
        if not first:
            first.append(fn(*args, **kwargs))
        return first[0]
    return stuck


def _half_batch_capture(fn):
    def half(llr, words, soft_last, h, capture_capacity=0):
        b = llr.shape[0] // 2
        counters, cap = fn(llr[:b], words[:b], soft_last[:b], h, capture_capacity)
        return counters * 2, cap
    return half


def _flip_one_decision(fn):
    def flipped(*args, **kwargs):
        out = fn(*args, **kwargs)
        out["success"] = out["success"].clone()
        out["success"][0] = ~out["success"][0]
        return out
    return flipped


def _bf16_magnitudes(fn):
    """``engine.prepare`` with ``mag_original`` (and the truth's
    discrepancy from it) in bfloat16."""
    def prepare(*args, **kwargs):
        prep = fn(*args, **kwargs)
        mag = prep.mag_original.to(torch.bfloat16).to(torch.float32)
        truth = ((prep.order_labels ^ prep.hard_original).to(torch.float32)
                 * mag).sum(1)
        return dataclasses.replace(prep, mag_original=mag,
                                   truth_discrepancy=truth)
    return prepare


def _stuck_round(monkeypatch):
    capture_round = system.TwoPhase.capture_round
    first = {}

    def stuck(self, i):
        if "out" not in first:
            first["out"] = capture_round(self, i)
        return first["out"]
    monkeypatch.setattr(system.TwoPhase, "capture_round", stuck)


SYSTEM_FAULTS = {
    "state_unchanged": _stuck_round,
    "half_batch": lambda mp: mp.setattr(
        harness, "count_and_capture", _half_batch_capture(harness.count_and_capture)),
    "answer_altered": lambda mp: mp.setattr(
        engine, "sliding_osd", _flip_one_decision(engine.sliding_osd)),
    "magnitudes_bf16": lambda mp: mp.setattr(
        engine, "prepare", _bf16_magnitudes(engine.prepare)),
}


@pytest.mark.parametrize("fault", SYSTEM_FAULTS)
def test_system_fault_is_not_correct(fault, monkeypatch):
    SYSTEM_FAULTS[fault](monkeypatch)
    line = run("ccsds-system-3.0dB")
    assert not line["correct"] and line["failed"] >= 1, line["checks"]
    if fault == "magnitudes_bf16":
        # read at the preparation, where the system's magnitudes are held
        # against the reference's own
        assert line["checks"]["prepare_mismatch"]["value"] > 0, line["checks"]


def _half_step(fn):
    def half(code, params, variant, iters, snr, batch, **kw):
        return fn(code, params, variant, iters, snr, batch // 2, **kw) * 2
    return half


def _altered_step(fn):
    def altered(*args, **kwargs):
        out = fn(*args, **kwargs).clone()
        out[1] += 1
        return out
    return altered


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_phase1_fault_is_not_correct(fault, monkeypatch):
    plant = {"state_unchanged": _first_result, "half_batch": _half_step,
             "answer_altered": _altered_step}[fault]
    monkeypatch.setattr(nms_edge, "fused_counters_edge_compact",
                        plant(nms_edge.fused_counters_edge_compact))
    line = run("ccsds-phase1-3.0dB")
    assert not line["correct"] and line["failed"] >= 1, line["checks"]


def test_system_control_is_not_correct():
    cell = core.find_cell(ROOT, "ccsds-system-3.0dB")
    tr = dict(cell.traffic, **SMALL["ccsds-system-3.0dB"])
    ref = setup.build(ROOT, cell.config, tr, torch.device("cpu"))
    args = {"cap_b": 4096, "cap": 128, "iters": 12, "window": 5, "soft_margin": 0.9}
    for seed in (1, 2, 3):
        nums = control.system_numbers(ref, args, seed, 0)
        nums.pop("walk_ties")
        assert any(v > cell.limits[k] for k, v in nums.items()), nums
        sound = control.system_numbers(ref, args, seed, 0, mode="f64")
        sound.pop("walk_ties")
        assert all(v <= cell.limits[k] for k, v in sound.items()), sound


def test_phase1_control_is_not_correct():
    cell = core.find_cell(ROOT, "ccsds-phase1-3.0dB")
    tr = dict(cell.traffic, batch=4096)
    for seed in (1, 2, 3):
        nums = control.phase1_control(ROOT, cell.config, tr, torch.device("cpu"), seed)
        assert nums["counter_mismatch"] > cell.limits["counter_mismatch"], nums


@pytest.mark.cuda
@pytest.mark.parametrize("name", SMALL)
def test_cell_on_the_card(name, card):
    """A short run of each cell at its own size on the card."""
    line = core.run_cell(ROOT, name, SEED, 1.0, False, time.perf_counter(),
                         device=card)
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
