"""The port's span-and-counter recorder (``utils/profiling.py``) on the CPU:
off, a round and a fused step record nothing and add no profiler range,
operation or synchronisation; on, the spans nest as the stages do, the
counters count the walked rows and the real failures among them, a
profiler's trace holds every span as a ``sldpc.*`` range, and a round's
outputs are the same bit for bit."""

import collections
import contextlib
import ctypes
import json

import numpy as np
import pytest
import torch

from short_ldpc_decoding_osd_tpu_torch import _kernels, system
from short_ldpc_decoding_osd_tpu_torch.codes import get_code
from short_ldpc_decoding_osd_tpu_torch.ops import nms, nms_edge, nms_edge_padded
from short_ldpc_decoding_osd_tpu_torch.utils import profiling

from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

CAP_B, CAP = 1024, 64  # ~100 failures a round: the buffer overflows
# each span's enclosing span in a round and in a fused step
TREE = {
    "round": None,
    "capture": "round",
    "capture.sample": "capture",
    "capture.decode": "capture",
    "capture.compact": "capture",
    "phase2": "round",
    "redecode": "phase2",
    "detect": "phase2",
    "dia": "phase2",
    "prepare": "phase2",
    "osd": "phase2",
    "minima": "osd",
    "minima.terms": "minima",
    "minima.k5": "minima",
    "walk": "osd",
    "select": "osd",
    "mc.step": None,
    "mc.setup": "mc.step",
}


@pytest.fixture(scope="module")
def two_phase():
    """The system, after the process's first round and first fused step:
    those run inside set-up span ``setup.first_unit``
    (``tests/test_torch_setup_spans.py``), and the tests here are about the
    units after them."""
    tp = system.TwoPhase(cap_b=CAP_B, cap=CAP, device="cpu", seed=5)
    tp.full_round(10**6)
    _step()
    return tp


@pytest.fixture(autouse=True)
def _clean_record():
    profiling.reset()
    yield
    profiling.reset()


def _step():
    return nms_edge.fused_counters_edge_compact(
        get_code("ccsds_128_64"), nms.init_params("NMS-1"), "NMS-1", 8, 3.0, 64,
        seed=3, block_frames=32, schedule=((4, 0.5),), device="cpu")


def _flat(out):
    """A round's or a step's outputs as one tuple of tensors."""
    return out if isinstance(out, tuple) else (out,)


def test_span_off_is_the_shared_null_object():
    assert profiling.span("round") is profiling.span("minima.k5")
    with profiling.span("round") as got:
        assert got is None
    profiling.count("osd.rows", 5)
    profiling.count("osd.failures", torch.tensor(3), at_most=2)
    assert profiling.snapshot() == {"spans": {}, "counters": {}}


@pytest.mark.parametrize("unit", ["round", "step"])
def test_off_unit_records_nothing(two_phase, unit, monkeypatch):
    """Off, a unit opens no profiler range and synchronises nothing
    (either would raise here) and leaves no aggregate and no counter."""

    def forbidden(*args, **kwargs):
        raise AssertionError("called while nothing records")

    monkeypatch.setattr(profiling, "record_function", forbidden)
    monkeypatch.setattr(profiling, "synchronize", forbidden)
    monkeypatch.setattr(profiling, "_Span", forbidden)
    if unit == "round":
        two_phase.full_round(0)
    else:
        _step()
    assert profiling.snapshot() == {"spans": {}, "counters": {}}


def _op_counts(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return collections.Counter(e.name for e in prof.events())


@pytest.mark.parametrize("unit", ["round", "step"])
def test_off_path_adds_no_operation(two_phase, unit, monkeypatch):
    """The profiler sees the same operations, one for one, with the spans
    off as with every span replaced by a bare null context."""
    run = (lambda: two_phase.full_round(1)) if unit == "round" else _step
    off = _op_counts(run)
    monkeypatch.setattr(profiling, "span", lambda name: contextlib.nullcontext())
    bare = _op_counts(run)
    assert off == bare
    assert not any(name.startswith("sldpc.") for name in off)


def test_spans_nest_as_the_stages(two_phase):
    with profiling.recording() as record:
        for i in range(2):
            two_phase.full_round(i)
        _step()
    assert record is profiling._SHARED
    spans = profiling.snapshot()["spans"]
    assert set(spans) == set(TREE)
    # K5's counters count launches on the card: the CPU twin adds none
    assert not any(key.startswith("k5.") for key in profiling.snapshot()["counters"])
    for name, parent in TREE.items():
        calls = 1 if name.startswith("mc.") else 2
        assert spans[name]["calls"] == calls, name
        assert spans[name]["parents"] == {parent: calls}, name
        assert 0.0 <= spans[name]["self_seconds"] <= spans[name]["seconds"]
    for name, parent in TREE.items():
        if parent is not None:
            assert spans[name]["seconds"] <= spans[parent]["seconds"], name
    children = sum(spans[c]["seconds"] for c, p in TREE.items() if p == "round")
    assert spans["round"]["self_seconds"] == pytest.approx(
        spans["round"]["seconds"] - children, abs=1e-9)


def test_counters_walked_rows_and_real_failures(two_phase):
    with profiling.recording():
        got = [two_phase.full_round(i) for i in range(3)]
    counts = [int(out[1]) for out in got]
    assert max(counts) > CAP  # the overflow is capped, not counted
    assert profiling.snapshot()["counters"] == {
        "osd.rows": 3 * CAP,
        "osd.failures": sum(min(c, CAP) for c in counts)}
    # a snapshot reads the device counts once and keeps the sums
    assert profiling.snapshot()["counters"]["osd.rows"] == 3 * CAP
    profiling.reset()
    assert profiling.snapshot() == {"spans": {}, "counters": {}}


def test_cpu_step_counts_no_encode_columns():
    """The encode's counters count launches of ``mc_frames`` on the card:
    the CPU twins of K3's chain and of K4 add neither."""
    with profiling.recording():
        _step()
        nms_edge.fused_counters_edge(
            get_code("ccsds_128_64"), nms.init_params("NMS-1"), "NMS-1", 4,
            3.0, 64, seed=3, device="cpu")
    counters = profiling.snapshot()["counters"]
    assert "mc.columns_as_bit" not in counters
    assert "mc.columns_encoded" not in counters


@pytest.mark.parametrize("status", [0, 719])
def test_launch_counts_encode_columns(monkeypatch, status):
    """Each ``mc_frames`` launch that succeeded adds G's unit columns to
    ``mc.columns_as_bit`` and the others to ``mc.columns_encoded`` (WiMAX:
    880 and 176); a refused launch raises and counts nothing.  The launch
    is a stand-in: there is no card here."""
    code = get_code("wimax_1056_880")
    mc = nms_edge.mc_setup(code, nms.init_params("NMS-1"), "NMS-1", 4.0, 1,
                           "cpu")
    launched = []

    class Library:
        def mc_frames(self, *args):
            launched.append(args)
            return status

    monkeypatch.setattr(nms_edge._kernels, "library", lambda name: Library())
    monkeypatch.setattr(nms_edge._kernels, "stream_handle", lambda dev: 0)
    monkeypatch.setattr(nms_edge, "mc_occupancy", lambda *a: {
        "blocks_per_sm": 1, "sms": 132, "table_shared": 1})
    with profiling.recording():
        for _ in range(2):
            if status:
                with pytest.raises(RuntimeError, match="cudaError 719"):
                    nms_edge._mc_frames_kernel(mc, 4, 1024)
            else:
                nms_edge._mc_frames_kernel(mc, 4, 1024)
    assert len(launched) == 2
    want = {} if status else {"mc.columns_as_bit": 2 * 880,
                              "mc.columns_encoded": 2 * 176}
    assert profiling.snapshot()["counters"] == want


@pytest.mark.parametrize("status", [0, 719])
@pytest.mark.parametrize("variant", ["ENMS", "NMS-1"])
def test_launch_counts_enms_frames(monkeypatch, variant, status):
    """Each ``mc_frames`` launch that succeeded on ENMS's extended matrix
    adds its slots to ``enms.frames``, and each K1/K2 launch with the
    variant ENMS its frames; NMS-1's launches and a refused launch count
    none.  The launches are stand-ins: there is no card here."""
    code = get_code("wimax_1056_880")
    params = nms.init_params(variant)
    mc = nms_edge.mc_setup(code, params, variant, 4.0, 1, "cpu")
    assert mc.extended == (variant == "ENMS")
    launched = []

    class Library:
        def mc_frames(self, *args):
            launched.append(args)
            return status

        def nms_edge_decode(self, *args):
            launched.append(args)
            return status

    monkeypatch.setattr(nms_edge._kernels, "library", lambda name: Library())
    monkeypatch.setattr(nms_edge._kernels, "stream_handle", lambda dev: 0)
    monkeypatch.setattr(nms_edge, "mc_occupancy", lambda *a: {
        "blocks_per_sm": 1, "sms": 132, "table_shared": 1})
    llr = torch.zeros((16, code.n))
    weights = nms.scalar_weights(params, variant)
    with profiling.recording():
        for call in (lambda: nms_edge._mc_frames_kernel(mc, 4, 1024),
                     lambda: nms_edge._decode_edge_kernel(
                         llr, mc.h, 3, weights, False, variant == "ENMS"),
                     lambda: nms_edge._decode_edge_kernel(
                         llr, mc.h, 3, weights, True, variant == "ENMS")):
            if status:
                with pytest.raises(RuntimeError, match="cudaError 719"):
                    call()
            else:
                call()
    assert len(launched) == 3
    counters = profiling.snapshot()["counters"]
    want = 1024 + 2 * 16 if variant == "ENMS" and not status else None
    assert counters.get("enms.frames") == want


@pytest.mark.parametrize("status", [0, 719])
@pytest.mark.parametrize("code_name,variant,bucket", [
    ("wimax_1056_880", "ENMS", 4), ("wimax_1056_880", "NMS-1", 2),
    ("ccsds_128_64", "NMS-1", 0)])
def test_launch_counts_split_frames(monkeypatch, code_name, variant, bucket,
                                    status):
    """Each ``mc_frames`` and K1/K2 launch that succeeded at the split
    bucket (WiMAX's extended matrix) adds its slots or frames to
    ``split.frames``, handing the kernel the lane map and the lanes its
    checks take; buckets 0 and 2 hand neither and count none, nor does a
    refused launch.  The launches are stand-ins: there is no card here."""
    code = get_code(code_name)
    params = nms.init_params(variant)
    mc = nms_edge.mc_setup(code, params, variant, 4.0, 1, "cpu")
    assert mc.plan.bucket == bucket
    launched = []

    class Library:
        def mc_frames(self, *args):
            launched.append(("mc_frames", args[8], args[21]))
            return status

        def nms_edge_decode(self, *args):
            launched.append(("nms_edge_decode", args[4], args[18]))
            return status

    monkeypatch.setattr(nms_edge._kernels, "library", lambda name: Library())
    monkeypatch.setattr(nms_edge._kernels, "stream_handle", lambda dev: 0)
    monkeypatch.setattr(nms_edge, "mc_occupancy", lambda *a: {
        "blocks_per_sm": 1, "sms": 132, "table_shared": 1})
    llr = torch.zeros((16, code.n))
    weights = nms.scalar_weights(params, variant)
    with profiling.recording():
        for call in (lambda: nms_edge._mc_frames_kernel(mc, 4, 1024),
                     lambda: nms_edge._decode_edge_kernel(
                         llr, mc.h, 3, weights, False, variant == "ENMS"),
                     lambda: nms_edge._decode_edge_kernel(
                         llr, mc.h, 3, weights, True, variant == "ENMS")):
            if status:
                with pytest.raises(RuntimeError, match="cudaError 719"):
                    call()
            else:
                call()
    split = bucket == nms_edge.SPLIT_BUCKET
    lane_map = nms_edge.split_operand(mc.h, mc.plan, "cpu")
    assert (lane_map is not None) == split
    want_ptr = lane_map.data_ptr() if split else None
    lanes = 264 if split else code.h.shape[0]
    assert launched == [("mc_frames", want_ptr, lanes)] + [
        ("nms_edge_decode", want_ptr, lanes)] * 2
    counters = profiling.snapshot()["counters"]
    want = 1024 + 2 * 16 if split and not status else None
    assert counters.get("split.frames") == want
    if variant == "ENMS" and not status:
        assert counters["split.frames"] == counters["enms.frames"]


def test_split_twins_count_no_frames():
    """The CPU twins of K3's chain, K4 and K1 on WiMAX's extended matrix
    (the split bucket's) count no ``split.frames``."""
    code = get_code("wimax_1056_880")
    params = nms.init_params("ENMS")
    with profiling.recording():
        nms_edge.fused_counters_edge_compact(
            code, params, "ENMS", 6, 4.0, 128, seed=3, block_frames=128,
            device="cpu")
        nms_edge.fused_counters_edge(code, params, "ENMS", 4, 4.0, 32, seed=3,
                                     device="cpu")
        nms_edge.decode_final_edge(params, code.extended().h,
                                   torch.zeros((8, code.n)), 3, "ENMS")
    assert "split.frames" not in profiling.snapshot()["counters"]


def test_enms_twins_count_no_frames():
    """On the CPU the fused step and the edge wrappers run the kernels'
    twins on ENMS's extended matrix: no ``enms.frames``."""
    code = get_code("wimax_1056_880")
    params = nms.init_params("ENMS")
    llr = torch.zeros((8, code.n))
    with profiling.recording():
        nms_edge.fused_counters_edge_compact(
            code, params, "ENMS", 6, 4.0, 128, seed=3, block_frames=128,
            device="cpu")
        nms_edge.fused_counters_edge(code, params, "ENMS", 4, 4.0, 32, seed=3,
                                     device="cpu")
        nms_edge.decode_final_edge(params, code.extended().h, llr, 3, "ENMS")
    assert "enms.frames" not in profiling.snapshot()["counters"]


def test_recording_into_a_record_of_its_own(two_phase):
    """``stage_times`` times one round by its spans and leaves the shared
    record as it was."""
    with profiling.recording():
        two_phase.full_round(0)
    before = profiling.snapshot()
    times = two_phase.stage_times(1)
    assert [k for k, _ in system.STAGE_SPANS] == list(times)
    assert all(t > 0 for t in times.values())
    assert times["sliding_osd_total"] >= times["disc_minima_k5"]
    assert profiling.snapshot() == before


def test_profiler_trace_holds_the_spans_nested(two_phase, tmp_path):
    with profiling.trace(str(tmp_path)), profiling.recording():
        two_phase.full_round(0)
        _step()
    (path,) = tmp_path.glob("*.pt.trace.json")
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"
              and e.get("name", "").startswith("sldpc.")]
    found = {e["name"][len("sldpc."):]: e for e in events}
    assert set(found) == set(TREE) and len(events) == len(TREE)
    for name, parent in TREE.items():
        if parent is None:
            continue
        e, p = found[name], found[parent]
        assert p["ts"] <= e["ts"] and e["ts"] + e["dur"] <= p["ts"] + p["dur"], name
        assert e["tid"] == p["tid"]


@pytest.mark.parametrize("unit", ["round", "step"])
def test_outputs_bit_identical_with_recording(two_phase, unit):
    run = (lambda: two_phase.full_round(2)) if unit == "round" else _step
    off = _flat(run())
    with profiling.recording(synchronize=torch.device("cpu")):
        on = _flat(run())
    assert len(off) == len(on)
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and torch.equal(a, b)



def _nmsr_decode(route, batch=16, iters=3):
    code = get_code("ccsds_128_64")
    params = nms.init_params("NMS-r", code.h, seed=1)
    llr = torch.randn((batch, code.n), generator=torch.Generator().manual_seed(2)) + 1.0
    if route == "padded":
        return nms_edge_padded.decode_edge_padded(params, code.h, llr, iters, "NMS-r")
    if route == "padded_final":
        return nms_edge_padded.decode_final_edge_padded(params, code.h, llr, iters,
                                                        "NMS-r")
    return nms.decode(params, code.h, llr, iters, "NMS-r", nms.edge_columns(code.h))


@pytest.mark.parametrize("route", ["padded", "padded_final", "dense"])
def test_nmsr_spans_and_counters(route):
    """NMS-r's check update is span ``nmsr.check`` around ``nmsr.sort`` and
    ``nmsr.net``, once an iteration; ``nmsr.edge_updates`` counts frames x
    512 edges x iterations, and ``padded.frames`` each padded decode's
    frames."""
    with profiling.recording():
        _nmsr_decode(route, batch=16, iters=3)
    snap = profiling.snapshot()
    spans = snap["spans"]
    assert set(spans) == {"nmsr.check", "nmsr.sort", "nmsr.net"}
    assert spans["nmsr.check"]["calls"] == 3
    assert spans["nmsr.check"]["parents"] == {None: 3}
    for name in ("nmsr.sort", "nmsr.net"):
        assert spans[name]["parents"] == {"nmsr.check": 3}, name
        assert spans[name]["seconds"] <= spans["nmsr.check"]["seconds"]
    want = {"nmsr.edge_updates": 16 * 512 * 3}
    if route != "dense":
        want["padded.frames"] = 16
    assert snap["counters"] == want


@pytest.mark.parametrize("route", ["padded", "padded_final", "dense"])
def test_nmsr_off_records_nothing(route, monkeypatch):
    """Outside ``recording()`` NMS-r's update opens no range, synchronises
    nothing and counts nothing, and its outputs are the same bit for bit."""
    with profiling.recording(synchronize=torch.device("cpu")):
        on = _nmsr_decode(route)
    profiling.reset()

    def forbidden(*args, **kwargs):
        raise AssertionError("called while nothing records")

    monkeypatch.setattr(profiling, "record_function", forbidden)
    monkeypatch.setattr(profiling, "synchronize", forbidden)
    monkeypatch.setattr(profiling, "_Span", forbidden)
    off = _nmsr_decode(route)
    assert profiling.snapshot() == {"spans": {}, "counters": {}}
    assert torch.equal(on, off)


def test_nmsr_round_counts_its_updates(tmp_path):
    """A two-phase round of an NMS-r run directory records the update
    inside both the capture's decode and the re-decode: frames x 512 x
    iterations each (the CPU takes the dense decoders, so no padded
    frames)."""
    import shutil

    root = system._ROOT
    for name in ("dia_model_cnn.pkl", "stopper_params.pkl", "decoding_path.json"):
        shutil.copy(f"{root}/runs/r4_pipeline/{name}", tmp_path)
    shutil.copy(f"{root}/runs/r5_variants_nmsr/nms_params.pkl", tmp_path)
    cfg = json.load(open(f"{root}/runs/r4_pipeline/config.json"))
    (tmp_path / "config.json").write_text(json.dumps(dict(cfg, variant="NMS-r")))
    tp = system.TwoPhase(run_dir=str(tmp_path), cap_b=256, cap=32, device="cpu",
                         seed=5)
    with profiling.recording():
        tp.full_round(0)
    snap = profiling.snapshot()
    assert snap["counters"]["nmsr.edge_updates"] == (256 + 32) * 512 * 12
    assert snap["spans"]["nmsr.check"]["parents"] == {"capture.decode": 12,
                                                      "redecode": 12}


@pytest.mark.parametrize("status", [0, 719])
def test_nmsr_kernel_counts_its_frames(monkeypatch, status):
    """Each NMS-r kernel launch that succeeded adds its frames to
    ``nmsr.kernel_frames`` and one launch to its ``LAUNCHES`` entry, and
    hands the kernel its weights as host values (w_vc, w_marg, w2, w1); a
    refused launch raises and counts nothing; it opens none of the padded
    path's spans.  The launch is a stand-in: there is no card here."""
    code = get_code("ccsds_128_64")
    params = nms.init_params("NMS-r", code.h, seed=1)
    w_vc, w_marg, w1, w2 = nms_edge.nmsr_weights(params)
    llr = torch.randn((16, code.n), generator=torch.Generator().manual_seed(2))
    launched = []

    class Library:
        def nms_edge_decode_nmsr(self, *args):
            launched.append(args)
            weights = np.ctypeslib.as_array(
                (ctypes.c_float * 34).from_address(args[10]))
            assert weights[:2].tolist() == [np.float32(w_vc), np.float32(w_marg)]
            assert (weights[2:6] == w2.ravel()).all()
            assert (weights[6:] == w1.ravel()).all()
            return status

    monkeypatch.setattr(nms_edge._kernels, "library", lambda name: Library())
    monkeypatch.setattr(nms_edge._kernels, "stream_handle", lambda dev: 0)
    _kernels.reset_launches()
    weights = nms_edge.nmsr_weights(params)
    with profiling.recording():
        for traj in (False, True):
            if status:
                with pytest.raises(RuntimeError, match="cudaError 719"):
                    nms_edge._decode_nmsr_kernel(llr, code.h, 3, weights, traj)
            else:
                nms_edge._decode_nmsr_kernel(llr, code.h, 3, weights, traj)
    assert len(launched) == 2
    snap = profiling.snapshot()
    assert snap["spans"] == {}
    assert snap["counters"] == ({} if status else {"nmsr.kernel_frames": 2 * 16})
    want = 0 if status else 1
    assert (_kernels.LAUNCHES["nmsr_edge_final"],
            _kernels.LAUNCHES["nmsr_edge_traj"]) == (want, want)


@pytest.mark.parametrize("traj", [False, True])
def test_nmsr_twin_counts_no_kernel_frames(traj):
    """On the CPU the NMS-r edge wrappers run the kernels' twin: no
    ``nmsr.kernel_frames``, no launch, and none of the padded path's spans
    or counters."""
    code = get_code("ccsds_128_64")
    params = nms.init_params("NMS-r", code.h, seed=1)
    llr = torch.randn((16, code.n), generator=torch.Generator().manual_seed(2))
    fn = nms_edge.decode_traj_edge if traj else nms_edge.decode_final_edge
    _kernels.reset_launches()
    with profiling.recording():
        fn(params, code.h, llr, 3, "NMS-r")
    assert profiling.snapshot() == {"spans": {}, "counters": {}}
    assert sum(_kernels.LAUNCHES.values()) == 0
