"""The port's NMS-r decoders against the benchmark's plain NMS-r reference
(``gpubench/reference/variants/NMS-r.py``, which imports nothing of the
port), on the CPU, on seeded random non-negative network weights and
random bit scalars.

The tolerance is the benchmark's re-decode limit, a relative gap
``|port - ref| / (1 + |ref|)`` of 3e-4 over every slot of the
trajectory, on the frames whose reference decode stays clear of a tie
(``NMS-r.py``'s ``TIE`` and ``DECIDE``): the padded layout and the dense
decoder sum the columns and the network's products in other orders than
the reference, and those f32 orders part by about 5e-6 here (1.1e-5 on
the card, PERF.md §2), while TF32 operands in the network or bfloat16
messages part by 1 and more.  On those frames the hard decisions and the
detected flags are identical.
"""

import os

import numpy as np
import pytest
import torch

from gpubench import control_decoder, core
from gpubench.reference import codes, decode
from short_ldpc_decoding_osd_tpu_torch.codes import get_code
from short_ldpc_decoding_osd_tpu_torch.codes.code import make_regular_ldpc
from short_ldpc_decoding_osd_tpu_torch.ops import nms, nms_edge, nms_edge_padded as pad

from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

GAP = 3e-4
ITERS = 8
DEC = core.decoder("NMS-r")


def _h(name):
    if name == "regular_32_16":
        return make_regular_ldpc(32, 16, row_weight=6, seed=3).h.astype(np.uint8)
    return np.asarray(get_code(name).h, np.uint8)


def _params(h, seed):
    """Non-negative (dc-1, 4) and (4, 1) weights and bit scalars whose
    softplus lies between 0.7 and 2.1.  The weights of the i-th smallest
    magnitude shrink as 0.4^i, as trained weights weigh the smallest most,
    so that the messages stay bounded (growing messages amplify the
    orders' differences along with themselves)."""
    dc = int(h.sum(1)[0])
    rng = np.random.default_rng(seed)
    decay = 0.4 ** np.arange(dc - 1)[:, None]
    return {"bit1": rng.uniform(0.0, 2.0, 1).astype(np.float32),
            "bit2": rng.uniform(0.0, 2.0, 1).astype(np.float32),
            "nn_w1": (rng.uniform(0.0, 1.0, (dc - 1, 4)) * decay).astype(np.float32),
            "nn_w2": rng.uniform(0.0, 0.5, (4, 1)).astype(np.float32)}


def _ref(h, params):
    return {"tables": decode.Tables(h, *codes.edges(h), torch.device("cpu")),
            "weights": DEC.weights(params)}


def _frames(h, seed, batch=64):
    """Channel LLRs of ``4 * batch`` all-zero words at about 2 dB (the
    tests judge those the reference's decode keeps clear of a tie)."""
    m, n = h.shape
    rng = np.random.default_rng(seed)
    sigma = (2.0 * (n - m) / n * 10 ** 0.2) ** -0.5
    llr = torch.as_tensor((1.0 + sigma * rng.standard_normal((4 * batch, n)))
                          .astype(np.float32))
    return llr


def _decodes(h, params, llr):
    """{name: (T+1, B, n)}: the reference, the padded layout and the dense
    decoder, with the reference's near-tie flags."""
    ref = _ref(h, params)
    soft, crossed = DEC.decode_rows(llr, ref, ITERS, set(range(ITERS + 1)))
    want = torch.stack([soft[i] for i in range(ITERS + 1)])
    p = {k: torch.as_tensor(v) for k, v in params.items()}
    return want, crossed | (want[ITERS].abs() < DEC.DECIDE).any(1), {
        "padded": pad.decode_edge_padded(p, h, llr, ITERS, "NMS-r"),
        "dense": nms.decode(p, h, llr, ITERS, "NMS-r", nms.edge_columns(h))}


def _gap(got, want):
    return float(((got - want).abs() / (1.0 + want.abs())).max())


def _reference(h, params, llr):
    """(T+1, B, n) the reference's soft outputs of ``llr``."""
    soft, _ = DEC.decode_rows(llr, _ref(h, params), ITERS, set(range(ITERS + 1)))
    return torch.stack([soft[i] for i in range(ITERS + 1)])


def _edge(h, params, llr, form):
    """NMS-r through the edge wrappers (on the CPU the kernels' twin):
    the trajectory, or the final output alone."""
    p = {k: torch.as_tensor(v) for k, v in params.items()}
    if form == "trajectory":
        return nms_edge.decode_traj_edge(p, h, llr, ITERS, "NMS-r")
    return nms_edge.decode_final_edge(p, h, llr, ITERS, "NMS-r")


def _bits_equal(got, want):
    return got.shape == want.shape and torch.equal(got.view(torch.int32),
                                                   want.view(torch.int32))


@pytest.mark.parametrize("form", ["trajectory", "final"])
@pytest.mark.parametrize("name", ["ccsds_128_64", "regular_32_16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_twin_is_the_reference_bit_for_bit(name, seed, form):
    """NMS-r's kernel twin sums and multiplies in the reference's f32
    order, so every soft output of every frame, near-tie frames included,
    equals the reference's to the bit."""
    h = _h(name)
    params = _params(h, seed)
    llr = _frames(h, seed)
    want = _reference(h, params, llr)
    got = _edge(h, params, llr, form)
    assert _bits_equal(got, want if form == "trajectory" else want[ITERS])


@pytest.mark.parametrize("name", ["ccsds_128_64", "regular_32_16"])
@pytest.mark.parametrize("form", ["trajectory", "final"])
def test_kernel_twin_duplicate_magnitudes(name, form):
    """Channel values on a coarse grid give rows with equal magnitudes (at
    the first iteration most rows have some): whichever copy a sort puts
    first, the outputs are the reference's to the bit."""
    h = _h(name)
    params = _params(h, 5)
    llr = torch.round(_frames(h, 5) * 2.0) / 2.0 + 0.25
    mags = llr[:, torch.as_tensor(nms.edge_columns(h))].abs()  # (B, m, dc)
    sorted_mags = torch.sort(mags, dim=-1).values
    tied = (sorted_mags[..., 1:] == sorted_mags[..., :-1]).any(-1)
    assert float(tied.float().mean()) > 0.5
    want = _reference(h, params, llr)
    got = _edge(h, params, llr, form)
    assert _bits_equal(got, want if form == "trajectory" else want[ITERS])


@pytest.mark.parametrize("name", ["ccsds_128_64", "regular_32_16"])
@pytest.mark.parametrize("form", ["trajectory", "final"])
def test_kernel_twin_zero_check_input(name, form):
    """A zero channel value makes its checks' inputs zero at the first
    iteration, which zeroes those rows' messages: the reference's sign
    rule, to the bit."""
    h = _h(name)
    params = _params(h, 6)
    llr = _frames(h, 6)
    llr[::3, 5] = 0.0
    llr[1::3, :3] = 0.0
    want = _reference(h, params, llr)
    got = _edge(h, params, llr, form)
    assert _bits_equal(got, want if form == "trajectory" else want[ITERS])
    # a zeroed row sends 0 on every edge: one iteration on the frames whose
    # only zero is bit 5 reads as on H without bit 5's rows
    p = {k: torch.as_tensor(v) for k, v in params.items()}
    rest = np.ascontiguousarray(h[h[:, 5] == 0])
    assert _bits_equal(nms_edge.decode_final_edge(p, h, llr[::3], 1, "NMS-r"),
                       nms_edge.decode_final_edge(p, rest, llr[::3], 1, "NMS-r"))


@pytest.mark.parametrize("name", ["ccsds_128_64", "regular_32_16"])
def test_kernel_twin_within_tolerance_of_the_dense_decoder(name):
    """The twin against the dense ``nms.decode``, whose products run in
    another order: within the re-decode limit on the frames clear of a
    tie, with the same hard decisions."""
    h = _h(name)
    params = _params(h, 3)
    llr = _frames(h, 3)
    want, near, got = _decodes(h, params, llr)
    clear = ~near
    twin = _edge(h, params, llr, "trajectory")
    assert _gap(twin[:, clear], got["dense"][:, clear]) < GAP
    assert torch.equal(twin[ITERS][clear] < 0, got["dense"][ITERS][clear] < 0)


@pytest.mark.parametrize("dc", range(2, 9))
def test_padded_slots_change_no_value(dc):
    """The kernel's rows hold 8 slots: a code of degree dc < 8 fills the
    rest with magnitudes clamped to FLT_MAX (they sort last) and w1 with
    +0 rows.  Its network by position then equals the unpadded one, and
    that the literal network over each leave-one-out list, to the bit."""
    rng = np.random.default_rng(dc)
    a = torch.as_tensor(np.sort(np.abs(3.0 * rng.standard_normal((256, dc, 16))),
                                axis=1).astype(np.float32))
    a[:64, 1] = a[:64, 0]  # ties
    w1 = torch.as_tensor(rng.uniform(0.0, 1.0, (dc - 1, 4)).astype(np.float32))
    w2 = torch.as_tensor(rng.uniform(0.0, 1.0, (4, 1)).astype(np.float32))
    want = nms_edge._network_by_position(a, w1, w2)
    big = torch.full((256, 8 - dc, 16), np.finfo(np.float32).max)
    padded = nms_edge._network_by_position(
        torch.cat([a, big], 1), torch.cat([w1, torch.zeros(8 - dc, 4)]), w2)
    assert _bits_equal(padded[:, :dc], want)
    assert bool(torch.isfinite(padded).all())
    literal = []
    for r in range(dc):
        x = torch.cat([a[:, :r], a[:, r + 1:]], 1)
        literal.append(DEC._products(x.transpose(1, 2), w1, w2, None))
    assert _bits_equal(want, torch.stack(literal, 1))


def test_regular_code_is_regular():
    h = _h("regular_32_16")
    assert (h.sum(1) == 6).all() and pad.supports(h, "NMS-r")


@pytest.mark.parametrize("name", ["ccsds_128_64", "regular_32_16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_port_matches_the_reference(name, seed):
    h = _h(name)
    params = _params(h, seed)
    llr = _frames(h, seed)
    want, near, got = _decodes(h, params, llr)
    clear = ~near
    assert int(clear.sum()) >= 64
    labels = torch.zeros((int(clear.sum()), h.shape[1]), dtype=torch.int32)
    _, det = decode.frame_stats(want[ITERS][clear], labels,
                                torch.as_tensor(h, dtype=torch.float32))
    for key, traj in got.items():
        assert traj.shape == want.shape
        assert _gap(traj[:, clear], want[:, clear]) < GAP, key
        assert torch.equal(traj[ITERS][clear] < 0, want[ITERS][clear] < 0), key
        _, got_det = decode.frame_stats(traj[ITERS][clear], labels,
                                        torch.as_tensor(h, dtype=torch.float32))
        assert torch.equal(got_det, det), key


@pytest.mark.parametrize("name", ["ccsds_128_64", "regular_32_16"])
@pytest.mark.parametrize("mode", ["tf32", "bf16"])
def test_one_precision_below_fails(name, mode):
    """TF32 operands in the network, or bfloat16 messages, part from the
    f32 reference by more than the tolerance."""
    h = _h(name)
    params = _params(h, 0)
    llr = _frames(h, 0)
    ref = _ref(h, params)
    slots = set(range(ITERS + 1))
    soft, crossed = DEC.decode_rows(llr, ref, ITERS, slots)
    clear = ~crossed
    low = DEC.soft_outputs(llr, ref, ITERS, slots, **control_decoder.MODES[mode])
    want = torch.stack([soft[i] for i in range(ITERS + 1)])[:, clear]
    got = torch.stack([low[i] for i in range(ITERS + 1)])[:, clear]
    assert _gap(got, want) > 10 * GAP


def test_reassociated_network_passes():
    """``x @ (w1 @ w2)`` in place of ``(x @ w1) @ w2``: another f32 order of
    the same function, inside the tolerance."""
    h = _h("ccsds_128_64")
    params = _params(h, 2)
    llr = _frames(h, 2)
    ref = _ref(h, params)
    slots = set(range(ITERS + 1))
    soft, crossed = DEC.decode_rows(llr, ref, ITERS, slots)
    w = ref["weights"]
    fused = dict(ref, weights=dict(
        w, w1=(w["w1"].astype(np.float64) @ w["w2"].astype(np.float64))
        .astype(np.float32), w2=np.ones((1, 1), np.float32)))
    other = DEC.soft_outputs(llr, fused, ITERS, slots)
    clear = ~crossed
    want = torch.stack([soft[i] for i in range(ITERS + 1)])[:, clear]
    got = torch.stack([other[i] for i in range(ITERS + 1)])[:, clear]
    assert 0 < _gap(got, want) < GAP


def test_reference_decodes_in_blocks(monkeypatch):
    """Blocks of frames decode alike: the reference's block size changes
    nothing."""
    h = _h("regular_32_16")
    params = _params(h, 4)
    llr = _frames(h, 4)
    ref = _ref(h, params)
    whole = DEC.soft_outputs(llr, ref, ITERS, {ITERS})[ITERS]
    monkeypatch.setattr(DEC, "BLOCK", 7)
    blocks = DEC.soft_outputs(llr, ref, ITERS, {ITERS})[ITERS]
    assert torch.equal(whole, blocks)


def test_frame_index_finds_each_row():
    rng = np.random.default_rng(5)
    frames = torch.as_tensor(rng.standard_normal((300, 16)).astype(np.float32))
    pick = torch.tensor([299, 0, 17, 17, 150])
    rows = frames[pick].clone()
    rows[4, 3] = torch.nextafter(rows[4, 3], torch.tensor(10.0))
    assert DEC.frame_index(rows, frames).tolist() == [299, 0, 17, 17, -1]


def test_reference_file_is_the_configs():
    spec = core.load_json(os.path.join(core.BENCH_DIR, "configs",
                                       "ccsds_128_64_nmsr.json"))
    assert spec["variant"] == "NMS-r"
    assert os.path.basename(DEC.__file__) == "NMS-r.py"
