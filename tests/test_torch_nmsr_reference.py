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
from short_ldpc_decoding_osd_tpu_torch.ops import nms, nms_edge_padded as pad

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
