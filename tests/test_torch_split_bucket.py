"""The split bucket of the iteration body (``csrc/nms_edge_body.cuh``,
bucket 4): a lane owns a segment of at most 20 slots, and a check of
degree above 20 spans two lanes of one warp whose tournaments combine by
one shuffle each.

On the CPU: the lane map of WiMAX's extended matrix (the one matrix of
the packaged codes that takes the bucket) and where each edge lands; the
launch plan of every other matrix as the rule before the split gave it;
the pair's combine against the one-lane tournament bit for bit; and the
lanes emulated in float32, with the kernel's addresses and combine,
against the plain twin ``_decode_edge_plain`` on WiMAX ENMS frames.
"""

import numpy as np
import pytest
import torch

from short_ldpc_decoding_osd_tpu_torch.codes import get_code
from short_ldpc_decoding_osd_tpu_torch.ops import mc_hash, nms, nms_dense, nms_edge

from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

SLOTS = nms_edge.SPLIT_SLOTS
LANES = nms_edge.MAX_LANES
CODES = ["array_121_60", "array_121_80", "ccsds_128_64", "code1_64_32",
         "qc_96_48", "wimax_1056_880", "wimaxlike_384_192"]


def _wimax_extended():
    return get_code("wimax_1056_880").extended().h


def test_split_map_of_the_wimax_extended_matrix():
    """264 of the 288 lanes: the 44 checks of degree 36 on lanes 0-87 in
    pairs, each on an even lane and the next of the same warp, then the
    176 of degree 20 one a lane."""
    h = _wimax_extended()
    smap = nms_edge.split_map(h)
    lanes, first = smap[:LANES], smap[LANES:]
    degrees = h.sum(1)
    assert smap.dtype == np.int32 and len(first) == 220
    assert nms_edge.split_lanes(h) == 264 == int((lanes >= 0).sum())
    assert (lanes[:264] >= 0).all() and (lanes[264:] == -1).all()
    wide = np.flatnonzero(degrees > SLOTS)
    assert len(wide) == 44 and (degrees[wide] == 36).all()
    for c in range(220):
        lane = first[c]
        assert lanes[lane] == 2 * c
        if degrees[c] > SLOTS:
            assert lane % 2 == 0 and lane // 32 == (lane + 1) // 32
            assert lanes[lane + 1] == 2 * c + 1
    assert sorted(first[wide]) == list(range(0, 88, 2))
    plan = nms_edge.mc_plan(h, 880)
    assert plan == nms_edge.LaunchPlan(nms_edge.SPLIT_BUCKET, 9, 1)
    assert nms_edge.split_lanes(h) <= 32 * plan.warps


def test_every_edge_lands_on_one_lane_slot():
    """Each real edge of the extended matrix is one (lane, slot) of the
    lanes' column tables, and the var-edge offset of edge e = j*m + c
    (segment first[c] + j // 20, slot j % 20) addresses that slot."""
    h = _wimax_extended()
    edge_col, var_edges = nms_edge.edge_layout(h)
    dc, m = edge_col.shape
    smap = nms_edge.split_map(h)
    lanes, first = smap[:LANES], smap[LANES:]
    owner = {}  # (variable, check) -> (lane, slot)
    for lane in np.flatnonzero(lanes >= 0):
        c, half = divmod(int(lanes[lane]), 2)
        for slot in range(SLOTS):
            j = SLOTS * half + slot
            v = int(edge_col[j, c]) if j < dc else -1
            if v >= 0:
                assert (v, c) not in owner
                owner[v, c] = (int(lane), slot)
    assert len(owner) == int(h.sum()) == 5104
    for v in range(h.shape[1]):
        for e in var_edges[:, v]:
            if e < 0:
                continue
            c, j = int(e) % m, int(e) // m
            assert edge_col[j, c] == v
            assert owner[v, c] == (int(first[c]) + j // SLOTS, j % SLOTS)


def _plan_before(m, n, dc, dv, extra_words=0, table_words=0):
    """The launch plan as the rule before the split bucket gave it: the
    buckets (dc, dv, checks a lane, variables a lane), bucket 4 a whole
    check of up to 40 slots a lane."""
    buckets = ((8, 6, 2, 4), (11, 6, 2, 4), (20, 6, 1, 4), (12, 64, 2, 1),
               (40, 6, 1, 4))
    for bucket, (bdc, bdv, cpl, vpl) in enumerate(buckets):
        if dc > bdc or dv > bdv:
            continue
        warps = max(1, -(-m // (32 * cpl)), -(-n // (32 * vpl)))
        if warps > 16:
            return None
        frames = max(1, 4 // warps)
        words = (vpl * 32 * warps + 1 + cpl * 32 * warps * (bdc | 1) + 1
                 + extra_words)
        if 4 * (table_words + frames * words) > nms_edge.SMEM_LIMIT:
            return None
        return nms_edge.LaunchPlan(bucket, warps, frames)
    return None


@pytest.mark.parametrize("matrix", ["h", "extended"])
@pytest.mark.parametrize("code_name", CODES)
def test_plans_below_the_split_bucket_are_unchanged(code_name, matrix):
    """Every packaged matrix of buckets 0-3 (H, and ENMS's extended H but
    WiMAX's) keeps the plan and the frame region the rule before the
    split gave it, for K1/K2, K3/K4/K8 and K6/K7; no lane map goes to the
    kernels there."""
    code = get_code(code_name)
    h = code.h if matrix == "h" else code.extended().h
    m, n = h.shape
    dc, dv = int(h.sum(1).max()), int(h.sum(0).max())
    plan = nms_edge.matrix_plan(h)
    if plan.bucket == nms_edge.SPLIT_BUCKET:
        assert (code_name, matrix) == ("wimax_1056_880", "extended")
        return
    assert plan == _plan_before(m, n, dc, dv)
    kw = (code.k + 31) // 32
    assert nms_edge.mc_plan(h, code.k) == _plan_before(m, n, dc, dv, kw + 2, 16)
    bdc, _, cpl, vpl = nms_edge.BUCKETS[plan.bucket]
    threads = 32 * plan.warps
    assert nms_edge.region_words(plan.bucket, threads, 7) == (
        vpl * threads + 1 + cpl * threads * (bdc | 1) + 1 + 7)
    assert nms_edge.split_operand(h, plan, "cpu") is None
    if nms_dense.holds(m, n, code.k):
        mask = torch.tensor(h, dtype=torch.float32)
        table = dc * m + dv * n + 16 + n + n * kw
        got = nms_dense.dense_plan(mask, code.k, n)
        assert got == (dc, dv, nms_edge.split_lanes(h),
                       _plan_before(m, n, dc, dv, kw + 2, table))


def test_split_region_and_plans():
    """The split bucket's frame region keeps 21-word segment rows: WiMAX
    ENMS's is bucket 2's on H (the rule before kept 41-word rows); a
    default lane count takes two lanes a check."""
    threads, extra = 9 * 32, (880 + 31) // 32 + 2
    words = nms_edge.region_words(nms_edge.SPLIT_BUCKET, threads, extra)
    assert words == nms_edge.region_words(2, threads, extra) == (
        4 * threads + 1 + threads * 21 + 1 + extra)
    assert 4 * (16 + words) == 28_992
    assert nms_edge.launch_plan(220, 1056, 36, 6).warps == 14
    assert nms_edge.launch_plan(220, 1056, 36, 6, lanes=264).warps == 9
    assert nms_edge.launch_plan(64, 128, 41, 3) is None


def _segment(vc):
    """One lane's tournament over its slots (the kernel's order): min1,
    min2 with duplicates at the minimum, and the parity of the sign bits;
    a dummy slot reads +inf."""
    min1 = min2 = np.float32(np.inf)
    parity = np.uint32(0)
    for x in vc:
        mag = np.abs(x)
        min2 = np.fmin(min2, np.fmax(min1, mag))
        min1 = np.fmin(min1, mag)
        parity ^= np.float32(x).view(np.uint32)
    return min1, min2, parity


SIGN = np.uint32(0x80000000)


def _combine(a, b):
    """The pair's combine of two segments' tournaments."""
    (a1, a2, pa), (b1, b2, pb) = a, b
    return np.fmin(a1, b1), np.fmin(np.fmax(a1, b1), np.fmin(a2, b2)), pa ^ pb


def _messages(vc, min1, min2, parity, w_chk=np.float32(0.8125)):
    """The outgoing messages of a row's slots from its tournament."""
    zero = min1 == 0
    wmin1 = np.float32(0) if zero else np.float32(w_chk * min1)
    wmin2 = np.float32(0) if zero else np.float32(w_chk * min2)
    out = []
    for x in vc:
        pick = wmin1 if np.abs(x) > min1 else wmin2
        flip = (np.float32(x).view(np.uint32) ^ parity) & np.uint32(0x80000000)
        out.append((pick.view(np.uint32) ^ flip).view(np.float32))
    return np.array(out, np.float32)


def _bits(*values):
    return [np.float32(v).view(np.uint32) for v in values]


@pytest.mark.parametrize("degree", [20, 21, 36, 40])
def test_combine_is_the_one_lane_tournament(degree):
    """Split at slot 20 (the second segment padded with +inf dummies), the
    two segments' combined tournament equals the one-lane tournament over
    the whole row bit for bit, and so does every outgoing message: rows
    with ties at the minimum and at the second, +0 and -0, and none."""
    rng = np.random.default_rng(degree)
    pool = np.array([0.25, 0.5, 0.5, 1.5, 2.0, 3.75, 7.0], np.float32)
    for trial in range(400):
        row = rng.choice(pool, degree) * rng.choice([-1, 1], degree)
        row = row.astype(np.float32)
        if trial % 4 == 1:
            row[rng.integers(degree)] = 0.0
        elif trial % 4 == 2:
            row[rng.integers(degree)] = -0.0
        elif trial % 4 == 3:  # a tie at the minimum, across the halves
            other = (SLOTS + rng.integers(degree - SLOTS) if degree > SLOTS
                     else rng.integers(degree))
            row[rng.integers(min(degree, SLOTS))] = 0.125
            row[other] = -0.125
        padded = np.full(2 * SLOTS, np.inf, np.float32)
        padded[:degree] = row
        whole = _segment(padded)
        pair = _combine(_segment(padded[:SLOTS]), _segment(padded[SLOTS:]))
        assert _bits(*whole[:2]) == _bits(*pair[:2])
        assert (whole[2] ^ pair[2]) & SIGN == 0
        assert (_messages(padded, *whole).view(np.uint32)
                == _messages(padded, *pair).view(np.uint32)).all()


def _lanes_decode(h, llr, iters, weights):
    """The split bucket's lanes emulated in float32 (``csrc/
    nms_edge_body.cuh``): phase A sums each variable's segment slots in
    ascending check order through the var-edge offsets, phase B runs each
    lane's tournament over its 20 slots and combines a pair's with its
    partner lane's; returns the soft outputs and the messages saved in
    the (dc, m) layout, as ``save`` writes them."""
    w_vc, w_chk, w_marg = weights  # f32 values
    edge_col, var_edges = nms_edge.edge_layout(h)
    dc, m = edge_col.shape
    dv, n = var_edges.shape
    smap = nms_edge.split_map(h)
    threads = 32 * nms_edge.matrix_plan(h).warps
    lanes, first = smap[:threads], smap[LANES:]
    col = np.full((threads, SLOTS), n)  # n: the +inf word
    for lane in np.flatnonzero(lanes >= 0):
        c, half = divmod(int(lanes[lane]), 2)
        for slot in range(SLOTS):
            j = SLOTS * half + slot
            if j < dc and edge_col[j, c] >= 0:
                col[lane, slot] = edge_col[j, c]
    e = var_edges.astype(np.int64)
    words = (first[e % m] + (e // m) // SLOTS) * SLOTS + (e // m) % SLOTS
    ve = torch.as_tensor(np.where(e >= 0, words, threads * SLOTS))  # zero word
    check = np.where(lanes >= 0, lanes >> 1, -1)
    pair = torch.as_tensor((lanes >= 0) & (check[np.arange(threads) ^ 1] == check))
    partner = torch.as_tensor(np.arange(threads) ^ 1)
    col = torch.as_tensor(col)
    batch = llr.shape[0]
    rows = torch.zeros(batch, threads * SLOTS + 1)
    cv = torch.zeros(batch, threads, SLOTS)
    for it in range(iters + 1):
        s = torch.zeros(batch, n)
        for d in range(dv):
            s = s + rows[:, ve[d]]
        if it == iters:
            break
        total = torch.cat([s + w_vc * llr, torch.full((batch, 1), torch.inf)], 1)
        vc = total[:, col] - cv
        mag = vc.abs()
        min1 = torch.full((batch, threads), torch.inf)
        min2 = min1.clone()
        neg = torch.zeros((batch, threads), dtype=torch.bool)
        for j in range(SLOTS):
            min2 = torch.fmin(min2, torch.fmax(min1, mag[..., j]))
            min1 = torch.fmin(min1, mag[..., j])
            neg = neg ^ torch.signbit(vc[..., j])
        b1, b2, nb = min1[:, partner], min2[:, partner], neg[:, partner]
        min2 = torch.where(pair, torch.fmin(torch.fmax(min1, b1),
                                            torch.fmin(min2, b2)), min2)
        min1 = torch.where(pair, torch.fmin(min1, b1), min1)
        neg = torch.where(pair, neg ^ nb, neg)
        zero = min1 == 0
        wmin1 = torch.where(zero, 0.0, w_chk * min1)[..., None]
        wmin2 = torch.where(zero, 0.0, w_chk * min2)[..., None]
        pick = torch.where(mag > min1[..., None], wmin1, wmin2)
        cv = torch.where(torch.signbit(vc) ^ neg[..., None], -pick, pick)
        rows[:, :-1] = cv.reshape(batch, -1)
    msgs = torch.zeros(batch, dc * m)
    for lane in np.flatnonzero(lanes >= 0):
        c, half = divmod(int(lanes[lane]), 2)
        for slot in range(SLOTS):
            j = SLOTS * half + slot
            if j < dc and col[lane, slot] < n:
                msgs[:, j * m + c] = cv[:, lane, slot]
    return s + w_marg * llr, msgs


@pytest.mark.parametrize("iters", [1, 12])
def test_split_lanes_are_the_twin(iters):
    """The emulated split lanes decode WiMAX ENMS hash frames at 3.0 dB to
    the plain twin's soft outputs and saved messages exactly (a zero
    message may differ in its sign, which no later step sees)."""
    code = get_code("wimax_1056_880")
    h = code.extended().h
    params = {k: v + 0.05 for k, v in nms.init_params("ENMS").items()}
    mc = nms_edge.mc_setup(code, params, "ENMS", 3.0, 17, "cpu")
    _, llr = mc_hash.sample(torch.arange(4), mc.seed, mc.g32, mc.sigma)
    soft, msgs = _lanes_decode(h, llr, iters, mc.weights)
    want, want_cv = nms_edge._decode_edge_plain(llr, h, iters, mc.weights,
                                                False, return_cv=True)
    assert torch.equal(soft, want)
    assert torch.equal(msgs, want_cv)
    assert (msgs != 0).any() and ((soft < 0) != (llr < 0)).any()


def _split_mask(n=60):
    """A (12, n) mask whose rows of degree 21-40 split (as ``chip_smoke``'s
    ``split_mask``): each row's columns run on from the previous row's."""
    degrees = [40, 21, 36, 24, 22, 30, 20, 8, 12, 20, 16, 21]
    h = np.zeros((len(degrees), n), np.uint8)
    col = 0
    for row, d in enumerate(degrees):
        h[row, (col + np.arange(d)) % n] = 1
        col += d
    return h


def test_split_mask_plans():
    """A small mask of the split bucket: 7 checks on two lanes and 5 on
    one, 19 lanes of one warp, pairs first; the dense rung's plan counts
    the lane map its kernels build beside the slab tables."""
    h = _split_mask()
    assert int(h.sum(0).max()) <= 6 and int(h.sum(1).max()) == 40
    smap = nms_edge.split_map(h)
    assert nms_edge.split_lanes(h) == 19
    assert smap[:19].tolist() == [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11,
                                  22, 23, 12, 14, 16, 18, 20]
    assert (smap[19:LANES] == -1).all()
    assert smap[LANES:].tolist() == [0, 2, 4, 6, 8, 10, 14, 15, 16, 17, 18, 12]
    plan = nms_edge.matrix_plan(h)
    assert plan == nms_edge.LaunchPlan(nms_edge.SPLIT_BUCKET, 1, 4)
    mask = torch.tensor(h, dtype=torch.float32)
    dc, dv, lanes, dense = nms_dense.dense_plan(mask, 8, 60)
    assert (dc, dv, lanes, dense) == (40, int(h.sum(0).max()), 19, plan)
    m, n = h.shape
    words = nms_edge.region_words(nms_edge.SPLIT_BUCKET, 32, 3)
    table = dc * m + dv * n + 16 + n + 60 + LANES + m
    assert 4 * (table + 4 * words) <= nms_edge.SMEM_LIMIT
    assert nms_edge.kernel_holds(h) and nms_dense.holds(m, n, 8)
