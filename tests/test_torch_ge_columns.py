"""The column-owned elimination rule of the GE kernel (``csrc/gf2_ge.cu``),
rehearsed on the CPU: a numpy emulation in which a frame's columns hold
its rows as bits, so a row swap is a swap of two bits inside every column,
the row XOR a conditional column XOR, and the no-pivot column swap an
exchange of two columns and their order entries.  It is held bit for bit
against JAX's packed route (``_reduce_packed``) on the cases of
``test_torch_gf2_bitpack.py`` and on WiMAX's ``h_osd`` with duplicated rows,
rank-deficient at m > 64, so that it reaches the step with neither a pivot
nor a swap column in block mode.  Also: ``ge_plan``'s column layout and the
cache of H packed by columns."""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from short_ldpc_decoding_osd_tpu.codes import get_code as jax_get_code
from short_ldpc_decoding_osd_tpu.ops import gf2_bitpack as jbp
from short_ldpc_decoding_osd_tpu_torch.codes import get_code, tables
from short_ldpc_decoding_osd_tpu_torch.ops import gf2_bitpack
from test_torch_gf2_bitpack import CASES, _permuted

from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

FULL = np.uint64(0xFFFFFFFF)


def _wimax_dup_rows(b, seed):
    """WiMAX h_osd (176 x 1056) with rows 0-5 copied onto rows 120-125."""
    h = jax_get_code("wimax_1056_880").h_osd.copy()
    h[120:126] = h[0:6]
    return _permuted(h, b, seed)


COLUMN_CASES = {**CASES, "wimax_1056_880_osd_dup_rows": lambda: _wimax_dup_rows(3, 8)}


def _lowest_from(col_t, t):
    """(B, mw) uint64 words -> (B,) the lowest set bit index >= t, or -1."""
    b, mw = col_t.shape
    jw, jb = divmod(t, 32)
    keep = np.where(np.arange(mw) < jw, np.uint64(0),
                    np.where(np.arange(mw) == jw, (FULL << np.uint64(jb)) & FULL,
                             FULL))
    x = col_t & keep
    first = np.argmax(x != 0, axis=1)
    word = x[np.arange(b), first]
    low = word & (~word + np.uint64(1))  # the lowest set bit
    bit = np.log2(np.maximum(low, 1).astype(np.float64)).astype(np.int64)
    return np.where(word != 0, 32 * first + bit, -1)


def column_rule(batch, folded=False, deferred=False):
    """The kernel's rule on (B, m, n) 0/1 frames, columns owning rows.

    ``folded``: the row swap folded into the XOR as the kernel runs it
    (``update_column``): with A = column t with bit t flipped (a pivot) or
    cleared (none), a column XORs A where its bit p was set, and bits t and
    p where its bit t was set and p != t.  Returns the reduced (B, m, n)
    int8 matrix, the (B, n) int32 column order and the steps (t, frame)
    with no pivot, split by whether a swap column was found.

    ``deferred``: the swap of columns t and sc at a step with no pivot is
    left to the end, as the kernel does: the step eliminates with column sc
    as column t, which turns column sc into e_t in place of column t; both
    have no bit at rows >= t, so no later step changes or picks them, and
    exchanging them (and their order entries) after the last step, swap by
    swap in step order, gives the same matrix."""
    b, m, n = batch.shape
    mw = -(-m // 32)
    bits = np.zeros((b, n, 32 * mw), np.uint64)
    bits[:, :, :m] = batch.transpose(0, 2, 1)
    shifts = np.arange(32, dtype=np.uint64)
    cols = (bits.reshape(b, n, mw, 32) << shifts).sum(3)  # (B, n, mw)
    order = np.tile(np.arange(n, dtype=np.int32), (b, 1))
    frames = np.arange(b)
    swaps, neither, later = [], [], []
    for t in range(m):
        jw, jb = divmod(t, 32)
        tb = np.uint64(1 << jb)
        col_t = cols[:, t, :].copy()
        p = _lowest_from(col_t, t)
        # no pivot: the lowest column c > t with bit t, its words and order
        # entry exchanged with column t's
        cand = ((cols[:, :, jw] & tb) != 0) & (np.arange(n) > t)
        found = (p < 0) & cand.any(1)
        f, sc = frames[found], np.argmax(cand, 1)[found]
        if deferred:
            later += [(t, f, sc)]
            col_t[f] = cols[f, sc]
        else:
            cols[f, t], cols[f, sc] = cols[f, sc].copy(), cols[f, t].copy()
            order[f, t], order[f, sc] = order[f, sc], order[f, t].copy()
            col_t[f] = cols[f, t]
        swaps += [(t, int(x)) for x in f]
        neither += [(t, int(x)) for x in frames[(p < 0) & ~found]]
        pivot = p >= 0
        p = np.where(pivot, p, t)
        # rows t <-> p: bits t and p swap inside each column; then each
        # column whose new bit t (old bit p) is set XORs column t less bit p
        pmask = np.zeros((b, mw), np.uint64)
        pmask[frames, p // 32] = np.uint64(1) << (p % 32).astype(np.uint64)
        tmask = np.zeros((b, mw), np.uint64)
        tmask[:, jw] = tb
        hp = ((cols & pmask[:, None, :]) != 0).any(2)
        ht = (cols[:, :, jw] & tb) != 0
        if folded:
            a = col_t.copy()
            a[:, jw] = np.where(pivot, a[:, jw] ^ tb, a[:, jw] & ~tb)
            ht &= (p != t)[:, None]
            cols ^= np.where(hp[..., None], a[:, None, :], 0)
            cols ^= np.where(ht[..., None], (tmask ^ pmask)[:, None, :], 0)
            continue
        cols ^= np.where((hp != ht)[..., None], (tmask ^ pmask)[:, None, :], 0)
        cols ^= np.where(hp[..., None], (col_t & ~pmask)[:, None, :], 0)
    for t, f, sc in later:
        cols[f, t], cols[f, sc] = cols[f, sc].copy(), cols[f, t].copy()
        order[f, t], order[f, sc] = order[f, sc], order[f, t].copy()
    rows = np.arange(m)
    red = (cols[:, :, rows // 32] >> (rows % 32).astype(np.uint64)) & 1
    return red.transpose(0, 2, 1).astype(np.int8), order, swaps, neither


@pytest.mark.parametrize("case", list(COLUMN_CASES))
def test_column_rule_matches_jax(case):
    """The column-owned rule, literal and folded, equals JAX's
    ``_reduce_packed`` bit for bit (matrix and column order), and so does
    the port's packed twin."""
    batch = COLUMN_CASES[case]().astype(np.uint8)
    b, m, n = batch.shape
    red, order, swaps, neither = column_rule(batch)
    folded = column_rule(batch, folded=True)
    deferred = column_rule(batch, folded=True, deferred=True)
    order0 = np.broadcast_to(np.arange(n, dtype=np.int32)[:, None], (n, b))
    packed = jbp.pack_columns(jnp.asarray(batch))
    want_mat, want_ord = jbp._reduce_packed(packed, jnp.asarray(order0),
                                            m_steps=m)
    want_red = np.asarray(jbp.unpack_columns(want_mat, n))
    np.testing.assert_array_equal(red, want_red, err_msg="reduced")
    np.testing.assert_array_equal(order, np.asarray(want_ord).T,
                                  err_msg="col_order")
    np.testing.assert_array_equal(folded[0], want_red, err_msg="folded")
    np.testing.assert_array_equal(folded[1], order, err_msg="folded order")
    np.testing.assert_array_equal(deferred[0], want_red, err_msg="deferred")
    np.testing.assert_array_equal(deferred[1], order, err_msg="deferred order")
    got_red, got_ord = gf2_bitpack.batched_row_reduce_bitpack(
        torch.as_tensor(batch))
    np.testing.assert_array_equal(got_red.numpy(), want_red)
    np.testing.assert_array_equal(got_ord.numpy(), np.asarray(want_ord).T)
    if case.endswith("_raw") or "forced" in case or "word_edges" in case:
        assert swaps or neither, case  # the no-pivot path ran
    if case.endswith("_dup_rows"):
        plan = gf2_bitpack.ge_plan(b, m, n)
        assert plan.mode == "block"
        # six duplicated rows: six steps a frame with neither a pivot nor a
        # swap column, all past the warp mode's 64 rows
        assert len(neither) == 6 * b and min(t for t, _ in neither) > 64


@pytest.mark.parametrize("name", ["ccsds_128_64", "qc_96_48", "code1_64_32",
                                  "array_121_60", "array_121_80",
                                  "wimaxlike_384_192", "wimax_1056_880"])
def test_ge_plan_layout_owns_every_column_once(name):
    """Under the plan's layout (thread i of a frame's T owns columns
    i + T s) every column of a frame has one owner slot, column t < m sits
    where the kernel looks for it (lane t & 31, slot t >> 5 in warp mode;
    slot 0 of thread t in block mode), and the words a column hold its m
    rows."""
    code = get_code(name)
    for h in (code.h_osd, code.h):
        m, n = h.shape
        plan = gf2_bitpack.ge_plan(64, m, n)
        per_frame = 32 if plan.mode == "warp" else plan.threads
        owner = {}
        for thr in range(per_frame):
            for s in range(plan.cols):
                c = thr + per_frame * s
                if c < n:
                    assert c not in owner
                    owner[c] = (thr, s)
        assert sorted(owner) == list(range(n))
        for t in range(m):
            want = (t & 31, t >> 5) if plan.mode == "warp" else (t, 0)
            assert owner[t] == want
        assert 32 * plan.words >= m


def test_ge_plan_refuses_columns_beyond_registers():
    """More than 6 columns for each of 256 threads, or more than 256 rows,
    is refused; 6 columns for each of 256 threads is taken."""
    assert gf2_bitpack.ge_plan(4, 64, 1537) is None
    assert gf2_bitpack.ge_plan(4, 257, 300) is None
    plan = gf2_bitpack.ge_plan(4, 64, 1536)
    assert (plan.mode, plan.threads, plan.cols, plan.words) == ("block", 256,
                                                                6, 2)


def test_packed_h_columns_reads_h_once():
    """The GE kernel's packed H is a ``codes.tables`` item: a lookup with an
    H already seen packs and reads nothing of it; a different H of the same
    shape gets its own words, an equal copy equal words of its own."""
    h = jax_get_code("qc_96_48").h.copy()
    first = tables.get(h, gf2_bitpack._packed_h_columns, "cpu")
    with mock.patch.object(gf2_bitpack, "pack_columns",
                           side_effect=AssertionError("H read again")), \
            mock.patch.object(tables, "_Entry",
                              side_effect=AssertionError("H read again")):
        assert tables.get(h, gf2_bitpack._packed_h_columns, "cpu") is first
    other = h[:, ::-1].copy()
    words = tables.get(other, gf2_bitpack._packed_h_columns, "cpu")
    np.testing.assert_array_equal(words.numpy(), first.numpy()[::-1])
    again = tables.get(h.copy(), gf2_bitpack._packed_h_columns, "cpu")
    assert again is not first and torch.equal(again, first)
