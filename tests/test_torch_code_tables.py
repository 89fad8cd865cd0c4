"""``codes.tables``, the holder of a code's static device tables, and the
static matrices of ``Code``: each table is built once per matrix and
device, whatever calls read it; a lookup reads nothing of the matrix; the
holder keeps the matrices used last; ``Code``'s matrices are read-only and
its ENMS extension one object."""

import numpy as np
import pytest
import torch

from short_ldpc_decoding_osd_tpu_torch.codes import Code, get_code, tables
from short_ldpc_decoding_osd_tpu_torch.ops import nms, nms_edge
from short_ldpc_decoding_osd_tpu_torch.osd import engine

from torch_threads import one_intra_op_thread  # noqa: F401  (autouse)


def _counting(monkeypatch, module, name, built):
    real = getattr(module, name)

    def build(host, device):
        built.append((name, host.shape, device))
        return real(host, device)

    monkeypatch.setattr(module, name, build)


def test_a_table_is_built_once_per_matrix_and_device(monkeypatch):
    """Two ``frame_stats`` calls, two K1 (twin) calls and a ``prepare``
    build H as f32, K1's edge tables and ``h_osd`` as int8 once each; the
    same H on another device is built again there."""
    code = Code.from_parity(get_code("qc_96_48").h, "fresh")  # nothing held
    built = []
    for module, name in ((tables, "_f32"), (tables, "_int8"),
                         (nms_edge, "_edge_tables")):
        _counting(monkeypatch, module, name, built)
    rng = np.random.default_rng(1)
    llr = torch.as_tensor(rng.normal(1.0, 0.8, (8, code.n)).astype(np.float32))
    words = torch.zeros((8, code.n), dtype=torch.int32)
    params = nms.init_params("NMS-1")
    for _ in range(2):
        soft = nms_edge.decode_final_edge(params, code.h, llr, 3)
        nms.frame_stats(soft, words, code.h)
    engine.prepare(llr, llr, words, code.h_osd, code.k)
    assert code.h_osd is code.h  # full rank: the same matrix
    assert sorted(built) == sorted([("_f32", code.h.shape, torch.device("cpu")),
                                    ("_int8", code.h.shape, torch.device("cpu")),
                                    ("_edge_tables", code.h.shape,
                                     torch.device("cpu"))])
    meta = tables.f32(code.h, "meta")
    assert meta.device.type == "meta" and len(built) == 4
    assert tables.f32(code.h, "cpu") is tables.f32(code.h, torch.device("cpu"))
    assert len(built) == 4


def test_a_lookup_reads_nothing_of_the_matrix(monkeypatch):
    """A second lookup builds nothing, makes no entry, copies nothing to a
    tensor and reads nothing of the array."""
    h = Code.from_parity(get_code("ccsds_128_64").h, "fresh").h
    built = []
    _counting(monkeypatch, tables, "_f32", built)
    _counting(monkeypatch, tables, "_degrees", built)
    first = tables.f32(h, "cpu")
    assert tables.degrees(h) == (8, 5) and len(built) == 2

    def forbidden(*args, **kwargs):
        raise AssertionError("the matrix was read again")

    monkeypatch.setattr(tables, "_Entry", forbidden)
    monkeypatch.setattr(torch, "tensor", forbidden)
    monkeypatch.setattr(np, "asarray", forbidden)
    assert tables.f32(h, "cpu") is first
    assert tables.degrees(h) == (8, 5) and len(built) == 2


def test_the_holder_keeps_the_matrices_used_last():
    keep = get_code("ccsds_128_64").h
    first = tables.f32(keep, "cpu")
    rng = np.random.default_rng(2)
    others = [rng.integers(0, 2, (4, 8)) for _ in range(tables.MAX_MATRICES)]
    for i, other in enumerate(others):
        if i % 4 == 0:
            assert tables.f32(keep, "cpu") is first  # used again: kept
        np.testing.assert_array_equal(tables.f32(other, "cpu").numpy(), other)
    assert len(tables._ENTRIES) == tables.MAX_MATRICES
    assert id(others[0]) not in tables._ENTRIES  # the oldest went
    assert tables.f32(keep, "cpu") is first
    # a tensor's entry holds the tensor and reads it once
    t = torch.as_tensor(others[-1], dtype=torch.float32)
    assert tables.degrees(t) == tuple(
        int(x) for x in (others[-1].sum(1).max(), others[-1].sum(0).max()))
    assert tables._ENTRIES[id(t)].matrix is t


@pytest.mark.parametrize("name", ["ccsds_128_64", "array_121_60"])
def test_code_matrices_are_static(name):
    """``h``, ``g`` and ``h_osd`` are read-only copies, and ``extended()``
    returns one object, so the holder's keys hold for ENMS too."""
    source = get_code(name).h.copy()
    code = Code.from_parity(source, name)
    assert code.h is not source and np.array_equal(code.h, source)
    for matrix in (code.h, code.g, code.h_osd, code.extended().h):
        assert not matrix.flags.writeable
        with pytest.raises(ValueError):
            matrix[0, 0] = 1
    source[0, 0] ^= 1  # the caller's array stays the caller's
    assert code.h[0, 0] != source[0, 0]
    assert code.extended() is code.extended()
    assert code.extended().h is code.extended().h
