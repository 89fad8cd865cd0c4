"""The static tables of a code's matrices: one holder for what the kernels
and their plain twins read of a parity or generator matrix.

A code's matrix is static: built once at set-up (``Code`` makes its ``h``,
``g`` and ``h_osd`` read-only) and never changed after its first use.  The
holder keys each matrix by the object itself, not by its contents, so a
lookup on the hot path reads nothing of the matrix, copies nothing from
the host and waits for nothing on the device.  Its entry holds the matrix,
so that no other object can take the matrix's id while the entry lives; a
matrix changed in place after its first use is not read again.  The holder
keeps the :data:`MAX_MATRICES` matrices used last.

Every item derived from a matrix is built by a function ``build(host,
device)`` of the matrix as host uint8 0/1 numpy (read-only), on the first
:func:`get` with that function and device, and kept for the next: the
matrix as f32 or int8 on a device, its degrees and rank (``device`` None:
a host item), the kernels' edge tables and the split bucket's lane map
and lane count (``ops.nms_edge``), the padded layout's tables
(``ops.nms_edge_padded``), H packed by columns for the GE kernel
(``ops.gf2_bitpack``), G's encode tables (``ops.nms_edge``: its columns by
kind and its parity columns word-major) and the neighbourhood table
(``models.extras``).  A kernel's own build functions live beside its
wrapper; the items several wrappers read are here.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from . import gf2

MAX_MATRICES = 32

_ENTRIES: collections.OrderedDict = collections.OrderedDict()


class _Entry:
    """One matrix (held, so that its id stays its own), its host copy and
    the items built from it, keyed by (build function, device)."""

    __slots__ = ("matrix", "host", "items")

    def __init__(self, matrix):
        if isinstance(matrix, torch.Tensor):
            host = matrix.detach().cpu().numpy()
        else:
            host = np.asarray(matrix)
        self.matrix = matrix
        self.host = np.ascontiguousarray(host != 0, dtype=np.uint8)
        self.host.setflags(write=False)
        self.items = {}


def get(matrix, build, device=None):
    """``build(host, device)`` of the static ``matrix`` (numpy or a
    tensor), built at the first call with this ``build`` and ``device`` and
    returned as it is after that."""
    key = id(matrix)
    entry = _ENTRIES.get(key)
    if entry is None:
        entry = _ENTRIES[key] = _Entry(matrix)
        if len(_ENTRIES) > MAX_MATRICES:
            _ENTRIES.popitem(last=False)
    else:
        _ENTRIES.move_to_end(key)
    if device is not None:
        device = torch.device(device)
    item = entry.items.get((build, device))
    if item is None:
        item = entry.items[(build, device)] = build(entry.host, device)
    return item


def _f32(host, device):
    return torch.tensor(host, dtype=torch.float32, device=device)


def _int8(host, device):
    return torch.tensor(host.view(np.int8), device=device)


def _degrees(host, device):
    del device
    return int(host.sum(axis=1).max()), int(host.sum(axis=0).max())


def _rank(host, device):
    del device
    return gf2.rank(host)


def f32(matrix, device) -> torch.Tensor:
    """The matrix as f32 on ``device``; a tensor is taken as it is (moved
    and cast where it must be)."""
    if isinstance(matrix, torch.Tensor):
        return matrix.to(device=device, dtype=torch.float32)
    return get(matrix, _f32, device)


def int8(matrix, device) -> torch.Tensor:
    """The matrix as int8 0/1 on ``device``; a tensor as :func:`f32`."""
    if isinstance(matrix, torch.Tensor):
        return matrix.to(device=device, dtype=torch.int8)
    return get(matrix, _int8, device)


def degrees(matrix) -> tuple[int, int]:
    """(largest row weight, largest column weight), host ints."""
    return get(matrix, _degrees)


def rank(matrix) -> int:
    """The matrix's GF(2) rank."""
    return get(matrix, _rank)
