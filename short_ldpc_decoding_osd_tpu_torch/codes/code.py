"""Linear block code container + registry.

Replaces the reference's ``Code`` class (``fill_matrix_info.py:2-150``) with an
immutable dataclass built at set-up time.  The registry ships the CCSDS
(128,64) code — the headline benchmark code of the reference — as packaged
data (regenerated from the public alist definition), plus programmatically
constructed regular LDPC codes for the multi-code sweep.

A copy of ``short_ldpc_decoding_osd_tpu/codes/code.py`` reading the port's
own ``data/*.npz`` (byte-equal copies of the JAX package's files).
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np

from . import alist as alist_mod
from . import gf2

_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data")


@dataclasses.dataclass(frozen=True)
class Code:
    """Binary linear code defined by a parity-check matrix.

    Attributes:
      name: registry name (e.g. ``ccsds_128_64``)
      h: parity-check matrix, shape (m, n), uint8
      g: systematic-derived generator matrix, shape (k, n), uint8
    """

    name: str
    h: np.ndarray
    g: np.ndarray

    def __post_init__(self):
        # the matrices are static (``codes.tables`` keys them by identity):
        # a read-only copy of each, so that nothing changes them in place
        for field in ("h", "g"):
            object.__setattr__(self, field, _frozen(getattr(self, field)))

    @property
    def n(self) -> int:
        return self.h.shape[1]

    @property
    def m(self) -> int:
        return self.h.shape[0]

    @property
    def k(self) -> int:
        return self.g.shape[0]

    @property
    def rate(self) -> float:
        return self.k / self.n

    @property
    def max_chk_degree(self) -> int:
        return int(self.h.sum(axis=1).max())

    @property
    def max_var_degree(self) -> int:
        return int(self.h.sum(axis=0).max())

    @classmethod
    def from_parity(cls, h: np.ndarray, name: str = "custom") -> "Code":
        h = np.asarray(h, dtype=np.uint8)
        return cls(name=name, h=h, g=gf2.generator_from_parity(h))

    @classmethod
    def from_alist(cls, path: str, name: str | None = None) -> "Code":
        h = alist_mod.load_alist(path)
        return cls.from_parity(h, name or os.path.basename(path))

    def extended(self) -> "Code":
        """ENMS redundant-row extension: append all pairwise row sums of
        weight <= 2*max_chk_degree - 4 (reference ``fill_matrix_info.py:135-150``).

        The generator matrix is unchanged (the extra rows are dependent).
        The same object on every call."""
        return self._extended

    @functools.cached_property
    def _extended(self) -> "Code":
        cap = 2 * self.max_chk_degree - 4
        extra = []
        for i in range(self.m - 1):
            summed = (self.h[i + 1 :] + self.h[i]) % 2
            weights = summed.sum(axis=1)
            extra.append(summed[weights <= cap])
        h_ext = np.concatenate([self.h] + extra, axis=0).astype(np.uint8)
        return dataclasses.replace(self, name=self.name + "_ext", h=h_ext)

    def encode(self, messages: np.ndarray) -> np.ndarray:
        """messages (..., k) -> codewords (..., n), host-side numpy."""
        return (np.asarray(messages, dtype=np.int64) @ self.g.astype(np.int64)) % 2

    @functools.cached_property
    def h_osd(self) -> np.ndarray:
        """Full-rank row basis of H for the fixed-shape OSD elimination.

        Identical to ``h`` for full-rank codes.  For codes whose parity
        matrix carries redundant rows (the packaged array codes), the OSD
        permutation dance must run on a rank-(n-k) basis: the reference's
        per-frame ``gf2elim`` deletes rows that become zero
        (``fill_matrix_info.py:6-41``), and the RREF + column-swap record of
        the basis equals that of the full matrix (both depend only on the
        row space).  NMS decoding and syndrome checks keep the full ``h``
        (redundant checks are legitimate BP constraints)."""
        if self.m == self.n - self.k:
            return self.h
        basis = gf2.row_basis(self.h)
        assert basis.shape[0] == self.n - self.k, (basis.shape, self.k)
        return _frozen(basis)


def _frozen(matrix) -> np.ndarray:
    """A read-only uint8 copy of ``matrix``."""
    out = np.array(matrix, dtype=np.uint8)
    out.setflags(write=False)
    return out


def make_regular_ldpc(
    n: int, m: int, row_weight: int, seed: int = 0, name: str | None = None
) -> Code:
    """Construct a random (near-)regular full-rank LDPC code via column-wise
    placement (Gallager-style).  Used for the (256,128)/(512,256) multi-code
    sweep entries that the reference does not ship alists for."""
    rng = np.random.default_rng(seed)
    col_weight = max(2, (m * row_weight) // n)
    if col_weight % 2 == 0:
        # even column weight forces the rows to sum to zero mod 2 (rank < m)
        col_weight += 1
    for attempt in range(64):
        h = np.zeros((m, n), dtype=np.uint8)
        row_fill = np.zeros(m, dtype=np.int64)
        for col in range(n):
            # pick col_weight least-filled rows with random tie-breaking
            order = np.argsort(row_fill + rng.uniform(0, 0.5, size=m))
            rows = order[:col_weight]
            h[rows, col] = 1
            row_fill[rows] += 1
        if gf2.rank(h) == m:
            try:
                return Code.from_parity(h, name or f"regular_{n}_{n - m}")
            except ValueError:
                pass
    raise RuntimeError(f"failed to build full-rank regular LDPC ({n},{n - m})")


_REGISTRY_BUILDERS = {
    "ccsds_128_64": lambda: _load_packaged("ccsds_128_64"),
    "regular_256_128": lambda: make_regular_ldpc(256, 128, row_weight=8, seed=1),
    "regular_512_256": lambda: make_regular_ldpc(512, 256, row_weight=8, seed=2),
    # the reference's other public code assets (SURVEY.md §2 cross-cutting
    # assets row), packaged as npz like the CCSDS matrix — see data/README.md
    # and scripts/import_reference_codes.py.  array_121_60/_80 carry redundant
    # parity rows (rank 61/41 < m), exercised by the rank-deficient paths.
    "array_121_60": lambda: _load_packaged("array_121_60"),
    "array_121_80": lambda: _load_packaged("array_121_80"),
    "qc_96_48": lambda: _load_packaged("qc_96_48"),
    "code1_64_32": lambda: _load_packaged("code1_64_32"),
    "wimax_1056_880": lambda: _load_packaged("wimax_1056_880"),
    "wimaxlike_384_192": lambda: _load_packaged("wimaxlike_384_192"),
    # programmatic regular codes kept for seeded reproducible sweeps
    "regular_64_32": lambda: make_regular_ldpc(64, 32, row_weight=6, seed=3),
    "regular_96_48": lambda: make_regular_ldpc(96, 48, row_weight=6, seed=4),
    "regular_384_192": lambda: make_regular_ldpc(384, 192, row_weight=8, seed=5),
    "regular_121_60": lambda: make_regular_ldpc(121, 61, row_weight=6, seed=6),
    "regular_1056_880": lambda: make_regular_ldpc(1056, 176, row_weight=18, seed=7),
}
_CACHE: dict[str, Code] = {}


def _load_packaged(name: str) -> Code:
    path = os.path.join(_DATA_DIR, name + ".npz")
    with np.load(path) as blob:
        h = blob["h"].astype(np.uint8)
    return Code.from_parity(h, name)


def get_code(name: str) -> Code:
    """Load a code by registry name, alist path, or npz path."""
    if name in _CACHE:
        return _CACHE[name]
    if name in _REGISTRY_BUILDERS:
        code = _REGISTRY_BUILDERS[name]()
    elif name.endswith(".alist") or name.endswith(".txt"):
        code = Code.from_alist(name)
    elif name.endswith(".npz"):
        with np.load(name) as blob:
            code = Code.from_parity(blob["h"], os.path.basename(name))
    else:
        raise KeyError(
            f"unknown code {name!r}; registry has {sorted(_REGISTRY_BUILDERS)}"
        )
    _CACHE[name] = code
    return code
