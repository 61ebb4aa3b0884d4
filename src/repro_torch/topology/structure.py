"""Structure extraction: what a mixing matrix *is*, execution-wise.

The backends in `repro_torch.topology.ops` never pattern-match on graph
*kinds*; they look only at the numeric structure of W:

  * `circulant_structure` — shift-invariant W (ring, 2k-regular
    circulant): every row is a cyclic shift of row 0, so W·Y is k
    weighted cyclic shifts — no indices needed at all.
  * `sparse_structure` — any W (Erdős–Rényi, star, ...): the
    irregular-graph representation, extracted once at `MixingOp`
    construction in two coupled layouts:

      - true CSR (`rowptr`/`col`/`val` + expanded sorted `row` ids)
        driving the `index_add_` path for skewed degree distributions
        (star), cost O((nnz+n)·d);
      - padded fixed-degree tables (`neighbors`/`weights`, shape
        (n, k_max), rows padded with the row's own index and weight 0)
        driving the per-row gather CUDA kernel on near-regular graphs
        (ER), which needs a rectangular index table, cost O(n·k_max·d).

Both carry the diagonal separately (`w_self`, (n,)) so backends can keep
the *local* term of W·y in full precision while quantizing only the
communicated neighbor values.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CirculantStructure:
    """Shift-invariant W: W[i, (i+o) mod n] = weights[offsets.index(o)],
    W[i, i] = w_self.  Offsets are 0 < o < n (±o pairs appear as o and
    n−o), so k = len(offsets) is the per-agent neighbor count."""
    n: int
    w_self: float
    offsets: tuple[int, ...]
    weights: tuple[float, ...]


def circulant_structure(W, atol: float = 1e-12) -> CirculantStructure | None:
    """Detect shift invariance: returns the structure iff every row of W
    is the cyclic shift of row 0 (ring / 2k-regular circulant graphs
    with any uniform weight scheme), else None."""
    W = np.asarray(W)
    n = W.shape[0]
    if W.ndim != 2 or W.shape != (n, n) or n < 2:
        return None
    c = W[0]
    idx = (np.arange(n)[None, :] - np.arange(n)[:, None]) % n
    if not np.allclose(W, c[idx], atol=atol, rtol=0.0):
        return None
    offsets = tuple(int(o) for o in range(1, n) if abs(c[o]) > atol)
    weights = tuple(float(c[o]) for o in offsets)
    return CirculantStructure(n=n, w_self=float(c[0]), offsets=offsets,
                              weights=weights)


@dataclasses.dataclass(frozen=True, eq=False)
class SparseStructure:
    """CSR view of an arbitrary mixing matrix (off-diagonal part).

    `rowptr`/`col`/`val` is standard CSR over the off-diagonal nonzeros
    (`row` is the expanded, sorted row-id vector `index_add_` wants);
    `neighbors`/`weights` is the same data padded to the maximum degree
    `k` — row i's unused slots hold index i with weight 0, so gathers
    through them are always in-bounds and contribute nothing.
    """
    n: int
    k: int                   # max (padded) neighbor count over rows
    nnz: int                 # off-diagonal nonzeros (2·|E| for symmetric W)
    w_self: np.ndarray       # (n,)   f32 diagonal
    rowptr: np.ndarray       # (n+1,) int32
    col: np.ndarray          # (nnz,) int32
    val: np.ndarray          # (nnz,) f32
    row: np.ndarray          # (nnz,) int32, sorted (expanded rowptr)
    neighbors: np.ndarray    # (n, k) int32, padded with the row index
    weights: np.ndarray      # (n, k) f32,  padded with 0

    @property
    def work_ratio(self) -> float:
        """Dense-matmul MACs / gather-backend MACs = n² / (nnz + n)."""
        return self.n * self.n / float(self.nnz + self.n)


def sparse_structure(W, atol: float = 1e-12) -> SparseStructure | None:
    """Extract the CSR + padded-table structure of any square W.

    Always succeeds on a square matrix with n ≥ 2 (a dense W just yields
    k = n−1); whether the gather backends are *worth it* is the dispatch
    policy's call (`MixingOp`), based on `work_ratio`."""
    W = np.asarray(W)
    n = W.shape[0]
    if W.ndim != 2 or W.shape != (n, n) or n < 2:
        return None
    mask = np.abs(W) > atol
    np.fill_diagonal(mask, False)
    row, col = np.nonzero(mask)                       # row-major ⇒ sorted
    val = W[row, col].astype(np.float32)
    nnz = int(row.size)
    counts = np.bincount(row, minlength=n)
    rowptr = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(counts, out=rowptr[1:])
    k = max(int(counts.max()) if nnz else 0, 1)
    neighbors = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, k))
    weights = np.zeros((n, k), dtype=np.float32)
    slot = np.concatenate([np.arange(c) for c in counts]) if nnz \
        else np.zeros(0, dtype=np.int64)
    neighbors[row, slot] = col.astype(np.int32)
    weights[row, slot] = val
    return SparseStructure(n=n, k=k, nnz=nnz,
                           w_self=np.diag(W).astype(np.float32),
                           rowptr=rowptr, col=col.astype(np.int32),
                           val=val, row=row.astype(np.int32),
                           neighbors=neighbors, weights=weights)
