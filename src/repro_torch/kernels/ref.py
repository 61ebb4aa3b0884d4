"""Plain PyTorch versions of the port's CUDA kernels.

Each function computes exactly what its kernel in `csrc/` computes, in
the same order of operations, on any device.  The wrappers in
`repro_torch.kernels.mixing_matvec` run these for CPU tensors; the
tests and `chip_smoke.py` hold the kernels against them on the card.
Counterparts of `repro.kernels.ref`.
"""
from __future__ import annotations

import torch


def circulant_mix_ref(y: torch.Tensor, w_self: float, offsets, weights,
                      laplacian: bool = False) -> torch.Tensor:
    """W·Y (or (I−W)·Y) for circulant W with W[i,(i+o)%n] = c_o; y (n,d).

    acc = w_self·y_i, then + c_o·y_{(i+o) mod n} in offset order, then
    y_i − acc for the Laplacian."""
    acc = w_self * y
    for o, c in zip(offsets, weights):
        acc = acc + c * torch.roll(y, -int(o), dims=0)
    return y - acc if laplacian else acc


def sparse_mix_ref(y: torch.Tensor, w_self: torch.Tensor,
                   row: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
                   laplacian: bool = False) -> torch.Tensor:
    """W·Y (or (I−W)·Y) from CSR triplets — the skewed-degree (star)
    path, O((nnz+n)·d); y (n, d).

    w_self: (n,) diagonal of W; row/col/val: the off-diagonal nonzeros
    (`repro_torch.topology.structure.SparseStructure`)."""
    gathered = y.index_select(0, col) * val.to(y.dtype)[:, None]
    neigh = torch.zeros_like(y).index_add_(0, row, gathered)
    acc = w_self.to(y.dtype)[:, None] * y + neigh
    return y - acc if laplacian else acc


def sparse_mix_padded_ref(y: torch.Tensor, w_self: torch.Tensor,
                          neighbors: torch.Tensor, weights: torch.Tensor,
                          laplacian: bool = False) -> torch.Tensor:
    """Same operator from the padded fixed-degree (n, k) tables,
    O(n·k·d): acc = w_self_i·y_i, then + w_ij·y_{nbr_ij} slot by slot.
    Padded slots hold the row's own index with weight 0."""
    acc = w_self.to(y.dtype)[:, None] * y
    for j in range(neighbors.shape[1]):
        acc = acc + weights[:, j:j + 1].to(y.dtype) \
            * y.index_select(0, neighbors[:, j].long())
    return y - acc if laplacian else acc


def neumann_update(mix, h, hvp_h, p, d_scalar, beta):
    """One DIHGP Neumann iteration given mix = W·h (Eq. 14):

        h⁺ = (D̃h − (h − W h) − β·hvp_h − p) / D̃
    """
    return (d_scalar * h - (h - mix) - beta * hvp_h - p) / d_scalar


def neumann_step_ref(h, hvp_h, p, d_scalar, *, w_self: float, offsets,
                     weights, beta: float) -> torch.Tensor:
    """The fused circulant Neumann step: `neumann_update` over
    `circulant_mix_ref`; d_scalar (n, 1)."""
    mix = circulant_mix_ref(h, w_self, offsets, weights)
    return neumann_update(mix, h, hvp_h, p, d_scalar, beta)
