"""DIHGP — Decentralized Inverse Hessian-Gradient Product (Algorithm 1).

The penalized inner Hessian (Eq. 8)

    H = (I−W)⊗I + β·blockdiag(∇²_y g_i)

is split (Eq. 9) as H = D − B with

    D = β·blockdiag(∇²_y g_i) + 2(I − diag(W))⊗I     (block diagonal, local)
    B = (I − 2·diag(W) + W)⊗I                        (neighbor sparse, PSD)

and the truncated Neumann series obeys the recursion (Eq. 14)

    h_(s+1) = D^{-1}(B h_(s) − p),      D_ii h_(0) = −p_i,

which per node needs only the neighbors' h_j plus a local solve.

Two tiers, as in `repro.core.dihgp`:

* `dihgp_dense`        — Algorithm 1 verbatim: per-agent D_ii factorized
                         by batched Cholesky, exact local solves.
* `dihgp_matrix_free`  — scalar-preconditioned splitting D̃_ii =
                         (β·c_i + 2(1−w_ii))·I with c_i ≥ λmax(∇²_y g_i):
                         every step is one HVP + one fused Neumann step
                         (one CUDA kernel on the circulant tier).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..topology.ops import (as_matrix, fused_neumann_step,
                            fused_neumann_step_c, mix_apply, mix_apply_c)
from .problems import BilevelProblem

Tensor = torch.Tensor


def _expand(v: Tensor, like: Tensor) -> Tensor:
    """(n,) -> (n, 1, ..., 1) broadcastable against `like`."""
    return v.reshape((v.shape[0],) + (1,) * (like.dim() - 1))


def B_apply(W, h: Tensor) -> Tensor:
    """B h = (I − 2 diag(W) + W) ⊗ I applied to stacked h (n, d)."""
    diag_w = _expand(torch.diagonal(as_matrix(W)).to(h.dtype), h)
    return h - 2.0 * diag_w * h + mix_apply(W, h)


def B_apply_c(W, h: Tensor, st):
    """Channel twin of `B_apply`: only the W·h term crosses the wire.
    Returns (B h, channel state)."""
    diag_w = _expand(torch.diagonal(as_matrix(W)).to(h.dtype), h)
    mixed, st = mix_apply_c(W, h, st)
    return h - 2.0 * diag_w * h + mixed, st


def _local_factor(prob: BilevelProblem, W, beta: float, x: Tensor,
                  y: Tensor) -> Tensor:
    """Cholesky factors of D_ii = β∇²_y g_i + 2(1 − w_ii) I, (n,d2,d2)."""
    diag_w = torch.diagonal(as_matrix(W)).to(y.dtype)
    Hg = prob.hess_yy_g(x, y)
    eye = torch.eye(y.shape[1], dtype=y.dtype, device=y.device)
    D = beta * Hg + 2.0 * (1.0 - diag_w)[:, None, None] * eye
    return torch.linalg.cholesky(D)


def _solve(chol: Tensor, b: Tensor) -> Tensor:
    return torch.cholesky_solve(b[..., None], chol)[..., 0]


def dihgp_dense(prob: BilevelProblem, W, beta: float,
                x: Tensor, y: Tensor, U: int) -> Tensor:
    """Algorithm 1: returns h_(U) ∈ R^{n×d2} ≈ −H^{-1}∇_y f(x,y)."""
    chol = _local_factor(prob, W, beta, x, y)
    p = prob.grad_y_f(x, y)                                    # (n,d2)
    h = _solve(chol, -p)                                       # line 4
    for _ in range(U):
        h = _solve(chol, B_apply(W, h) - p)                    # lines 6–8
    return h


def dihgp_dense_c(prob: BilevelProblem, W, beta: float,
                  x: Tensor, y: Tensor, U: int, st):
    """`dihgp_dense` with the per-iteration neighbor exchange routed
    through the gossip channel.  Returns (h_(U), state)."""
    chol = _local_factor(prob, W, beta, x, y)
    p = prob.grad_y_f(x, y)
    h = _solve(chol, -p)
    for _ in range(U):
        b, st = B_apply_c(W, h, st)
        h = _solve(chol, b - p)
    return h, st


def neumann_truncation_error(prob: BilevelProblem, W, beta: float,
                             x: Tensor, y: Tensor, U: int) -> Tensor:
    """‖h_(U) − h_exact‖ — Lemma 6's exponential decay in U (reference
    tier)."""
    from .penalty import exact_ihgp
    return torch.linalg.norm(dihgp_dense(prob, W, beta, x, y, U)
                             - exact_ihgp(prob, W, beta, x, y))


def dihgp_comm_vectors(U: int) -> int:
    """Vector exchanges per agent per DIHGP call (Appendix S1: U rounds)."""
    return U


# ---------------------------------------------------------------------------
# Matrix-free tier
# ---------------------------------------------------------------------------

def power_start(shape, device, seed: int = 0) -> Tensor:
    """Start vector of `estimate_curvature_bound`: N(0, I) from a CPU
    `torch.Generator` seeded with `seed`, moved to `device` — the same
    numbers on every device."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(tuple(shape), generator=gen).to(device)


def estimate_curvature_bound(hvp: Callable[[Tensor], Tensor], shape,
                             iters: int = 12, safety: float = 1.1,
                             v0: Tensor | None = None,
                             device=None) -> Tensor:
    """Per-agent power iteration on the stacked HVP to bound λmax(∇²g_i).

    `hvp` maps stacked (n, d2) → stacked (n, d2), applying each agent's
    local Hessian to its slice, so power iteration on the stack
    converges to each block's top eigenvalue independently.  `v0` is
    the start vector (default `power_start(shape, device)`)."""
    v = power_start(shape, device) if v0 is None else v0
    for _ in range(iters):
        w = hvp(v)
        nrm = torch.sqrt(torch.sum(w.reshape(w.shape[0], -1) ** 2, -1))
        v = w / _expand(torch.clamp(nrm, min=1e-20), w)
    w = hvp(v)
    lam = torch.sum((v * w).reshape(v.shape[0], -1), -1)
    return safety * torch.abs(lam)                              # (n,)


def _d_scalar(W, p: Tensor, beta: float, curvature: Tensor) -> Tensor:
    """D̃_ii = β·c_i + 2(1 − w_ii), expanded against p."""
    diag_w = torch.diagonal(as_matrix(W)).to(p.dtype)
    return _expand(beta * curvature + 2.0 * (1.0 - diag_w), p)


def dihgp_matrix_free(hvp: Callable[[Tensor], Tensor], p: Tensor, W,
                      beta: float, U: int, curvature: Tensor | None = None,
                      v0: Tensor | None = None) -> Tensor:
    """Scalar-preconditioned DIHGP: h_(U) ≈ −H^{-1} p with HVPs only.

    Splitting H = D̃ − B̃,  D̃ = (β c + 2(1−w_ii))·I (per agent scalars);
    each iteration is one HVP plus one `fused_neumann_step`.

    Args:
      hvp:        stacked block-diagonal HVP of the unpenalized inner
                  objective, v ↦ (∇²_y g_i v_i)_i.
      p:          stacked ∇_y f(x, y), shape (n, d2).
      W:          raw mixing matrix or MixingOp.
      curvature:  optional (n,) per-agent λmax bounds; estimated by
                  power iteration from `v0` if None.
    """
    if curvature is None:
        curvature = estimate_curvature_bound(hvp, p.shape, v0=v0,
                                             device=p.device)
    d_scalar = _d_scalar(W, p, beta, curvature)
    h = -p / d_scalar                                             # line 4
    for _ in range(U):
        h = fused_neumann_step(W, h, hvp(h), p, d_scalar, beta)
    return h


def dihgp_matrix_free_c(hvp: Callable[[Tensor], Tensor], p: Tensor, W,
                        beta: float, U: int, st,
                        curvature: Tensor | None = None,
                        v0: Tensor | None = None):
    """`dihgp_matrix_free` with the per-iteration W·h exchange routed
    through the gossip channel.  Returns (h_(U), state)."""
    if curvature is None:
        curvature = estimate_curvature_bound(hvp, p.shape, v0=v0,
                                             device=p.device)
    d_scalar = _d_scalar(W, p, beta, curvature)
    h = -p / d_scalar
    for _ in range(U):
        h, st = fused_neumann_step_c(W, h, hvp(h), p, d_scalar, beta, st)
    return h, st
