"""Penalized consensus reformulation (paper Lemma 3 / Eq. (4)).

For stacked variables x ∈ R^{n×d1}, y ∈ R^{n×d2} and mixing matrix W:

    F(x, y̌*(x)) = (1/2α) xᵀ(I−Ẃ)x + 1ᵀ f(x, y̌*(x))          (4a)
    G(x, y)      = (1/2β) yᵀ(I−W)y + 1ᵀ g(x, y)               (4b)

with W⊗I applied to the stacked (n, d) layout through the
`repro_torch.topology` façade, which takes a raw W tensor or a
`MixingOp`.  Counterpart of `repro.core.penalty`.
"""
from __future__ import annotations

import torch

from ..topology.ops import (as_matrix, laplacian_apply, mix_apply,
                            mix_apply_c)
from .problems import BilevelProblem

Tensor = torch.Tensor


def penalty_quadratic(W, z: Tensor) -> Tensor:
    """(1/2) zᵀ((I−W)⊗I)z  for stacked z of shape (n, d)."""
    return 0.5 * torch.sum(z * laplacian_apply(W, z))


def G_objective(prob: BilevelProblem, W, beta: float,
                x: Tensor, y: Tensor) -> Tensor:
    """Penalized inner objective G(x, y) of Eq. (4b)."""
    return penalty_quadratic(W, y) / beta + torch.sum(prob.g_stacked(x, y))


def F_objective(prob: BilevelProblem, W, alpha: float,
                x: Tensor, y: Tensor) -> Tensor:
    """Penalized outer objective F(x, y) of Eq. (4a) evaluated at y."""
    return penalty_quadratic(W, x) / alpha + torch.sum(prob.f_stacked(x, y))


def grad_y_G(prob: BilevelProblem, W, beta: float,
             x: Tensor, y: Tensor) -> Tensor:
    """q = ∇_y G = (1/β)(I−W)y + ∇_y g(x,y)  (stacked (n,d2)); Eq. (16a)."""
    return laplacian_apply(W, y) / beta + prob.grad_y_g(x, y)


def inner_dgd_step(prob: BilevelProblem, W, beta: float,
                   x: Tensor, y: Tensor) -> Tensor:
    """One decentralized GD step on the inner problem, Eq. (15)–(16):
       y⁺ = y − β q = W y − β ∇_y g(x, y).  Neighbor-only communication."""
    return mix_apply(W, y) - beta * prob.grad_y_g(x, y)


def inner_dgd_step_c(prob: BilevelProblem, W, beta: float,
                     x: Tensor, y: Tensor, st):
    """`inner_dgd_step` through the gossip channel: the W·y exchange is
    the only wire crossing.  Returns (y⁺, channel state)."""
    mixed, st = mix_apply_c(W, y, st)
    return mixed - beta * prob.grad_y_g(x, y), st


def penalized_hessian(prob: BilevelProblem, W, beta: float,
                      x: Tensor, y: Tensor) -> Tensor:
    """H = (I−W)⊗I_{d2} + β·blockdiag(∇²_y g_i)  ∈ R^{nd2×nd2}  (Eq. 8).

    Reference tier only (materializes nd2 × nd2)."""
    n, d2 = y.shape
    Wm = as_matrix(W).to(y.dtype)
    eye_n = torch.eye(n, dtype=y.dtype, device=y.device)
    Wl = torch.kron(eye_n - Wm, torch.eye(d2, dtype=y.dtype,
                                          device=y.device))
    Hg = prob.hess_yy_g(x, y)                      # (n, d2, d2)
    return Wl + beta * torch.block_diag(*Hg.unbind(0))


def surrogate_hypergrad(prob: BilevelProblem, W, alpha: float,
                        beta: float, x: Tensor, y: Tensor,
                        h: Tensor) -> Tensor:
    """∇̃F of Eq. (7) given an (approximate) IHGP h  (stacked (n,d1)):

       ∇̃F = (1/α)(I−Ẃ)x + ∇_x f(x,y) + β ∇²_xy g(x,y) · h
    """
    return laplacian_apply(W, x) / alpha + prob.grad_x_f(x, y) \
        + beta * prob.cross_xy_g_times(x, y, h)


def exact_ihgp(prob: BilevelProblem, W, beta: float,
               x: Tensor, y: Tensor) -> Tensor:
    """h = −H^{-1} ∇_y f  (Eq. 8), via dense solve.  Reference tier."""
    n, d2 = y.shape
    H = penalized_hessian(prob, W, beta, x, y)
    p = prob.grad_y_f(x, y).reshape(n * d2)
    return (-torch.linalg.solve(H, p)).reshape(n, d2)


def exact_penalized_inner(prob: BilevelProblem, W, beta: float,
                          x: Tensor, y0: Tensor, iters: int = 2000,
                          v0: Tensor | None = None) -> Tensor:
    """y̌*(x): minimize G(x, ·) to high precision (reference/testing).

    Gradient descent on G with the safe step 1/L_G, L_G ≤ 2/β + c, c a
    power-iteration bound on the local curvature at y0 (30 iterations
    from `v0`, by default `dihgp.power_start`; `repro` starts from its
    own jax.random draw, so pass that vector for the same step)."""
    from .dihgp import estimate_curvature_bound
    hvp = lambda v: prob.hvp_yy_g(x, y0, v)
    c = float(torch.max(estimate_curvature_bound(
        hvp, y0.shape, iters=30, v0=v0, device=y0.device)))
    t = 1.0 / (2.0 / beta + c)
    y = y0
    for _ in range(iters):
        y = y - t * grad_y_G(prob, W, beta, x, y)
    return y


def consensus_error(z: Tensor) -> Tensor:
    """‖z − z̄‖² / n — distance of the stack from its mean (diagnostic)."""
    zbar = torch.mean(z, dim=0, keepdim=True)
    return torch.sum((z - zbar) ** 2) / z.shape[0]
