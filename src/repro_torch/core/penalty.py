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


def exact_ihgp(prob: BilevelProblem, W, beta: float,
               x: Tensor, y: Tensor) -> Tensor:
    """h = −H^{-1} ∇_y f  (Eq. 8), via dense solve.  Reference tier."""
    n, d2 = y.shape
    H = penalized_hessian(prob, W, beta, x, y)
    p = prob.grad_y_f(x, y).reshape(n * d2)
    return (-torch.linalg.solve(H, p)).reshape(n, d2)


def consensus_error(z: Tensor) -> Tensor:
    """‖z − z̄‖² / n — distance of the stack from its mean (diagnostic)."""
    zbar = torch.mean(z, dim=0, keepdim=True)
    return torch.sum((z - zbar) ** 2) / z.shape[0]
