"""The port's stacked autodiff helpers against `repro.core.problems` on
the CPU, on `quadratic`, `ho_regression` and a narrow
`hyper_representation` (d=20, hidden=40).

Tolerance: f32 autodiff on both sides with other reduction orders,
rtol 1e-5 / atol 1e-5 (values of order 1-10); the MLP's x-gradients sum
over hundreds of hidden-layer products and get rtol 1e-4.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_problems import _close, _iterates, _pair


@pytest.mark.parametrize("family", ["quadratic", "ho_regression",
                                    "hyper_representation"])
def test_stacked_helpers_match_repro(family):
    j, t = _pair(family)
    x, y, v = _iterates(t, seed=1)
    jx, jy, jv = (jnp.asarray(a) for a in (x, y, v))
    tx, ty, tv = (torch.as_tensor(a) for a in (x, y, v))
    rtol = 1e-4 if family == "hyper_representation" else 1e-5
    _close(t.grad_y_g(tx, ty), jax.jit(j.grad_y_g)(jx, jy))
    _close(t.grad_x_f(tx, ty), jax.jit(j.grad_x_f)(jx, jy), rtol=rtol)
    _close(t.grad_y_f(tx, ty), jax.jit(j.grad_y_f)(jx, jy))
    _close(t.hvp_yy_g(tx, ty, tv), jax.jit(j.hvp_yy_g)(jx, jy, jv))
    _close(t.cross_xy_g_times(tx, ty, tv),
           jax.jit(j.cross_xy_g_times)(jx, jy, jv), rtol=rtol)
    _close(t.mean_outer_at(tx[0], ty[0]),
           jax.jit(j.mean_outer_at)(jx[0], jy[0]))
    H = t.hess_yy_g(tx, ty)
    _close(H, jax.jit(j.hess_yy_g)(jx, jy))
    # the HVP is the Hessian applied to v
    _close(t.hvp_yy_g(tx, ty, tv), torch.einsum("nij,nj->ni", H, tv),
           rtol=1e-4)


def test_quadratic_closed_forms_match_repro():
    j, t = _pair("quadratic")
    x, _, _ = _iterates(t, seed=2)
    _close(t.y_star(torch.as_tensor(x)), jax.jit(j.y_star)(jnp.asarray(x)),
           rtol=1e-4)
    _close(t.hypergrad(torch.as_tensor(x[0])),
           jax.jit(j.hypergrad)(jnp.asarray(x[0])), rtol=1e-4)
    # y* is the stationary point of g_i
    ys = t.y_star(torch.as_tensor(x))
    assert t.grad_y_g(torch.as_tensor(x), ys).abs().max() < 1e-4
