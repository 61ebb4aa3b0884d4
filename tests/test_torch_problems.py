"""The port's problem zoo against `repro.core.problems` on the CPU.

Data: the numpy generators are `repro`'s, so the same seed must give
exactly the same arrays.  Objectives and gradients: f32 on both sides
with other reduction orders, compared at rtol 1e-5 / atol 1e-5 (values
of order 1-10).  The stacked autodiff helpers are held against `repro`
in test_torch_problem_helpers.py.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.core import problems as jp

from repro_torch.core import problems as tp
from repro_torch.interop import load_problem

FAMILY_ARGS = {
    "quadratic": ((6, 4, 5), {}),
    "ho_regression": ((6, 7), {}),
    "ho_logistic": ((6, 7), {}),
    "ho_svm": ((6, 7), {}),
    "ho_softmax": ((6, 5), {"n_classes": 3}),
    "hyper_representation": ((4,), {"d": 20, "hidden": 40}),
    "fair_loss_tuning": ((6,), {"d": 5, "n_classes": 4}),
}
# family settings `load_problem` needs beside the data arrays
BUILD_KWARGS = {
    "quadratic": {"mu_g": 1.0, "mu_f": 0.1},
    "ho_softmax": {"n_classes": 3},
    "hyper_representation": {"hidden": 40, "n_classes": 10},
    "fair_loss_tuning": {"n_classes": 4},
}


def _pair(family, seed=0):
    args, kw = FAMILY_ARGS[family]
    j = jp.PROBLEM_FAMILIES[family](*args, seed=seed, **kw)
    t = tp.PROBLEM_FAMILIES[family](*args, seed=seed, device="cpu", **kw)
    return j, t


def _iterates(prob, seed=0, scale=0.3):
    rng = np.random.default_rng(seed)
    return tuple((scale * rng.standard_normal((prob.n, d))).astype(
        np.float32) for d in (prob.d1, prob.d2, prob.d2))


def _close(got: torch.Tensor, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("family", sorted(FAMILY_ARGS))
def test_same_seed_same_data(family):
    j, t = _pair(family, seed=3)
    assert (j.name, j.n, j.d1, j.d2, j.mu_g) == (t.name, t.n, t.d1, t.d2,
                                                 t.mu_g)
    assert sorted(j.data) == sorted(t.data)
    for key in j.data:
        np.testing.assert_array_equal(np.asarray(j.data[key]),
                                      t.data[key].numpy())
    x, y, _ = _iterates(t)
    _close(t.f_stacked(torch.as_tensor(x), torch.as_tensor(y)),
           jax.jit(j.f_stacked)(jnp.asarray(x), jnp.asarray(y)))
    _close(t.g_stacked(torch.as_tensor(x), torch.as_tensor(y)),
           jax.jit(j.g_stacked)(jnp.asarray(x), jnp.asarray(y)))


@pytest.mark.parametrize("family", sorted(FAMILY_ARGS))
def test_load_problem_carries_repro_data_across(family):
    j, t = _pair(family, seed=5)
    data = {k: np.asarray(v) for k, v in j.data.items()}
    u = load_problem(family, data, device="cpu",
                     **BUILD_KWARGS.get(family, {}))
    assert (u.name, u.n, u.d1, u.d2) == (j.name, j.n, j.d1, j.d2)
    x, y, _ = _iterates(u, seed=4)
    _close(u.g_stacked(torch.as_tensor(x), torch.as_tensor(y)),
           jax.jit(j.g_stacked)(jnp.asarray(x), jnp.asarray(y)))
    _close(u.grad_y_g(torch.as_tensor(x), torch.as_tensor(y)),
           jax.jit(j.grad_y_g)(jnp.asarray(x), jnp.asarray(y)))


def test_problem_constructors_need_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.ho_regression(4, 3)
    with pytest.raises(KeyError, match="unknown problem family"):
        load_problem("lasso", {}, device="cpu")
