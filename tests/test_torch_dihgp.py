"""The port's penalty and DIHGP algebra against `repro.core` on the CPU,
on numpy inputs handed to both packages.

Tolerance: f32 on both sides with other reduction orders; DIHGP runs U
Neumann iterations whose terms are of order 1, so rtol 1e-5 /
atol 1e-5 (the dense tier's Cholesky solves get rtol 1e-4).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.core import dihgp as jd
from repro.core import penalty as jpen
from repro.core import problems as jp
from repro.topology import make_mixing_op as j_make_mixing_op
from repro.topology import make_network as j_make_network

from repro_torch.core import dihgp as td
from repro_torch.core import penalty as tpen
from repro_torch.core import problems as tp
from repro_torch.topology import make_mixing_op, make_network

BETA = 0.2


def _setup(kind, n=8):
    jprob = jp.quadratic_bilevel(n, 3, 6, seed=2)
    tprob = tp.quadratic_bilevel(n, 3, 6, seed=2, device="cpu")
    rng = np.random.default_rng(7)
    x = (0.5 * rng.standard_normal((n, 3))).astype(np.float32)
    y = (0.5 * rng.standard_normal((n, 6))).astype(np.float32)
    kw = {"r": 0.5, "seed": 0} if kind == "erdos_renyi" else {}
    jW = j_make_mixing_op(j_make_network(kind, n, **kw))
    tW = make_mixing_op(make_network(kind, n, **kw), device="cpu")
    return (jprob, jW, jnp.asarray(x), jnp.asarray(y)), \
        (tprob, tW, torch.as_tensor(x), torch.as_tensor(y))


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("kind", ["ring", "erdos_renyi"])
@pytest.mark.parametrize("U", [0, 3])
def test_dihgp_dense_matches_repro(kind, U):
    (jprob, jW, jx, jy), (tprob, tW, tx, ty) = _setup(kind)
    want = jax.jit(lambda x, y: jd.dihgp_dense(jprob, jW, BETA, x, y, U))(
        jx, jy)
    _close(td.dihgp_dense(tprob, tW, BETA, tx, ty, U), want, rtol=1e-4)


@pytest.mark.parametrize("kind", ["ring", "erdos_renyi"])
@pytest.mark.parametrize("U", [0, 3])
def test_dihgp_matrix_free_matches_repro(kind, U):
    (jprob, jW, jx, jy), (tprob, tW, tx, ty) = _setup(kind)
    curv = np.full((jprob.n,), 6.0, np.float32)

    def jrun(x, y):
        hvp = lambda v: jprob.hvp_yy_g(x, y, v)
        return jd.dihgp_matrix_free(hvp, jprob.grad_y_f(x, y), jW, BETA,
                                    U, curvature=jnp.asarray(curv))
    want = jax.jit(jrun)(jx, jy)
    hvp = lambda v: tprob.hvp_yy_g(tx, ty, v)
    got = td.dihgp_matrix_free(hvp, tprob.grad_y_f(tx, ty), tW, BETA, U,
                               curvature=torch.as_tensor(curv))
    _close(got, want)


def test_dihgp_tiers_approach_the_exact_ihgp():
    """Both tiers converge toward −H⁻¹p with growing U (Lemma 6)."""
    _, (tprob, tW, tx, ty) = _setup("ring")
    exact = tpen.exact_ihgp(tprob, tW, BETA, tx, ty)
    hvp = lambda v: tprob.hvp_yy_g(tx, ty, v)
    p = tprob.grad_y_f(tx, ty)
    errs = [(td.dihgp_dense(tprob, tW, BETA, tx, ty, U) - exact).norm()
            for U in (0, 4, 16)]
    assert errs[0] > errs[1] > errs[2]
    curv = torch.full((tprob.n,), 6.0)
    mf = (td.dihgp_matrix_free(hvp, p, tW, BETA, 200, curvature=curv)
          - exact).norm()
    assert mf < 1e-3 * exact.norm()


def test_curvature_bound_brackets_the_local_spectra():
    """Power iteration from `power_start` bounds each agent's λmax
    (quadratic: spectrum in [1, 5]) within the 1.1 safety factor."""
    _, (tprob, _, tx, ty) = _setup("ring")
    hvp = lambda v: tprob.hvp_yy_g(tx, ty, v)
    c = td.estimate_curvature_bound(hvp, ty.shape, iters=60, device="cpu")
    lam = torch.linalg.eigvalsh(tprob.hess_yy_g(tx, ty))[:, -1]
    assert torch.all(c >= lam * 0.999) and torch.all(c <= 1.1 * lam + 1e-4)
    v0 = td.power_start(ty.shape, "cpu")
    assert torch.equal(v0, td.power_start(ty.shape, "cpu"))
    torch.testing.assert_close(
        td.estimate_curvature_bound(hvp, ty.shape, iters=60, v0=v0), c)


@pytest.mark.parametrize("kind", ["ring", "erdos_renyi"])
def test_penalty_terms_match_repro(kind):
    (jprob, jW, jx, jy), (tprob, tW, tx, ty) = _setup(kind)
    _close(tpen.penalty_quadratic(tW, ty), jpen.penalty_quadratic(jW, jy))
    _close(tpen.grad_y_G(tprob, tW, BETA, tx, ty),
           jax.jit(lambda x, y: jpen.grad_y_G(jprob, jW, BETA, x, y))(jx,
                                                                      jy))
    _close(tpen.inner_dgd_step(tprob, tW, BETA, tx, ty),
           jax.jit(lambda x, y: jpen.inner_dgd_step(jprob, jW, BETA, x,
                                                    y))(jx, jy))
    _close(tpen.penalized_hessian(tprob, tW, BETA, tx, ty),
           jpen.penalized_hessian(jprob, jW, BETA, jx, jy))
    _close(tpen.exact_ihgp(tprob, tW, BETA, tx, ty),
           jpen.exact_ihgp(jprob, jW, BETA, jx, jy), rtol=1e-4)
    _close(tpen.consensus_error(ty), jpen.consensus_error(jy))
