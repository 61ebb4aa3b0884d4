"""The paper's metrics and analysis helpers in the port against `repro`
on the CPU, on numpy inputs handed to both packages: the §6.2 and §6.3
accuracies (`hyperrep_accuracy`, `balanced_accuracy`), the penalized
objectives and their exact solutions (`G_objective`, `F_objective`,
`surrogate_hypergrad`, `exact_penalized_inner`), Lemma 6's decay in U
(`neumann_truncation_error`), and the byte and vector counts
(`dagm_comm_bytes`, `dihgp_comm_vectors`).

Tolerance: the accuracies are counts of argmax hits, equal exactly; the
objectives are f32 sums of O(1) terms in other orders, rtol 1e-5 /
atol 1e-5 (the dense solves of `exact_ihgp` and the truncation error,
rtol 1e-4).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.core import dagm as jdagm
from repro.core import dihgp as jd
from repro.core import penalty as jpen
from repro.core import problems as jp
from repro.solve import CommSpec as JComm
from repro.solve import SolverSpec as JSpec
from repro.topology import make_mixing_op as j_make_mixing_op
from repro.topology import make_network as j_make_network

from repro_torch.core import dagm as tdagm
from repro_torch.core import dihgp as td
from repro_torch.core import penalty as tpen
from repro_torch.core import problems as tp
from repro_torch.solve import CommSpec, SolverSpec
from repro_torch.topology import make_mixing_op, make_network

BETA, ALPHA = 0.3, 0.2


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _networks(kind, n):
    kw = {"r": 0.5, "seed": 2} if kind == "erdos_renyi" else {}
    return j_make_network(kind, n, **kw), make_network(kind, n, **kw)


def _draw(rng, n, d, scale):
    return (scale * rng.standard_normal((n, d))).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hyperrep_accuracy_equals_repro(seed):
    kw = dict(d=8, hidden=6, n_classes=4, m_per=24, seed=seed)
    jprob = jp.hyper_representation(4, **kw)
    tprob = tp.hyper_representation(4, device="cpu", **kw)
    rng = np.random.default_rng(seed + 10)
    x = _draw(rng, 4, tprob.d1, 0.5)
    y = _draw(rng, 4, tprob.d2, 0.5)
    want = jp.hyperrep_accuracy(jprob, jnp.asarray(x), jnp.asarray(y))
    got = tp.hyperrep_accuracy(tprob, torch.as_tensor(x),
                               torch.as_tensor(y))
    assert isinstance(got, float)
    assert got == want
    assert 0.0 < got < 1.0


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("q", [0.0, 0.8])
def test_balanced_accuracy_equals_repro(seed, q):
    kw = dict(d=6, n_classes=5, m_per=30, q=q, seed=seed)
    jprob = jp.fair_loss_tuning(4, **kw)
    tprob = tp.fair_loss_tuning(4, device="cpu", **kw)
    y = _draw(np.random.default_rng(seed + 20), 4, tprob.d2, 1.0)
    want = jp.balanced_accuracy(jprob, jnp.asarray(y))
    got = tp.balanced_accuracy(tprob, torch.as_tensor(y))
    assert isinstance(got, float)
    assert got == want


@pytest.fixture(scope="module", params=["ring", "erdos_renyi"])
def quad(request):
    n = 8
    jnet, tnet = _networks(request.param, n)
    jprob = jp.quadratic_bilevel(n, 3, 5, seed=0)
    tprob = tp.quadratic_bilevel(n, 3, 5, seed=0, device="cpu")
    rng = np.random.default_rng(4)
    x, y, h = _draw(rng, n, 3, 0.5), _draw(rng, n, 5, 0.5), \
        _draw(rng, n, 5, 0.5)
    return dict(jprob=jprob, tprob=tprob, jnet=jnet, tnet=tnet,
                jW=j_make_mixing_op(jnet),
                tW=make_mixing_op(tnet, device="cpu"), x=x, y=y, h=h)


def _args(q, side):
    if side == "j":
        return q["jprob"], q["jW"], jnp.asarray(q["x"]), jnp.asarray(q["y"])
    return q["tprob"], q["tW"], torch.as_tensor(q["x"]), \
        torch.as_tensor(q["y"])


def test_penalized_objectives_match_repro(quad):
    jprob, jW, jx, jy = _args(quad, "j")
    tprob, tW, tx, ty = _args(quad, "t")
    _close(tpen.G_objective(tprob, tW, BETA, tx, ty),
           jpen.G_objective(jprob, jW, BETA, jx, jy))
    _close(tpen.F_objective(tprob, tW, ALPHA, tx, ty),
           jpen.F_objective(jprob, jW, ALPHA, jx, jy))
    # with the raw W matrix instead of the MixingOp
    _close(tpen.G_objective(tprob, torch.as_tensor(quad["tnet"].W,
                                                   dtype=torch.float32),
                            BETA, tx, ty),
           jpen.G_objective(jprob, jW, BETA, jx, jy))


def test_surrogate_hypergrad_matches_repro(quad):
    jprob, jW, jx, jy = _args(quad, "j")
    tprob, tW, tx, ty = _args(quad, "t")
    want = jpen.surrogate_hypergrad(jprob, jW, ALPHA, BETA, jx, jy,
                                    jnp.asarray(quad["h"]))
    got = tpen.surrogate_hypergrad(tprob, tW, ALPHA, BETA, tx, ty,
                                   torch.as_tensor(quad["h"]))
    assert got.shape == (8, 3)
    _close(got, want)


def test_exact_penalized_inner_matches_repro(quad):
    """Both start the step's power iteration from `repro`'s jax.random
    vector, so the step is the same; y̌*(x) is then ∇_y G's zero."""
    jprob, jW, jx, jy = _args(quad, "j")
    tprob, tW, tx, ty = _args(quad, "t")
    v0 = np.array(jax.random.normal(jax.random.PRNGKey(0), jy.shape,
                                      jnp.float32))
    want = jpen.exact_penalized_inner(jprob, jW, BETA, jx, jy, iters=400)
    got = tpen.exact_penalized_inner(tprob, tW, BETA, tx, ty, iters=400,
                                     v0=torch.as_tensor(v0))
    _close(got, want, rtol=1e-4)
    # at the minimiser the gradient of G is (nearly) zero
    grad = tpen.grad_y_G(tprob, tW, BETA, tx, got)
    assert float(grad.abs().max()) < 1e-3
    # the default start vector converges to the same minimiser
    other = tpen.exact_penalized_inner(tprob, tW, BETA, tx, ty, iters=400)
    _close(other, want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("U", [0, 2, 4, 8, 16])
def test_neumann_truncation_error_matches_repro(quad, U):
    jprob, jW, jx, jy = _args(quad, "j")
    tprob, tW, tx, ty = _args(quad, "t")
    want = jd.neumann_truncation_error(jprob, jW, BETA, jx, jy, U)
    got = td.neumann_truncation_error(tprob, tW, BETA, tx, ty, U)
    _close(got, want, rtol=1e-3, atol=1e-6)


def test_neumann_truncation_error_decays_exponentially(quad):
    """Lemma 6: ‖h_(U) − h*‖ ≤ C·ρ^{U+1}, so the error falls by a
    roughly constant ratio per step of U."""
    tprob, tW, tx, ty = _args(quad, "t")
    errs = [float(td.neumann_truncation_error(tprob, tW, BETA, tx, ty, U))
            for U in (0, 4, 8, 16)]
    assert all(a > b for a, b in zip(errs, errs[1:]))
    assert max(b / a for a, b in zip(errs, errs[1:])) < 0.5
    assert errs[-1] < 1e-2 * errs[0]


@pytest.mark.parametrize("U", [0, 3, 7])
def test_dihgp_comm_vectors(U):
    assert td.dihgp_comm_vectors(U) == jd.dihgp_comm_vectors(U) == U


@pytest.mark.parametrize("comm", ["identity", "bf16", "int8", "int8+ef",
                                  "int4", "top_k:0.25+ef"])
@pytest.mark.parametrize("kind", ["ring", "erdos_renyi", "star"])
@pytest.mark.parametrize("bytes_per", [4, 2])
def test_dagm_comm_bytes_equals_repro(comm, kind, bytes_per):
    jnet, tnet = _networks(kind, 10)
    kw = dict(K=7, M=4, U=3)
    want = jdagm.dagm_comm_bytes(JSpec(comm=JComm(spec=comm), **kw), jnet,
                                 157, 21, bytes_per=bytes_per)
    got = tdagm.dagm_comm_bytes(SolverSpec(comm=CommSpec(spec=comm), **kw),
                                tnet, 157, 21, bytes_per=bytes_per)
    assert isinstance(got, int)
    assert got == int(want)
    if comm == "identity":
        assert got == (7 * (4 * 21 + 3 * 21 + 157) * bytes_per
                       * 2 * tnet.num_edges)


def test_dagm_comm_bytes_exact_dihgp_sends_no_h():
    jnet, tnet = _networks("ring", 6)
    kw = dict(K=3, M=2, U=5, dihgp="exact")
    want = jdagm.dagm_comm_bytes(JSpec(**kw), jnet, 11, 4)
    assert tdagm.dagm_comm_bytes(SolverSpec(**kw), tnet, 11, 4) == want \
        == 3 * (2 * 4 + 11) * 4 * 2 * 6
