"""End to end: `repro_torch.solve` against `repro.solve` on the CPU, on
identical inputs (problem data from the shared numpy generators, x0, y0
and the matrix-free curvature handed to both).

Tolerance: f32 on both sides with other reduction orders, compounded
over K ≤ 10 rounds: iterates and metric trajectories at rtol 1e-4 /
atol 1e-5.  Ledger bytes are integers and must be equal.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.core import problems as jp
from repro.kernels.ops import pallas_mode
from repro.solve import ScheduleSpec as JSchedule
from repro.solve import SolverSpec as JSpec
from repro.solve import solve as jsolve
from repro.topology import make_network as j_make_network

from repro_torch.core import problems as tp
from repro_torch.interop import load_problem
from repro_torch.solve import ScheduleSpec, SolverSpec, solve
from repro_torch.topology import make_network

RTOL, ATOL = 1e-4, 1e-5


def _problems(family, n, d):
    if family == "quadratic":
        return (jp.quadratic_bilevel(n, d, d, seed=1),
                tp.quadratic_bilevel(n, d, d, seed=1, device="cpu"))
    return (jp.ho_regression(n, d, seed=1),
            tp.ho_regression(n, d, seed=1, device="cpu"))


def _run_both(kind, n, family, dihgp, *, d=6, K=10, pallas=False):
    jprob, tprob = _problems(family, n, d)
    kw = dict(K=K, M=5, U=3, dihgp=dihgp, curvature=10.0)
    sched = dict(alpha=0.05, beta=0.05)
    net_kw = {"r": 0.5, "seed": 0} if kind == "erdos_renyi" else {}
    rng = np.random.default_rng(0)
    x0 = (0.1 * rng.standard_normal((n, tprob.d1))).astype(np.float32)
    y0 = (0.1 * rng.standard_normal((n, tprob.d2))).astype(np.float32)
    with pallas_mode(pallas, interpret=True):
        jres = jsolve(jprob, j_make_network(kind, n, **net_kw),
                      JSpec(schedule=JSchedule(**sched), **kw),
                      x0=jnp.asarray(x0), y0=jnp.asarray(y0))
    spec = SolverSpec(schedule=ScheduleSpec(**sched), **kw)
    tres = solve(tprob, make_network(kind, n, **net_kw), spec, x0=x0, y0=y0,
                 device="cpu")
    return jres, tres, spec


def _assert_same_run(jres, tres, spec):
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tres.y.numpy(), np.asarray(jres.y),
                               rtol=RTOL, atol=ATOL)
    assert sorted(tres.metrics) == sorted(jres.metrics)
    for key, val in jres.metrics.items():
        np.testing.assert_allclose(tres.metrics[key].numpy(),
                                   np.asarray(val), rtol=RTOL, atol=ATOL,
                                   err_msg=key)
    assert tres.ledger.total_bytes == jres.ledger.total_bytes
    assert tres.ledger.summary() == jres.ledger.summary()
    preview = spec.comm_ledger(tres.x.shape[1], tres.y.shape[1])
    assert preview.summary()["channels"] == tres.ledger.summary()["channels"]


@pytest.mark.parametrize("kind,n", [("ring", 8), ("erdos_renyi", 16)])
@pytest.mark.parametrize("family", ["quadratic", "ho_regression"])
@pytest.mark.parametrize("dihgp", ["dense", "matrix_free"])
def test_solve_matches_repro(kind, n, family, dihgp):
    _assert_same_run(*_run_both(kind, n, family, dihgp))


def test_solve_matches_repro_through_its_pallas_kernels():
    """The reference side runs `repro`'s Pallas circulant and Neumann
    kernels (interpret mode) at d1 = d2 = 128."""
    _assert_same_run(*_run_both("ring", 8, "quadratic", "matrix_free",
                                d=128, K=4, pallas=True))


def test_solve_runs_repro_data_through_load_problem():
    jprob = jp.ho_regression(8, 5, seed=4)
    tprob = load_problem("ho_regression",
                         {k: np.asarray(v) for k, v in jprob.data.items()},
                         device="cpu")
    spec = dict(K=3, M=2, U=2, dihgp="matrix_free", curvature=5.0)
    y0 = np.full((8, 5), 0.01, np.float32)
    jres = jsolve(jprob, j_make_network("ring", 8), JSpec(**spec),
                  y0=jnp.asarray(y0))
    tspec = SolverSpec(**spec)
    tres = solve(tprob, make_network("ring", 8), tspec,
                 y0=torch.as_tensor(y0), device="cpu")
    _assert_same_run(jres, tres, tspec)
