"""The paper's baselines in the port (`repro_torch.core.baselines`,
behind `repro_torch.solve.solve(method=...)`) against `repro` on the CPU.

Identical numpy problem data and explicit x0/y0 go through both
packages; final x and y and every per-round metric agree within rtol
1e-4 / atol 1e-5 (f32 rounding in the autodiff terms and the batched
solves, compounded over K rounds), the measured ledger and the
Appendix-S1 closed form exactly.  The compressed runs (int8+ef) hand
the port `repro`'s per-send seeds, as test_torch_comm_solve.py does:
`repro` runs under `pallas_mode(True)` with every width a multiple of
128 and n a multiple of 8, so it fuses every gossip and both packages
quantize with the same hash uniforms.
"""
from __future__ import annotations


import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.core import problems as jp
from repro.kernels.ops import pallas_mode
from repro.solve import CommSpec as JCommSpec
from repro.solve import ScheduleSpec as JSchedule
from repro.solve import SolverSpec as JSpec
from repro.solve import solve as jsolve
from repro.topology import make_network as j_make_network
from test_torch_comm_solve import _repro_send_seeds

from repro_torch.core import problems as tp
from repro_torch.solve import CommSpec, ScheduleSpec, SolverSpec, solve
from repro_torch.topology import MixingOp, make_network

RTOL, ATOL = 1e-4, 1e-5
METHODS = ["dgbo", "dgtbo", "fednest", "ma_dbo"]
GRAPHS = [("ring", 8, {}), ("erdos_renyi", 16, {"r": 0.5, "seed": 0})]
PROBLEMS = {
    "quadratic": (lambda n, pkg, **kw: pkg.quadratic_bilevel(
        n, 6, 5, seed=1, **kw), 6, 5),
    "ho_regression": (lambda n, pkg, **kw: pkg.ho_regression(
        n, 5, m_per=12, seed=2, **kw), 5, 5),
}
HP = dict(K=4, M=3, U=2, b=2, N=3)


def _data(shape, seed, scale=0.1):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _assert_same_run(tres, jres):
    for got, want in ((tres.x, jres.x), (tres.y, jres.y)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)
    assert set(tres.metrics) == set(jres.metrics)
    for key, val in jres.metrics.items():
        np.testing.assert_allclose(tres.metrics[key].numpy(),
                                   np.asarray(val), rtol=RTOL, atol=ATOL,
                                   err_msg=key)
    assert tres.ledger.summary() == jres.ledger.summary()
    assert tres.extras == jres.extras


@pytest.mark.parametrize("problem", list(PROBLEMS))
@pytest.mark.parametrize("kind,n,net_kw", GRAPHS)
@pytest.mark.parametrize("method", METHODS)
def test_baseline_matches_repro(method, kind, n, net_kw, problem):
    make, d1, d2 = PROBLEMS[problem]
    x0, y0 = _data((n, d1), 0), _data((n, d2), 1)
    sched = dict(alpha=0.05, beta=0.1)
    jres = jsolve(make(n, jp), j_make_network(kind, n, **net_kw),
                  JSpec(method=method, schedule=JSchedule(**sched), **HP),
                  x0=jnp.asarray(x0), y0=jnp.asarray(y0), seed=0)
    tres = solve(make(n, tp, device="cpu"), make_network(kind, n, **net_kw),
                 SolverSpec(method=method, schedule=ScheduleSpec(**sched),
                            **HP), x0=x0, y0=y0, seed=0, device="cpu")
    assert tres.method == method and tres.tier == "reference"
    assert (tres.channels is None) == (method == "fednest")
    _assert_same_run(tres, jres)


@pytest.mark.parametrize("kind,n,net_kw", GRAPHS)
@pytest.mark.parametrize("method", ["dgbo", "ma_dbo"])
def test_compressed_baseline_matches_repro_with_its_seeds(
        method, kind, n, net_kw, monkeypatch):
    K, M, U, b = 2, 2, 2, 2
    d1 = d2 = 128
    x0, y0 = _data((n, d1), 0), _data((n, d2), 1)
    kw = dict(method=method, K=K, M=M, U=U, b=b)
    sched = dict(alpha=0.05, beta=0.1)
    with pallas_mode(True, interpret=True):
        jres = jsolve(jp.quadratic_bilevel(n, d1, d2, seed=1),
                      j_make_network(kind, n, **net_kw),
                      JSpec(schedule=JSchedule(**sched),
                            comm=JCommSpec("int8+ef"), **kw),
                      x0=jnp.asarray(x0), y0=jnp.asarray(y0), seed=0)
    sends = {"dgbo": {"inner_y": K * M, "hess_nu": K * b, "outer_x": K},
             "ma_dbo": {"inner_y": K * M, "dihgp_h": K * U, "lap_x": K,
                        "tracker_v": K}}[method]
    seeds = _repro_send_seeds(0, sends)
    monkeypatch.setattr(MixingOp, "_next_seed",
                        lambda self, st: seeds[st.name][st.sends])
    tres = solve(tp.quadratic_bilevel(n, d1, d2, seed=1, device="cpu"),
                 make_network(kind, n, **net_kw),
                 SolverSpec(schedule=ScheduleSpec(**sched),
                            comm=CommSpec("int8+ef"), **kw),
                 x0=x0, y0=y0, seed=0, device="cpu")
    _assert_same_run(tres, jres)
    assert {k: st.sends for k, st in tres.channels.items()} == sends


@pytest.mark.parametrize("method", METHODS)
def test_default_init_matches_across_runs_and_seeds(method):
    """x0 = 0 and y0 = 0.01·N(0, I) from torch.Generator(device) seeded
    with `seed` (FedNest's global y from the same generator)."""
    prob = tp.quadratic_bilevel(8, 4, 3, seed=1, device="cpu")
    net = make_network("ring", 8)
    spec = SolverSpec(method=method, K=2, M=2, U=1, b=1, N=1)
    a, b, c = (solve(prob, net, spec, seed=s, device="cpu")
               for s in (3, 3, 4))
    assert torch.equal(a.x, b.x) and torch.equal(a.y, b.y)
    assert not torch.equal(a.y, c.y)


@pytest.mark.parametrize("spec,kw,err,match", [
    (dict(method="dgbo", tier="serve"), {}, ValueError,
     "only executes method='dagm'"),
    (dict(method="ma_dbo", tier="sharded"), {}, ValueError,
     "only executes method='dagm'"),
    (dict(method="dgtbo", schedule=ScheduleSpec(gamma=2.0)), {},
     ValueError, "no penalty term"),
    (dict(method="fednest", schedule=ScheduleSpec(gamma=2.0)), {},
     ValueError, "no penalty term"),
    (dict(method="dgbo", b=0), {}, ValueError, "SolverSpec.b"),
    (dict(method="dgtbo", N=0), {}, ValueError, "SolverSpec.N"),
    (dict(method="dgbo"), {"metrics_fn": lambda *a: {}}, ValueError,
     "metrics_fn"),
    (dict(method="ma_dbo"), {"recorder": object()}, ValueError,
     "recorder= needs method='dagm'")])
def test_validation_errors(spec, kw, err, match):
    prob = tp.quadratic_bilevel(4, 2, 3, device="cpu")
    with pytest.raises(err, match=match):
        solve(prob, make_network("ring", 4), SolverSpec(K=1, **spec),
              device="cpu", **kw)


def test_gamma_schedule_runs_on_ma_dbo():
    """MA-DBO forms the penalty term, so a gamma schedule is accepted."""
    prob = tp.quadratic_bilevel(4, 2, 3, device="cpu")
    net = make_network("ring", 4)
    res = solve(prob, net, SolverSpec(method="ma_dbo", K=2, M=1, U=1,
                                      schedule=ScheduleSpec(gamma=3.0)),
                device="cpu")
    base = solve(prob, net, SolverSpec(method="ma_dbo", K=2, M=1, U=1),
                 device="cpu")
    assert not torch.equal(res.x, base.x)
