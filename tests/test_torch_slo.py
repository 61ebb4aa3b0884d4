"""`repro_torch.serve.slo` against `repro.serve.slo` on the CPU: the same
seeded Poisson schedules, the same latency pairing and quantiles, the
same published metrics; `drive_poisson` on the port's engine and
`drive_poisson_async` on its admission loop."""
from __future__ import annotations

import numpy as np
import pytest
from repro import obs as jobs_obs
from repro.serve import slo as jslo

from repro_torch import obs
from repro_torch.serve import JobSpec, ServeEngine, slo
from repro_torch.solve import ScheduleSpec, SolverSpec


@pytest.fixture(autouse=True)
def _fresh_obs():
    for mod in (obs, jobs_obs):
        mod.reset_metrics()
        mod.tracer().clear()
        mod.enable_tracing(False)
    yield
    for mod in (obs, jobs_obs):
        mod.reset_metrics()
        mod.tracer().clear()
        mod.enable_tracing(False)


@pytest.mark.parametrize("n,rate,seed", [(0, 1.0, 0), (5, 2.0, 0),
                                         (40, 0.5, 3), (100, 50.0, 7)])
def test_poisson_arrivals_match_repros(n, rate, seed):
    got = slo.poisson_arrivals(n, rate, seed)
    np.testing.assert_array_equal(got, jslo.poisson_arrivals(n, rate, seed))
    assert np.all(np.diff(got) >= 0)


@pytest.mark.parametrize("n,rate", [(-1, 1.0), (3, 0.0), (3, -2.0)])
def test_poisson_arrivals_refuse_what_repros_refuses(n, rate):
    for mod in (slo, jslo):
        with pytest.raises(ValueError):
            mod.poisson_arrivals(n, rate)


def _events(mod):
    tr = mod.Tracer(enabled=True)
    for jid, (t0, t1) in {"a": (0.0, 2e6), "b": (1e6, 1.5e6),
                          "c": (3e6, None)}.items():
        tr._record(mod.SpanEvent("submit", "serve.lifecycle", t0, None,
                                 "engine", {"job_id": jid}))
        if t1 is not None:
            tr._record(mod.SpanEvent("retire", "serve.lifecycle", t1, None,
                                     "engine", {"job_id": jid}))
    tr.add_span("chunk", 0.0, 5.0, job_id="a")        # a span: ignored
    return tr


@pytest.mark.parametrize("since", [None, 0.5e6, 2.5e6])
def test_job_latencies_match_repros(since):
    got = slo.job_latencies(_events(obs), since=since)
    want = jslo.job_latencies(_events(jobs_obs), since=since)
    assert got == want


@pytest.mark.parametrize("vals", [[1.0], [0.5, 0.1, 2.0, 7.5],
                                  list(np.linspace(0, 1, 17))])
def test_quantiles_and_observed_metrics_match_repros(vals):
    assert slo.latency_quantiles(vals) == jslo.latency_quantiles(vals)
    treg, jreg = obs.MetricsRegistry(), jobs_obs.MetricsRegistry()
    assert slo.observe_latencies(vals, reg=treg, run="x") \
        == jslo.observe_latencies(vals, reg=jreg, run="x")
    assert obs.prometheus_text(treg) == jobs_obs.prometheus_text(jreg)
    with pytest.raises(ValueError):
        slo.latency_quantiles([])


def _spec(seed):
    return JobSpec("quadratic", {"n": 6, "d1": 4, "d2": 8, "seed": seed},
                   SolverSpec(K=4, M=2, U=2, dihgp="matrix_free",
                              curvature=6.0,
                              schedule=ScheduleSpec(alpha=0.05, beta=0.1)),
                   seed=seed)


def test_drive_poisson_on_the_ports_engine():
    eng = ServeEngine(chunk_rounds=2, device="cpu")
    rep = slo.drive_poisson(eng, [_spec(s) for s in range(4)],
                            rate_hz=200.0, seed=1, run="cpu")
    assert rep.jobs == rep.retired == 4 and rep.waves >= 1
    assert rep.latencies_s.shape == (4,) and np.all(rep.latencies_s > 0)
    assert rep.p50_s <= rep.p99_s
    rec = rep.as_record()
    assert rec["kind"] == "slo_report" and "results" not in rec
    assert len(rec["latencies_s"]) == 4
    assert obs.registry().gauge("serve_peak_queue_depth").value(
        run="cpu") >= 1


@pytest.mark.parametrize("rate", [200.0, 5.0])
def test_drive_poisson_async_retires_every_job(rate):
    """`drive_poisson_async` on the port's admission loop: the same seeded
    schedule as `drive_poisson`, no waves, every job retired, each
    latency paired from the loop's own submit/retire instants, and the
    loop's thread stopped when the driver started it."""
    from repro_torch.serve.admission import AdmissionLoop
    loop = AdmissionLoop(chunk_rounds=2, max_width=2, device="cpu")
    specs = [_spec(s) for s in range(4)]
    rep = slo.drive_poisson_async(loop, specs, rate_hz=rate, seed=1,
                                  run="async")
    assert rep.jobs == rep.retired == 4 and rep.waves == 0
    assert [r.job_id for r in rep.results] == [f"job{i}" for i in range(4)]
    assert rep.latencies_s.shape == (4,) and np.all(rep.latencies_s > 0)
    assert rep.p50_s <= rep.p99_s
    assert not loop.running
    assert obs.registry().gauge("serve_peak_queue_depth").value(
        run="async") >= 0
    np.testing.assert_array_equal(
        slo.poisson_arrivals(4, rate, 1), jslo.poisson_arrivals(4, rate, 1))
