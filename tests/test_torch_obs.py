"""`repro_torch.obs` against `repro.obs` on the CPU.

* The same span and metric sequence exports the same Perfetto JSON and
  Prometheus text in both packages (timestamps aside: spans given
  explicit times export identically, instants are compared without
  their clock).
* Flight-recorder rows of the port's solve match `repro.solve(...,
  recorder=)` on identical inputs within f32 tolerance (rtol 1e-4,
  atol 1e-5, the solve parity tests' band; the round index and wire
  bytes exactly).
* Tracing and the recorder are inert: the port's solve is bitwise the
  same with them on and off.
"""
from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro import obs as jobs_obs
from repro.comm import static_ledger as j_static_ledger
from repro.core import problems as jp
from repro.solve import ScheduleSpec as JSchedule
from repro.solve import SolverSpec as JSpec
from repro.solve import solve as jsolve
from repro.topology import make_network as j_make_network

from repro_torch import obs
from repro_torch.comm import static_ledger
from repro_torch.core import problems as tp
from repro_torch.solve import CommSpec, ScheduleSpec, SolverSpec, solve
from repro_torch.topology import make_network

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _fresh_obs():
    """Each test starts with tracing off and empty registries."""
    for mod in (obs, jobs_obs):
        mod.reset_metrics()
        mod.tracer().clear()
        mod.enable_tracing(False)
    yield
    for mod in (obs, jobs_obs):
        mod.reset_metrics()
        mod.tracer().clear()
        mod.enable_tracing(False)


# ---------------------------------------------------------------------------
# export parity
# ---------------------------------------------------------------------------

def _record(mod):
    """One span/instant sequence on a fresh tracer of `mod`."""
    tr = mod.Tracer(enabled=True)
    tr.add_span("solve", 0.0, 100.0, cat="solver", track="solver", K=3)
    tr.add_span("chunk", 10.0, 80.0, cat="solver.chunk", track="solver")
    mod.synthesize_round_spans(tr, t0_us=10.0, dur_us=80.0, rounds=3,
                               phases=[("inner_dgd", 3),
                                       ("dihgp_neumann", 2),
                                       ("outer_step", 1)],
                               track="solver",
                               round_args=[{"outer_gap_sq": 1.5}])
    tr.add_span("build_chunk_fn", 5.0, 2.0, cat="serve.compile",
                track="engine", width=4)
    tr.instant("retire", cat="serve.lifecycle", track="engine",
               job_id="job0", slot=1)
    with tr.span("live", cat="t", track="other") as sp:
        sp.annotate(k=2)
    return tr


def _no_clock(events):
    return [{k: v for k, v in ev.items() if k not in ("ts", "dur")}
            if ev.get("name") in ("retire", "live") else ev
            for ev in events]


def test_trace_json_matches_repros(tmp_path):
    docs = []
    for mod, name in ((obs, "t"), (jobs_obs, "j")):
        path = tmp_path / f"{name}.json"
        n = mod.export.write_trace(_record(mod), path)
        docs.append((n, json.loads(path.read_text())))
    (nt, dt), (nj, dj) = docs
    assert nt == nj
    assert dt["displayTimeUnit"] == dj["displayTimeUnit"]
    assert _no_clock(dt["traceEvents"]) == _no_clock(dj["traceEvents"])
    obs.validate_trace(dt)
    jobs_obs.validate_trace(dt)


@pytest.mark.parametrize("bad", [
    {"ph": "X", "pid": 1, "tid": 1, "name": "a", "ts": 0.0},
    {"ph": "X", "pid": 1, "tid": 1, "name": "a", "ts": -1.0, "dur": 1.0},
    {"ph": "Q", "pid": 1, "tid": 1, "name": "a", "ts": 0.0},
    {"pid": 1, "tid": 1, "name": "a", "ts": 0.0},
])
def test_validate_trace_rejects_what_repros_rejects(bad):
    for mod in (obs, jobs_obs):
        with pytest.raises(ValueError):
            mod.validate_trace([bad])


def test_validate_trace_rejects_partial_overlap():
    evs = [{"ph": "X", "pid": 1, "tid": 1, "name": "a", "ts": 0.0,
            "dur": 10.0},
           {"ph": "X", "pid": 1, "tid": 1, "name": "b", "ts": 5.0,
            "dur": 10.0}]
    for mod in (obs, jobs_obs):
        with pytest.raises(ValueError, match="not well-nested"):
            mod.validate_trace(evs)


def _metrics(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("jobs_total", "jobs")
    c.labels(tenant="a").inc(3)
    c.labels(tenant="b\n\"x").inc()
    reg.gauge("depth", "queue depth").set(4.5)
    h = reg.histogram("lat_seconds", "latency")
    for v in (0.002, 0.03, 0.7, 20.0):
        h.observe(v)
    mod.observe_ledger(
        (static_ledger if mod is obs else j_static_ledger)(
            "int8+ef", [("inner_y", (10,), 6), ("outer_x", (4,), 2)],
            name="dagm"), reg, run="r")
    return reg


def test_prometheus_text_and_jsonl_match_repros(tmp_path):
    treg, jreg = _metrics(obs), _metrics(jobs_obs)
    ttext, jtext = obs.prometheus_text(treg), jobs_obs.prometheus_text(jreg)
    assert ttext == jtext
    assert obs.parse_prometheus(ttext) == jobs_obs.parse_prometheus(jtext)
    obs.write_metrics_jsonl(treg, tmp_path / "t.jsonl")
    jobs_obs.write_metrics_jsonl(jreg, tmp_path / "j.jsonl")
    assert (tmp_path / "t.jsonl").read_text() \
        == (tmp_path / "j.jsonl").read_text()


def test_streaming_writer_segments_match_repros(tmp_path):
    for mod, name in ((obs, "t"), (jobs_obs, "j")):
        tr = mod.Tracer(enabled=True)
        w = mod.StreamingTraceWriter(tmp_path / name, flush_every=3,
                                     rotate_events=5, tracer=tr)
        for k in range(8):
            tr.add_span(f"s{k}", 10.0 * k, 5.0, track="a" if k % 2
                        else "b")
        w.close()
        for seg in w.segments:
            mod.read_trace(seg)
    tseg = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert tseg == sorted(p.name for p in (tmp_path / "j").iterdir())
    for name in tseg:
        assert (tmp_path / "t" / name).read_text() \
            == (tmp_path / "j" / name).read_text()


def test_tracer_eviction_and_sinks():
    tr = obs.Tracer(enabled=True, max_resident_spans=3)
    seen = []
    tr.add_sink(seen.append)
    for k in range(5):
        tr.add_span(f"s{k}", float(k), 1.0)
    assert [e.name for e in tr.events()] == ["s2", "s3", "s4"]
    assert len(seen) == 5 and tr.dropped == 2
    assert obs.counter_value("obs_dropped_spans_total") == 2
    with pytest.raises(ValueError):
        obs.Tracer(max_resident_spans=0)


def test_trace_counter_memoises_builds():
    tc = obs.TraceCounter("runner")
    built = []
    build = tc.wrap(lambda key: built.append(key) or object())
    a = build("a")
    assert build("a") is a and tc.count == 1 and tc.retraces == 0
    build("b")
    build("a")
    assert tc.count == 2 and built == ["a", "b"] and tc.retraces == 1
    assert obs.counter_value("jit_traces_total", name="runner") == 2


def test_fused_fallback_counter_is_exported_and_zero():
    prob = tp.quadratic_bilevel(6, 4, 5, seed=0, device="cpu")
    solve(prob, make_network("ring", 6), _spec(comm="int8"),
          device="cpu")
    fam = obs.fused_fallback_counter()
    assert fam.value() == 0.0
    assert "mixing_fused_fallbacks_total" in obs.prometheus_text(
        obs.registry())


# ---------------------------------------------------------------------------
# the flight recorder and the solve's instrumentation
# ---------------------------------------------------------------------------

def _spec(K=6, comm="identity", dihgp="matrix_free"):
    return SolverSpec(K=K, M=3, U=2, dihgp=dihgp, curvature=6.0,
                      schedule=ScheduleSpec(alpha=0.05, beta=0.1),
                      comm=CommSpec(comm))


def test_recorder_ring_buffer_wraps_oldest_first():
    rec = obs.recorder_init(obs.RecorderSpec(capacity=3))
    for k in range(5):
        v = torch.tensor(float(k))
        rec = obs.recorder_write(rec, {"outer_gap_sq": v, "penalty": v,
                                       "wire_bytes": v,
                                       "alive_fraction": v})
    rows = obs.recorder_rows(rec)
    assert rows[:, 0].tolist() == [2.0, 3.0, 4.0]
    assert rows[:, 1].tolist() == [2.0, 3.0, 4.0]
    assert obs.rows_to_dicts(rows)[0]["round"] == 2.0
    with pytest.raises(ValueError):
        obs.RecorderSpec(capacity=0)


@pytest.mark.parametrize("kind", ["ring", "erdos_renyi"])
@pytest.mark.parametrize("dihgp", ["matrix_free", "dense"])
def test_recorder_rows_match_repros(kind, dihgp):
    n, d1, d2, K = 6, 4, 5, 6
    jprob = jp.quadratic_bilevel(n, d1, d2, seed=0)
    tprob = tp.quadratic_bilevel(n, d1, d2, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    y0 = (0.1 * rng.standard_normal((n, d2))).astype(np.float32)
    kw = {"r": 0.6, "seed": 1} if kind == "erdos_renyi" else {}
    spec = _spec(K=K, dihgp=dihgp)
    jres = jsolve(jprob, j_make_network(kind, n, **kw),
                  JSpec(K=K, M=3, U=2, dihgp=dihgp, curvature=6.0,
                        schedule=JSchedule(alpha=0.05, beta=0.1)),
                  y0=jnp.asarray(y0),
                  recorder=jobs_obs.RecorderSpec(capacity=16))
    tres = solve(tprob, make_network(kind, n, **kw), spec, y0=y0,
                 device="cpu", recorder=obs.RecorderSpec(capacity=16))
    jf, tf = np.asarray(jres.extras["flight"]), tres.extras["flight"]
    assert tf.shape == jf.shape == (K, len(obs.FIELDS))
    exact = [obs.FIELDS.index(f) for f in ("round", "wire_bytes",
                                           "alive_fraction")]
    np.testing.assert_array_equal(tf[:, exact], jf[:, exact])
    np.testing.assert_allclose(tf, jf, rtol=RTOL, atol=ATOL)
    assert tf[-1, obs.FIELDS.index("wire_bytes")] \
        == tres.ledger.total_bytes


@pytest.mark.parametrize("comm", ["identity", "int8+ef", "int4"])
def test_solve_bitwise_identical_with_obs_on(comm):
    prob = tp.quadratic_bilevel(6, 4, 5, seed=0, device="cpu")
    net = make_network("ring", 6)
    base = solve(prob, net, _spec(comm=comm), device="cpu")
    with obs.tracing() as tr:
        res = solve(prob, net, _spec(comm=comm), device="cpu",
                    recorder=obs.RecorderSpec(capacity=4))
    assert torch.equal(base.x, res.x) and torch.equal(base.y, res.y)
    for k in base.metrics:
        assert torch.equal(base.metrics[k], res.metrics[k])
    flight = res.extras["flight"]
    assert flight[:, 0].tolist() == [2.0, 3.0, 4.0, 5.0]   # wrapped
    names = [e.name for e in tr.events()]
    for name in ("solve", "init_carry", "trace_compile", "chunk",
                 "outer_round", "inner_dgd", "dihgp_neumann",
                 "outer_step"):
        assert name in names
    assert names.count("outer_round") == 6
    obs.validate_trace(obs.trace_events(tr))
    rounds = [e for e in tr.events() if e.name == "outer_round"]
    assert all(e.args["synthetic"] for e in rounds)
    assert flight[-1, obs.FIELDS.index("wire_bytes")] \
        == float(res.ledger.total_bytes)


def test_tracing_off_records_nothing():
    prob = tp.quadratic_bilevel(6, 4, 5, seed=0, device="cpu")
    solve(prob, make_network("ring", 6), _spec(), device="cpu")
    assert len(obs.tracer()) == 0


def test_faulted_recorder_alive_fraction_and_observe():
    from repro_torch.faults import FaultSpec
    prob = tp.quadratic_bilevel(6, 4, 5, seed=0, device="cpu")
    spec = SolverSpec(K=6, M=3, U=2, dihgp="matrix_free", curvature=6.0,
                      schedule=ScheduleSpec(alpha=0.05, beta=0.1),
                      faults=FaultSpec(drop_prob=0.3, seed=2))
    res = solve(prob, make_network("erdos_renyi", 6, r=0.6, seed=1), spec,
                device="cpu", recorder=obs.RecorderSpec())
    trace = res.extras["fault_trace"]
    alive = res.extras["flight"][:, obs.FIELDS.index("alive_fraction")]
    assert np.isclose(alive.mean(), trace.alive_fraction(), rtol=1e-5)
    trace.observe(run="faulted")
    assert obs.registry().gauge("fault_trace_rounds").value(
        run="faulted") == 6.0
    assert np.isclose(obs.registry().gauge("fault_alive_fraction").value(
        run="faulted"), trace.alive_fraction())
    res.ledger.observe(run="faulted")
    assert obs.counter_value(
        "comm_wire_bytes_total", run="faulted", ledger=res.ledger.name,
        channel="outer_x", spec="identity") \
        == res.ledger.channels["outer_x"].bytes


def test_recorder_rejects_baseline_methods():
    prob = tp.quadratic_bilevel(6, 4, 5, seed=0, device="cpu")
    with pytest.raises(ValueError, match="flight recorder"):
        solve(prob, make_network("ring", 6),
              SolverSpec(method="dgbo", K=2), device="cpu",
              recorder=obs.RecorderSpec())
