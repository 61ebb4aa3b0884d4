"""`repro_torch.serve.admission` on the CPU: the always-on loop's
contracts against the port's own solo solves, and against `repro`'s
admission loop.

* The 27 contracts of `tests/test_admission.py`, on the port alone (at
  K = 4 / 8 with chunk_rounds 2 where `repro`'s tests take K = 20 / 40
  with 10, and K = 3 where they take the prime 7): async admission at
  chunk boundaries bitwise its solo `solve(tier="reference")` under any
  interleaving (a seeded loop and a hypothesis property), K-packed
  buckets on one runner (`EngineStats.traces` counts the port's runner
  builds, its "retraces"), priority preemption bitwise through a crash
  (the EF replicas and the channels' host send counters included:
  preemption cases run int8+ef too), queued jobs surviving a crash
  through the `loop_*.pkl` sidecar, tenant quotas, the scheduler thread,
  telemetry and `solve(serve_engine=AdmissionLoop(...))`.
* Against `repro` (module-scoped runs, shared by the parity tests): on
  the same submissions, a preempting, K-packed, quota-metered schedule
  emits the same lifecycle sequence in both packages — admit, preempt,
  resume and retire, each with its job id, bucket key (by order of
  first use) and slot, and the same trace instants — with the same
  exact tenant ledger bytes and per-job wire bytes; and each job's
  final iterates equal `repro.solve(tier="reference")`'s on the same
  data and y0 within rtol 1e-4 / atol 1e-5 (the solve parity tests'
  f32 band; `repro`'s serve tier draws its own y0, so its loop's
  iterates are not the reference).
"""
from __future__ import annotations

import dataclasses
import functools
import glob
import os
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.serve import (JobSpec, SimulatedCrash, build_network,
                               build_problem)
from repro_torch.serve import batching as port_batching
from repro_torch.serve.admission import (DEFAULT_CLASSES,
                                         DEPRIORITIZED_PRIORITY,
                                         AdmissionLoop, PriorityClass,
                                         QuotaExceeded, TenantLedger,
                                         admission_key, compatible,
                                         pack_chunk_rounds, plan_bucket,
                                         resolve_class)
from repro_torch.solve import CommSpec, ScheduleSpec, SolverSpec, solve

RTOL, ATOL = 1e-4, 1e-5
T = 2                       # chunk rounds (repro's tests: 10)
K_SHORT, K_LONG = 4, 8      # (repro's tests: 20, 40)


def cfg(K=K_SHORT, comm="identity"):
    return SolverSpec(K=K, M=3, U=2, dihgp="matrix_free", curvature=6.0,
                      schedule=ScheduleSpec(alpha=0.05, beta=0.1),
                      comm=CommSpec(comm))


def quad_spec(data_seed, K=K_SHORT, comm="identity", **kw):
    return JobSpec("quadratic", {"n": 6, "d1": 4, "d2": 8,
                                 "seed": data_seed},
                   cfg(K, comm), seed=data_seed, **kw)


def make_loop(**kw):
    kw.setdefault("chunk_rounds", T)
    kw.setdefault("max_width", 2)
    kw.setdefault("hp_mode", "traced")
    return AdmissionLoop(device="cpu", **kw)


@functools.lru_cache(maxsize=None)
def _solo(data_seed, K, comm):
    spec = quad_spec(data_seed, K, comm)
    return solve(build_problem(spec, "cpu"), build_network(spec),
                 spec.config, seed=spec.seed, device="cpu")


def solo(spec):
    return _solo(spec.problem["seed"], spec.config.K, spec.config.comm.spec)


def assert_bitexact(result, spec):
    ref = solo(spec)
    assert torch.equal(result.x, ref.x) and torch.equal(result.y, ref.y)
    assert result.wire_bytes == ref.ledger.total_bytes


@pytest.fixture(autouse=True)
def _fresh_obs():
    obs.reset_metrics()
    obs.tracer().clear()
    obs.enable_tracing(False)
    yield
    obs.reset_metrics()
    obs.tracer().clear()
    obs.enable_tracing(False)


# ---------------------------------------------------------------------------
# classes / quotas / packing units
# ---------------------------------------------------------------------------

def test_admission_key_total_order():
    # priority first (higher drains first), then deadline, then seq
    assert admission_key(100, None, 5) < admission_key(10, 0.1, 0)
    assert admission_key(10, 1.0, 9) < admission_key(10, 2.0, 0)
    assert admission_key(10, None, 0) > admission_key(10, 99.0, 1)
    assert admission_key(10, None, 0) < admission_key(10, None, 1)


def test_priority_class_validation():
    with pytest.raises(ValueError, match="non-empty"):
        PriorityClass("", 1)
    with pytest.raises(ValueError, match="deadline_s"):
        PriorityClass("x", 1, deadline_s=0.0)
    with pytest.raises(ValueError, match="unknown priority class"):
        resolve_class(DEFAULT_CLASSES, "platinum")


def test_tenant_ledger_modes():
    led = TenantLedger(budgets={"a": 100}, mode="reject")
    assert led.remaining("a") == 100
    assert led.budget("other") is None          # unmetered by default
    led.charge("a", 60)
    assert led.admit("a", 10) == 10             # still under budget
    led.charge("a", 60)
    assert led.over_budget("a")
    with pytest.raises(QuotaExceeded, match="120 spent of 100"):
        led.admit("a", 10)
    assert led.admit("other", 10) == 10         # unmetered passes

    soft = TenantLedger(budgets={"a": 1}, mode="deprioritize")
    soft.charge("a", 5)
    assert soft.admit("a", 10) == DEPRIORITIZED_PRIORITY

    with pytest.raises(ValueError, match="unknown quota mode"):
        TenantLedger(mode="meter")


def test_pack_chunk_rounds_and_compatible():
    assert pack_chunk_rounds([20, 40], 10) == 10
    assert pack_chunk_rounds([20, 30], 10) == 10
    assert pack_chunk_rounds([6, 9], 10) == 3
    assert pack_chunk_rounds([5, 7], 10) is None   # no common divisor >= 2
    assert pack_chunk_rounds([1, 8], 10) is None   # K=1 can't chunk
    assert compatible(20, 10, 40, 20)
    assert not compatible(0, 10, 40, 20)           # nothing left to run
    assert not compatible(15, 10, 40, 15)          # misses the boundary
    assert not compatible(20, 10, 20, 40)          # rows overflow capacity


def test_plan_bucket_prefers_widest_pack():
    E = dataclasses.make_dataclass("E", ["budget", "remaining"])
    T_, K_max, adm = plan_bucket([E(20, 20), E(40, 40), E(30, 30)], 10)
    assert (T_, K_max) == (10, 40) and len(adm) == 3
    # no common divisor: plan around the head, pick up who fits
    T_, K_max, adm = plan_bucket([E(20, 20), E(7, 7)], 10)
    assert T_ == 10 and [e.budget for e in adm] == [20]


# ---------------------------------------------------------------------------
# async admission: mid-flight submits, bit-exact vs solo
# ---------------------------------------------------------------------------

def test_midflight_submit_joins_at_chunk_boundary():
    loop = make_loop(bucket_width=2)
    first = [quad_spec(0), quad_spec(1)]
    loop.submit(first)
    loop.step()                       # both in flight, one chunk done
    late = quad_spec(2)
    (jid,) = loop.submit(late)        # arrives while bucket is hot
    loop.pump()
    assert_bitexact(loop.result(jid), late)
    for i, s in enumerate(first):
        assert_bitexact(loop.result(f"job{i}"), s)
    # one bucket runner served all three jobs across the join: the
    # port's "zero retraces"
    assert loop.stats.cache_misses == 1 and loop.stats.traces == 1


def test_interleaved_submits_bitexact_seeded():
    """Randomized interleaving of submit() against scheduler steps —
    every job must match its solo run bitwise no matter when it
    arrived (the no-hypothesis twin of the property test below)."""
    rng = np.random.default_rng(42)
    for trial in range(3):
        n = int(rng.integers(3, 6))
        ks = rng.choice([K_SHORT, K_LONG], size=n)
        specs = [quad_spec(10 * trial + i, K=int(k))
                 for i, k in enumerate(ks)]
        loop = make_loop(bucket_width=2)
        ids = []
        i = 0
        while i < len(specs) or ids and not all(
                loop._done[j].is_set() for j in ids):
            if i < len(specs) and (not ids or rng.random() < 0.5):
                ids.extend(loop.submit(specs[i]))
                i += 1
            else:
                loop.step()
        for jid, spec in zip(ids, specs):
            assert_bitexact(loop.result(jid), spec)
        assert loop.stats.traces == 1


def test_interleaving_property_hypothesis():
    from hypothesis import given, settings
    from hypothesis import strategies as st

    @settings(max_examples=10, deadline=None)
    @given(st.lists(st.tuples(st.booleans(),
                              st.sampled_from([K_SHORT, K_LONG])),
                    min_size=1, max_size=5))
    def prop(plan):
        specs = [quad_spec(i, K=k) for i, (_, k) in enumerate(plan)]
        loop = make_loop(bucket_width=2)
        ids = []
        for step_first, _ in plan:
            if step_first:
                loop.step()
        for spec in specs:
            ids.extend(loop.submit(spec))
            if len(ids) % 2:
                loop.step()           # interleave boundary admits
        loop.pump()
        for jid, spec in zip(ids, specs):
            assert_bitexact(loop.result(jid), spec)

    prop()


def test_run_returns_submission_order():
    specs = [quad_spec(s) for s in range(3)]
    loop = make_loop(max_width=4)
    ids = loop.submit(specs)
    results = loop.run()
    assert [r.job_id for r in results] == ids


def test_duplicate_and_unknown_job_ids():
    loop = make_loop()
    loop.submit(quad_spec(0, job_id="mine"))
    with pytest.raises(ValueError, match="duplicate job_id"):
        loop.submit(quad_spec(1, job_id="mine"))
    with pytest.raises(KeyError, match="unknown job_id"):
        loop.result("nobody")


# ---------------------------------------------------------------------------
# K-packing: one bucket, one runner, per-slot retirement
# ---------------------------------------------------------------------------

def test_packed_k_single_bucket_bitexact():
    specs = [quad_spec(s, K=K_SHORT if s % 2 else K_LONG) for s in range(6)]
    loop = make_loop(max_width=4)
    ids = loop.submit(specs)
    results = loop.run()
    assert loop.stats.buckets == 1          # K=4 and K=8 packed
    assert loop.stats.cache_misses == 1     # one runner
    assert loop.stats.traces == 1
    for spec, r in zip(specs, results):
        assert r.rounds == spec.config.K    # own budget, not the max
        assert_bitexact(r, spec)
    assert sorted(ids) == sorted(r.job_id for r in results)


def test_packing_off_buckets_by_k():
    specs = [quad_spec(0, K=K_SHORT), quad_spec(1, K=K_LONG)]
    loop = make_loop(packing=False)
    loop.submit(specs)
    results = loop.run()
    assert loop.stats.buckets == 2          # exact-signature grouping
    for spec, r in zip(specs, results):
        assert_bitexact(r, spec)


def test_incompatible_k_stays_queued_then_runs():
    # K=3 has no common chunk length with K=4 at T=2; it must wait for
    # its own bucket, not corrupt the packed one
    specs = [quad_spec(0, K=K_SHORT), quad_spec(1, K=3)]
    loop = make_loop()
    loop.submit(specs)
    results = loop.run()
    assert loop.stats.buckets == 2
    for spec, r in zip(specs, results):
        assert r.rounds == spec.config.K
        assert_bitexact(r, spec)


# ---------------------------------------------------------------------------
# priority classes and preemption
# ---------------------------------------------------------------------------

def test_priority_drains_before_submission_order():
    loop = make_loop(bucket_width=2)
    batch = dataclasses.replace(quad_spec(0), klass="batch")
    rt = dataclasses.replace(quad_spec(1), klass="realtime")
    loop.submit([batch, rt])
    entries = loop.queue.ordered()
    assert [e.spec.job_id for e in entries] == ["job1", "job0"]


@pytest.mark.parametrize("comm", ["identity", "int8+ef"])
def test_preemption_is_bitexact_and_counted(comm):
    loop = make_loop(bucket_width=2)
    victims = [dataclasses.replace(quad_spec(s, K=K_LONG, comm=comm),
                                   klass="batch") for s in (0, 1)]
    loop.submit(victims)
    loop.step()                                  # both at T rounds
    rt = dataclasses.replace(quad_spec(2, K=K_SHORT, comm=comm),
                             klass="realtime")
    (rt_id,) = loop.submit(rt)
    loop.pump()
    assert obs.counter_value("serve_preemptions_total") >= 1
    assert_bitexact(loop.result(rt_id), rt)
    for i, v in enumerate(victims):              # resumed, not re-run
        r = loop.result(f"job{i}")
        assert r.rounds == K_LONG
        assert_bitexact(r, v)
    assert loop.stats.traces == 1


def test_equal_priority_never_preempts():
    loop = make_loop(bucket_width=2)
    loop.submit([quad_spec(s, K=K_LONG) for s in (0, 1)])
    loop.step()
    loop.submit(quad_spec(2, K=K_SHORT))          # same "standard" class
    loop.pump()
    assert obs.counter_value("serve_preemptions_total") == 0.0


def test_realtime_is_not_preemptible():
    loop = make_loop(bucket_width=2,
                     classes={**DEFAULT_CLASSES,
                              "ultra": PriorityClass("ultra", 200)})
    rts = [dataclasses.replace(quad_spec(s, K=K_LONG), klass="realtime")
           for s in (0, 1)]
    loop.submit(rts)
    loop.step()
    loop.submit(dataclasses.replace(quad_spec(2, K=K_SHORT), klass="ultra"))
    loop.pump()
    assert obs.counter_value("serve_preemptions_total") == 0.0


@pytest.mark.parametrize("comm", ["identity", "int8+ef"])
def test_preempt_checkpoint_resume_bitexact(tmp_path, comm):
    """Preempted carry spools through repro_torch.checkpoint, the loop
    crashes, and the resumed job still matches an uninterrupted run
    bitwise — the subsystem's strongest exactness claim."""
    victims = [dataclasses.replace(quad_spec(s, K=K_LONG, comm=comm),
                                   klass="batch") for s in (0, 1)]
    rt = dataclasses.replace(quad_spec(2, K=K_SHORT, comm=comm),
                             klass="realtime")
    base = make_loop(bucket_width=2)
    base.submit(victims + [rt])
    ref = {r.job_id: r for r in base.run()}

    d = str(tmp_path / "svc")
    crash = make_loop(bucket_width=2, checkpoint_dir=d,
                      checkpoint_every=1, crash_after_chunks=2,
                      telemetry=False)
    crash.submit(victims)
    crash.step()                      # chunk 1 before the rt arrival
    crash.submit(rt)                  # preempts at the next boundary
    with pytest.raises(SimulatedCrash):
        crash.pump()
    assert glob.glob(os.path.join(d, "preempt", "step_*.npz"))

    fresh = make_loop(bucket_width=2, checkpoint_dir=d, telemetry=False)
    fresh.pump()
    assert fresh.stats.restarts == 1
    for jid, r in ref.items():
        got = fresh.result(jid)
        assert got.rounds == r.rounds and got.wire_bytes == r.wire_bytes
        assert torch.equal(got.x, r.x) and torch.equal(got.y, r.y)
    for jid, spec in zip(("job0", "job1", "job2"), victims + [rt]):
        assert_bitexact(fresh.result(jid), spec)


def test_queued_unadmitted_jobs_survive_crash(tmp_path):
    specs = [quad_spec(s) for s in range(4)]
    base = make_loop(bucket_width=2)
    base.submit(specs)
    ref = base.run()

    d = str(tmp_path / "svc")
    crash = make_loop(bucket_width=2, checkpoint_dir=d,
                      checkpoint_every=1, crash_after_chunks=1,
                      telemetry=False)
    crash.submit(specs)
    with pytest.raises(SimulatedCrash):
        crash.pump()

    fresh = make_loop(bucket_width=2, checkpoint_dir=d, telemetry=False)
    fresh._maybe_restore()
    assert fresh.queue.job_ids() == ["job2", "job3"]   # never admitted
    fresh.pump()
    for i, r in enumerate(ref):
        got = fresh.result(f"job{i}")
        assert torch.equal(got.x, r.x) and torch.equal(got.y, r.y)
    # a drained loop owes the disk nothing
    fresh.step()
    assert not glob.glob(os.path.join(d, "step_*.npz"))
    assert not glob.glob(os.path.join(d, "loop_*.pkl"))
    assert not os.path.isdir(os.path.join(d, "preempt"))


def test_restore_rejects_mismatched_chunking(tmp_path):
    d = str(tmp_path / "svc")
    crash = make_loop(checkpoint_dir=d, checkpoint_every=1,
                      crash_after_chunks=1, telemetry=False)
    crash.submit([quad_spec(0, K=K_SHORT)])
    with pytest.raises(SimulatedCrash):
        crash.pump()
    other = make_loop(chunk_rounds=4, checkpoint_dir=d, telemetry=False)
    with pytest.raises(ValueError, match=f"chunk_rounds={T}"):
        other._maybe_restore()


# ---------------------------------------------------------------------------
# tenant quotas
# ---------------------------------------------------------------------------

def test_quota_exhaustion_rejects_submit():
    led = TenantLedger(budgets={"acme": 1})
    loop = make_loop(quotas=led)
    loop.submit(dataclasses.replace(quad_spec(0), tenant="acme"))
    loop.pump()
    # exact ledger bytes
    assert led.spent("acme") == solo(quad_spec(0)).ledger.total_bytes > 0
    with pytest.raises(QuotaExceeded, match="acme"):
        loop.submit(dataclasses.replace(quad_spec(1), tenant="acme"))
    assert obs.counter_value("serve_quota_rejections_total",
                             tenant="acme") == 1.0
    # other tenants are unaffected
    loop.submit(dataclasses.replace(quad_spec(2), tenant="beta"))
    loop.pump()
    assert_bitexact(loop.result("job2"), quad_spec(2))


def test_quota_deprioritize_runs_last():
    led = TenantLedger(budgets={"acme": 1}, mode="deprioritize")
    led.charge("acme", 5)                        # already over budget
    loop = make_loop(bucket_width=2, quotas=led)
    over = dataclasses.replace(quad_spec(0), tenant="acme")
    normal = dataclasses.replace(quad_spec(1), tenant="beta",
                                 klass="batch")
    loop.submit([over, normal])
    ordered = [e.spec.job_id for e in loop.queue.ordered()]
    assert ordered == ["job1", "job0"]           # batch(0) > clamped
    loop.pump()
    assert_bitexact(loop.result("job0"), over)   # still runs, and runs right


def test_quota_spent_survives_restart(tmp_path):
    d = str(tmp_path / "svc")
    led = TenantLedger(budgets={"acme": 10_000_000})
    crash = make_loop(quotas=led, checkpoint_dir=d, checkpoint_every=1,
                      crash_after_chunks=2, telemetry=False)
    crash.submit([dataclasses.replace(quad_spec(s), tenant="acme")
                  for s in range(2)])
    with pytest.raises(SimulatedCrash):
        crash.pump()
    spent = led.spent("acme")
    assert spent > 0                             # chunk-2 boundary retired
    led2 = TenantLedger(budgets={"acme": 10_000_000})
    fresh = make_loop(quotas=led2, checkpoint_dir=d, telemetry=False)
    fresh._maybe_restore()
    assert led2.spent("acme") == spent


# ---------------------------------------------------------------------------
# service thread + telemetry
# ---------------------------------------------------------------------------

def test_threaded_service_as_completed():
    specs = [quad_spec(s) for s in range(4)]
    with make_loop(max_width=4) as svc:
        ids = svc.submit(specs[:2])
        time.sleep(0.01)                         # overlap with running work
        ids += svc.submit(specs[2:])
        got = {r.job_id for r in svc.as_completed(ids, timeout=300)}
    assert got == set(ids)
    for jid, spec in zip(ids, specs):
        assert_bitexact(svc.result(jid), spec)


def test_submit_from_background_thread():
    loop = make_loop().start()
    try:
        ids: list = []

        def feeder():
            for s in range(3):
                ids.extend(loop.submit(quad_spec(s)))
                time.sleep(0.005)

        t = threading.Thread(target=feeder)
        t.start()
        t.join()
        loop.drain(timeout=300)
        for jid, s in zip(ids, range(3)):
            assert_bitexact(loop.result(jid), quad_spec(s))
    finally:
        loop.stop()


def test_scheduler_thread_error_reaches_result_and_stop(monkeypatch):
    """An exception in the scheduler thread (here a chunk that keeps
    failing past its retries) fails the run: `result()` and `stop()`
    raise, and no job is reported finished that did not retire."""
    loop = make_loop(max_chunk_retries=1, retry_backoff_s=0.0)
    calls = []

    def broken(fn, args):
        calls.append(1)
        raise RuntimeError("mixing kernel launch failed (injected)")
    monkeypatch.setattr(loop, "_invoke_chunk", broken)
    loop.start()
    (jid,) = loop.submit(quad_spec(0))
    with pytest.raises(RuntimeError, match="was not completed") as err:
        loop.result(jid, timeout=60)
    assert "injected" in repr(err.value.__cause__)
    assert jid not in loop._results and calls
    with pytest.raises(RuntimeError, match="thread died") as err:
        loop.stop()
    assert "injected" in repr(err.value.__cause__)
    assert not loop.running


def test_telemetry_default_on_with_checkpoint_dir(tmp_path):
    """A checkpointing loop opens its own streaming trace + metrics
    writers under <checkpoint_dir>/telemetry with no caller plumbing,
    and closes them into valid artifacts."""
    d = str(tmp_path / "svc")
    loop = make_loop(checkpoint_dir=d, checkpoint_every=1)
    loop.submit([quad_spec(s) for s in range(2)])
    loop.pump()
    loop.stop()                                   # close telemetry
    tdir = os.path.join(d, "telemetry")
    traces = glob.glob(os.path.join(tdir, "serve-trace-*.json"))
    metrics = glob.glob(os.path.join(tdir, "serve-metrics-*.jsonl"))
    assert traces and metrics
    evs = obs.read_trace(traces[0])
    names = {e["name"] for e in evs if e.get("ph") in ("i", "I")}
    assert "submit" in names and "retire" in names

    off = make_loop(checkpoint_dir=str(tmp_path / "quiet"),
                    telemetry=False)
    off.submit(quad_spec(9))
    off.pump()
    off.stop()
    assert not glob.glob(os.path.join(str(tmp_path / "quiet"),
                                      "telemetry", "*"))


def test_solve_api_accepts_admission_loop():
    from repro_torch.core.problems import quadratic_bilevel
    from repro_torch.topology import make_network
    prob = quadratic_bilevel(6, 4, 8, seed=0, device="cpu")
    net = make_network("ring", 6)
    spec = dataclasses.replace(cfg(K=K_SHORT), tier="serve")
    loop = make_loop(record_metrics=True)
    res = solve(prob, net, spec, seed=3, serve_engine=loop, device="cpu")
    ref = solve(prob, net, dataclasses.replace(spec, tier="reference"),
                seed=3, device="cpu")
    assert res.tier == "serve"
    assert torch.equal(res.x, ref.x) and torch.equal(res.y, ref.y)


# ---------------------------------------------------------------------------
# against repro's admission loop (module-scoped runs)
# ---------------------------------------------------------------------------

LIFECYCLE = ("submit", "open_bucket", "admit", "preempt", "resume",
             "retire")


def _schedule(pkg):
    """One preempting, K-packed, quota-metered schedule, driven
    synchronously through `pkg`'s loop (pkg "port" or "repro"); returns
    the lifecycle log, the trace instants, the ledger and the results."""
    if pkg == "port":
        Loop, Led, Spec, Bucket = AdmissionLoop, TenantLedger, JobSpec, \
            port_batching.BucketState
        obs_mod = obs
        conf = {"device": "cpu"}

        def config(K, comm):
            return cfg(K, comm)
    else:
        from repro import obs as jobs
        from repro.serve import JobSpec as JSpec
        from repro.serve import batching as jb
        from repro.serve.admission import AdmissionLoop as JLoop
        from repro.serve.admission import TenantLedger as JLed
        from repro.solve import CommSpec as JComm
        from repro.solve import ScheduleSpec as JSched
        from repro.solve import SolverSpec as JSolver
        Loop, Led, Spec, Bucket = JLoop, JLed, JSpec, jb.BucketState
        obs_mod = jobs
        conf = {}

        def config(K, comm):
            return JSolver(K=K, M=3, U=2, dihgp="matrix_free",
                           curvature=6.0,
                           schedule=JSched(alpha=0.05, beta=0.1),
                           comm=JComm(comm))
    log, keys = [], []

    def key_id(sig):
        if sig not in keys:
            keys.append(sig)
        return keys.index(sig)

    admit, preempt, retire = Bucket.admit, Bucket.preempt, Bucket.retire

    def log_admit(self, slot, spec, prob, resume=None):
        log.append(("resume" if resume is not None else "admit",
                    spec.job_id, key_id(self.signature), int(slot)))
        return admit(self, slot, spec, prob, resume=resume)

    def log_preempt(self, slot):
        log.append(("preempt", self.slots[slot].job_id,
                    key_id(self.signature), int(slot)))
        return preempt(self, slot)

    def log_retire(self, slot, *a, **kw):
        log.append(("retire", self.slots[slot].job_id,
                    key_id(self.signature), int(slot)))
        return retire(self, slot, *a, **kw)

    def spec(s, K, comm="int8+ef", **kw):
        return Spec("quadratic", {"n": 6, "d1": 4, "d2": 8, "seed": s},
                    config(K, comm), seed=s, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(Bucket, "admit", log_admit)
    mp.setattr(Bucket, "preempt", log_preempt)
    mp.setattr(Bucket, "retire", log_retire)
    obs_mod.reset_metrics()
    led = Led(budgets={"acme": 1}, mode="deprioritize")
    loop = Loop(chunk_rounds=T, max_width=2, bucket_width=2, quotas=led,
                hp_mode="traced", **conf)
    try:
        with obs_mod.tracing() as tr:
            loop.submit([spec(0, K_LONG, klass="batch", tenant="acme"),
                         spec(1, K_LONG, klass="batch", tenant="beta")])
            loop.step()
            loop.submit(spec(2, K_SHORT, klass="realtime", tenant="beta"))
            loop.step()
            loop.step()
            # acme is over budget once job0 retires: job3 is clamped
            loop.submit([spec(3, K_SHORT, tenant="acme"),
                         spec(4, K_LONG, tenant="beta"),
                         spec(5, K_SHORT, comm="identity", tenant="acme")])
            loop.pump()
            events = [(e.name, e.args.get("job_id"), e.args.get("slot"))
                      for e in tr.events()
                      if e.dur_us is None and e.name in LIFECYCLE]
        results = {jid: loop.result(jid)
                   for jid in (f"job{i}" for i in range(6))}
    finally:
        mp.undo()
    spent = {t: led.spent(t) for t in ("acme", "beta")}
    out = dict(log=log, events=events, spent=spent, results=results,
               preemptions=obs_mod.counter_value("serve_preemptions_total"),
               buckets=loop.stats.buckets, traces=loop.stats.traces)
    # the process-default tracer and metrics of `repro.obs` outlive this
    # module (`_fresh_obs` resets only the port's): leave them empty for
    # the JAX package's tests that run later in this process
    obs_mod.tracer().clear()
    obs_mod.reset_metrics()
    return out


@pytest.fixture(scope="module")
def schedules():
    return {pkg: _schedule(pkg) for pkg in ("repro", "port")}


def test_lifecycle_sequence_equals_repros(schedules):
    port, ref = schedules["port"], schedules["repro"]
    assert port["log"] == ref["log"]
    assert port["events"] == ref["events"]
    names = [e[0] for e in port["log"]]
    assert "preempt" in names and "resume" in names
    assert port["preemptions"] == ref["preemptions"] >= 1
    # job3 and job5 (acme, over budget) were clamped below every class
    assert port["buckets"] == ref["buckets"] and port["traces"] == 2


def test_tenant_ledger_bytes_equal_repros(schedules):
    port, ref = schedules["port"], schedules["repro"]
    assert port["spent"] == ref["spent"]
    assert port["spent"]["acme"] > 0 and port["spent"]["beta"] > 0
    for jid, r in port["results"].items():
        j = ref["results"][jid]
        assert r.wire_bytes == j.wire_bytes and r.rounds == j.rounds
        assert r.sends == {k: int(v) for k, v in j.sends.items()}


def test_final_iterates_match_repros_reference():
    """The schedule's identity-wire twin: each job of a preempting,
    K-packed loop against `repro.solve(tier="reference")` on the same
    data and y0 (the port's draw for the job's seed), rtol 1e-4 / atol
    1e-5."""
    import jax.numpy as jnp
    from repro.core import problems as jp
    from repro.solve import ScheduleSpec as JSched
    from repro.solve import SolverSpec as JSolver
    from repro.solve import solve as jsolve
    from repro.topology import make_network as j_make_network
    specs = [dataclasses.replace(quad_spec(s, K=k), klass=c)
             for s, k, c in ((0, K_LONG, "batch"), (1, K_LONG, "batch"),
                             (2, K_SHORT, "realtime"))]
    loop = make_loop(bucket_width=2)
    loop.submit(specs[:2])
    loop.step()
    loop.submit(specs[2])
    loop.pump()
    assert obs.counter_value("serve_preemptions_total") == 1.0
    jnet = j_make_network("ring", 6)
    for i, s in enumerate(specs):
        r = loop.result(f"job{i}")
        gen = torch.Generator("cpu").manual_seed(s.seed)
        y0 = 0.01 * torch.randn((6, 8), generator=gen)
        j = jsolve(jp.quadratic_bilevel(6, 4, 8, seed=s.problem["seed"]),
                   jnet, JSolver(K=s.config.K, M=3, U=2,
                                 dihgp="matrix_free", curvature=6.0,
                                 schedule=JSched(alpha=0.05, beta=0.1)),
                   y0=jnp.asarray(y0.numpy()), seed=s.seed)
        np.testing.assert_allclose(r.x.numpy(), np.asarray(j.x),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(r.y.numpy(), np.asarray(j.y),
                                   rtol=RTOL, atol=ATOL)
        assert r.wire_bytes == j.ledger.total_bytes
