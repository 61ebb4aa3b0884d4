"""SLO layer — Poisson arrival driving and latency accounting.

A copy of `repro.serve.slo` on the port's engine, admission loop and
`repro_torch.obs`.

The engine's batch interface (`submit` everything, one `run()`) answers
"jobs per second" but not the question an always-on hyperopt service is
judged on: *what latency does the p99 tenant see when jobs arrive at
random?*  This module closes that gap without touching the engine's
scheduling loop:

* `poisson_arrivals` draws a Poisson arrival process (i.i.d.
  exponential inter-arrival gaps, seeded, reproducible);
* `drive_poisson` replays job specs against a live `ServeEngine` on
  that schedule — due jobs are submitted the moment the driver observes
  their arrival time, and the engine runs in waves whenever its queue
  is non-empty (jobs landing while a wave is in flight queue up and are
  submitted at the next wave boundary, exactly how a service front-end
  batches admissions);
* `job_latencies` pairs the **already-emitted** submit/retire lifecycle
  instants from the tracer by `job_id` — no second bookkeeping channel,
  the latency a tenant experiences is literally the distance between
  two trace events;
* `drive_poisson_async` offers the same seeded schedule to an
  always-on `admission.AdmissionLoop`: no wave barrier;
* `observe_latencies` publishes the distribution into the metrics
  registry: a `serve_job_latency_seconds` histogram plus p50/p99
  gauges, next to the queue-depth / in-flight gauges the engine itself
  maintains.

"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Sequence

import numpy as np

from .. import obs

#: Quantiles every report publishes (p50 = median, p99 = SLO tail).
SLO_QUANTILES = (0.5, 0.99)


def poisson_arrivals(n: int, rate_hz: float, seed: int = 0) -> np.ndarray:
    """Arrival offsets (seconds from the stream start) of `n` jobs from
    a Poisson process with intensity `rate_hz`: cumulative sums of
    i.i.d. Exp(rate) inter-arrival gaps, nondecreasing, reproducible
    per seed."""
    if n < 0:
        raise ValueError(f"need a non-negative job count (got {n})")
    if not rate_hz > 0:
        raise ValueError(
            f"rate_hz must be a positive arrival intensity "
            f"(got {rate_hz})")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(scale=1.0 / float(rate_hz), size=int(n))
    return np.cumsum(gaps)


def job_latencies(events, *, start: str = "submit",
                  end: str = "retire",
                  since: float | None = None) -> dict[str, float]:
    """Pair lifecycle instants by `args["job_id"]` → latency seconds.

    `events` is a `Tracer` or a raw SpanEvent list.  The first `start`
    instant and the first `end` instant per job id win (job ids are
    unique per engine run); jobs with no `end` yet are simply absent —
    the caller decides whether in-flight jobs matter.  `since` (tracer
    µs, compare `Tracer.now_us`) ignores instants recorded before it —
    how a long-lived service's driver scopes one measurement window out
    of an always-on tracer without clearing it."""
    if hasattr(events, "events"):
        events = events.events()
    starts: dict[str, float] = {}
    ends: dict[str, float] = {}
    for ev in events:
        if ev.dur_us is not None or "job_id" not in ev.args:
            continue
        if since is not None and ev.ts_us < since:
            continue
        jid = ev.args["job_id"]
        if ev.name == start and jid not in starts:
            starts[jid] = ev.ts_us
        elif ev.name == end and jid not in ends:
            ends[jid] = ev.ts_us
    return {jid: (ends[jid] - starts[jid]) * 1e-6
            for jid in ends if jid in starts}


def latency_quantiles(latencies_s,
                      qs: Sequence[float] = SLO_QUANTILES
                      ) -> dict[float, float]:
    """{q: quantile seconds} with numpy's default linear interpolation
    (deterministic, exact against hand-computed schedules in the
    tests).  Raises on an empty sample — a service with zero retired
    jobs has no latency, and silently reporting 0.0 would read as a
    perfect SLO."""
    vals = np.asarray(list(latencies_s), dtype=np.float64)
    if vals.size == 0:
        raise ValueError(
            "no completed jobs to take latency quantiles over")
    return {float(q): float(np.quantile(vals, q)) for q in qs}


def observe_latencies(latencies_s, reg=None, **labels) -> dict[float, float]:
    """Publish the latency distribution into `reg` (default registry):
    every sample into the `serve_job_latency_seconds` histogram and the
    `SLO_QUANTILES` into `serve_job_latency_p{50,99}_seconds` gauges.
    Returns the quantile dict."""
    reg = reg or obs.registry()
    vals = [float(v) for v in latencies_s]
    hist = reg.histogram(
        "serve_job_latency_seconds",
        "submit→retire latency of completed serve jobs")
    child = hist.labels(**labels)
    for v in vals:
        child.observe(v)
    quants = latency_quantiles(vals)
    for q, v in quants.items():
        pct = int(round(q * 100))
        reg.gauge(
            f"serve_job_latency_p{pct}_seconds",
            f"p{pct} submit→retire latency of completed serve jobs"
        ).labels(**labels).set(v)
    return quants


@dataclasses.dataclass
class SLOReport:
    """What one Poisson-driven engine session measured."""
    jobs: int                     # specs offered to the stream
    retired: int                  # jobs that produced a retire instant
    wall_s: float                 # driver wall clock, first submit→drain
    rate_hz: float                # offered arrival intensity
    waves: int                    # engine.run() invocations
    peak_queue_depth: int         # max queued jobs at a wave boundary
    latencies_s: np.ndarray       # per-retired-job submit→retire seconds
    p50_s: float
    p99_s: float
    throughput_jobs_s: float      # retired / wall
    results: list                 # JobResults in completion-wave order

    def as_record(self) -> dict:
        """JSON-safe dict for `obs.MetricsJsonlWriter.write_record` —
        the whole report minus `results` (JobResults hold tensors; the
        metrics sink wants numbers), latencies as a plain list."""
        rec = {f.name: getattr(self, f.name)
               for f in dataclasses.fields(self)
               if f.name != "results"}
        rec["latencies_s"] = [float(v) for v in self.latencies_s]
        rec["kind"] = "slo_report"
        return rec


def drive_poisson(engine, specs: Iterable, rate_hz: float,
                  seed: int = 0, reg=None, **labels) -> SLOReport:
    """Offer `specs` to `engine` on a Poisson arrival schedule and
    report tail latency.

    Runs inside `obs.tracing()` (enabling the default tracer for the
    duration) so the engine's own submit/retire instants exist to be
    paired; latency is computed *only* from those instants.  The driver
    loop alternates between submitting every due spec and draining the
    queue with `engine.run()` — a wave in flight delays the next
    admissions to the wave boundary, and that queueing delay is part of
    the measured latency, as it would be for a real tenant."""
    specs = list(specs)
    arrivals = poisson_arrivals(len(specs), rate_hz, seed)
    results: list = []
    submitted: list[str] = []
    waves = 0
    peak_queue = 0
    with obs.tracing() as tr:
        t0 = time.perf_counter()
        i = 0
        while i < len(specs) or engine._queue:
            now = time.perf_counter() - t0
            while i < len(specs) and arrivals[i] <= now:
                ids = engine.submit(specs[i])
                for jid in ids:
                    tr.instant("arrival", cat="serve.slo", track="load",
                               job_id=jid,
                               scheduled_s=float(arrivals[i]))
                submitted.extend(ids)
                i += 1
            peak_queue = max(peak_queue, len(engine._queue))
            if engine._queue:
                results.extend(engine.run())
                waves += 1
            elif i < len(specs):
                time.sleep(min(max(arrivals[i] - now, 0.0), 0.05))
        wall = time.perf_counter() - t0
        lat = job_latencies(tr.events())
    vals = np.array([lat[jid] for jid in submitted if jid in lat])
    quants = observe_latencies(vals, reg=reg, **labels)
    reg = reg or obs.registry()
    reg.gauge(
        "serve_peak_queue_depth",
        "max queued jobs observed at a Poisson wave boundary"
    ).labels(**labels).set(float(peak_queue))
    return SLOReport(
        jobs=len(specs), retired=int(vals.size), wall_s=wall,
        rate_hz=float(rate_hz), waves=waves,
        peak_queue_depth=peak_queue, latencies_s=vals,
        p50_s=quants[0.5], p99_s=quants[0.99],
        throughput_jobs_s=float(vals.size) / max(wall, 1e-9),
        results=results)


def drive_poisson_async(loop, specs: Iterable, rate_hz: float,
                        seed: int = 0, reg=None,
                        **labels) -> SLOReport:
    """`drive_poisson` against an `admission.AdmissionLoop`: the SAME
    seeded arrival schedule, but jobs are submitted to the always-on
    loop the moment they arrive and join buckets at the next chunk
    boundary — no wave barrier, so a job's latency no longer includes
    waiting out every earlier arrival's full run.  `waves` is 0 by
    construction; the before/after against `drive_poisson` on the same
    schedule is the admission loop's headline number."""
    specs = list(specs)
    arrivals = poisson_arrivals(len(specs), rate_hz, seed)
    submitted: list[str] = []
    peak_queue = 0
    own_thread = not loop.running
    with obs.tracing() as tr:
        since = tr.now_us()
        if own_thread:
            loop.start()
        try:
            t0 = time.perf_counter()
            for i, spec in enumerate(specs):
                wait = arrivals[i] - (time.perf_counter() - t0)
                if wait > 0:
                    time.sleep(wait)
                ids = loop.submit(spec)
                for jid in ids:
                    tr.instant("arrival", cat="serve.slo", track="load",
                               job_id=jid,
                               scheduled_s=float(arrivals[i]))
                submitted.extend(ids)
                peak_queue = max(peak_queue, len(loop.queue))
            results = [loop.result(jid) for jid in submitted]
            wall = time.perf_counter() - t0
        finally:
            if own_thread:
                loop.stop()
        lat = job_latencies(tr.events(), since=since)
    vals = np.array([lat[jid] for jid in submitted if jid in lat])
    quants = observe_latencies(vals, reg=reg, **labels)
    reg = reg or obs.registry()
    reg.gauge(
        "serve_peak_queue_depth",
        "max queued jobs observed at a Poisson wave boundary"
    ).labels(**labels).set(float(peak_queue))
    return SLOReport(
        jobs=len(specs), retired=int(vals.size), wall_s=wall,
        rate_hz=float(rate_hz), waves=0,
        peak_queue_depth=peak_queue, latencies_s=vals,
        p50_s=quants[0.5], p99_s=quants[0.99],
        throughput_jobs_s=float(vals.size) / max(wall, 1e-9),
        results=results)
