"""repro_torch.serve — the multi-tenant batched bilevel solver engine.

Counterpart of `repro.serve`.  `JobSpec`s
(`jobs`) are grouped by signature and padded into fixed-width buckets
(`batching`), then a `ServeEngine` (`engine`) advances each bucket
through job-axis T-round chunks (`repro_torch.core.jobs`): every gossip
of a bucket is one kernel launch for all of its jobs.  Converged jobs
retire mid-flight and queued jobs backfill their slots.  Per-job results
report rounds, convergence, wall-clock share and exact wire bytes from
the bucket ledger's per-slot send counters.

The `admission` subpackage turns the wave-mode engine into an
always-on service: `AdmissionLoop` accepts `submit()` at any time
(jobs join at the next chunk boundary), packs near-miss signatures
that differ only in K into shared buckets, schedules priority/deadline
classes with bit-exact chunk-boundary preemption, and meters
per-tenant wire-byte quotas — `drive_poisson_async` measures its tail
latency on the same seeded schedule as `drive_poisson`.

    from repro_torch.serve import JobSpec, ServeEngine
    eng = ServeEngine(chunk_rounds=10)
    eng.submit([JobSpec("ho_regression", {"n": 8, "d": 16, "seed": s},
                        SolverSpec(K=40, M=5, U=3, dihgp="matrix_free",
                                   curvature=40.0,
                                   schedule=ScheduleSpec(alpha=a, beta=b)))
                for s, (a, b) in enumerate(grid)])
    results = eng.run()
"""
from .batching import (WIDTHS, BucketState, PreemptedState, bucketize,
                       chunk_rounds_for, pad_schedule, pad_width)
from .engine import HP_MODES, EngineStats, ServeEngine, SimulatedCrash
from .jobs import (JobResult, JobSpec, build_network, build_problem,
                   compile_signature, job_hp, pack_signature,
                   schedule_rows, solver_spec)
from .slo import (SLO_QUANTILES, SLOReport, drive_poisson,
                  drive_poisson_async, job_latencies, latency_quantiles,
                  observe_latencies, poisson_arrivals)
from .admission import (AdmissionLoop, AdmissionQueue, DEFAULT_CLASSES,
                        PriorityClass, QuotaExceeded, TenantLedger)

__all__ = [
    "AdmissionLoop", "AdmissionQueue", "BucketState", "DEFAULT_CLASSES",
    "EngineStats", "HP_MODES", "JobResult", "JobSpec", "PreemptedState",
    "PriorityClass", "QuotaExceeded", "SLOReport", "SLO_QUANTILES",
    "ServeEngine", "SimulatedCrash", "TenantLedger", "WIDTHS",
    "bucketize", "build_network",
    "build_problem", "chunk_rounds_for", "compile_signature",
    "drive_poisson", "drive_poisson_async", "job_hp", "job_latencies",
    "latency_quantiles", "observe_latencies", "pack_signature",
    "pad_schedule", "pad_width", "poisson_arrivals", "schedule_rows",
    "solver_spec",
]
