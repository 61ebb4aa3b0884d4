"""ServeEngine — continuous-batched execution of bilevel job fleets.

Counterpart of `repro.serve.engine`.  The scheduling loop per bucket:

    admit jobs into slots ─► one job-axis T-round chunk
         ▲                          │ (runner cache: one build per
         │                          │  bucket runner, ever)
         └── backfill ◄── retire converged / budget-exhausted slots

Every chunk advances *all* slots T outer rounds
(`repro_torch.core.jobs.dagm_run_chunk_jobs`): each gossip of a round
is one kernel launch for every job of the bucket, on the kernels' job
axis.  Converged jobs retire mid-flight at chunk boundaries and queued
jobs backfill their slots.  Per-job results carry the exact wire bytes
from the bucket's per-slot send counters, the rounds actually run, and
the wall-clock share.

Runners and `hp_mode`
---------------------
The port compiles nothing: a bucket's *runner* is a closure over the
bucket's template problem, MixingOp, spec and metrics callback, built
once per cache key (`_chunk_fn`, keyed as `repro`'s compile cache,
LRU-bounded) and counted by an `obs.TraceCounter` where it is built —
the port's "trace".  ``hp_mode="traced"`` (default) hands the chunk's
α/β/γ slices to the runner at each call; ``"static"`` closes over them
and keys the cache on their snapshot, so a new schedule builds a new
runner.  The two give the same bits; "static" changes only the cache
key, as in `repro`.

Crash safety
------------
An engine built with ``checkpoint_dir=...`` persists every chunk
boundary: the device state (states, EF replicas, flight buffer and the
stacked data) through `repro_torch.checkpoint` as an atomic
``step_<chunks>.npz``, and the host state (run order, finished results,
remaining buckets, slot bookkeeping, the channels' host send counters,
stats) in a ``state_<chunks>.pkl`` sidecar.  A new engine pointed at the
same directory resumes the interrupted `run()` bit for bit: the
restored carry is the exact chunk-boundary state.  Device errors are
retried with backoff; a chunk that makes a slot non-finite rolls that
slot back, retires it as quarantined and backfills the slot.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import re
import time
from collections import deque

import numpy as np
import torch

from .. import obs
from .._device import resolve_device, strict_f32
from ..core.jobs import (JobsHP, JobsProblem, dagm_run_chunk_jobs,
                         freeze_inactive)
from ..solve.spec import validate_spec
from ..topology.ops import make_mixing_op

from .batching import (BucketState, bucketize, chunk_rounds_for,
                       pad_width)
from .jobs import (JobResult, JobSpec, Signature, build_network,
                   build_problem, compile_signature, solver_spec)

HP_MODES = ("traced", "static")


class SimulatedCrash(RuntimeError):
    """Raised by the `crash_after_chunks` test hook right after a
    checkpoint lands — a stand-in for kill -9."""


def _no_metrics(prob, W, x, y):
    # the outer step appends hypergrad_est_norm_sq — the engine's
    # convergence signal — on top of whatever the metrics_fn returns;
    # the default serve run records nothing else per round
    return {}


@dataclasses.dataclass
class EngineStats:
    """Aggregate counters across the engine's lifetime."""
    traces: int = 0            # bucket runners built (TraceCounter)
    cache_misses: int = 0      # runner builds (≡ distinct cache keys)
    cache_hits: int = 0        # runner lookups served from cache
    chunks: int = 0            # job-axis chunk invocations
    buckets: int = 0           # bucket flights completed
    jobs_completed: int = 0
    wall_s: float = 0.0        # engine wall time inside run()
    retries: int = 0           # chunk invocations retried after errors
    quarantined: int = 0       # job slots retired by the poison detector
    restarts: int = 0          # run() resumptions from a checkpoint
    checkpoints: int = 0       # chunk-boundary checkpoints written


class ServeEngine:
    """Multi-tenant batched DAGM solver (see module docstring); the
    options are `repro.serve.ServeEngine`'s, plus `device` (CUDA unless
    named; raises without a card)."""

    def __init__(self, chunk_rounds: int = 10, max_width: int = 64,
                 hp_mode: str = "traced", metrics_fn=None,
                 cache_capacity: int = 64,
                 record_metrics: bool = False,
                 checkpoint_dir: str | None = None,
                 checkpoint_every: int = 1, keep_last: int = 3,
                 max_chunk_retries: int = 2,
                 retry_backoff_s: float = 0.05,
                 crash_after_chunks: int | None = None,
                 flight_recorder=None, device=None):
        if hp_mode not in HP_MODES:
            raise ValueError(f"unknown hp_mode {hp_mode!r}; expected "
                             f"one of {HP_MODES}")
        if max_width < 2:
            raise ValueError(
                f"max_width must be >= 2 (got {max_width}): buckets "
                f"are padded to widths of at least 2, as repro's")
        if flight_recorder is not None \
                and not isinstance(flight_recorder, obs.RecorderSpec):
            raise TypeError(
                f"flight_recorder must be a repro_torch.obs.RecorderSpec "
                f"or None, got {type(flight_recorder).__name__}")
        self.device = resolve_device(device)
        self.chunk_rounds = int(chunk_rounds)
        self.max_width = int(max_width)
        self.hp_mode = hp_mode
        self.metrics_fn = metrics_fn if metrics_fn is not None \
            else _no_metrics
        self.record_metrics = bool(record_metrics)
        self.flight_recorder = flight_recorder
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = max(int(checkpoint_every), 1)
        self.keep_last = int(keep_last)
        self.max_chunk_retries = int(max_chunk_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.crash_after_chunks = crash_after_chunks
        self.stats = EngineStats()
        self.ledgers: dict[Signature, object] = {}
        self._queue: list[JobSpec] = []
        self._auto_id = 0
        self._cache: dict[tuple, object] = {}
        self._cache_capacity = int(cache_capacity)
        self._trace_counter = obs.TraceCounter(name="serve_chunk")

    # -- queue -------------------------------------------------------------

    def submit(self, specs) -> list[str]:
        """Enqueue job specs (auto-assigning missing job_ids); returns
        the job ids in submission order.  Specs are validated here, at
        the API edge (see `_validate_submit`)."""
        ids = []
        queued = {spec.job_id for spec in self._queue}
        for spec in ([specs] if isinstance(specs, JobSpec) else
                     list(specs)):
            self._validate_submit(spec)
            if spec.job_id is None:
                spec = dataclasses.replace(
                    spec, job_id=f"job{self._auto_id}")
                self._auto_id += 1
            if spec.job_id in queued:
                raise ValueError(
                    f"duplicate job_id {spec.job_id!r} in queue")
            queued.add(spec.job_id)
            self._queue.append(spec)
            obs.instant("submit", cat="serve.lifecycle",
                        track="engine", job_id=spec.job_id)
            ids.append(spec.job_id)
        self._set_queue_gauge()
        return ids

    def _set_queue_gauge(self) -> None:
        obs.registry().gauge(
            "serve_queue_depth",
            "jobs waiting in the ServeEngine queue").set(
                float(len(self._queue)))

    def _validate_submit(self, spec: JobSpec) -> None:
        sspec = solver_spec(spec)     # TypeError for non-SolverSpecs
        validate_spec(sspec)
        if sspec.method != "dagm":
            raise ValueError(f"serve jobs run method='dagm'; got "
                             f"method={sspec.method!r}")
        if sspec.faults is not None:
            raise ValueError(
                "serve jobs do not thread fault masks yet: a bucket's "
                "runner carries per-slot hyper-parameter operands only, "
                "so a per-job FaultSpec would be silently ignored — run "
                "faulted solves through repro_torch.solve with "
                "tier='reference', or drop SolverSpec.faults")
        T = chunk_rounds_for(sspec.K, self.chunk_rounds)
        if spec.tol is not None and T >= sspec.K \
                and sspec.K > self.chunk_rounds:
            raise ValueError(
                f"JobSpec.tol needs a chunk boundary to retire at, but "
                f"K={sspec.K} and chunk_rounds={self.chunk_rounds} "
                f"share no divisor ≥ 2 — the whole run would be one "
                f"chunk and the tolerance could only fire at the full "
                f"budget; pick K with a small factor (e.g. "
                f"{sspec.K + 1}) or raise chunk_rounds")
        if self.checkpoint_dir is not None and callable(spec.family):
            raise ValueError(
                "a checkpointing engine (checkpoint_dir=...) must be "
                "able to pickle every queued JobSpec, and callable "
                "problem families (repro_torch.solve's inline serve-tier "
                "wrapper) do not survive a restart — use a problem-zoo "
                "family name, or drop checkpoint_dir")

    # -- runner cache ------------------------------------------------------

    def _chunk_fn(self, bucket: BucketState, T: int):
        # keyed as repro's compile cache: the metrics_fn and the flight
        # recorder shape the runner, so they key it too
        key = (bucket.signature, bucket.width, T, self.hp_mode,
               self.metrics_fn, self.flight_recorder)
        if self.hp_mode == "static":
            key += (bucket.hp_key(T),)
        fn = self._cache.get(key)
        if fn is not None:
            self.stats.cache_hits += 1
            self._cache[key] = self._cache.pop(key)   # LRU touch
            return fn
        self.stats.cache_misses += 1
        with obs.span("build_chunk_fn", cat="serve.compile",
                      track="engine", width=bucket.width, rounds=T,
                      hp_mode=self.hp_mode):
            fn = self._build_chunk_fn(bucket, T)
            self.stats.traces = self._trace_counter.bump()
        while len(self._cache) >= self._cache_capacity:
            self._cache.pop(next(iter(self._cache)))  # evict oldest
        self._cache[key] = fn
        return fn

    def _build_chunk_fn(self, bucket: BucketState, T: int):
        # close over a data-free template: the job data always arrives
        # through the `data` argument
        template = bucket.template.with_data(None)
        op, spec = bucket.op, bucket.spec
        metrics_fn = self.metrics_fn
        recorder = self.flight_recorder
        dev = bucket.device

        def tables(hp: dict) -> JobsHP:
            def t(key):
                return torch.as_tensor(np.ascontiguousarray(hp[key].T),
                                       dtype=torch.float32, device=dev)
            curv = None
            if "curvature" in hp:
                curv = torch.as_tensor(hp["curvature"],
                                       dtype=torch.float32, device=dev)
            return JobsHP(alpha=t("alpha"), beta=t("beta"),
                          gamma=t("gamma"), curvature=curv)

        @strict_f32()
        def run(data, hp: JobsHP, carry, active):
            new, metrics = dagm_run_chunk_jobs(
                JobsProblem(template, data), op, spec, carry, T,
                metrics_fn, hp, recorder=recorder)
            return freeze_inactive(
                new, carry, torch.as_tensor(active, device=dev),
                active), metrics

        if self.hp_mode == "static":
            hp_const = tables(bucket.hp_chunk(T))

            def chunk(data, carry, active):
                return run(data, hp_const, carry, active)
        else:
            def chunk(data, hp, carry, active):
                return run(data, tables(hp), carry, active)
        return chunk

    # -- scheduling loop ---------------------------------------------------

    def run(self) -> list[JobResult]:
        """Drain the queue; returns JobResults in submission order.  With
        `checkpoint_dir` set and a checkpoint present, resumes the
        interrupted run first (bit for bit)."""
        t0 = time.perf_counter()
        with obs.span("engine_run", cat="serve", track="engine") as sp:
            ctx = self._restore_run_state()
            if ctx is None:
                queue, self._queue = self._queue, []
                self._set_queue_gauge()
                ctx = {"order": [spec.job_id for spec in queue],
                       "buckets": list(bucketize(queue,
                                                 self.device).values()),
                       "bucket_index": 0, "results": {}, "resume": None}
            while ctx["bucket_index"] < len(ctx["buckets"]):
                items = ctx["buckets"][ctx["bucket_index"]]
                self._run_bucket(items, ctx)
                ctx["bucket_index"] += 1
                ctx["resume"] = None
            self._clear_checkpoints()
            sp.annotate(jobs=len(ctx["order"]),
                        chunks=self.stats.chunks,
                        traces=self._trace_counter.count)
        self.stats.wall_s += time.perf_counter() - t0
        return [ctx["results"][jid] for jid in ctx["order"]]

    def _run_bucket(self, items: list, ctx: dict) -> None:
        results = ctx["results"]
        spec0, prob0 = items[0]
        sig = compile_signature(spec0, prob0)
        sspec = solver_spec(spec0)
        net = build_network(spec0)
        op = make_mixing_op(net, backend=sspec.mixing.backend,
                            dtype=sspec.mixing.dtype,
                            comm=sspec.comm.spec, device=self.device)
        width = pad_width(len(items), self.max_width)
        T = chunk_rounds_for(sspec.K, self.chunk_rounds)
        bucket = BucketState(sig, width, prob0, net, op, sspec,
                             recorder=self.flight_recorder)
        tr = obs.tracer()
        resume = ctx["resume"]
        if resume is None:
            pending = deque(items)
            for slot in range(width):
                if pending:
                    spec_a, prob_a = pending.popleft()
                    bucket.admit(slot, spec_a, prob_a)
                    tr.instant("admit", cat="serve.lifecycle",
                               track="engine", job_id=spec_a.job_id,
                               slot=int(slot))
        else:
            # chunk-boundary restore: host bookkeeping from the sidecar,
            # device state through repro_torch.checkpoint
            from .. import checkpoint as ckpt
            bucket.restore_host(resume["bucket_host"])
            bucket.load_device_tree(ckpt.restore_into(
                ckpt.load_arrays(self.checkpoint_dir, resume["step"]),
                bucket.device_tree()))
            ids = set(resume["pending_ids"])
            pending = deque(it for it in items if it[0].job_id in ids)

        def backfill(bkt, slot):
            if not pending:
                return False
            spec_b, prob_b = pending.popleft()
            bkt.admit(slot, spec_b, prob_b)
            tr.instant("admit", cat="serve.lifecycle", track="engine",
                       job_id=spec_b.job_id, slot=int(slot),
                       backfill=True)
            return True

        inflight = obs.registry().gauge(
            "serve_inflight_jobs",
            "active slots in the currently running bucket")
        while bucket.any_active():
            inflight.set(float(bucket.active.sum()))
            self._advance_bucket(bucket, T, results, backfill)
            self._maybe_checkpoint(bucket, ctx, pending)
        inflight.set(0.0)
        self._finalize_ledger(bucket)
        self.stats.buckets += 1

    def _advance_bucket(self, bucket: BucketState, T: int,
                        results: dict, backfill) -> None:
        """One T-round chunk + the boundary processing that follows:
        poison quarantine, rounds/wall/metrics accounting, retirement
        of converged/budget-exhausted slots, and backfill."""
        tr = obs.tracer()
        fn = self._chunk_fn(bucket, T)
        prev_carry = bucket.carry
        active = bucket.active.copy()
        t0 = time.perf_counter()
        with tr.span("chunk", cat="serve.chunk", track="engine",
                     rounds=T, width=bucket.width,
                     active=int(active.sum())) as chunk_sp:
            if self.hp_mode == "static":
                args = (bucket.data, bucket.carry, active)
            else:
                args = (bucket.data, bucket.hp_chunk(T), bucket.carry,
                        active)
            carry, metrics = self._invoke_chunk(fn, args)
            # the boundary reads each slot's last gap (one sync a chunk)
            gaps = metrics["hypergrad_est_norm_sq"][-1].cpu().numpy()
            chunk_sp.annotate(traces=self._trace_counter.count)
        dt = time.perf_counter() - t0
        self.stats.chunks += 1
        bucket.carry = carry

        ran = active
        bad = self._poisoned_slots(bucket)
        if bad.any():
            self._quarantine(bucket, prev_carry, bad, results, backfill)
        # freshly backfilled slots (quarantine replacements) start at
        # the next chunk; only surviving runners earn this one
        slots = np.nonzero(ran & ~bad)[0]
        bucket.rounds[slots] += T
        bucket.wall[slots] += dt / max(len(slots), 1)
        if self.record_metrics:
            host = {k: v.cpu().numpy() for k, v in metrics.items()}
            for slot in slots:
                bucket.metric_log[slot].append(
                    {k: v[:, slot] for k, v in host.items()})
        for slot in slots:
            spec = bucket.slots[slot]
            converged = spec.tol is not None \
                and float(gaps[slot]) <= spec.tol
            if converged or bucket.rounds[slot] >= bucket.budget[slot]:
                rec = bucket.retire(slot, float(gaps[slot]), converged)
                tr.instant("retire", cat="serve.lifecycle",
                           track="engine", job_id=rec.spec.job_id,
                           slot=int(slot), rounds=rec.rounds,
                           converged=rec.converged)
                result = self._make_result(bucket, rec)
                results[rec.spec.job_id] = result
                self.stats.jobs_completed += 1
                self._on_retired(rec, result)
                backfill(bucket, slot)

    def _on_retired(self, rec, result: JobResult) -> None:
        """Retirement hook (wave mode: nothing beyond the results dict
        the caller already owns)."""

    # -- fault tolerance ---------------------------------------------------

    def _invoke_chunk(self, fn, args):
        """Run one chunk, retrying device/runtime errors with exponential
        backoff (a ValueError/TypeError is a bug and raises at once)."""
        attempt = 0
        while True:
            try:
                out = fn(*args)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                return out
            except (RuntimeError, OSError) as e:
                if attempt >= self.max_chunk_retries:
                    raise
                self.stats.retries += 1
                obs.instant("retry", cat="serve.lifecycle",
                            track="engine", attempt=attempt,
                            error=type(e).__name__)
                time.sleep(self.retry_backoff_s * (2.0 ** attempt))
                attempt += 1

    def _poisoned_slots(self, bucket: BucketState) -> np.ndarray:
        """(width,) bool: active slots whose post-chunk iterates went
        non-finite."""
        (x, y) = bucket.carry[0]
        finite = (torch.isfinite(x).all(dim=2).all(dim=0)
                  & torch.isfinite(y).all(dim=2).all(dim=0))
        return bucket.active & ~finite.cpu().numpy()

    def _quarantine(self, bucket: BucketState, prev_carry, bad,
                    results: dict, backfill) -> None:
        """Roll the poisoned slots back to their pre-chunk state (the
        other tenants keep the chunk's results), retire them as
        quarantined and backfill."""
        keep = ~bad
        bucket.carry = freeze_inactive(
            bucket.carry, prev_carry,
            torch.as_tensor(keep, device=bucket.device), keep)
        for slot in np.nonzero(bad)[0]:
            rec = bucket.retire(slot, float("nan"), False,
                                quarantined=True)
            obs.instant("quarantine", cat="serve.lifecycle",
                        track="engine", job_id=rec.spec.job_id,
                        slot=int(slot), rounds=rec.rounds)
            result = self._make_result(bucket, rec)
            results[rec.spec.job_id] = result
            self.stats.quarantined += 1
            self._on_retired(rec, result)
            backfill(bucket, slot)

    # -- crash checkpoints (repro_torch.checkpoint) ------------------------

    def _state_path(self, step: int) -> str:
        return os.path.join(self.checkpoint_dir, f"state_{step:08d}.pkl")

    def _maybe_checkpoint(self, bucket: BucketState, ctx: dict,
                          pending: deque) -> None:
        if self.checkpoint_dir is None:
            return
        if self.stats.chunks % self.checkpoint_every == 0:
            with obs.span("checkpoint", cat="serve.checkpoint",
                          track="engine", step=self.stats.chunks):
                self._save_run_state(bucket, ctx, pending)
        if self.crash_after_chunks is not None \
                and self.stats.chunks >= self.crash_after_chunks:
            raise SimulatedCrash(
                f"crash_after_chunks hook fired at chunk "
                f"{self.stats.chunks}")

    def _save_run_state(self, bucket: BucketState, ctx: dict,
                        pending: deque) -> None:
        from .. import checkpoint as ckpt
        step = self.stats.chunks
        ckpt.save_checkpoint(self.checkpoint_dir, step,
                             bucket.device_tree(), keep_last=self.keep_last)
        host = {
            "format": 1,
            "engine": {"chunk_rounds": self.chunk_rounds,
                       "hp_mode": self.hp_mode},
            "order": ctx["order"],
            "results": ctx["results"],
            "bucket_index": ctx["bucket_index"],
            "bucket_specs": [[spec for spec, _ in items]
                             for items in ctx["buckets"]],
            "pending_ids": [spec.job_id for spec, _ in pending],
            "bucket_host": bucket.snapshot_host(),
            "stats": {"chunks": self.stats.chunks,
                      "jobs_completed": self.stats.jobs_completed,
                      "retries": self.stats.retries,
                      "quarantined": self.stats.quarantined,
                      "restarts": self.stats.restarts,
                      "checkpoints": self.stats.checkpoints + 1},
            "auto_id": self._auto_id,
        }
        tmp = self._state_path(step) + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(host, f)
        os.replace(tmp, self._state_path(step))
        self.stats.checkpoints += 1
        kept = {f"state_{s:08d}.pkl" for s in
                ckpt.checkpoint_steps(self.checkpoint_dir)}
        for f in os.listdir(self.checkpoint_dir):
            if re.fullmatch(r"state_\d+\.pkl", f) and f not in kept:
                os.remove(os.path.join(self.checkpoint_dir, f))

    def _restore_run_state(self) -> dict | None:
        if self.checkpoint_dir is None:
            return None
        from .. import checkpoint as ckpt
        ckpt.sweep_stale(self.checkpoint_dir)
        host, step = None, None
        for s in reversed(ckpt.checkpoint_steps(self.checkpoint_dir)):
            # a crash between the npz and its sidecar leaves a torn
            # step — fall back to the newest complete pair
            if os.path.exists(self._state_path(s)):
                with open(self._state_path(s), "rb") as f:
                    host = pickle.load(f)
                step = s
                break
        if host is None:
            return None
        eng = host["engine"]
        if eng["chunk_rounds"] != self.chunk_rounds \
                or eng["hp_mode"] != self.hp_mode:
            raise ValueError(
                f"checkpoint at {self.checkpoint_dir!r} was written by "
                f"an engine with chunk_rounds={eng['chunk_rounds']}, "
                f"hp_mode={eng['hp_mode']!r}; this engine has "
                f"chunk_rounds={self.chunk_rounds}, "
                f"hp_mode={self.hp_mode!r} — bit-exact resumption "
                f"needs identical chunking, construct the resuming "
                f"engine to match")
        for k, v in host["stats"].items():
            setattr(self.stats, k, v)
        self.stats.restarts += 1
        self._auto_id = max(self._auto_id, host["auto_id"])
        ctx = {
            "order": list(host["order"]),
            "buckets": [[(s, build_problem(s, self.device)) for s in specs]
                        for specs in host["bucket_specs"]],
            "bucket_index": host["bucket_index"],
            "results": dict(host["results"]),
            "resume": {"step": step,
                       "bucket_host": host["bucket_host"],
                       "pending_ids": host["pending_ids"]},
        }
        if self._queue:                      # jobs queued before resume
            queue, self._queue = self._queue, []
            ctx["order"] += [spec.job_id for spec in queue]
            ctx["buckets"] += list(bucketize(queue, self.device).values())
        return ctx

    def _clear_checkpoints(self) -> None:
        """A completed run owes the disk nothing: drop every step and
        sidecar so the next run() starts fresh instead of resuming."""
        if self.checkpoint_dir is None \
                or not os.path.isdir(self.checkpoint_dir):
            return
        from .. import checkpoint as ckpt
        ckpt.sweep_stale(self.checkpoint_dir)
        for s in ckpt.checkpoint_steps(self.checkpoint_dir):
            os.remove(os.path.join(self.checkpoint_dir,
                                   f"step_{s:08d}.npz"))
        for f in os.listdir(self.checkpoint_dir):
            if re.fullmatch(r"state_\d+\.pkl", f):
                os.remove(os.path.join(self.checkpoint_dir, f))

    # -- accounting --------------------------------------------------------

    def _make_result(self, bucket: BucketState, rec) -> JobResult:
        chans = bucket.op.ledger.channels
        wire_bytes = sum(sends * chans[name].bytes_per_send
                         for name, sends in rec.sends.items())
        wire_floats = sum(sends * chans[name].floats_per_send
                          for name, sends in rec.sends.items())
        return JobResult(
            job_id=rec.spec.job_id, x=rec.x, y=rec.y, rounds=rec.rounds,
            converged=rec.converged, final_gap=rec.final_gap,
            wire_bytes=int(wire_bytes), wire_floats=int(wire_floats),
            sends=dict(rec.sends), wall_clock_s=rec.wall_s,
            signature=bucket.signature, metrics=rec.metrics,
            quarantined=rec.quarantined, flight=rec.flight)

    def _finalize_ledger(self, bucket: BucketState) -> None:
        """Charge the bucket ledger with per-job send arrays (ordered by
        retirement) so `CommLedger.per_job_bytes` attributes exact
        traffic and the total is their sum."""
        for name in bucket.op.ledger.channels:
            bucket.op.ledger.charge(name, np.asarray(
                [rec.sends[name] for rec in bucket.retired], np.int64))
        self.ledgers[bucket.signature] = bucket.op.ledger
