"""AdmissionLoop — ServeEngine as a long-lived always-on service.

Counterpart of `repro.serve.admission.loop`.  The wave-mode engine
drains a static queue: jobs submitted after `run()` starts wait for the
whole wave (`drive_poisson` measures exactly that queueing delay).
`AdmissionLoop` keeps the same bucket runners, the same `BucketState`
slot mechanics and the same per-job accounting, but never runs in waves:

* **async admission** — `submit()` is callable at any time (any
  thread), including while buckets are mid-chunk.  Accepted jobs enter
  an `AdmissionQueue` and join a bucket at the *next chunk boundary*
  through the engine's backfill path, so admission costs one
  `dagm_init_carry` + slot write, never a runner build or a wave
  restart (one build per bucket key, ever: `EngineStats.traces`).
* **bucket packing** — with ``packing=True`` (default) buckets key on
  `pack_signature` (the compile signature with K replaced by a
  sentinel): jobs differing only in round budget share one bucket and
  one runner, each slot retiring at its own budget at a chunk boundary
  (`admission.packing` for the exactness argument).
* **priority / deadline classes** — the queue drains priority-first,
  earliest-deadline within a priority; a strictly-higher-priority
  arrival may preempt a running preemptible slot at a chunk boundary.
  The victim's carry is lifted out bit-exactly (`BucketState.preempt`:
  iterates, EF replicas, the channels' host send counters and seeds),
  spooled through `repro_torch.checkpoint` when checkpointing is on,
  and the job re-enters the queue to resume where it stopped — no
  rounds are re-run, and the final result is bit-identical to an
  uninterrupted run.
* **tenant quotas** — `quotas.TenantLedger` meters the exact ledger
  bytes each tenant's retired jobs moved; over-budget tenants are
  rejected at `submit()` or deprioritized below every class.

Drive it synchronously (`submit` + `pump()`/`run()`/`step()`) or as a
service: `start()` spawns a scheduler thread, `result(job_id)` /
`as_completed(ids)` deliver results as they retire, `stop()` drains
and joins.  The scheduler thread launches every kernel of the buckets
it advances, on its own current stream (the wrappers read the stream
at launch); the first launch builds the kernel library once, under the
build lock.  An exception there ends the thread and reaches `result()`
and `stop()` as a RuntimeError, so no job is reported finished that did
not retire.  With `checkpoint_dir` set the loop checkpoints every chunk
boundary — device state of ALL live buckets plus a `loop_*.pkl` sidecar
holding the admission queue (queued-but-unadmitted jobs survive a kill
-9) — and, by default, opens a `StreamingTraceWriter` plus
`MetricsJsonlWriter` under `<checkpoint_dir>/telemetry` so the
always-on service emits rotating Perfetto segments and metrics
snapshots without caller plumbing (`telemetry=False` opts out).
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import re
import shutil
import threading
import time
from typing import Any, Iterator

import numpy as np

from ... import obs
from ...core.dagm import dagm_init_carry
from ...topology.ops import make_mixing_op

from ..batching import BucketState, PreemptedState, _host_slot, pad_width
from ..engine import ServeEngine, SimulatedCrash
from ..jobs import (JobResult, JobSpec, build_network, build_problem,
                    compile_signature, pack_signature, solver_spec)
from .classes import (DEFAULT_CLASSES, PriorityClass, admission_key,
                      resolve_class)
from .packing import compatible, plan_bucket
from .quotas import TenantLedger


@dataclasses.dataclass
class QueueEntry:
    """One queued (or preempted-and-requeued) job."""
    seq: int                      # submission order (stable tie-break)
    spec: JobSpec
    prob: Any                     # built problem (signature needs it)
    klass: PriorityClass
    priority: int                 # effective (quota may deprioritize)
    deadline_abs: float | None    # absolute monotonic deadline
    key: tuple                    # bucket key (pack/compile signature)
    budget: int                   # solver_spec(spec).K
    resume: PreemptedState | None = None

    @property
    def rounds_done(self) -> int:
        return 0 if self.resume is None else int(self.resume.rounds)

    @property
    def remaining(self) -> int:
        return self.budget - self.rounds_done

    def order_key(self) -> tuple:
        return admission_key(self.priority, self.deadline_abs, self.seq)


class AdmissionQueue:
    """Priority/deadline-ordered wait queue (see `classes`).

    Deliberately a plain list + sort-on-demand: service queues are
    tens of entries, the scheduler scans them with bucket-compatibility
    predicates anyway, and a heap cannot remove by predicate."""

    def __init__(self):
        self._entries: list[QueueEntry] = []

    def push(self, entry: QueueEntry) -> None:
        self._entries.append(entry)

    def ordered(self) -> list[QueueEntry]:
        """Drain-order snapshot: priority desc, deadline asc, seq asc."""
        return sorted(self._entries, key=QueueEntry.order_key)

    def remove(self, entry: QueueEntry) -> None:
        self._entries.remove(entry)

    def pop_next(self, pred) -> QueueEntry | None:
        """Remove and return the first entry (in drain order) matching
        `pred`, or None."""
        for entry in self.ordered():
            if pred(entry):
                self._entries.remove(entry)
                return entry
        return None

    def job_ids(self) -> list[str]:
        return [e.spec.job_id for e in self.ordered()]

    def __iter__(self):
        return iter(list(self._entries))

    def __len__(self) -> int:
        return len(self._entries)

    def __bool__(self) -> bool:
        return bool(self._entries)


@dataclasses.dataclass
class _LiveBucket:
    """One in-flight bucket plus the admission metadata the engine's
    BucketState deliberately doesn't know about."""
    bucket: BucketState
    T: int                        # chunk rounds this bucket advances by
    key: tuple
    rep: JobSpec                  # representative spec (rebuild recipe)
    entries: list                 # per-slot QueueEntry | None (class/
    #                               tenant metadata for preemption)


class AdmissionLoop(ServeEngine):
    """Always-on async admission service over the serve engine.

    Engine kwargs pass through (`chunk_rounds`, `hp_mode`,
    `checkpoint_dir`, `record_metrics`, ...).  Loop-specific:

    classes:      {name: PriorityClass} table (`DEFAULT_CLASSES`).
    quotas:       `TenantLedger` metering wire bytes per tenant (None
                  = unmetered).
    packing:      bucket near-miss K-packing (default on; see
                  `admission.packing`).
    bucket_width: fixed slot count per bucket (padded to a power of
                  two, default `max_width`).  Fixed — not sized per
                  wave — so the runner's width never varies and the
                  runner cache serves the service's whole lifetime:
                  admission must not defeat the cache.
    telemetry:    with `checkpoint_dir` set, auto-open rotating trace +
                  metrics writers under `<checkpoint_dir>/telemetry`.
    idle_wait_s:  scheduler-thread poll interval while idle.
    """

    def __init__(self, *, classes: dict | None = None,
                 quotas: TenantLedger | None = None,
                 packing: bool = True,
                 bucket_width: int | None = None,
                 telemetry: bool = True,
                 idle_wait_s: float = 0.02, **engine_kwargs):
        super().__init__(**engine_kwargs)
        self.classes = dict(DEFAULT_CLASSES if classes is None
                            else classes)
        if quotas is not None and not isinstance(quotas, TenantLedger):
            raise TypeError(
                f"quotas must be an admission.TenantLedger or None, "
                f"got {type(quotas).__name__}")
        self.quotas = quotas
        self.packing = bool(packing)
        self.bucket_width = pad_width(
            bucket_width if bucket_width is not None else self.max_width,
            self.max_width)
        self.telemetry = bool(telemetry)
        self.idle_wait_s = float(idle_wait_s)
        self.queue = AdmissionQueue()
        self._live: dict[tuple, _LiveBucket] = {}
        self._results: dict[str, JobResult] = {}
        self._done: dict[str, threading.Event] = {}
        self._known: set[str] = set()
        self._order: list[str] = []       # run()-compat pending ids
        self._seq = 0
        self._preempt_seq = 0
        self._lock = threading.RLock()
        self._wake = threading.Condition(self._lock)
        self._thread: threading.Thread | None = None
        self._stopping = False
        self._error: BaseException | None = None
        self._trace_writer = None
        self._metrics_writer = None
        self._prev_trace_enabled: bool | None = None
        self._ckpt_dirty = False
        self._restore_pending = self.checkpoint_dir is not None

    # -- submission ----------------------------------------------------------

    def submit(self, specs) -> list[str]:
        """Enqueue specs — callable at ANY time, from any thread,
        including while buckets are in flight.  Admission happens at
        the next chunk boundary; quota rejection (`QuotaExceeded`)
        happens here, before the job enters the queue."""
        specs = [specs] if isinstance(specs, JobSpec) else list(specs)
        ids: list[str] = []
        with self._wake:
            self._maybe_restore()
            self._open_telemetry()   # the submit instant must be seen
            for spec in specs:
                self._validate_submit(spec)
                klass = resolve_class(self.classes, spec.klass)
                if spec.job_id is None:
                    spec = dataclasses.replace(
                        spec, job_id=f"job{self._auto_id}")
                    self._auto_id += 1
                if spec.job_id in self._known:
                    raise ValueError(
                        f"duplicate job_id {spec.job_id!r}: the loop "
                        f"already knows this id (queued, running or "
                        f"finished)")
                priority = klass.priority
                if self.quotas is not None:
                    priority = self.quotas.admit(spec.tenant, priority)
                prob = build_problem(spec, self.device)
                deadline = None if klass.deadline_s is None \
                    else time.monotonic() + klass.deadline_s
                self.queue.push(QueueEntry(
                    seq=self._seq, spec=spec, prob=prob, klass=klass,
                    priority=priority, deadline_abs=deadline,
                    key=self._bucket_key(spec, prob),
                    budget=solver_spec(spec).K))
                self._seq += 1
                self._known.add(spec.job_id)
                self._done[spec.job_id] = threading.Event()
                self._order.append(spec.job_id)
                obs.instant("submit", cat="serve.lifecycle",
                            track="engine", job_id=spec.job_id,
                            klass=klass.name, tenant=spec.tenant)
                ids.append(spec.job_id)
            self._set_queue_gauge()
            self._wake.notify_all()
        return ids

    def _bucket_key(self, spec: JobSpec, prob) -> tuple:
        return pack_signature(spec, prob) if self.packing \
            else compile_signature(spec, prob)

    def _set_queue_gauge(self) -> None:
        obs.registry().gauge(
            "serve_queue_depth",
            "jobs waiting in the ServeEngine queue").set(
                float(len(self.queue)))

    # -- the scheduling tick ---------------------------------------------------

    def step(self) -> bool:
        """One scheduling tick: admit due entries (opening/preempting
        as needed), advance every live bucket one chunk, retire/
        backfill at the boundary, reap drained buckets, checkpoint.
        Returns whether any work happened (False = the loop is idle)."""
        with self._lock:
            self._maybe_restore()
            self._open_telemetry()
            worked = self._admit_phase()
            inflight = obs.registry().gauge(
                "serve_inflight_jobs",
                "active slots in the currently running bucket")
            for live in list(self._live.values()):
                if not live.bucket.any_active():
                    continue
                inflight.set(float(sum(
                    int(lb.bucket.active.sum())
                    for lb in self._live.values())))
                self._advance_bucket(live.bucket, live.T,
                                     self._results,
                                     self._backfill_for(live))
                worked = True
                self._maybe_checkpoint_loop()
            self._reap_idle()
            inflight.set(float(sum(
                int(lb.bucket.active.sum())
                for lb in self._live.values())))
            if not worked and self._ckpt_dirty and not self.queue \
                    and not self._live:
                self._clear_loop_checkpoints()
            return worked

    def pump(self) -> None:
        """Drive the loop synchronously until idle (queue empty, no
        active slots) — the single-threaded way to drain it."""
        with self._lock:
            while self.step():
                pass

    def run(self) -> list[JobResult]:
        """ServeEngine-compat drain: results of every job submitted
        since the last `run()`, in submission order.  Synchronous when
        no scheduler thread is running; otherwise waits on the
        thread."""
        with self._lock:
            order, self._order = list(self._order), []
        if self._thread is None:
            self.pump()
        return [self.result(jid) for jid in order]

    # -- admission / preemption ------------------------------------------------

    def _admit_phase(self) -> bool:
        admitted = False
        for entry in self.queue.ordered():
            live = self._live.get(entry.key)
            if live is None:
                live = self._open_bucket(entry)
            slot = self._find_slot(live, entry)
            if slot is None:
                continue
            self.queue.remove(entry)
            self._admit_entry(live, slot, entry)
            admitted = True
        if admitted:
            self._set_queue_gauge()
        return admitted

    def _open_bucket(self, entry: QueueEntry) -> _LiveBucket:
        peers = [e for e in self.queue.ordered() if e.key == entry.key]
        T, K_max, _ = plan_bucket(peers, self.chunk_rounds)
        spec0, prob0 = entry.spec, entry.prob
        sspec = solver_spec(spec0)
        net = build_network(spec0)
        op = make_mixing_op(net, backend=sspec.mixing.backend,
                            dtype=sspec.mixing.dtype,
                            comm=sspec.comm.spec, device=self.device)
        bucket = BucketState(entry.key, self.bucket_width, prob0, net,
                             op, sspec, recorder=self.flight_recorder,
                             bucket_K=K_max)
        live = _LiveBucket(bucket=bucket, T=T, key=entry.key,
                           rep=spec0,
                           entries=[None] * self.bucket_width)
        self._live[entry.key] = live
        obs.instant("open_bucket", cat="serve.admission",
                    track="admission", width=self.bucket_width,
                    chunk_rounds=T, bucket_K=K_max)
        self._set_bucket_gauge()
        return live

    def _find_slot(self, live: _LiveBucket,
                   entry: QueueEntry) -> int | None:
        if not compatible(entry.remaining, live.T, live.bucket.K,
                          entry.budget):
            return None
        free = np.nonzero(~live.bucket.active)[0]
        if free.size:
            return int(free[0])
        return self._preempt_for(live, entry)

    def _preempt_for(self, live: _LiveBucket,
                     entry: QueueEntry) -> int | None:
        """Evict the weakest strictly-lower-priority preemptible slot
        for `entry` (least progressed among the lowest class — the
        cheapest wall-clock to set aside).  Chunk boundaries only: the
        caller holds the loop between chunks by construction."""
        best = None
        for slot, occ in enumerate(live.entries):
            if occ is None or not live.bucket.active[slot]:
                continue
            if not occ.klass.preemptible \
                    or occ.priority >= entry.priority:
                continue
            rank = (occ.priority, int(live.bucket.rounds[slot]))
            if best is None or rank < best[0]:
                best = (rank, slot)
        if best is None:
            return None
        slot = best[1]
        victim = live.entries[slot]
        state = live.bucket.preempt(slot)
        live.entries[slot] = None
        state = self._spool_preempt(state)
        self.queue.push(dataclasses.replace(victim, resume=state))
        obs.instant("preempt", cat="serve.admission", track="admission",
                    job_id=victim.spec.job_id,
                    by=entry.spec.job_id, rounds=state.rounds,
                    klass=victim.klass.name)
        obs.registry().counter(
            "serve_preemptions_total",
            "slots preempted at chunk boundaries by higher classes"
        ).inc()
        self._set_queue_gauge()
        return slot

    def _admit_entry(self, live: _LiveBucket, slot: int,
                     entry: QueueEntry) -> None:
        live.bucket.admit(slot, entry.spec, entry.prob,
                          resume=entry.resume)
        live.entries[slot] = dataclasses.replace(entry, resume=None)
        obs.instant("resume" if entry.resume is not None else "admit",
                    cat="serve.lifecycle", track="engine",
                    job_id=entry.spec.job_id, slot=int(slot),
                    rounds=entry.rounds_done, klass=entry.klass.name)
        obs.registry().counter(
            "serve_admissions_total",
            "jobs admitted into bucket slots by the admission loop"
        ).inc()
        if entry.resume is not None \
                and entry.resume.spool_step is not None:
            self._drop_spool(entry.resume.spool_step)

    def _backfill_for(self, live: _LiveBucket):
        """The `_advance_bucket` backfill hook: freed slots pull the
        next compatible queue entry at the chunk boundary — this IS
        the async admission path."""
        def backfill(bucket: BucketState, slot: int) -> bool:
            live.entries[slot] = None
            entry = self.queue.pop_next(
                lambda e: e.key == live.key and compatible(
                    e.remaining, live.T, bucket.K, e.budget))
            if entry is None:
                return False
            self._admit_entry(live, slot, entry)
            self._set_queue_gauge()
            return True
        return backfill

    def _reap_idle(self) -> None:
        """Drop drained buckets (finalizing their ledgers) unless a
        queued entry still fits them — re-opening is cheap (the runner
        stays in the runner cache) and keeps incompatible-K entries
        from starving behind an idle plan."""
        for key, live in list(self._live.items()):
            if live.bucket.any_active():
                continue
            if any(e.key == key and compatible(
                    e.remaining, live.T, live.bucket.K, e.budget)
                    for e in self.queue):
                continue
            self._finalize_ledger(live.bucket)
            self.stats.buckets += 1
            del self._live[key]
            self._set_bucket_gauge()

    def _set_bucket_gauge(self) -> None:
        obs.registry().gauge(
            "serve_live_buckets",
            "buckets the admission loop currently holds in flight"
        ).set(float(len(self._live)))

    def _on_retired(self, rec, result: JobResult) -> None:
        if self.quotas is not None:
            self.quotas.charge(getattr(rec.spec, "tenant", "default"),
                               result.wire_bytes)
        ev = self._done.get(rec.spec.job_id)
        if ev is not None:
            ev.set()

    # -- preempt spooling (repro_torch.checkpoint) -----------------------------

    def _preempt_dir(self) -> str:
        return os.path.join(self.checkpoint_dir, "preempt")

    def _spool_preempt(self, state: PreemptedState) -> PreemptedState:
        """Persist a preempted carry (the slot's host copy: iterates, EF
        replicas, send counters, seeds, flight buffer) through
        `repro_torch.checkpoint` so a crash between preemption and
        resumption loses nothing; the in-memory copy stays
        authoritative for same-process resumes."""
        if self.checkpoint_dir is None:
            return state
        from ... import checkpoint as ckpt
        step = self._preempt_seq
        self._preempt_seq += 1
        ckpt.save_checkpoint(self._preempt_dir(), step,
                             {"carry": state.carry})
        return dataclasses.replace(state, spool_step=step)

    def _drop_spool(self, step: int) -> None:
        path = os.path.join(self._preempt_dir(),
                            f"step_{step:08d}.npz")
        if os.path.exists(path):
            os.remove(path)

    def _load_spooled_carry(self, spec: JobSpec, step: int):
        """Rebuild a preempted carry from its spool npz after a crash:
        a fresh `dagm_init_carry` gives the shape/dtype template, the
        spooled arrays restore the exact boundary values."""
        from ... import checkpoint as ckpt
        prob = build_problem(spec, self.device)
        sspec = solver_spec(spec)
        net = build_network(spec)
        op = make_mixing_op(net, backend=sspec.mixing.backend,
                            dtype=sspec.mixing.dtype,
                            comm=sspec.comm.spec, device=self.device)
        template = _host_slot(dagm_init_carry(
            prob, op, sspec, seed=spec.seed,
            recorder=self.flight_recorder))
        arrays = ckpt.load_arrays(self._preempt_dir(), step)
        return ckpt.restore_into(arrays, {"carry": template})["carry"]

    # -- loop checkpoints --------------------------------------------------------

    def _loop_state_path(self, step: int) -> str:
        return os.path.join(self.checkpoint_dir,
                            f"loop_{step:08d}.pkl")

    def _maybe_checkpoint_loop(self) -> None:
        if self.checkpoint_dir is None:
            return
        if self.stats.chunks % self.checkpoint_every == 0:
            with obs.span("checkpoint", cat="serve.checkpoint",
                          track="engine", step=self.stats.chunks):
                self._save_loop_state()
            if self._metrics_writer is not None:
                self._metrics_writer.write_snapshot(
                    obs.registry(), step=self.stats.chunks)
        if self.crash_after_chunks is not None \
                and self.stats.chunks >= self.crash_after_chunks:
            raise SimulatedCrash(
                f"crash_after_chunks hook fired at chunk "
                f"{self.stats.chunks}")

    def _entry_host(self, entry: QueueEntry) -> dict:
        resume = None
        if entry.resume is not None:
            resume = {"rounds": entry.resume.rounds,
                      "wall": entry.resume.wall,
                      "metric_log": list(entry.resume.metric_log),
                      "spool_step": entry.resume.spool_step}
        deadline_rel = None if entry.deadline_abs is None else \
            max(entry.deadline_abs - time.monotonic(), 0.0)
        return {"spec": entry.spec, "seq": entry.seq,
                "priority": entry.priority,
                "deadline_rel": deadline_rel, "resume": resume}

    def _entry_from_host(self, h: dict) -> QueueEntry:
        spec = h["spec"]
        prob = build_problem(spec, self.device)
        resume = None
        if h["resume"] is not None:
            r = h["resume"]
            if r["spool_step"] is None:
                raise ValueError(
                    "loop checkpoint holds a preempted entry without a "
                    "spool step — written without checkpoint_dir?")
            resume = PreemptedState(
                spec=spec,
                carry=self._load_spooled_carry(spec, r["spool_step"]),
                rounds=int(r["rounds"]), wall=float(r["wall"]),
                metric_log=list(r["metric_log"]),
                spool_step=r["spool_step"])
        deadline = None if h["deadline_rel"] is None \
            else time.monotonic() + h["deadline_rel"]
        return QueueEntry(
            seq=h["seq"], spec=spec, prob=prob,
            klass=resolve_class(self.classes, spec.klass),
            priority=h["priority"], deadline_abs=deadline,
            key=self._bucket_key(spec, prob),
            budget=solver_spec(spec).K, resume=resume)

    def _save_loop_state(self) -> None:
        from ... import checkpoint as ckpt
        step = self.stats.chunks
        lives = list(self._live.values())
        ckpt.save_checkpoint(
            self.checkpoint_dir, step,
            {f"b{i}": lb.bucket.device_tree()
             for i, lb in enumerate(lives)},
            keep_last=self.keep_last)
        host = {
            "format": 2,
            "kind": "admission_loop",
            "engine": {"chunk_rounds": self.chunk_rounds,
                       "hp_mode": self.hp_mode},
            "buckets": [{
                "rep": lb.rep, "T": lb.T, "K": lb.bucket.K,
                "width": lb.bucket.width,
                "host": lb.bucket.snapshot_host(),
                "entries": [None if e is None else self._entry_host(e)
                            for e in lb.entries],
            } for lb in lives],
            "queue": [self._entry_host(e) for e in self.queue.ordered()],
            "results": dict(self._results),
            "order": list(self._order),
            "known": sorted(self._known),
            "quota_spent": None if self.quotas is None
            else self.quotas.snapshot(),
            "stats": {"chunks": self.stats.chunks,
                      "jobs_completed": self.stats.jobs_completed,
                      "retries": self.stats.retries,
                      "quarantined": self.stats.quarantined,
                      "restarts": self.stats.restarts,
                      "checkpoints": self.stats.checkpoints + 1},
            "auto_id": self._auto_id,
            "seq": self._seq,
            "preempt_seq": self._preempt_seq,
        }
        tmp = self._loop_state_path(step) + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(host, f)
        os.replace(tmp, self._loop_state_path(step))
        self.stats.checkpoints += 1
        self._ckpt_dirty = True
        kept = {f"loop_{s:08d}.pkl" for s in
                ckpt.checkpoint_steps(self.checkpoint_dir)}
        for f in os.listdir(self.checkpoint_dir):
            if re.fullmatch(r"loop_\d+\.pkl", f) and f not in kept:
                os.remove(os.path.join(self.checkpoint_dir, f))

    def _maybe_restore(self) -> None:
        """Resume an interrupted service on first touch: rebuild every
        live bucket (host bookkeeping from the sidecar, device arrays
        through `repro_torch.checkpoint`) and the admission queue —
        including
        jobs that were queued but never admitted, and preempted carries
        from their spool files.  Bit-exact: restored state is the exact
        chunk-boundary state the crashed loop held."""
        if not self._restore_pending:
            return
        self._restore_pending = False
        if self.checkpoint_dir is None \
                or not os.path.isdir(self.checkpoint_dir):
            return
        from ... import checkpoint as ckpt
        ckpt.sweep_stale(self.checkpoint_dir)
        host, step = None, None
        for s in reversed(ckpt.checkpoint_steps(self.checkpoint_dir)):
            if os.path.exists(self._loop_state_path(s)):
                with open(self._loop_state_path(s), "rb") as f:
                    host = pickle.load(f)
                step = s
                break
        if host is None:
            return
        eng = host["engine"]
        if eng["chunk_rounds"] != self.chunk_rounds \
                or eng["hp_mode"] != self.hp_mode:
            raise ValueError(
                f"loop checkpoint at {self.checkpoint_dir!r} was "
                f"written with chunk_rounds={eng['chunk_rounds']}, "
                f"hp_mode={eng['hp_mode']!r}; this loop has "
                f"chunk_rounds={self.chunk_rounds}, "
                f"hp_mode={self.hp_mode!r} — bit-exact resumption "
                f"needs identical chunking, construct the resuming "
                f"loop to match")
        for k, v in host["stats"].items():
            setattr(self.stats, k, v)
        self.stats.restarts += 1
        self._auto_id = max(self._auto_id, host["auto_id"])
        self._seq = max(self._seq, host["seq"])
        self._preempt_seq = max(self._preempt_seq, host["preempt_seq"])
        if self.quotas is not None and host["quota_spent"] is not None:
            self.quotas.restore(host["quota_spent"])
        self._results.update(host["results"])
        self._known.update(host["known"])
        self._order = host["order"] + self._order
        for jid in self._known:
            ev = self._done.setdefault(jid, threading.Event())
            if jid in self._results:
                ev.set()
        # live buckets: host halves first (templates), then one shot of
        # device restore across all of them
        templates: dict[str, dict] = {}
        lives: list[_LiveBucket] = []
        for i, b in enumerate(host["buckets"]):
            rep = b["rep"]
            prob = build_problem(rep, self.device)
            sspec = solver_spec(rep)
            net = build_network(rep)
            op = make_mixing_op(net, backend=sspec.mixing.backend,
                                dtype=sspec.mixing.dtype,
                                comm=sspec.comm.spec, device=self.device)
            key = self._bucket_key(rep, prob)
            bucket = BucketState(key, b["width"], prob, net, op, sspec,
                                 recorder=self.flight_recorder,
                                 bucket_K=b["K"])
            bucket.restore_host(b["host"])
            entries = [None if e is None else self._entry_from_host(e)
                       for e in b["entries"]]
            templates[f"b{i}"] = bucket.device_tree()
            live = _LiveBucket(bucket=bucket, T=b["T"], key=key,
                               rep=rep, entries=entries)
            lives.append(live)
            self._live[key] = live
        if lives:
            dev = ckpt.restore_into(
                ckpt.load_arrays(self.checkpoint_dir, step), templates)
            for i, live in enumerate(lives):
                live.bucket.load_device_tree(dev[f"b{i}"])
        for h in host["queue"]:
            self.queue.push(self._entry_from_host(h))
        self._ckpt_dirty = True
        self._set_queue_gauge()
        self._set_bucket_gauge()

    def _clear_loop_checkpoints(self) -> None:
        """An idle loop owes the disk nothing (mirrors the wave
        engine's contract): drop step npzs, loop sidecars and the
        preempt spool directory."""
        self._ckpt_dirty = False
        if self.checkpoint_dir is None \
                or not os.path.isdir(self.checkpoint_dir):
            return
        from ... import checkpoint as ckpt
        ckpt.sweep_stale(self.checkpoint_dir)
        for s in ckpt.checkpoint_steps(self.checkpoint_dir):
            os.remove(os.path.join(self.checkpoint_dir,
                                   f"step_{s:08d}.npz"))
        for f in os.listdir(self.checkpoint_dir):
            if re.fullmatch(r"loop_\d+\.pkl", f):
                os.remove(os.path.join(self.checkpoint_dir, f))
        shutil.rmtree(self._preempt_dir(), ignore_errors=True)

    # -- telemetry (StreamingTraceWriter / MetricsJsonlWriter) -----------------

    def _open_telemetry(self) -> None:
        if not self.telemetry or self.checkpoint_dir is None \
                or self._trace_writer is not None:
            return
        from ...obs.export import MetricsJsonlWriter, StreamingTraceWriter
        tdir = os.path.join(self.checkpoint_dir, "telemetry")
        tr = obs.tracer()
        self._prev_trace_enabled = tr.enabled
        tr.enabled = True
        self._trace_writer = StreamingTraceWriter(
            tdir, prefix="serve-trace", tracer=tr)
        self._metrics_writer = MetricsJsonlWriter(
            tdir, prefix="serve-metrics")

    def _close_telemetry(self) -> None:
        if self._trace_writer is None:
            return
        self._metrics_writer.write_snapshot(
            obs.registry(), step=self.stats.chunks, final=True)
        self._trace_writer.close()
        self._metrics_writer.close()
        obs.tracer().enabled = bool(self._prev_trace_enabled)
        self._trace_writer = None
        self._metrics_writer = None

    # -- service thread ----------------------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None

    def start(self) -> "AdmissionLoop":
        """Spawn the scheduler thread (idempotent); `submit()` from any
        thread afterwards, read completions via `result` /
        `as_completed`."""
        with self._wake:
            if self._thread is not None:
                return self
            self._maybe_restore()
            self._open_telemetry()
            self._stopping = False
            self._thread = threading.Thread(
                target=self._serve, name="admission-loop", daemon=True)
            self._thread.start()
        return self

    def _serve(self) -> None:
        while True:
            with self._wake:
                if self._stopping:
                    return
            try:
                worked = self.step()
            except BaseException as e:
                with self._wake:
                    self._error = e
                    self._stopping = True
                    for ev in self._done.values():
                        ev.set()       # unblock waiters; result() raises
                return
            if not worked:
                with self._wake:
                    if not self._stopping and not self.queue:
                        self._wake.wait(self.idle_wait_s)

    def stop(self, drain: bool = True) -> None:
        """Join the scheduler thread (after draining by default) and
        close telemetry.  Safe to call without `start()`.  The thread is
        joined even when draining raises (a job the dead thread never
        finished)."""
        if self._thread is not None:
            try:
                if drain:
                    self.drain()
            finally:
                with self._wake:
                    self._stopping = True
                    self._wake.notify_all()
                self._thread.join()
                self._thread = None
            if self._error is not None:
                err, self._error = self._error, None
                raise RuntimeError(
                    "admission loop thread died") from err
        self._close_telemetry()

    close = stop

    def __enter__(self) -> "AdmissionLoop":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop(drain=exc_type is None)

    # -- completion delivery -------------------------------------------------------

    def drain(self, timeout: float | None = None) -> None:
        """Block until every known job has completed."""
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        with self._lock:
            pending = [jid for jid in self._known
                       if not self._done[jid].is_set()]
        for jid in pending:
            self.result(jid, timeout=None if deadline is None
                        else max(deadline - time.monotonic(), 0.0))

    def result(self, job_id: str,
               timeout: float | None = None) -> JobResult:
        """The job's JobResult, blocking until it retires.  Without a
        scheduler thread this drives the loop inline."""
        try:
            ev = self._done[job_id]
        except KeyError:
            raise KeyError(f"unknown job_id {job_id!r}") from None
        if self._thread is None and not ev.is_set():
            with self._lock:
                while not ev.is_set() and self.step():
                    pass
        if not ev.wait(timeout):
            raise TimeoutError(
                f"job {job_id!r} did not complete within {timeout}s")
        if job_id not in self._results:
            raise RuntimeError(
                f"job {job_id!r} was not completed (loop error: "
                f"{self._error!r})") from self._error
        return self._results[job_id]

    def as_completed(self, job_ids,
                     timeout: float | None = None
                     ) -> Iterator[JobResult]:
        """Yield results in completion order (the service-side
        consumption pattern: read results as they retire).  Ids the
        loop hasn't seen yet are simply awaited — callers may iterate
        over ids a feeder thread is still submitting."""
        pending = list(job_ids)
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        while pending:
            ready = [jid for jid in pending
                     if jid in self._done and self._done[jid].is_set()]
            for jid in ready:
                pending.remove(jid)
                yield self.result(jid)
            if not pending:
                return
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"{len(pending)} jobs still pending at timeout")
            unknown = [jid for jid in pending if jid not in self._done]
            if self._thread is None:
                with self._lock:
                    if not self.step() and not ready and not unknown:
                        raise RuntimeError(
                            f"loop went idle with {len(pending)} jobs "
                            f"unfinished — were they submitted?")
                if unknown and not ready:
                    time.sleep(min(self.idle_wait_s, 0.01))
            elif not ready:
                time.sleep(min(self.idle_wait_s, 0.01))
