"""Shape buckets + slot management for the batched solver engine.

Counterpart of `repro.serve.batching`.  The unit of execution is a
**bucket**: a fixed width of job *slots* sharing one signature.  All
slots advance together through one job-axis chunk per scheduling step
(`repro_torch.core.jobs`); a slot whose job retires (converged / round
budget exhausted) is backfilled from the queue without touching the
other slots' in-flight state — continuous batching at chunk
granularity.

Width policy, as `repro`'s: buckets are padded to the next power of
two, with a floor of 2 (`pad_width`).  Chunk policy: `chunk_rounds_for`
slices the K-round run into T-round chunks with T | K and T ≥ 2.  The
port's round loop is the same arithmetic whatever T, so chunking
changes no bit; the rules are `repro`'s so that the two engines retire
and backfill at the same rounds.

Layout: the bucket stores each state as (n, B, d), contiguous — x, y
and the error-feedback replicas — so that a gossip of all B jobs is one
(n, B·d) operand without a copy.  The stacked data have leaves (B, n,
...) (`stack_problem_data`).  The per-slot send counters and channel
seeds stay host integers, as the port's `ChannelState` keeps them.

Inert padding: slots that are not active still compute, but the
engine's freeze (`core.jobs.freeze_inactive`) holds their whole carry —
state, EF replicas, send counters and flight buffer — so a padded slot
costs FLOPs but never bytes, rounds or ledger entries.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..comm import stack_channels
from ..core.dagm import dagm_init_carry
from ..core.problems import BilevelProblem, stack_problem_data
from ..topology.ops import Network

from .jobs import (JobSpec, Signature, compile_signature, job_hp,
                   schedule_rows, solver_spec)

__all__ = ["WIDTHS", "BucketState", "PreemptedState", "RetiredJob",
           "bucketize", "chunk_rounds_for", "pad_schedule", "pad_width"]

#: Bucket widths (powers of two, floor 2 — see module docstring).
WIDTHS = (2, 4, 8, 16, 32, 64)


def pad_width(n_jobs: int, max_width: int = WIDTHS[-1]) -> int:
    """Smallest bucket width holding `n_jobs`: always one of `WIDTHS`
    (never 1, whatever max_width says), capped at the largest allowed
    width ≤ max_width."""
    allowed = [w for w in WIDTHS if w <= max(int(max_width), 2)] \
        or [WIDTHS[0]]
    for w in allowed:
        if w >= n_jobs:
            return w
    return allowed[-1]


def chunk_rounds_for(K: int, requested: int) -> int:
    """Largest T ≤ `requested` with T | K and T ≥ 2; K itself (one
    chunk, no mid-flight retirement) when K is prime beyond `requested`
    or K == 1."""
    top = max(2, min(int(requested), K))
    for t in range(top, 1, -1):
        if K % t == 0:
            return t
    return K


def pad_schedule(rows: np.ndarray, K: int) -> np.ndarray:
    """Pad (K_j, 3) schedule rows to a bucket's (K, 3) by repeating the
    last row (inert: a slot retires or is frozen before it scans
    them)."""
    rows = np.asarray(rows, np.float32)
    if rows.shape[0] > K:
        raise ValueError(
            f"schedule has {rows.shape[0]} rows but the bucket budget "
            f"is K={K} — a job cannot out-run its bucket")
    if rows.shape[0] == K:
        return rows
    pad = np.repeat(rows[-1:], K - rows.shape[0], axis=0)
    return np.concatenate([rows, pad], axis=0)


def bucketize(specs, device=None) -> dict:
    """Group specs by signature, building each job's problem on
    `device`: {signature: [(spec, problem), ...]} in submission order."""
    from .jobs import build_problem
    buckets: dict[Signature, list] = {}
    for spec in specs:
        prob = build_problem(spec, device)
        sig = compile_signature(spec, prob)
        buckets.setdefault(sig, []).append((spec, prob))
    return buckets


@dataclasses.dataclass
class RetiredJob:
    """Raw per-slot readout at retirement (JobResult sans ledger math)."""
    spec: JobSpec
    x: Any
    y: Any
    rounds: int
    converged: bool
    final_gap: float
    sends: dict
    wall_s: float
    metrics: dict | None = None
    quarantined: bool = False
    flight: Any = None


@dataclasses.dataclass
class PreemptedState:
    """A mid-flight job lifted out of its slot at a chunk boundary: the
    host copy of the slot's carry (iterates, EF replicas, send counters
    and channel seeds, flight buffer), the rounds already run and the
    accounting that travels with them.  Host data only, so it pickles."""
    spec: JobSpec
    carry: Any
    rounds: int
    wall: float
    metric_log: list
    spool_step: int | None = None


def _solo_slot(carry, j: int) -> dict:
    """Slot j of a bucket carry as host data."""
    (x, y), cs = carry[0], carry[1]
    out = {"x": x[:, j].cpu(), "y": y[:, j].cpu(),
           "hats": {name: None if st.hat is None else st.hat[:, j].cpu()
                    for name, st in cs.items()},
           "sends": {name: int(st.sends[j]) for name, st in cs.items()},
           "seeds": {name: int(st.seeds[j]) for name, st in cs.items()}}
    if len(carry) > 2:
        out["flight"] = (carry[2].rows[j].cpu(), carry[2].count[j].cpu())
    return out


def _host_slot(carry1) -> dict:
    """A solo `dagm_init_carry` as the host slot dict of `_solo_slot`."""
    (x, y), cs = carry1[0], carry1[1]
    out = {"x": x, "y": y,
           "hats": {name: st.hat for name, st in cs.items()},
           "sends": {name: int(st.sends) for name, st in cs.items()},
           "seeds": {name: int(st.seed) for name, st in cs.items()}}
    if len(carry1) > 2:
        out["flight"] = (carry1[2].rows, carry1[2].count)
    return out


class BucketState:
    """Device-resident state of one in-flight bucket: the stacked job
    axis (data leaves (B, n, ...), states (n, B, d)), per-slot
    hyper-parameters, the chunk carry, the active mask and per-slot
    accounting.  `admit` writes one job's freshly-initialized state into
    a slot (exactly `dagm_init_carry`'s output, so a slot's trajectory
    is the solo run's); `retire` reads the slot back out."""

    def __init__(self, signature: Signature, width: int,
                 template: BilevelProblem, net: Network, op, spec,
                 recorder=None, bucket_K: int | None = None):
        self.signature = signature
        self.width = width
        self.template = template
        self.net = net
        self.op = op
        self.spec = spec
        self.device = op.device
        self.K = int(bucket_K if bucket_K is not None else spec.K)
        self.recorder = recorder
        self.has_curvature = spec.curvature is not None
        self.slots: list[JobSpec | None] = [None] * width
        self.active = np.zeros(width, bool)
        self.rounds = np.zeros(width, np.int64)
        self.budget = np.full(width, self.K, np.int64)
        self.wall = np.zeros(width, np.float64)
        self.retired: list[RetiredJob] = []
        self.metric_log: list[list] = [[] for _ in range(width)]
        # padding slots replicate the template job, so every slot always
        # computes well-defined math
        self.data = stack_problem_data([template] * width)
        self.sched = np.tile(
            pad_schedule(schedule_rows(spec), self.K)[None],
            (width, 1, 1))
        self.curv = np.full((width,), spec.curvature or 0.0, np.float32)
        carries = [dagm_init_carry(template, op, spec, seed=0,
                                   recorder=recorder)] * width
        (x, y), cs = carries[0][0], carries[0][1]
        self.carry = (
            (torch.stack([c[0][0] for c in carries], dim=1),
             torch.stack([c[0][1] for c in carries], dim=1)),
            {name: stack_channels([c[1][name] for c in carries])
             for name in cs})
        if recorder is not None:
            from ..obs.recorder import FlightBuffer
            self.carry += (FlightBuffer(
                rows=torch.stack([c[2].rows for c in carries]),
                count=torch.stack([c[2].count for c in carries])),)

    # -- slot lifecycle ----------------------------------------------------

    def _write_slot(self, slot: int, host: dict) -> None:
        """Put a slot's state (a `_solo_slot` / `_host_slot` dict) into
        the carry, out of place (the chunk before keeps its tensors)."""
        dev = self.device

        def put(stack, val, axis):
            stack = stack.clone()
            idx = (slice(None),) * axis + (slot,)
            stack[idx] = torch.as_tensor(val).to(dev, stack.dtype)
            return stack
        (x, y), cs = self.carry[0], self.carry[1]
        new_cs = {}
        for name, st in cs.items():
            sends, seeds = st.sends.copy(), st.seeds.copy()
            sends[slot] = host["sends"][name]
            seeds[slot] = host["seeds"][name]
            hat = st.hat if st.hat is None \
                else put(st.hat, host["hats"][name], 1)
            new_cs[name] = dataclasses.replace(st, hat=hat, sends=sends,
                                               seeds=seeds)
        carry = ((put(x, host["x"], 1), put(y, host["y"], 1)), new_cs)
        if len(self.carry) > 2:
            from ..obs.recorder import FlightBuffer
            fb = self.carry[2]
            rows, count = host["flight"]
            carry += (FlightBuffer(rows=put(fb.rows, rows, 0),
                                   count=put(fb.count, count, 0)),)
        self.carry = carry

    def admit(self, slot: int, spec: JobSpec, prob: BilevelProblem,
              resume: PreemptedState | None = None) -> None:
        """Write one job's state into `slot`: round 0 (exactly
        `dagm_init_carry`'s output) or the preserved chunk-boundary
        state of a preempted job (`resume`)."""
        assert not self.active[slot], f"slot {slot} still active"
        self.slots[slot] = spec
        self.active[slot] = True
        self.budget[slot] = solver_spec(spec).K
        self.sched[slot] = pad_schedule(job_hp(spec), self.K)
        if self.has_curvature:
            self.curv[slot] = np.float32(solver_spec(spec).curvature)
        data = {}
        for k, stack in self.data.items():
            stack = stack.clone()
            stack[slot] = prob.data[k].to(stack.device)
            data[k] = stack
        self.data = data
        if resume is None:
            self.rounds[slot] = 0
            self.wall[slot] = 0.0
            self.metric_log[slot] = []
            host = _host_slot(dagm_init_carry(prob, self.op, self.spec,
                                              seed=spec.seed,
                                              recorder=self.recorder))
        else:
            self.rounds[slot] = int(resume.rounds)
            self.wall[slot] = float(resume.wall)
            self.metric_log[slot] = list(resume.metric_log)
            host = resume.carry
        self._write_slot(slot, host)

    def preempt(self, slot: int) -> PreemptedState:
        """Lift a mid-flight job out of `slot` at a chunk boundary (the
        exact host copy of its state; `admit(..., resume=)` puts it back
        bit for bit)."""
        assert self.active[slot], f"slot {slot} not active"
        state = PreemptedState(
            spec=self.slots[slot], carry=_solo_slot(self.carry, slot),
            rounds=int(self.rounds[slot]), wall=float(self.wall[slot]),
            metric_log=list(self.metric_log[slot]))
        self.slots[slot] = None
        self.active[slot] = False
        self.metric_log[slot] = []
        return state

    def retire(self, slot: int, final_gap: float, converged: bool,
               quarantined: bool = False) -> RetiredJob:
        """Read a finished job back out of `slot` and free it."""
        spec = self.slots[slot]
        (x, y), cs = self.carry[0], self.carry[1]
        metrics = None
        if self.metric_log[slot]:
            chunks = self.metric_log[slot]
            metrics = {k: np.concatenate([c[k] for c in chunks])
                       for k in chunks[0]}
        flight = None
        if self.recorder is not None:
            from ..obs.recorder import FlightBuffer, recorder_rows
            fb = self.carry[2]
            flight = recorder_rows(FlightBuffer(rows=fb.rows[slot],
                                                count=fb.count[slot]))
        rec = RetiredJob(
            spec=spec, x=x[:, slot].cpu(), y=y[:, slot].cpu(),
            rounds=int(self.rounds[slot]), converged=bool(converged),
            final_gap=float(final_gap),
            sends={name: int(st.sends[slot]) for name, st in cs.items()},
            wall_s=float(self.wall[slot]), metrics=metrics,
            quarantined=bool(quarantined), flight=flight)
        self.retired.append(rec)
        self.slots[slot] = None
        self.active[slot] = False
        self.metric_log[slot] = []
        return rec

    # -- checkpoint support ------------------------------------------------

    def device_tree(self) -> dict:
        """The bucket's device state as a checkpoint tree: the states,
        EF replicas, flight buffer and stacked data (the host counters
        go through `snapshot_host`)."""
        (x, y), cs = self.carry[0], self.carry[1]
        carry = {"x": x, "y": y,
                 "hat": {name: st.hat for name, st in cs.items()
                         if st.hat is not None}}
        if len(self.carry) > 2:
            carry["flight"] = self.carry[2]
        return {"carry": carry, "data": self.data}

    def load_device_tree(self, tree: dict) -> None:
        (_, _), cs = self.carry[0], self.carry[1]
        c = tree["carry"]
        new_cs = {name: dataclasses.replace(
            st, hat=c["hat"][name] if st.hat is not None else None)
            for name, st in cs.items()}
        self.carry = ((c["x"], c["y"]), new_cs) + \
            ((c["flight"],) if "flight" in c else ())
        self.data = tree["data"]

    def snapshot_host(self) -> dict:
        """Picklable host-side slot state: the slot bookkeeping and the
        channels' host send counters and seeds.  With the device tree
        through `repro_torch.checkpoint` this is the bucket's
        crash-restart protocol."""
        cs = self.carry[1]
        return {
            "slots": list(self.slots),
            "active": self.active.copy(),
            "rounds": self.rounds.copy(),
            "budget": self.budget.copy(),
            "wall": self.wall.copy(),
            "sched": self.sched.copy(),
            "curv": self.curv.copy(),
            "retired": list(self.retired),
            "metric_log": [list(m) for m in self.metric_log],
            "sends": {name: st.sends.copy() for name, st in cs.items()},
            "seeds": {name: st.seeds.copy() for name, st in cs.items()},
        }

    def restore_host(self, snap: dict) -> None:
        self.slots = list(snap["slots"])
        self.active = np.asarray(snap["active"], bool).copy()
        self.rounds = np.asarray(snap["rounds"], np.int64).copy()
        self.budget = np.asarray(snap["budget"], np.int64).copy()
        self.wall = np.asarray(snap["wall"], np.float64).copy()
        self.sched = np.asarray(snap["sched"], np.float32).copy()
        self.curv = np.asarray(snap["curv"], np.float32).copy()
        self.retired = list(snap["retired"])
        self.metric_log = [list(m) for m in snap["metric_log"]]
        (xy, cs) = self.carry[0], self.carry[1]
        self.carry = (xy, {name: dataclasses.replace(
            st, sends=np.asarray(snap["sends"][name], np.int64).copy(),
            seeds=np.asarray(snap["seeds"][name], np.int64).copy())
            for name, st in cs.items()}) + tuple(self.carry[2:])

    # -- views -------------------------------------------------------------

    def any_active(self) -> bool:
        return bool(self.active.any())

    def active_mask(self) -> torch.Tensor:
        return torch.as_tensor(self.active, device=self.device)

    def chunk_starts(self, T: int) -> np.ndarray:
        """Per-slot schedule offsets for the next T-round chunk (inactive
        slots clamped into range: their carry is frozen)."""
        return np.minimum(self.rounds,
                          max(self.K - T, 0)).astype(np.int64)

    def hp_chunk(self, T: int) -> dict:
        """The chunk's hyper-parameters: per-slot (T,) α/β/γ slices as
        (width, T) arrays (+ the (width,) curvature column when the
        bucket carries one), gathered at `chunk_starts`."""
        starts = self.chunk_starts(T)
        sl = np.stack([self.sched[i, s:s + T] for i, s
                       in enumerate(starts)])          # (width, T, 3)
        hp = {"alpha": sl[:, :, 0], "beta": sl[:, :, 1],
              "gamma": sl[:, :, 2]}
        if self.has_curvature:
            hp["curvature"] = self.curv
        return hp

    def hp_key(self, T: int) -> tuple:
        """Hashable snapshot of the chunk's hyper-parameters (the static
        hp_mode's cache key)."""
        hp = self.hp_chunk(T)
        return tuple(sorted((k, v.tobytes()) for k, v in hp.items()))
