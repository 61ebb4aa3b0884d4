"""`solve(problem, network, spec)` — the solver front-end of the port.

The reference tier (``tier="reference"``) runs every method:

* ``method="dagm"`` — one `dagm_run_chunk` of K rounds on the problem's
  device, every gossip through a `MixingOp` (the CUDA kernels on
  ring/circulant and Erdős–Rényi graphs) on the wire policy `spec.comm`
  — the comm-fused kernels for int8/int4 (± error feedback).  A
  `SolverSpec.faults` lowers once, on the host, to per-round table
  masks (`repro_torch.faults`), and every gossip of round k runs on the
  realized W_k (`MixingOp.masked`); `extras` then carries the
  `fault_trace` and its `fault_alive_fraction`.
* ``"dgbo" | "dgtbo" | "fednest" | "ma_dbo"`` — the paper's baselines
  (`repro_torch.core.baselines`), gossiping through the same
  `MixingOp`; `extras` carries their Appendix-S1
  `comm_floats_per_round` closed form and display `name`.

The serve tier (``tier="serve"``, method "dagm") runs the solve as a
one-job bucket of a `repro_torch.serve.ServeEngine` (its own, or the
`serve_engine=` passed in — an `AdmissionLoop` too — sharing that
engine's runner cache); the
job's trajectory is its reference-tier run's (`repro_torch.core.jobs`).
`recorder=` threads the flight recorder through either tier and returns
its rows in `extras["flight"]`; with tracing on (`repro_torch.obs
.tracing()`) the reference tier records `repro`'s spans.

The sharded tier (``tier="sharded"``, method "dagm", `sharded_spec`)
runs `repro_torch.distributed`'s round on a ring of agents, `mesh=`:
a `LocalRing` (all agents on one device, every gossip through
`MixingOp`'s kernels) or a `torch.distributed` `DeviceMesh` (one agent
per rank of the dim(s) `spec.sharded.axis`, a `ProcessRing`).  The
problem, or raw `g_fn`/`f_fn` tree objectives with `batch` and x0/y0,
is stacked over the agents; on a process ring every rank passes the
same stacked problem and gets back its own agent's rows, and the
metrics — agent means — are equal on every rank.  `extras["ring"]`
holds the ring's `RingWeights`.

`SolveResult.ledger` charges the exact (compressed) bytes of the sends
that ran.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from .._device import resolve_device, strict_f32
from .spec import SolverSpec, mixing_kwargs, validate_spec


@dataclasses.dataclass
class SolveResult:
    """Outcome of a `solve` call."""
    x: Any                       # final stacked outer iterates (n, d1)
    y: Any                       # final stacked inner iterates (n, d2);
    #   trees on the sharded tier, (1, ...) leaves on a process ring
    metrics: dict[str, torch.Tensor]   # per-outer-round traces, (K,)
    ledger: Any = None           # repro_torch.comm.CommLedger (measured)
    channels: Any = None         # final gossip ChannelStates
    method: str = "dagm"
    tier: str = "reference"
    extras: dict = dataclasses.field(default_factory=dict)
    #   method specifics: the baselines' Appendix-S1
    #   "comm_floats_per_round" closed form and display "name"; a faulted
    #   dagm run's "fault_trace" and "fault_alive_fraction"


def _as_state(a, shape, device) -> torch.Tensor | None:
    """numpy array or tensor -> float32 tensor of `shape` on `device`."""
    if a is None:
        return None
    t = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor)
                        else a, dtype=torch.float32, device=device)
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"initial iterate has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    return t.contiguous()


@strict_f32()
def solve(problem, network, spec: SolverSpec, *, x0=None, y0=None,
          seed: int = 0, metrics_fn: Callable | None = None,
          device=None, recorder=None, serve_engine=None, mesh=None,
          g_fn: Callable | None = None, f_fn: Callable | None = None,
          batch=None) -> SolveResult:
    """Run `spec` on (problem, network) and return a `SolveResult`.

    problem:  a `repro_torch.core.problems.BilevelProblem` whose data
              lies on `device`.  The sharded tier can instead take raw
              `g_fn`/`f_fn` tree objectives with `batch` and x0/y0.
    network:  a `repro_torch.topology.Network`; ignored by "fednest"
              (its star is implicit) and tier="sharded" (the ring is
              the topology).
    x0/y0:    optional initial stacked iterates, numpy arrays or tensors
              (trees of them on the sharded tier).
    seed:     the y0 draw (`torch.Generator(device).manual_seed(seed)`)
              and the gossip channels' random streams.
    device:   where the run happens — CUDA unless the caller names
              another (on tier="sharded", the ring's device); raises
              without a card.
    recorder: optional `repro_torch.obs.RecorderSpec`: per-round flight
              rows in `extras["flight"]` (method="dagm").
    serve_engine: optional pre-built `repro_torch.serve.ServeEngine`
              for tier="serve" (built with record_metrics=True, on
              `device`).  A `repro_torch.serve.admission.AdmissionLoop`
              works too: the solve is submitted into the live service
              and joins a bucket at the next chunk boundary, sharing
              slots with whatever jobs the loop is already running.
    mesh:     tier="sharded"'s ring: a `repro_torch.distributed
              .LocalRing` or a `torch.distributed` `DeviceMesh` (or a
              `ProcessRing`).
    g_fn/f_fn/batch: tier="sharded"'s raw per-agent objectives and
              their stacked data tree.
    Runs inside `strict_f32`: the caller's TF32 flags are unchanged on
    return.
    """
    validate_spec(spec)
    if spec.tier == "sharded":
        return _solve_sharded(problem, spec, x0=x0, y0=y0, seed=seed,
                              metrics_fn=metrics_fn, mesh=mesh,
                              g_fn=g_fn, f_fn=f_fn, batch=batch,
                              device=device, recorder=recorder)
    dev = resolve_device(device)
    if problem.device != dev:
        raise ValueError(f"the problem's data lies on {problem.device} but "
                         f"solve runs on {dev}; build the problem with "
                         f"device={str(dev)!r}")
    if metrics_fn is not None and spec.method != "dagm":
        raise ValueError(
            f"metrics_fn is only supported for method='dagm' (the "
            f"baselines record the fixed default_metrics trace); got "
            f"method={spec.method!r}")
    if recorder is not None and spec.method != "dagm":
        raise ValueError(
            "the flight recorder rides the dagm round carry: "
            "recorder= needs method='dagm' (the baselines record no "
            "flight rows) — got method=" + repr(spec.method))
    if recorder is not None:
        from ..obs import RecorderSpec
        if not isinstance(recorder, RecorderSpec):
            raise TypeError(f"recorder must be a repro_torch.obs."
                            f"RecorderSpec, got {type(recorder).__name__}")
    if spec.tier == "serve":
        return _solve_serve(problem, network, spec, x0=x0, y0=y0,
                            seed=seed, metrics_fn=metrics_fn, device=dev,
                            engine=serve_engine, recorder=recorder)
    x0 = _as_state(x0, (problem.n, problem.d1), dev)
    y0 = _as_state(y0, (problem.n, problem.d2), dev)
    if spec.method == "dagm":
        return _solve_dagm_reference(problem, network, spec, device=dev,
                                     seed=seed, metrics_fn=metrics_fn,
                                     x0=x0, y0=y0, recorder=recorder)
    return _solve_baseline(problem, network, spec, device=dev, x0=x0,
                           y0=y0, seed=seed)


def _schedule_hp(spec: SolverSpec):
    from ..core.dagm import RoundHP
    sched = spec.schedule.materialize(spec.K)
    return RoundHP(alpha=sched.alpha, beta=sched.beta, gamma=sched.gamma)


def _dagm_phases(spec: SolverSpec):
    """(label, gossip-weight) pairs for the synthesized per-round phase
    spans: M inner DGD exchanges, U DIHGP Neumann exchanges (0 when the
    exact backend never gossips h), 1 outer (I−Ẃ)x exchange."""
    u = 0 if spec.dihgp == "exact" else spec.U
    return [("inner_dgd", spec.M), ("dihgp_neumann", u),
            ("outer_step", 1)]


def _solve_dagm_reference(prob, net, spec: SolverSpec, *, device, x0, y0,
                          seed, metrics_fn, recorder=None) -> SolveResult:
    from .. import obs
    from ..core.dagm import dagm_init_carry, dagm_run_chunk
    from ..topology.ops import make_mixing_op
    tr = obs.tracer()
    with tr.span("solve", cat="solver", track="solver", method="dagm",
                 tier="reference", K=spec.K, seed=seed):
        W = make_mixing_op(net, device=device, **mixing_kwargs(spec))
        with tr.span("init_carry", cat="solver", track="solver"):
            carry0 = dagm_init_carry(prob, W, spec, x0, y0, seed,
                                     recorder=recorder)
        # faults lower once, on the host, to a (K, n, k_max) mask operand
        # that dagm_run_chunk moves to the device before its loop
        trace = masks = None
        if spec.faults is not None:
            from ..faults import lower_faults
            with tr.span("lower_faults", cat="solver", track="solver"):
                trace = lower_faults(spec.faults, net, spec.K)
                masks = trace.table_masks(W.sparse)
        t0 = tr.now_us()
        out = dagm_run_chunk(prob, W, spec, carry0, spec.K, metrics_fn,
                             hp=_schedule_hp(spec), masks=masks,
                             recorder=recorder)
        t_disp = tr.now_us()
        if tr.enabled and device.type == "cuda":
            # the loop above returned once every round was dispatched;
            # waiting here makes the chunk span cover the device's work
            # (values are unchanged)
            torch.cuda.synchronize(device)
        t1 = tr.now_us()
        flight = None
        if recorder is not None:
            ((x, y), cs, rec), metrics = out
            flight = obs.recorder_rows(rec)
        else:
            ((x, y), cs), metrics = out
        W.ledger.charge_states(cs.values())
        if tr.enabled:
            # the port compiles nothing: the host's dispatch of the K
            # rounds stands where repro's trace+compile span stands, on
            # a track of its own because the rounds overlap it
            tr.add_span("trace_compile", t0, t_disp - t0,
                        cat="solver.compile", track="solver_host",
                        rounds=spec.K)
            tr.add_span("chunk", t0, t1 - t0, cat="solver.chunk",
                        track="solver", rounds=spec.K)
            obs.synthesize_round_spans(
                tr, t0_us=t0, dur_us=t1 - t0, rounds=spec.K,
                phases=_dagm_phases(spec), track="solver",
                round_args=(obs.rows_to_dicts(flight)
                            if flight is not None else None))
    extras = {}
    if trace is not None:
        # ledger sends stay nominal (channel counters tick whether or
        # not a given link carried the payload); the honest wire scale
        # of the faulted run is the trace's realized-link fraction
        extras = {"fault_trace": trace,
                  "fault_alive_fraction": trace.alive_fraction()}
    if flight is not None:
        extras["flight"] = flight
    return SolveResult(x=x, y=y, metrics=metrics, ledger=W.ledger,
                       channels=cs, method="dagm", tier="reference",
                       extras=extras)


def _solve_baseline(prob, net, spec: SolverSpec, *, device, x0, y0, seed
                    ) -> SolveResult:
    from ..core.baselines import BASELINE_SOLVERS
    x, y, metrics, cs, ledger, floats, name = \
        BASELINE_SOLVERS[spec.method](prob, net, spec, _schedule_hp(spec),
                                      x0=x0, y0=y0, seed=seed,
                                      device=device)
    return SolveResult(x=x, y=y, metrics=metrics, ledger=ledger,
                       channels=cs, method=spec.method, tier="reference",
                       extras={"comm_floats_per_round": floats,
                               "name": name})


# ---------------------------------------------------------------------------
# serve tier
# ---------------------------------------------------------------------------

#: problem-object → inline family callable.  The family object is part
#: of the serve signature, so re-solving the same problem must hand the
#: engine the same callable or a shared engine's runner cache could
#: never hit.  id-keyed with an identity check against stale-id reuse;
#: bounded because each family closure keeps its problem alive.
_INLINE_FAMILIES: dict = {}
_INLINE_FAMILIES_CAP = 256


def _inline_family(prob):
    ent = _INLINE_FAMILIES.get(id(prob))
    if ent is not None and ent[0] is prob:
        return ent[1]
    fam = lambda: prob
    while len(_INLINE_FAMILIES) >= _INLINE_FAMILIES_CAP:
        _INLINE_FAMILIES.pop(next(iter(_INLINE_FAMILIES)))
    _INLINE_FAMILIES[id(prob)] = (prob, fam)
    return fam


def _default_serve_metrics(prob, W, x, y):
    """Module-level (a stable identity: it keys the engine's runner
    cache) default — the reference tier's default_metrics, so a
    serve-tier SolveResult carries the same trajectory."""
    from ..core.dagm import default_metrics
    return default_metrics(prob, x, y)


def _solve_serve(prob, net, spec: SolverSpec, *, x0, y0, seed, metrics_fn,
                 device, engine, recorder=None) -> SolveResult:
    from ..serve import JobSpec, ServeEngine
    if x0 is not None or y0 is not None:
        raise ValueError(
            "tier='serve' jobs initialize from their seed (the engine's "
            "slot-admission protocol); custom x0/y0 are a "
            "reference-tier feature — use tier='reference' or bake the "
            "init into the problem")
    if engine is None:
        engine = ServeEngine(record_metrics=True, device=device,
                             flight_recorder=recorder)
    elif not engine.record_metrics:
        raise ValueError(
            "the ServeEngine passed to solve(tier='serve') must be "
            "built with record_metrics=True so the SolveResult can "
            "carry the per-round metric trajectory")
    elif recorder is not None and engine.flight_recorder != recorder:
        raise ValueError(
            "solve(recorder=...) on a pre-built engine needs the "
            "engine constructed with the same flight_recorder= spec "
            "(the recorder buffer is part of every bucket's carry)")
    elif engine.device != device:
        raise ValueError(f"the ServeEngine runs on {engine.device}; this "
                         f"solve on {device}")
    mf = _default_serve_metrics if metrics_fn is None else metrics_fn
    job = JobSpec(family=_inline_family(prob), problem={},
                  config=dataclasses.replace(spec, tier="reference"),
                  graph=net, seed=seed)
    prev_mf = engine.metrics_fn
    engine.metrics_fn = mf
    try:
        engine.submit(job)
        (res,) = engine.run()
    finally:
        engine.metrics_fn = prev_mf
    extras = {"rounds": res.rounds, "converged": res.converged,
              "final_gap": res.final_gap,
              "wire_bytes": res.wire_bytes,
              "wire_floats": res.wire_floats, "sends": res.sends}
    if recorder is not None:
        extras["flight"] = res.flight
    metrics = {k: torch.as_tensor(v, device=device)
               for k, v in (res.metrics or {}).items()}
    return SolveResult(
        x=res.x.to(device), y=res.y.to(device), metrics=metrics,
        ledger=engine.ledgers[res.signature], channels=None,
        method="dagm", tier="serve", extras=extras)


# ---------------------------------------------------------------------------
# sharded tier
# ---------------------------------------------------------------------------

def _as_ring(mesh, spec: SolverSpec, device):
    """The agent ring `mesh` names, on the solve's device."""
    from ..distributed import LocalRing, ProcessRing
    if mesh is None:
        raise ValueError(
            "tier='sharded' runs on a ring of agents: pass solve(..., "
            "mesh=LocalRing(n)) for all agents on one device, or a "
            "torch.distributed DeviceMesh whose "
            f"{spec.sharded.axis!r} dim(s) hold one agent per rank")
    if isinstance(mesh, (LocalRing, ProcessRing)):
        ring = mesh
    else:
        from torch.distributed.device_mesh import DeviceMesh
        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a LocalRing, a ProcessRing or "
                            f"a DeviceMesh, got {type(mesh).__name__}")
        ring = ProcessRing(mesh, spec.sharded.axis)
    if device is not None and resolve_device(device) != ring.device:
        raise ValueError(f"the ring runs on {ring.device}; this solve "
                         f"asks for {device}")
    return ring


def _state_tree(tree, dev):
    """numpy or tensor leaves -> float32 tensors on `dev`."""
    from torch.utils._pytree import tree_map
    return tree_map(lambda a: torch.as_tensor(
        np.asarray(a) if not isinstance(a, torch.Tensor) else a,
        dtype=torch.float32, device=dev).contiguous(), tree)


def _solve_sharded(prob, spec: SolverSpec, *, x0, y0, seed, metrics_fn,
                   mesh, g_fn, f_fn, batch, device, recorder=None
                   ) -> SolveResult:
    from torch.utils._pytree import tree_flatten, tree_map

    from .. import obs
    from ..distributed.dagm_sharded import (make_sharded_dagm,
                                            open_sharded_channels,
                                            round_channels,
                                            sharded_comm_ledger,
                                            sharded_round_coeffs)
    if metrics_fn is not None:
        raise ValueError(
            "tier='sharded' records the fixed per-agent metrics (outer/"
            "inner loss, hypergrad norm, consensus, comm sends); a "
            "custom metrics_fn is a reference-tier feature")
    if g_fn is None or f_fn is None:
        if prob is None:
            raise ValueError(
                "tier='sharded' needs objectives: pass a BilevelProblem "
                "as `problem`, or explicit g_fn/f_fn tree objectives "
                "(with x0/y0/batch)")
        g_fn = g_fn or prob.g
        f_fn = f_fn or prob.f
    if batch is None:
        if prob is None:
            raise ValueError(
                "tier='sharded' with raw g_fn/f_fn needs the stacked "
                "per-agent `batch` tree (leading agent axis)")
        batch = prob.data
    ring = _as_ring(mesh, spec, device)
    dev = ring.device
    n = ring.n
    if x0 is None or y0 is None:
        if prob is None:
            raise ValueError(
                "tier='sharded' with raw g_fn/f_fn needs explicit x0/y0 "
                "stacked iterates (the shapes are not inferable)")
    if x0 is None:
        x0 = torch.zeros((n, prob.d1), dtype=torch.float32, device=dev)
    if y0 is None:
        gen = torch.Generator(dev).manual_seed(seed)
        y0 = 0.01 * torch.randn((n, prob.d2), generator=gen,
                                dtype=torch.float32, device=dev)
    x0, y0 = _state_tree(x0, dev), _state_tree(y0, dev)
    for name, tree in (("x0", x0), ("y0", y0), ("batch", batch)):
        for leaf in tree_flatten(tree)[0]:
            if leaf.shape[0] != n or leaf.device != dev:
                raise ValueError(
                    f"every {name} leaf needs a leading agent axis of the "
                    f"ring's n={n} on {dev}; got {tuple(leaf.shape)} on "
                    f"{leaf.device}")
    x, y = x0, y0
    if not ring.stacked:
        # a process ring's rank runs its own agent's rows
        x, y, batch = tree_map(lambda t: t[ring.rank], (x, y, batch))

    step, w = make_sharded_dagm(g_fn, f_fn, spec, ring, recorder=recorder)
    sched = spec.schedule.materialize(spec.K)
    channels = open_sharded_channels(spec, x, y, seed) \
        if spec.comm.persist_ef else None
    rec = obs.recorder_init(recorder, device=dev) \
        if recorder is not None else None
    rows = []
    tr = obs.tracer()
    # the round loop is the host's, so with tracing on each round span
    # waits for the device and measures the round's wall time
    with tr.span("solve", cat="solver", track="solver", method="dagm",
                 tier="sharded", K=spec.K, seed=seed):
        for k in range(spec.K):
            hp = sharded_round_coeffs(float(sched.alpha[k]),
                                      float(sched.beta[k]),
                                      spec.curvature, w.w_self)
            cs = channels if channels is not None \
                else round_channels(spec, x, y, seed, k)
            with tr.span("outer_round", cat="solver.round",
                         track="solver", round=k):
                if rec is not None:
                    x, y, m, cs, rec = step(x, y, batch, cs, hp,
                                            float(sched.gamma[k]), rec)
                else:
                    x, y, m, cs = step(x, y, batch, cs, hp)
                if tr.enabled and dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            if channels is not None:
                channels = cs
            rows.append(m)
    metrics = {key: torch.stack([r[key] for r in rows]) for key in rows[0]}
    local = tree_map(lambda t: t[0], (x0, y0))
    ledger = sharded_comm_ledger(spec, local[0], local[1], rounds=spec.K)
    if not ring.stacked:          # the agent's rows, (1, ...) leaves
        x, y = tree_map(lambda t: t[None], (x, y))
    extras = {"ring": w}
    if rec is not None:
        extras["flight"] = obs.recorder_rows(rec)
    return SolveResult(x=x, y=y, metrics=metrics, ledger=ledger,
                       channels=channels, method="dagm", tier="sharded",
                       extras=extras)
