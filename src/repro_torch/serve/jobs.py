"""Job descriptions for the multi-tenant bilevel solver engine.

Counterpart of `repro.serve.jobs`.  A `JobSpec` is one independent DAGM
instance — a problem-zoo family (`core.problems.PROBLEM_FAMILIES`)
instantiated with its own data/seed, plus a `repro_torch.solve
.SolverSpec` for the run.  The engine never executes a JobSpec
directly: specs are grouped by `compile_signature` (everything that
shapes a bucket's runner), padded into fixed-width buckets, and run as
one job-axis chunk per bucket (`repro_torch.serve.engine`).

The signature split, as `repro`'s:

* **static** (bucket key): problem family + data leaf shapes, (n, d1,
  d2), topology, mixing backend/dtype, comm policy, dihgp backend,
  K / M / U loop bounds, and whether a curvature bound is supplied.
  Two jobs with equal signatures share one bucket runner.
* **per-job** (vary freely inside a bucket): the data *values*, the
  init seed, the curvature bound, and the full α/β/γ schedules, which
  enter the runner as (B,) device tables per round.

`JobResult` reports the per-job outcome *including the exact wire
bytes* the job's gossip cost, attributed from the bucket's per-slot send
counters (`repro_torch.comm.CommLedger.per_job_bytes`).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any

import numpy as np

from ..core.problems import BilevelProblem, problem_family
from ..solve.spec import SolverSpec, validate_spec
from ..topology.ops import Network, make_network

Signature = tuple


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One bilevel solve request (fields as `repro.serve.JobSpec`).

    family:   `core.problems.PROBLEM_FAMILIES` key, or a callable
              constructor (called with the `problem` kwargs) for
              problems outside the zoo — `repro_torch.solve`'s serve
              tier wraps ad-hoc problem instances this way.
    problem:  constructor kwargs for the family (n, d, m_per, seed, ...);
              the engine adds its device.  Everything that changes a
              data *shape* changes the signature.
    config:   `SolverSpec` for the run.  The schedules and curvature are
              per-job; the remaining fields are bucket-static.
    graph:    topology kind for `make_network` (+ graph_kwargs), or a
              prebuilt `Network`; shared across a bucket.
    seed:     init seed (y0 draw + comm channel streams), per-job.
    tol:      optional convergence threshold on the Eq. (17b) estimate
              ‖∇̂F‖²; a job whose last chunked round reaches it retires
              early and its slot is backfilled from the queue.
    job_id:   caller's handle (auto-assigned when None).
    tenant, klass: admission-loop identities; never part of the
              signature (the wave-mode engine ignores them).
    """
    family: Any
    problem: dict
    config: Any
    graph: Any = "ring"
    graph_kwargs: dict = dataclasses.field(default_factory=dict)
    seed: int = 0
    tol: float | None = None
    job_id: str | None = None
    tenant: str = "default"
    klass: str = "standard"


@dataclasses.dataclass
class JobResult:
    """Outcome of one job: final iterates, convergence, cost."""
    job_id: str
    x: Any                    # final stacked outer iterates (n, d1), host
    y: Any                    # final stacked inner iterates (n, d2), host
    rounds: int               # outer rounds actually run (≤ config.K)
    converged: bool           # tol reached before the K-round budget
    final_gap: float          # last ‖∇̂F‖² (Eq. 17b estimate)
    wire_bytes: int           # exact gossip bytes this job moved
    wire_floats: int          # uncompressed f32 words (comparison base)
    sends: dict               # per-channel send counts
    wall_clock_s: float       # engine wall time attributed to this job
    signature: Signature      # bucket the job ran in
    metrics: dict | None = None   # per-round trajectory when recorded
    quarantined: bool = False     # a chunk made this job's iterates
    #                               non-finite; x/y hold the last finite
    #                               state before it
    flight: Any = None            # (rows, len(obs.FIELDS)) flight rows
    #                               when the engine has a flight_recorder


def solver_spec(spec: JobSpec) -> SolverSpec:
    """The job's SolverSpec with the tier pinned to "reference" (the
    chunk machinery is tier-agnostic; the job already *is* the serve
    tier)."""
    s = spec.config
    if not isinstance(s, SolverSpec):
        raise TypeError(f"JobSpec.config must be a repro_torch.solve."
                        f"SolverSpec, got {type(s).__name__}")
    return dataclasses.replace(s, tier="reference") \
        if s.tier != "reference" else s


def build_problem(spec: JobSpec, device=None) -> BilevelProblem:
    """Instantiate the spec's problem-zoo family on `device` (or call an
    ad-hoc family, which brings its own device)."""
    if callable(spec.family):
        return spec.family(**spec.problem)
    kw = dict(spec.problem)
    kw.setdefault("device", device)
    return problem_family(spec.family)(**kw)


def build_network(spec: JobSpec) -> Network:
    """Topology shared by the spec's bucket (n defaults to the
    problem's agent count); prebuilt Networks pass through."""
    if isinstance(spec.graph, Network):
        return spec.graph
    kw = dict(spec.graph_kwargs)
    n = int(kw.pop("n")) if "n" in kw else _graph_n(spec)
    return make_network(spec.graph, n, **kw)


def _graph_n(spec: JobSpec) -> int:
    n = spec.problem.get("n")
    if n is None:
        raise ValueError(
            f"JobSpec.problem must carry the agent count 'n' "
            f"(got keys {sorted(spec.problem)})")
    return int(n)


def schedule_rows(cfg: SolverSpec) -> np.ndarray:
    """(K, 3) float32 (α, β, γ) schedule rows in the order the engine's
    chunk runner consumes them."""
    sched = cfg.schedule.materialize(cfg.K)
    return np.stack([sched.alpha, sched.beta, sched.gamma],
                    axis=1).astype(np.float32)


def job_hp(spec: JobSpec) -> np.ndarray:
    """The per-job hyper-parameter schedule rows (see `schedule_rows`)."""
    return schedule_rows(spec.config)


def compile_signature(spec: JobSpec, prob: BilevelProblem) -> Signature:
    """Everything that shapes a bucket's runner (see module docstring);
    per-job data values, seeds, curvature bounds and schedule values
    stay out."""
    return _signature(spec, prob, k_entry=None)


def pack_signature(spec: JobSpec, prob: BilevelProblem) -> Signature:
    """`compile_signature` with the round budget K replaced by a
    sentinel: the near-miss bucket key of `repro`'s admission K-packing
    (jobs that differ only in K)."""
    return _signature(spec, prob, k_entry="K:packed")


def _signature(spec: JobSpec, prob: BilevelProblem, k_entry) -> Signature:
    s = solver_spec(spec)
    validate_spec(s)
    if s.faults is not None:
        raise ValueError(
            "serve jobs do not thread fault masks yet: a bucket's "
            "runner carries per-slot hyper-parameter operands only, so a "
            "per-job FaultSpec would be silently ignored — run faulted "
            "solves through repro_torch.solve with tier='reference', or "
            "drop SolverSpec.faults")
    leaf_shapes = tuple(sorted((f"[{k!r}]", tuple(v.shape))
                               for k, v in prob.data.items()))
    if isinstance(spec.graph, Network):
        # content-addressed: two prebuilt Networks with equal (name, n)
        # but different W must not share a bucket
        digest = hashlib.sha1(
            np.ascontiguousarray(spec.graph.W).tobytes()).hexdigest()
        graph = ("net", spec.graph.name, spec.graph.n, digest)
    else:
        graph = (spec.graph,) + tuple(sorted(spec.graph_kwargs.items()))
    return (spec.family, prob.n, prob.d1, prob.d2, leaf_shapes, graph,
            s.mixing.backend, s.mixing.dtype, s.comm.spec, s.dihgp,
            s.K if k_entry is None else k_entry, s.M, s.U,
            s.curvature is not None)
