"""Layered solver specification — a jax-free copy of `repro.solve.spec`.

    SolverSpec(method="dagm", tier="reference", K=..., M=..., U=...,
               schedule=ScheduleSpec(alpha=..., beta=..., gamma=...),
               mixing=MixingSpec(...), comm=CommSpec(...),
               sharded=ShardedSpec(...))

* `ScheduleSpec` — the run's hyper-parameter sequences.  Each of α/β/γ
  is a constant, an explicit length-K tuple, or a callable applied to
  `np.arange(K)` (a `repro_torch.optim` schedule); `materialize()`
  lowers all three to (K,) float32 arrays.  γ defaults to
  float32(1)/float32(α), the paper's coupling.
* `MixingSpec` — the gossip execution backend (`repro_torch.topology`).
* `CommSpec`   — the gossip wire policy (`repro_torch.comm`) and, on the
  sharded tier, whether error feedback persists across rounds.
* `ShardedSpec`— the sharded tier's ring axis and inner gossip period
  (`repro_torch.distributed`).

The baselines read `momentum` (MA-DBO), `b` (DGBO) and `N` (DGTBO);
`faults` takes a `repro_torch.faults.FaultSpec` (DAGM on the reference
tier).  `repro`'s `ShardedSpec.unroll_loops` has no counterpart: the
port's loops are Python loops already.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

METHODS = ("dagm", "dgbo", "dgtbo", "ma_dbo", "fednest")
TIERS = ("reference", "sharded", "serve")


def _freeze_sequence(val):
    """Lists/arrays become tuples so specs stay hashable."""
    if isinstance(val, (list, np.ndarray)):
        return tuple(float(v) for v in np.asarray(val).ravel())
    return val


@dataclasses.dataclass(frozen=True)
class ScheduleSpec:
    """Runtime hyper-parameter sequences (per outer round k < K).

    alpha: outer step size αₖ.
    beta:  inner step size βₖ (also the inner penalty 1/βₖ).
    gamma: outer penalty coefficient γₖ multiplying (I−Ẃ)x in the
           Eq. (17b) hyper-gradient.  None keeps γₖ = 1/αₖ.
    """
    alpha: Any = 1e-2
    beta: Any = 1e-2
    gamma: Any = None

    def __post_init__(self):
        object.__setattr__(self, "alpha", _freeze_sequence(self.alpha))
        object.__setattr__(self, "beta", _freeze_sequence(self.beta))
        object.__setattr__(self, "gamma", _freeze_sequence(self.gamma))

    @property
    def is_constant(self) -> bool:
        return all(not callable(v) and not isinstance(v, tuple)
                   for v in (self.alpha, self.beta, self.gamma))

    def materialize(self, K: int) -> "RoundSchedules":
        """(K,) float32 arrays for α/β/γ (γ = f32(1)/f32(α) when None)."""
        alpha = _materialize_one(self.alpha, K, "alpha")
        beta = _materialize_one(self.beta, K, "beta")
        for name, arr in (("alpha", alpha), ("beta", beta)):
            if not np.all(arr > 0):
                raise ValueError(
                    f"ScheduleSpec.{name} must be positive at every "
                    f"round (min over K={K} rounds was {arr.min()!r}); "
                    f"step sizes of 0 or below stall/ diverge the run")
        if self.gamma is None:
            gamma = np.float32(1.0) / alpha
        else:
            gamma = _materialize_one(self.gamma, K, "gamma")
        return RoundSchedules(alpha=alpha, beta=beta, gamma=gamma)


def _materialize_one(val, K: int, name: str) -> np.ndarray:
    if callable(val):                       # schedule of the round index
        arr = np.asarray(val(np.arange(K, dtype=np.int32)), np.float32)
        return np.broadcast_to(arr, (K,)).astype(np.float32)
    if isinstance(val, tuple):
        if len(val) != K:
            raise ValueError(
                f"ScheduleSpec.{name} has {len(val)} entries but the "
                f"run is K={K} rounds; pass one value per outer round "
                f"(or a float / a schedule callable)")
        return np.asarray(val, np.float32)
    return np.full((K,), np.float32(val), np.float32)


@dataclasses.dataclass(frozen=True)
class RoundSchedules:
    """Materialized (K,) float32 α/β/γ rows (host-side numpy)."""
    alpha: np.ndarray
    beta: np.ndarray
    gamma: np.ndarray


@dataclasses.dataclass(frozen=True)
class MixingSpec:
    """Gossip execution backend — see repro_torch.topology.ops.MixingOp."""
    backend: str = "auto"       # "auto" | "dense" | "circulant[_pallas]"
    #                             | "sparse_gather[_pallas]"
    dtype: str = "f32"          # "f32" | "bf16" storage/gossip dtype


@dataclasses.dataclass(frozen=True)
class CommSpec:
    """Gossip wire policy — see repro_torch.comm.parse_comm_spec.

    persist_ef: the sharded tier threads its channels (EF replicas, send
    counters, streams) across outer rounds instead of reopening them
    each round; the reference and serve tiers always do."""
    spec: str = "identity"
    persist_ef: bool = False


@dataclasses.dataclass(frozen=True)
class ShardedSpec:
    """The sharded tier's ring (`repro_torch.distributed`).

    axis: the `DeviceMesh` dim name(s) a `ProcessRing` rings over (a
          tuple rings over their flattened product).
    mix_every: j > 1 gossips y only every j-th inner step (the
          local-updates variant; cuts inner traffic by ~j)."""
    axis: Any = "data"
    mix_every: int = 1


@dataclasses.dataclass(frozen=True)
class SolverSpec:
    """The single run description `repro_torch.solve.solve` executes."""
    method: str = "dagm"        # METHODS
    tier: str = "reference"     # TIERS
    K: int = 100                # outer rounds
    M: int = 10                 # inner DGD steps per round
    U: int = 3                  # Neumann truncation order
    schedule: ScheduleSpec = ScheduleSpec()
    mixing: MixingSpec = MixingSpec()
    comm: CommSpec = CommSpec()
    sharded: ShardedSpec = ShardedSpec()
    dihgp: str = "dense"        # "dense" | "matrix_free" | "exact"
    curvature: float | None = None   # λmax bound for matrix_free
    momentum: float = 0.9       # ma_dbo tracker momentum
    b: int = 3                  # dgbo Hessian gossip rounds
    N: int = 5                  # dgtbo JHIP iterations
    faults: Any = None          # repro_torch.faults.FaultSpec (or None):
    #                             lower a fault trace and run every gossip
    #                             on the per-round realized W_k

    def comm_channels(self, d1: int, d2: int) -> list[tuple]:
        h_sends = 0 if self.dihgp == "exact" else self.U
        return [("inner_y", (d2,), self.M),
                ("dihgp_h", (d2,), h_sends),
                ("outer_x", (d1,), 1)]

    def comm_ledger(self, d1: int, d2: int, rounds: int | None = None):
        from ..comm import static_ledger
        K = self.K if rounds is None else rounds
        return static_ledger(
            self.comm.spec,
            [(name, shape, K * sends) for name, shape, sends
             in self.comm_channels(d1, d2)], name="dagm")


def validate_spec(spec: SolverSpec) -> None:
    """Reject inexpressible/conflicting specs with actionable messages."""
    if not isinstance(spec, SolverSpec):
        raise TypeError(f"expected a repro_torch SolverSpec, got "
                        f"{type(spec).__name__}")
    if spec.method not in METHODS:
        raise ValueError(
            f"unknown method {spec.method!r}; expected one of {METHODS}")
    if spec.tier not in TIERS:
        raise ValueError(
            f"unknown tier {spec.tier!r}; expected one of {TIERS}")
    for name, val in (("K", spec.K), ("M", spec.M), ("b", spec.b),
                      ("N", spec.N)):
        if int(val) <= 0:
            raise ValueError(
                f"SolverSpec.{name} must be a positive iteration count "
                f"(got {val}); 0 rounds is not a run — drop the phase "
                f"by choosing a method/dihgp that skips it instead")
    if int(spec.U) < 0:
        raise ValueError(
            f"SolverSpec.U must be a non-negative Neumann truncation "
            f"order (got {spec.U}); U=0 keeps only the D̃⁻¹ "
            f"preconditioner term")
    spec.schedule.materialize(spec.K)
    if spec.tier in ("sharded", "serve") and spec.method != "dagm":
        raise ValueError(
            f"tier={spec.tier!r} only executes method='dagm' (the "
            f"baselines exist for reference-tier comparison); got "
            f"method={spec.method!r} — use tier='reference'")
    if spec.schedule.gamma is not None and \
            spec.method in ("dgbo", "dgtbo", "fednest"):
        raise ValueError(
            f"method={spec.method!r} has no penalty term: the gamma "
            f"schedule multiplies DAGM's (I−Ŵ)x/α "
            f"penalty gradient, which this baseline never forms; drop "
            f"schedule.gamma or use method='dagm'/'ma_dbo'")
    if spec.schedule.gamma is not None and spec.tier == "sharded":
        raise ValueError(
            "the sharded tier folds the penalty coefficient into the "
            "Ẃx − α(·) update (α·γ = 1 by construction), so an explicit "
            "gamma schedule is inexpressible there; use tier='reference' "
            "for decoupled penalties")
    if spec.comm.persist_ef and spec.tier != "sharded":
        raise ValueError(
            f"CommSpec.persist_ef=True is a sharded-tier knob (the "
            f"reference and serve tiers already thread channel state "
            f"through the whole run); got tier={spec.tier!r}")
    if spec.comm.persist_ef and spec.comm.spec == "identity":
        raise ValueError(
            "CommSpec.persist_ef=True with spec='identity' conflicts: "
            "the identity wire has no error-feedback state to persist; "
            "pick a compressing spec (e.g. 'top_k:0.1+ef') or drop "
            "persist_ef")
    if int(spec.sharded.mix_every) <= 0:
        raise ValueError(f"ShardedSpec.mix_every must be >= 1 (got "
                         f"{spec.sharded.mix_every})")
    if spec.dihgp not in ("dense", "matrix_free", "exact"):
        raise ValueError(f"unknown dihgp backend {spec.dihgp!r}")
    from ..comm import parse_comm_spec
    parse_comm_spec(spec.comm.spec)
    if spec.comm.spec != "identity" and spec.dihgp == "exact":
        raise ValueError(
            "dihgp='exact' solves the penalized system densely and has "
            "no gossip to compress; use 'dense' or 'matrix_free' with "
            f"comm={spec.comm.spec!r}")
    if spec.faults is not None:
        from ..faults import FaultSpec
        if not isinstance(spec.faults, FaultSpec):
            raise ValueError(
                f"SolverSpec.faults must be a repro_torch.faults.FaultSpec "
                f"(got {type(spec.faults).__name__}); construct one "
                f"with FaultSpec(drop_prob=..., stragglers=..., "
                f"churn=..., seed=...)")
        if spec.method != "dagm":
            raise ValueError(
                f"fault injection degrades the DAGM gossip rounds; the "
                f"baseline methods do not thread per-round edge masks "
                f"(got method={spec.method!r}) — use method='dagm' or "
                f"drop SolverSpec.faults")
        if spec.tier != "reference":
            raise ValueError(
                f"fault-masked mixing is a reference-tier feature (got "
                f"tier={spec.tier!r}): serve buckets share one program "
                f"whose per-slot operands are hyper-parameters only, and "
                f"the sharded tier's gossip has no per-round mask "
                f"channel — use tier='reference'")
    if spec.tier == "sharded" and spec.curvature is None:
        raise ValueError(
            "the sharded tier's scalar-preconditioned DIHGP needs an "
            "explicit curvature bound (SolverSpec.curvature ≥ "
            "λmax(∇²_y g_i)); it runs no power iteration")


def mixing_kwargs(spec: SolverSpec) -> dict:
    """`make_mixing_op` kwargs from a spec."""
    return dict(backend=spec.mixing.backend, dtype=spec.mixing.dtype,
                comm=spec.comm.spec)


def dagm_spec(alpha=1e-2, beta=1e-2, gamma=None, K: int = 100,
              M: int = 10, U: int = 3, dihgp: str = "dense",
              curvature: float | None = None, mixing: str = "auto",
              mixing_dtype: str = "f32", comm: str = "identity",
              tier: str = "reference", faults=None) -> SolverSpec:
    """Convenience constructor mirroring the old DAGMConfig kwargs."""
    return SolverSpec(
        method="dagm", tier=tier, K=K, M=M, U=U,
        schedule=ScheduleSpec(alpha=alpha, beta=beta, gamma=gamma),
        mixing=MixingSpec(backend=mixing, dtype=mixing_dtype),
        comm=CommSpec(spec=comm), dihgp=dihgp, curvature=curvature,
        faults=faults)


def sharded_spec(alpha=1e-2, beta=1e-2, M: int = 5, U: int = 3,
                 curvature: float = 4.0, axis="data",
                 comm: str = "identity", comm_dtype: str = "f32",
                 persist_ef: bool = False, mix_every: int = 1,
                 K: int = 1) -> SolverSpec:
    """A tier="sharded" spec from `repro`'s `sharded_spec` kwargs (K is
    the round budget of `solve`); comm_dtype="bf16" on the identity comm
    is the bf16 wire."""
    if comm == "identity" and comm_dtype == "bf16":
        comm = "bf16"
    return SolverSpec(
        method="dagm", tier="sharded", K=K, M=M, U=U,
        schedule=ScheduleSpec(alpha=alpha, beta=beta),
        mixing=MixingSpec(dtype=comm_dtype),
        comm=CommSpec(spec=comm, persist_ef=persist_ef),
        sharded=ShardedSpec(axis=axis, mix_every=mix_every),
        dihgp="matrix_free", curvature=curvature)
