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

`SolveResult.ledger` charges the exact (compressed) bytes of the sends
that ran.  The serve and sharded tiers, and the flight recorder, raise
NotImplementedError naming the ROADMAP queue item that ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from .._device import resolve_device, strict_f32
from .spec import SolverSpec, mixing_kwargs, validate_spec

_QUEUED_TIERS = {"serve": "ROADMAP queue 1 item 9 (serve)",
                 "sharded": "ROADMAP queue 1 item 11 (sharded tier)"}


@dataclasses.dataclass
class SolveResult:
    """Outcome of a `solve` call."""
    x: torch.Tensor              # final stacked outer iterates (n, d1)
    y: torch.Tensor              # final stacked inner iterates (n, d2)
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
          device=None, recorder=None) -> SolveResult:
    """Run `spec` on (problem, network) and return a `SolveResult`.

    problem:  a `repro_torch.core.problems.BilevelProblem` whose data
              lies on `device`.
    network:  a `repro_torch.topology.Network`; ignored by "fednest"
              (its star is implicit).
    x0/y0:    optional initial stacked iterates, numpy arrays or tensors.
    seed:     the y0 draw (`torch.Generator(device).manual_seed(seed)`)
              and the gossip channels' random streams.
    device:   where the run happens — CUDA unless the caller names
              another; raises without a card.
    Runs inside `strict_f32`: the caller's TF32 flags are unchanged on
    return.
    """
    validate_spec(spec)
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
    if spec.tier != "reference":
        raise NotImplementedError(
            f"tier={spec.tier!r} is {_QUEUED_TIERS[spec.tier]}")
    if recorder is not None:
        raise NotImplementedError(
            "the flight recorder is ROADMAP queue 1 item 10 (obs)")
    x0 = _as_state(x0, (problem.n, problem.d1), dev)
    y0 = _as_state(y0, (problem.n, problem.d2), dev)
    if spec.method == "dagm":
        return _solve_dagm_reference(problem, network, spec, device=dev,
                                     seed=seed, metrics_fn=metrics_fn,
                                     x0=x0, y0=y0)
    return _solve_baseline(problem, network, spec, device=dev, x0=x0,
                           y0=y0, seed=seed)


def _schedule_hp(spec: SolverSpec):
    from ..core.dagm import RoundHP
    sched = spec.schedule.materialize(spec.K)
    return RoundHP(alpha=sched.alpha, beta=sched.beta, gamma=sched.gamma)


def _solve_dagm_reference(prob, net, spec: SolverSpec, *, device, x0, y0,
                          seed, metrics_fn) -> SolveResult:
    from ..core.dagm import dagm_init_carry, dagm_run_chunk
    from ..topology.ops import make_mixing_op
    W = make_mixing_op(net, device=device, **mixing_kwargs(spec))
    carry0 = dagm_init_carry(prob, W, spec, x0, y0, seed)
    # faults lower once, on the host, to a (K, n, k_max) mask operand
    # that dagm_run_chunk moves to the device before its loop
    trace = masks = None
    if spec.faults is not None:
        from ..faults import lower_faults
        trace = lower_faults(spec.faults, net, spec.K)
        masks = trace.table_masks(W.sparse)
    ((x, y), cs), metrics = dagm_run_chunk(prob, W, spec, carry0, spec.K,
                                           metrics_fn,
                                           hp=_schedule_hp(spec),
                                           masks=masks)
    W.ledger.charge_states(cs.values())
    extras = {}
    if trace is not None:
        # ledger sends stay nominal (channel counters tick whether or
        # not a given link carried the payload); the honest wire scale
        # of the faulted run is the trace's realized-link fraction
        extras = {"fault_trace": trace,
                  "fault_alive_fraction": trace.alive_fraction()}
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
