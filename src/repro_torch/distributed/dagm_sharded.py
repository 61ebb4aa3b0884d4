"""Pod-scale DAGM: the paper's Algorithm 2 on a ring of agents — the
counterpart of `repro.distributed.dagm_sharded`.

Each agent holds a tree copy of the inner variable y (e.g. model
parameters) and the outer variable x, plus its data shard.  Every
cross-agent exchange is a ring gossip (`collectives.ring_mix_c`):
vectors only, never matrices, the paper's communication pattern.  The
ring is a `LocalRing` (all agents on one device, leaves with a leading
agent axis, per-agent autodiff under `torch.func.vmap`) or a
`ProcessRing` (one agent per rank, the agent's own leaves).

The inner HVPs are jvp-of-grad (matrix-free), and DIHGP is the
scalar-preconditioned splitting D̃ = (β·c + 2(1 − w_self))·I in this
tier's own algebra, h ← (1/D̃)·((D̃·h − (β·hvp + (I−W)h)) − p), whose
rounding differs from the fused Neumann step's (`kernels.ref
.neumann_update`), so it composes the gossip with tree arithmetic.
Nothing larger than a parameter tree is materialized or sent.

`dagm_local_round` is one round from the agents' side; `make_sharded_dagm`
wraps it into a step for a ring; `repro_torch.solve` drives it with
per-round coefficients (tier="sharded").
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
from torch.func import grad, jvp
from torch.utils._pytree import tree_flatten, tree_map

from .collectives import (ring_laplacian, ring_laplacian_c, ring_mix_c,
                          tadd, taxpy, tdot, tscale, tsub)

Pytree = Any
CHANNELS = ("inner_y", "dihgp_h", "outer_x")
# the per-round channel streams' own fold constant, as `repro` folds
# 0x5eed into the run's key
_ROUND_FOLD = 0x5eed


class ShardedRoundCoeffs(NamedTuple):
    """One outer round's scalar coefficients (float32).  The update
    algebra only multiplies by (combinations of) α, β and D̃; every
    reciprocal is taken on the host in float64, then rounded to f32."""
    neg_beta: Any       # −β   (inner DGD step)
    beta: Any           # β    (HVP + cross terms)
    d: Any              # D̃ = β·c + 2(1−w_self)
    neg_inv_d: Any      # −1/D̃ (DIHGP init)
    inv_d: Any          # 1/D̃  (DIHGP rescale)
    neg_alpha: Any      # −α   (outer step)


def sharded_round_coeffs(alpha: float, beta: float, curvature: float,
                         w_self: float) -> ShardedRoundCoeffs:
    """Host-side (float64) coefficient math, rounded to f32 once."""
    d = beta * curvature + 2.0 * (1.0 - w_self)
    return ShardedRoundCoeffs(
        neg_beta=np.float32(-beta), beta=np.float32(beta),
        d=np.float32(d), neg_inv_d=np.float32(-1.0 / d),
        inv_d=np.float32(1.0 / d), neg_alpha=np.float32(-alpha))


def sharded_policy(spec):
    """The tier's wire policy: `spec.comm`, with `mixing.dtype="bf16"`
    on the identity comm taken as the bf16 wire."""
    from ..comm import parse_comm_spec
    comm = spec.comm.spec
    if comm == "identity" and spec.mixing.dtype == "bf16":
        comm = "bf16"
    return parse_comm_spec(comm)


def _check_spec(spec) -> None:
    from ..solve.spec import SolverSpec
    if not isinstance(spec, SolverSpec):
        raise TypeError(f"expected a repro_torch SolverSpec, got "
                        f"{type(spec).__name__}")
    if spec.curvature is None:
        raise ValueError(
            "the sharded tier's scalar-preconditioned DIHGP needs "
            "SolverSpec.curvature (a λmax bound on the local inner "
            "Hessians)")


def _zero_hats(st):
    """The channel with its EF replicas at zero, each leaf's zeros one
    element broadcast to the leaf's shape: a model's replica tree is
    gigabytes, and the first send replaces it with the payload."""
    if st.hat is None:
        return st
    return dataclasses.replace(st, hat=tree_map(
        lambda t: t.new_zeros(()).expand(t.shape), st.hat))


def _open(spec, x, y, seeds: dict) -> dict:
    from ..comm import channel_init
    pol = sharded_policy(spec)
    tpl = {"inner_y": y, "dihgp_h": y, "outer_x": x}
    return {name: _zero_hats(channel_init(pol, name, tpl[name],
                                          seeds[name]))
            for name in CHANNELS}


def round_channels(spec, x: Pytree, y: Pytree, seed: int, k: int) -> dict:
    """Round k's fresh channels (EF replicas at zero, send counters at
    0), their streams `channel_seeds` of (seed ^ 0x5eed) folded with k.
    x / y are the ring's state trees (the hats' templates)."""
    from ..comm import channel_seeds, fold_seed
    return _open(spec, x, y, channel_seeds(
        fold_seed(seed ^ _ROUND_FOLD, k), CHANNELS))


def open_sharded_channels(spec, x: Pytree, y: Pytree, seed: int = 0
                          ) -> dict:
    """The three channels a persist_ef run threads through every round,
    opened once: EF replicas at zero, streams `channel_seeds(seed)`, send
    counters accumulating over the run.  The stochastic draws are keyed
    on (stream, agent row, column), so one stream serves every agent."""
    from ..comm import channel_seeds
    return _open(spec, x, y, channel_seeds(seed, CHANNELS))


def _agent_sq(ring, tree) -> torch.Tensor:
    """Each agent's ‖tree‖² ((n,) on a LocalRing, () on a ProcessRing)."""
    return sum(ring.agent_sum(t * t) for t in tree_flatten(tree)[0])


def dagm_local_round(g_fn: Callable, f_fn: Callable, spec, ring,
                     x: Pytree, y: Pytree, batch: Pytree, channels: dict,
                     hp: ShardedRoundCoeffs | None = None,
                     flight_gamma=None):
    """One DAGM outer round.

    g_fn(x, y, batch) -> scalar local inner loss of one agent
    f_fn(x, y, batch) -> scalar local outer loss of one agent
    x, y, batch: the ring's trees (a leading agent axis on a LocalRing).
    channels: {"inner_y", "dihgp_h", "outer_x"} ChannelStates, fresh
    each round (`round_channels`) or carried over (`open_sharded_channels`,
    persist_ef); dihgp_h's replica restarts at zero either way, with h.
    hp: this round's `ShardedRoundCoeffs` (None: round 0 of spec's
    schedule).  flight_gamma: γₖ, which adds `flight_gap_sq` (the agent
    mean of ‖γ·(I−W)x + β·cross + ∇ₓf‖²) and `flight_consensus_sq` (of
    ‖x − x̄‖²) to the metrics.

    Returns (x⁺, y, metrics, channels); metrics are agent means."""
    _check_spec(spec)
    if hp is None:
        sched = spec.schedule.materialize(max(spec.K, 1))
        hp = sharded_round_coeffs(float(sched.alpha[0]),
                                  float(sched.beta[0]), spec.curvature,
                                  ring.w.w_self)
    neg_beta, beta, d, neg_inv_d, inv_d, neg_alpha = (float(c) for c in hp)
    pol = sharded_policy(spec)
    agent = ring.per_agent
    grad_y_g = agent(grad(g_fn, argnums=1))
    grad_x_f = agent(grad(f_fn, argnums=0))
    grad_y_f = agent(grad(f_fn, argnums=1))
    st_y = channels["inner_y"]
    st_h = _zero_hats(channels["dihgp_h"])        # h restarts at zero
    st_x = channels["outer_x"]

    # ---- inner loop: y ← W y − β ∇_y g  (Eq. 15/16), M steps ----
    me = spec.sharded.mix_every
    for t in range(spec.M):
        if t % me == me - 1:
            mixed, st_y = ring_mix_c(y, ring, pol, st_y)
        else:
            mixed = y
        y = taxpy(neg_beta, grad_y_g(x, y, batch), mixed)
        # each tree dropped when done: an LM's are several GB
        del mixed

    # ---- DIHGP (Alg. 1, scalar-preconditioned, matrix-free) ----
    def hvp_one(xi, yi, bi, vi):
        return jvp(lambda yy: grad(g_fn, argnums=1)(xi, yy, bi),
                   (yi,), (vi,))[1]
    hvp = agent(hvp_one)
    p = grad_y_f(x, y, batch)
    h = tscale(neg_inv_d, p)
    for _ in range(spec.U):
        # the HVP before the gossip: its autodiff, the round's largest
        # live set, then holds no gossip output beside it
        hvp_h = hvp(x, y, batch, h)
        lap, st_h = ring_laplacian_c(h, ring, pol, st_h)
        bh_mix = taxpy(beta, hvp_h, lap)
        del hvp_h, lap
        bh = tsub(tscale(d, h), bh_mix)                       # B̃ h
        del bh_mix
        h = tscale(inv_d, tsub(bh, p))
        del bh

    # ---- outer hyper-gradient (Eq. 17b) and step ----
    def cross_one(xi, yi, bi, hi):
        return grad(lambda xx: tdot(grad(g_fn, argnums=1)(xx, yi, bi),
                                    hi))(xi)
    cross = agent(cross_one)(x, y, batch, h)
    d_dir = taxpy(beta, cross, grad_x_f(x, y, batch))
    mixed_x, st_x = ring_mix_c(x, ring, pol, st_x)
    x_new = taxpy(neg_alpha, d_dir, mixed_x)                  # Ẃx − α(...)

    # the consensus metric's exchange is full precision (a diagnostic,
    # outside the ledger)
    lap_x = ring_laplacian(x, ring)
    per_agent = {
        "outer_loss": agent(f_fn)(x, y, batch),
        "inner_loss": agent(g_fn)(x, y, batch),
        "hypergrad_norm": torch.sqrt(_agent_sq(ring, d_dir)),
        "consensus_x": torch.sqrt(_agent_sq(ring, lap_x)),
    }
    if flight_gamma is not None:
        gamma = float(np.float32(flight_gamma))
        per_agent["flight_gap_sq"] = _agent_sq(
            ring, tadd(tscale(gamma, lap_x), d_dir))
        per_agent["flight_consensus_sq"] = _agent_sq(
            ring, tsub(x, ring.average(x)))
    metrics = ring.mean(per_agent)
    # gossip exchanges from the channel counters (this round's, or the
    # run's under persist_ef): `sharded_comm_ledger` charges the same
    metrics["comm_sends"] = torch.tensor(
        float(st_y.sends + st_h.sends + st_x.sends), dtype=torch.float32,
        device=metrics["outer_loss"].device)
    return x_new, y, metrics, \
        {"inner_y": st_y, "dihgp_h": st_h, "outer_x": st_x}


def _local_leaves(ring, tree) -> list:
    """One agent's leaves (shapes only) of a ring state tree."""
    leaves = tree_flatten(tree)[0]
    if ring.stacked:
        leaves = [t[0] for t in leaves]
    return [torch.empty(t.shape, dtype=t.dtype, device="meta")
            for t in leaves]


def make_sharded_dagm(g_fn: Callable, f_fn: Callable, spec, ring,
                      recorder=None):
    """One DAGM round as a step on `ring`: returns (step, ring weights).

        step(x, y, batch, channels, hp=None) -> (x, y, metrics, channels)

    `channels` as `dagm_local_round` takes them; `hp` this round's
    `ShardedRoundCoeffs`, so one step serves any (αₖ, βₖ) schedule.
    Each call builds one step, counted by
    `TraceCounter("sharded_dagm_step")`.

    `recorder` (a `repro_torch.obs.RecorderSpec`) builds the recording
    twin, which takes and returns a `FlightBuffer` and γₖ:

        step(x, y, batch, channels, hp, gamma, rec)
            -> (x, y, metrics, channels, rec)

    appending one flight row a call: the agent-summed Eq. 17b gap, γₖ ×
    consensus_error(x), the cumulative exact wire bytes (rounds so far ×
    one round's `sharded_comm_ledger` charge) and alive fraction 1.0."""
    from ..obs import TraceCounter
    _check_spec(spec)
    TraceCounter("sharded_dagm_step").bump()
    if recorder is not None:
        return _make_recorded_step(g_fn, f_fn, spec, ring), ring.w

    def step(x, y, batch, channels, hp=None):
        return dagm_local_round(g_fn, f_fn, spec, ring, x, y, batch,
                                channels, hp=hp)
    return step, ring.w


def _make_recorded_step(g_fn, f_fn, spec, ring):
    """The flight-recorder twin of `make_sharded_dagm`'s step."""
    from ..obs.recorder import recorder_write
    round_bytes = {}

    def step(x, y, batch, channels, hp, gamma, rec):
        x1, y1, m, channels = dagm_local_round(
            g_fn, f_fn, spec, ring, x, y, batch, channels, hp=hp,
            flight_gamma=gamma)
        if "b" not in round_bytes:
            round_bytes["b"] = float(sharded_comm_ledger(
                spec, _local_leaves(ring, x), _local_leaves(ring, y),
                rounds=1).total_bytes)
        # agent means: the reference gap is the agent sum, while the
        # consensus error already divides by n
        gap = m.pop("flight_gap_sq") * float(ring.n)
        cons = m.pop("flight_consensus_sq")
        wire = (rec.count + 1).to(torch.float32) \
            * float(np.float32(round_bytes["b"]))
        rec = recorder_write(rec, {
            "outer_gap_sq": gap,
            "penalty": float(np.float32(gamma)) * cons,
            "wire_bytes": wire,
            "alive_fraction": torch.ones((), dtype=torch.float32,
                                         device=gap.device)})
        return x1, y1, m, channels, rec
    return step


def sharded_comm_ledger(spec, x: Pytree, y: Pytree, rounds: int = 1):
    """Byte-accurate CommLedger of the sharded DAGM round.

    `x` / `y` are one agent's trees (tensors, or anything with a
    `.shape`, leaves without the agent axis).  Each leaf is one wire row
    of the tier's policy (`sharded_policy`); sends per round follow the
    round's loops (inner M // mix_every, DIHGP U, outer 1).  The
    consensus metric's full-precision exchange is not the algorithm's
    traffic and is not charged."""
    from ..comm import CommLedger
    pol = sharded_policy(spec)
    comp = pol.compressor

    def tree_cost(tree):
        leaves = tree_flatten(tree)[0]
        return (sum(comp.payload_bytes(tuple(t.shape)) for t in leaves),
                sum(comp.payload_floats(tuple(t.shape)) for t in leaves))

    me = spec.sharded.mix_every
    inner_sends = sum(1 for t in range(spec.M) if t % me == me - 1)
    led = CommLedger("dagm_sharded")
    for name, tree, per_round in (("inner_y", y, inner_sends),
                                  ("dihgp_h", y, spec.U),
                                  ("outer_x", x, 1)):
        bytes_per, floats_per = tree_cost(tree)
        led.add_channel(name, (floats_per,), spec=pol.spec,
                        sends=rounds * per_round,
                        floats_per_send=floats_per,
                        bytes_per_send=bytes_per)
    return led
