"""DAGM — Decentralized Alternating Gradient Method (Algorithm 2).

Each outer iteration k (of K):
  1. M inner DGD steps on the penalized inner problem (Eq. 15–16):
         y ← W y − βₖ ∇_y g(x, y)           [M neighbor exchanges of d2]
  2. DIHGP (Algorithm 1) for h ≈ −H^{-1}∇_y f  [U neighbor exchanges]
  3. Outer step with the Eq. (17b) hyper-gradient estimate:
         ∇̂F = γₖ(I−Ẃ)x + ∇_x f(x, ỹ) + βₖ ∇²_xy g(x, ỹ) h
         x ← x − αₖ ∇̂F
                                             [1 neighbor exchange of d1]

Counterpart of `repro.core.dagm` on its reference-tier path: the round
loop is a Python loop, hyper-parameters are host floats per round (the
`repro_torch.solve` schedules), and each round's metrics stay on the
device until `dagm_run_chunk` stacks them once at the end — no host
synchronization inside the loop.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..topology.ops import MixingOp, laplacian_apply_c
from .dihgp import dihgp_dense_c, dihgp_matrix_free_c, power_start
from .penalty import consensus_error, exact_ihgp, inner_dgd_step_c
from .problems import BilevelProblem

Tensor = torch.Tensor


class RoundHP(NamedTuple):
    """One outer round's hyper-parameters (Python floats), or (rounds,)
    sequences of them when passed to `dagm_run_chunk`.  `gamma`
    multiplies (I−Ẃ)x; the paper's coupling is float32(1)/float32(α)."""
    alpha: Any
    beta: Any
    gamma: Any


def default_metrics(prob: BilevelProblem, x: Tensor, y: Tensor
                    ) -> dict[str, Tensor]:
    m = {
        "outer_obj": torch.mean(prob.f_stacked(x, y)),
        "inner_obj": torch.mean(prob.g_stacked(x, y)),
        "consensus_x": consensus_error(x),
        "consensus_y": consensus_error(y),
    }
    if prob.hypergrad is not None:
        xbar = torch.mean(x, dim=0)
        m["true_hypergrad_norm_sq"] = torch.sum(prob.hypergrad(xbar) ** 2)
    return m


def hypergrad_estimate_c(prob: BilevelProblem, W, cfg,
                         x: Tensor, y: Tensor, h_st, x_st,
                         hp: RoundHP, curvature=None, v0=None):
    """∇̂F(x, y) of Eq. (17b), with the U DIHGP exchanges of h and the
    single (I−Ẃ)x exchange on their gossip channels.  Returns
    (∇̂F, h-channel state, x-channel state).

    `curvature` is the matrix-free DIHGP λmax bound (a float, or None
    to estimate it by power iteration from `v0`)."""
    if cfg.dihgp == "dense":
        h, h_st = dihgp_dense_c(prob, W, hp.beta, x, y, cfg.U, h_st)
    elif cfg.dihgp == "matrix_free":
        hvp = lambda v: prob.hvp_yy_g(x, y, v)
        curv = None if curvature is None else torch.full(
            (prob.n,), float(curvature), dtype=torch.float32,
            device=x.device)
        h, h_st = dihgp_matrix_free_c(hvp, prob.grad_y_f(x, y), W,
                                      hp.beta, cfg.U, h_st,
                                      curvature=curv, v0=v0)
    elif cfg.dihgp == "exact":
        h = exact_ihgp(prob, W, hp.beta, x, y)
    else:
        raise ValueError(f"unknown dihgp backend {cfg.dihgp!r}")
    lap_x, x_st = laplacian_apply_c(W, x, x_st)
    return lap_x * hp.gamma + prob.grad_x_f(x, y) \
        + hp.beta * prob.cross_xy_g_times(x, y, h), h_st, x_st


def dagm_outer_step_c(prob: BilevelProblem, W, cfg,
                      x: Tensor, y: Tensor, cs: dict,
                      metrics_fn: Callable | None = None,
                      hp: RoundHP | None = None, curvature=None,
                      mask=None, v0=None):
    """One outer iteration with every gossip on its channel.

    `cs` maps {"inner_y", "dihgp_h", "outer_x"} to ChannelStates; `hp`
    is this round's RoundHP of floats.

    `mask` is this round's fault mask ((n, k_max) padded-table layout,
    see `repro_torch.faults`): every gossip of the round — the M inner
    exchanges, the U DIHGP exchanges and the outer (I−Ẃ)x exchange —
    runs on the degraded view `W.masked(mask)`, the round's realized
    W_k.  The DIHGP preconditioner D̃ keeps the *nominal* self-weights:
    realized self-weights only grow under link drops (w_ii + folded
    weight ≥ w_ii), so D̃ ⪰ D_k and the Neumann contraction bound still
    holds (possibly conservatively)."""
    if mask is not None:
        if not isinstance(W, MixingOp):
            raise ValueError(
                "fault masks require a MixingOp (the masked path lives "
                "in the padded neighbor-table operand space); wrap W "
                "with make_mixing_op first")
        W = W.masked(mask)
    # the DIHGP h vector is re-initialized every round: neighbors'
    # error-feedback replicas restart at zero with it
    cs = dict(cs, dihgp_h=cs["dihgp_h"].reset_hat())
    y_st = cs["inner_y"]
    y_tilde = y
    for _ in range(cfg.M):                                      # lines 4–9
        y_tilde, y_st = inner_dgd_step_c(prob, W, hp.beta, x, y_tilde,
                                         y_st)                  # Eq. 16
    d, h_st, x_st = hypergrad_estimate_c(prob, W, cfg, x, y_tilde,
                                         cs["dihgp_h"], cs["outer_x"],
                                         hp=hp, curvature=curvature,
                                         v0=v0)                 # lines 10–12
    x_next = x - hp.alpha * d                                   # line 13
    if metrics_fn is None:
        metrics = default_metrics(prob, x, y_tilde)
    else:
        metrics = metrics_fn(prob, W, x, y_tilde)
    metrics["hypergrad_est_norm_sq"] = torch.sum(d ** 2)
    return x_next, y_tilde, metrics, \
        {"inner_y": y_st, "dihgp_h": h_st, "outer_x": x_st}


def dagm_init_carry(prob: BilevelProblem, W, cfg,
                    x0: Tensor | None = None, y0: Tensor | None = None,
                    seed: int = 0, recorder=None):
    """The round-0 chunk carry ((x0, y0), channel states).

    x0 = 0 (the paper's analysis assumption) and y0 = 0.01·N(0, I) drawn
    from `torch.Generator(device).manual_seed(seed)` unless given; the
    gossip channels open on W's ledger, their random streams derived
    from `seed` (`repro_torch.comm.channel_seeds`).

    `recorder` (a `repro_torch.obs.RecorderSpec`) appends a third carry
    element, the flight recorder's ring buffer on the device
    (`repro_torch.obs.recorder`); None keeps the 2-tuple."""
    dev = prob.device
    if x0 is None:
        x0 = torch.zeros((prob.n, prob.d1), dtype=torch.float32, device=dev)
    if y0 is None:
        gen = torch.Generator(dev).manual_seed(seed)
        y0 = 0.01 * torch.randn((prob.n, prob.d2), generator=gen,
                                dtype=torch.float32, device=dev)
    from ..comm import open_channels
    cs0 = open_channels(W, {"inner_y": y0, "dihgp_h": y0, "outer_x": x0},
                        seed)
    if recorder is not None:
        from ..obs.recorder import recorder_init
        return ((x0, y0), cs0, recorder_init(recorder, device=dev))
    return ((x0, y0), cs0)


def chunk_hp(cfg, rounds: int, start: int = 0) -> RoundHP:
    """RoundHP of (rounds,) float32 schedule slices [start, start+rounds)."""
    sched = cfg.schedule.materialize(max(cfg.K, start + rounds))
    sl = slice(start, start + rounds)
    return RoundHP(alpha=sched.alpha[sl], beta=sched.beta[sl],
                   gamma=sched.gamma[sl])


def dagm_run_chunk(prob: BilevelProblem, W, cfg, carry,
                   rounds: int, metrics_fn: Callable | None = None,
                   hp: RoundHP | None = None, curvature=None,
                   masks=None, recorder=None):
    """`rounds` outer iterations of Algorithm 2, carry in / carry out.

    carry is ((x, y), channel states) as produced by `dagm_init_carry`
    or a previous chunk; `hp` the chunk's (rounds,) schedule slices
    (None materializes rounds [0, rounds) of `cfg`'s schedules);
    `curvature` the matrix-free DIHGP bound (defaults to the config's;
    None estimates it every round by power iteration from one fixed
    start vector, `dihgp.power_start`).

    `masks`: optional (rounds, n, k_max) per-round fault masks
    (`repro_torch.faults.FaultTrace.table_masks`), moved to W's device
    once, before the loop; round t gossips on `W.masked(masks[t])`.

    `recorder` (the `RecorderSpec` the carry was built with, see
    `dagm_init_carry`) extends the carry to ((x, y), channel states,
    FlightBuffer) and writes one flight row per round on the device; it
    only reads the round's metrics and counters, so (x, y) are bitwise
    the same with it on or off.

    Returns (carry, metrics) with metrics stacked over the chunk's
    rounds as (rounds,) tensors."""
    if masks is not None:
        masks = torch.as_tensor(masks, dtype=torch.float32,
                                device=W.device)
        if masks.shape[0] != rounds:
            raise ValueError(f"masks hold {masks.shape[0]} rounds; the "
                             f"chunk runs {rounds}")
    if hp is None:
        hp = chunk_hp(cfg, rounds)
    hp = RoundHP(*(np.asarray(a, np.float32) for a in hp))
    if curvature is None:
        curvature = cfg.curvature
    (x, y), cs = carry[0], carry[1]
    rec = None
    if recorder is not None:
        from ..obs.recorder import (flight_values, recorder_write,
                                    wire_bytes_sent, wire_constants)
        rec = carry[2]
        bps, valid = wire_constants(W)
    v0 = None
    if cfg.dihgp == "matrix_free" and curvature is None:
        v0 = power_start(y.shape, y.device)
    rows = []
    for t in range(rounds):
        hp_t = RoundHP(*(float(a[t]) for a in hp))
        x, y, m, cs = dagm_outer_step_c(prob, W, cfg, x, y, cs, metrics_fn,
                                        hp=hp_t, curvature=curvature,
                                        mask=None if masks is None
                                        else masks[t], v0=v0)
        if rec is not None:
            rec = recorder_write(rec, flight_values(
                m, wire_bytes_sent(cs, bps), hp_t.gamma,
                mask=None if masks is None else masks[t],
                offdiag_valid=valid))
        rows.append(m)
    metrics = {key: torch.stack([r[key] for r in rows]) for key in rows[0]}
    if rec is not None:
        return ((x, y), cs, rec), metrics
    return ((x, y), cs), metrics


def dagm_comm_bytes(spec, net, d1: int, d2: int,
                    bytes_per: int = 4) -> int:
    """Total bytes moved over spec.K rounds: each agent sends its payload
    to every neighbor each exchange ⇒ 2·|E| directed sends per exchange.

    Computed from the spec's `CommLedger` (`SolverSpec.comm_ledger`);
    `bytes_per` scales the uncompressed word size (identity wire only)
    and is ignored once a compressor sets the wire format."""
    led = spec.comm_ledger(d1, d2)
    sends = led.network_multiplier(net.num_edges)
    if spec.comm.spec == "identity":
        return led.total_floats * bytes_per * sends
    return led.total_bytes * sends
