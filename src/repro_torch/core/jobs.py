"""DAGM on a serve bucket's job axis: B jobs of one signature, one round.

A bucket (`repro_torch.serve`) advances B independent DAGM runs that
share one problem family at one set of shapes, one network and one
solver configuration; each job has its own data, seed, curvature and
α/β/γ schedule.  `repro`'s engine `vmap`s `dagm_run_chunk` over the job
axis, so every gossip of the bucket is one (batched) kernel launch.  The
port does the same by hand:

* every state is stored (n, B, d), contiguous, so that its (n, B·d)
  view is one gossip operand: each gossip of the round is one launch for
  all B jobs (`MixingOp.mix_jobs_c`, `neumann_step_jobs_c`), on the
  kernels' job axis where a job's β, D̃, wire metadata or send seed
  enters (`repro_torch.kernels.mixing_matvec`);
* every per-agent autodiff term is the solo helper `torch.func.vmap`ped
  over the job axis of the stacked data (`BilevelProblem.with_data`);
* the hyper-parameters of a round are (B,) device tables.

Each job's trajectory is its solo `dagm_run_chunk` run's: the algebra
is the solo round's, elementwise on each job's columns, and the gossips
of each job are bitwise its solo gossips.  The autodiff terms run as
batched operations, and nothing guarantees that their reductions sum in
the solo run's order, so a job is held to its solo run within f32
tolerance (on the CPU, and on the H100 at the §6.2 MLP's widths, the
two have come out bit for bit).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
from torch.func import vmap

from ..topology.ops import as_matrix
from .dihgp import estimate_curvature_bound
from .penalty import exact_ihgp
from .problems import BilevelProblem

Tensor = torch.Tensor


class JobsHP(NamedTuple):
    """A chunk's hyper-parameters: (rounds, B) f32 device tables, and
    the (B,) curvature bounds (or None to estimate them every round)."""
    alpha: Tensor
    beta: Tensor
    gamma: Tensor
    curvature: Tensor | None = None


class JobsProblem:
    """B jobs' problems over one stacked data dict (leaves (B, n, ...)):
    the solo `BilevelProblem` helpers mapped over the job axis, states
    (n, B, d) in and out."""

    def __init__(self, template: BilevelProblem, data: dict):
        self.template = template
        self.data = data
        self.jobs = next(iter(data.values())).shape[0]

    def job(self, j: int) -> BilevelProblem:
        return self.template.with_data({k: v[j] for k, v in
                                        self.data.items()})

    def _map(self, name: str, *states: Tensor) -> Tensor:
        t = self.template

        def one(d, *a):
            return getattr(t.with_data(d), name)(*a)
        out = vmap(one, in_dims=(0,) + (1,) * len(states),
                   out_dims=1)(self.data, *states)
        return out.contiguous()

    def grad_y_g(self, x, y):
        return self._map("grad_y_g", x, y)

    def grad_x_f(self, x, y):
        return self._map("grad_x_f", x, y)

    def grad_y_f(self, x, y):
        return self._map("grad_y_f", x, y)

    def hvp_yy_g(self, x, y, v):
        return self._map("hvp_yy_g", x, y, v)

    def cross_xy_g_times(self, x, y, h):
        return self._map("cross_xy_g_times", x, y, h)


def _col(t: Tensor, like: Tensor) -> Tensor:
    """(B,) per-job values -> (1, B, 1, ...) against states (n, B, ...)."""
    return t.reshape((1, -1) + (1,) * (like.dim() - 2))


def _diag(W, like: Tensor) -> Tensor:
    """diag(W) as (n, 1, 1, ...) against states (n, B, ...)."""
    return torch.diagonal(as_matrix(W)).to(like.dtype).reshape(
        (-1,) + (1,) * (like.dim() - 1))


def _job_metrics(jp: JobsProblem, W, x, y, metrics_fn) -> dict:
    """Each job's metrics (the solo `default_metrics` or `metrics_fn`),
    (B,) tensors."""
    from .dagm import default_metrics
    t = jp.template

    def one(d, xj, yj):
        prob = t.with_data(d)
        m = default_metrics(prob, xj, yj) if metrics_fn is None \
            else metrics_fn(prob, W, xj, yj)
        # one tensor always, so that a metrics_fn returning {} maps too
        return torch.zeros(()), m
    return vmap(one, in_dims=(0, 1, 1))(jp.data, x, y)[1]


def _dihgp_jobs(jp: JobsProblem, W, cfg, x, y, beta, curvature, h_st, v0):
    """Each job's h_(U) (Algorithm 1, its solo backend) with the U
    exchanges of h on the bucket's channel."""
    B = jp.jobs
    if cfg.dihgp == "exact":
        h = torch.stack([exact_ihgp(jp.job(j), W, beta[j], x[:, j],
                                    y[:, j]) for j in range(B)], dim=1)
        return h, h_st
    p = jp.grad_y_f(x, y)                                        # (n,B,d2)
    if cfg.dihgp == "dense":
        from .dihgp import _local_factor, _solve
        t = jp.template

        def factor(d, xj, yj, bj):
            return _local_factor(t.with_data(d), W, bj, xj, yj)
        chol = vmap(factor, in_dims=(0, 1, 1, 0), out_dims=1)(
            jp.data, x, y, beta)
        h = _solve(chol, -p)
        diag_w = _diag(W, h)
        for _ in range(cfg.U):
            mixed, h_st = W.mix_jobs_c(h, h_st)
            h = _solve(chol, (h - 2.0 * diag_w * h + mixed) - p)
        return h, h_st
    if cfg.dihgp != "matrix_free":
        raise ValueError(f"unknown dihgp backend {cfg.dihgp!r}")
    n = x.shape[0]
    if curvature is None:
        t = jp.template

        def bound(d, xj, yj):
            prob = t.with_data(d)
            return estimate_curvature_bound(
                lambda v: prob.hvp_yy_g(xj, yj, v), yj.shape, v0=v0,
                device=yj.device)
        curv = vmap(bound, in_dims=(0, 1, 1), out_dims=1)(jp.data, x, y)
    else:
        curv = curvature[None, :].expand(n, B)
    diag_w = torch.diagonal(as_matrix(W)).to(p.dtype)
    # D̃ = β·c + 2(1 − w_ii), (n, B): the solo `_d_scalar` per job
    d_scalar = (beta[None, :] * curv + 2.0 * (1.0 - diag_w)[:, None]
                ).contiguous()
    h = -p / d_scalar[:, :, None]
    for _ in range(cfg.U):
        h, h_st = W.neumann_step_jobs_c(h, jp.hvp_yy_g(x, y, h), p,
                                        d_scalar, beta, h_st)
    return h, h_st


def dagm_outer_step_jobs(jp: JobsProblem, W, cfg, x, y, cs: dict,
                         metrics_fn: Callable | None, alpha, beta, gamma,
                         curvature=None, v0=None):
    """One outer iteration of every job of the bucket (the solo
    `dagm_outer_step_c` per job).  x (n, B, d1), y (n, B, d2); `cs` the
    bucket's three `JobChannelState`s; alpha/beta/gamma (B,) device
    tables of this round; curvature (B,) or None.  Returns (x⁺, ỹ,
    metrics of (B,) tensors, channel states)."""
    cs = dict(cs, dihgp_h=cs["dihgp_h"].reset_hat())
    y_st = cs["inner_y"]
    b_y = _col(beta, y)
    y_tilde = y
    for _ in range(cfg.M):                                      # lines 4–9
        mixed, y_st = W.mix_jobs_c(y_tilde, y_st)
        y_tilde = mixed - b_y * jp.grad_y_g(x, y_tilde)         # Eq. 16
    h, h_st = _dihgp_jobs(jp, W, cfg, x, y_tilde, beta, curvature,
                          cs["dihgp_h"], v0)                    # lines 10–11
    lap_x, x_st = W.mix_jobs_c(x, cs["outer_x"], laplacian=True)
    d = lap_x * _col(gamma, x) + jp.grad_x_f(x, y_tilde) \
        + _col(beta, x) * jp.cross_xy_g_times(x, y_tilde, h)    # line 12
    x_next = x - _col(alpha, x) * d                             # line 13
    metrics = dict(_job_metrics(jp, W, x, y_tilde, metrics_fn))
    metrics["hypergrad_est_norm_sq"] = torch.sum(d ** 2, dim=(0, 2))
    return x_next, y_tilde, metrics, \
        {"inner_y": y_st, "dihgp_h": h_st, "outer_x": x_st}


def dagm_run_chunk_jobs(jp: JobsProblem, W, cfg, carry, rounds: int,
                        metrics_fn: Callable | None, hp: JobsHP,
                        recorder=None):
    """`rounds` outer iterations of every job of a bucket, carry in /
    carry out: the job-axis twin of `dagm_run_chunk`.

    carry is ((x, y), {channel: JobChannelState}) with x (n, B, d1) and
    y (n, B, d2), plus a FlightBuffer of rows (B, capacity, F) when
    `recorder` is given (`repro_torch.obs.recorder`).  `hp` holds the
    chunk's (rounds, B) α/β/γ tables on the bucket's device.  No host
    synchronization inside: the send counters are host integers.
    Returns (carry, metrics) with metrics stacked as (rounds, B)."""
    (x, y), cs = carry[0], carry[1]
    rec = carry[2] if recorder is not None else None
    if rec is not None:
        from ..obs.recorder import (flight_values, recorder_write,
                                    wire_bytes_sent, wire_constants)
        bps, _ = wire_constants(W)
    v0 = None
    if cfg.dihgp == "matrix_free" and hp.curvature is None:
        from .dihgp import power_start
        v0 = power_start((x.shape[0], y.shape[2]), y.device)
    rows = []
    for t in range(rounds):
        x, y, m, cs = dagm_outer_step_jobs(
            jp, W, cfg, x, y, cs, metrics_fn, hp.alpha[t], hp.beta[t],
            hp.gamma[t], curvature=hp.curvature, v0=v0)
        if rec is not None:
            rec = recorder_write(rec, flight_values(
                m, wire_bytes_sent(cs, bps), hp.gamma[t]))
        rows.append(m)
    metrics = {key: torch.stack([r[key] for r in rows]) for key in rows[0]}
    carry = ((x, y), cs) if rec is None else ((x, y), cs, rec)
    return carry, metrics


def freeze_inactive(new, old, active: Tensor, active_host):
    """The carry of a chunk with every inactive slot held at its state
    before the chunk: `torch.where` on every device leaf along its job
    axis (axis 1 of the (n, B, ...) states and EF replicas, axis 0 of
    the flight buffer), the host send counters by the host mask."""
    import numpy as np

    def where(a, b, axis):
        shape = [1] * a.dim()
        shape[axis] = -1
        return torch.where(active.reshape(shape), a, b)
    (x, y), cs = new[0], new[1]
    (x0, y0), cs0 = old[0], old[1]
    out_cs = {}
    for name, st in cs.items():
        st0 = cs0[name]
        hat = None if st.hat is None else where(st.hat, st0.hat, 1)
        out_cs[name] = dataclasses.replace(
            st, hat=hat, sends=np.where(active_host, st.sends, st0.sends))
    out = ((where(x, x0, 1), where(y, y0, 1)), out_cs)
    if len(new) > 2:
        from ..obs.recorder import FlightBuffer
        fb, fb0 = new[2], old[2]
        out = out + (FlightBuffer(rows=where(fb.rows, fb0.rows, 0),
                                  count=where(fb.count, fb0.count, 0)),)
    return out
