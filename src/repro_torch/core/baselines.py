"""Baselines the paper compares against (Table 2, Figs. 4–5).

Counterpart of `repro.core.baselines`.  Every baseline optimizes the
same stacked bilevel problems as DAGM and reproduces the communication
pattern that Table 2 / Appendix S1 charges it for: DGBO gossips d2×d2
Hessian estimates, DGTBO's JHIP oracle gossips d1×d2 matrices, FedNest
routes everything through a star center, MA-DBO gossips vectors plus a
momentum tracker.  Deterministic full-gradient variants, as in the
paper's Table 1/2 setting.

Entry surface: `repro_torch.solve.solve(prob, net, SolverSpec(method=
...))` with method "dgbo" | "dgtbo" | "ma_dbo" | "fednest".  The round
loop is a Python loop over per-round host floats (the spec's
schedules), as `core.dagm.dagm_run_chunk`'s; each round's metrics stay
on the device until the run stacks them, with no host synchronization
inside the loop.  The port has no legacy ``dgbo_run(prob, net,
alpha=..., beta=...)`` surface: `solve` is the only entry.

Every gossip goes through the network's `MixingOp` (`mix_apply_c` /
`laplacian_apply_c`, and MA-DBO's through `dihgp_dense_c`), so the
baselines run on the port's kernels as DAGM does: their Table 2 cost
gap is in *what* they communicate (matrices), not in how the mixing
executes.  Accounting is two-sided: `comm_floats_per_round` keeps the
Appendix-S1 closed form (what the papers charge), while the ledger is
charged from the gossips this implementation executes (FedNest's star
by a static ledger, since it never touches a MixingOp).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.func import grad, jacrev, vmap

from ..topology.ops import laplacian_apply_c, make_mixing_op, mix_apply_c
from .dagm import RoundHP, default_metrics
from .dihgp import dihgp_dense_c
from .penalty import inner_dgd_step_c
from .problems import BilevelProblem

Tensor = torch.Tensor


@contextlib.contextmanager
def _cusolver(device: torch.device):
    """Run the block's CUDA linear algebra on cuSOLVER, then restore the
    process's choice.  torch's default for the baselines' batched
    (16, 2010, 2010) LU and Cholesky is MAGMA: there a DGBO solve at the
    §6.2 MLP's published widths is 21,845 device ops against 7,296 on
    cuSOLVER, and chip_smoke's first DGBO run took 318.6 s against
    11.6 s (H100 80GB HBM3, 700 W)."""
    if device.type != "cuda":
        yield
        return
    saved = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(saved)


def _open_channels(W, templates: dict, seed: int):
    """Comm channels on the MixingOp, one per gossiped variable."""
    from ..comm import open_channels
    return open_channels(W, templates, seed)


def _mixing_op(net, spec, device):
    from ..solve.spec import mixing_kwargs
    return make_mixing_op(net, device=device, **mixing_kwargs(spec))


def _init_xy(prob: BilevelProblem, x0, y0, seed: int):
    """x0 = 0 and y0 = 0.01·N(0, I) from `torch.Generator(device)`
    seeded with `seed` unless given, as `dagm_init_carry`."""
    dev = prob.device
    if x0 is None:
        x0 = torch.zeros((prob.n, prob.d1), dtype=torch.float32, device=dev)
    if y0 is None:
        gen = torch.Generator(dev).manual_seed(seed)
        y0 = 0.01 * torch.randn((prob.n, prob.d2), generator=gen,
                                dtype=torch.float32, device=dev)
    return x0, y0


def _run_rounds(body, carry, hp: RoundHP, K: int):
    """K rounds of `body(carry, hp_t) -> (carry, metrics)` over per-round
    host floats; the metrics are stacked once, after the loop."""
    hp = RoundHP(*(np.asarray(a, np.float32) for a in hp))
    rows = []
    for t in range(K):
        carry, m = body(carry, RoundHP(*(float(a[t]) for a in hp)))
        rows.append(m)
    return carry, {key: torch.stack([r[key] for r in rows])
                   for key in rows[0]}


def _inner_loop(prob, W, beta, x, y, st, M: int):
    """M gossip DGD steps on the inner objective (Eq. 15–16)."""
    for _ in range(M):
        y, st = inner_dgd_step_c(prob, W, beta, x, y, st)
    return y, st


# ---------------------------------------------------------------------------
# DGBO  [Yang, Zhang & Wang, NeurIPS 2022] — gossip-based; communicates the
# full d2×d2 Hessian estimate in its inner Neumann loop (Appendix S1-II).
# ---------------------------------------------------------------------------

def dgbo_solve(prob: BilevelProblem, net, spec, hp: RoundHP, x0=None,
               y0=None, seed: int = 0, device=None):
    """Deterministic DGBO: gossip consensus on x and y, and a gossip
    estimate of the *global mean* Hessian (d2×d2 matrix communication —
    the expensive part the paper improves on)."""
    W = _mixing_op(net, spec, device)
    n, d1, d2 = prob.n, prob.d1, prob.d2
    M, b = spec.M, spec.b
    x0, y0 = _init_xy(prob, x0, y0, seed)
    cs = _open_channels(
        W, {"inner_y": y0,
            "hess_nu": torch.zeros((n, d2, d2), device=y0.device),
            "outer_x": x0}, seed)
    eye = torch.eye(d2, dtype=torch.float32, device=y0.device)

    def body(carry, hp_t):
        (x, y), cs = carry
        y1, y_st = _inner_loop(prob, W, hp_t.beta, x, y, cs["inner_y"], M)
        # b gossip rounds on the local Hessians (Steps 10–13): nu_i ←
        # Σ_j w_ij nu_j from ∇²_y g_i, so nu_i ≈ the mean Hessian
        nu, nu_st = prob.hess_yy_g(x, y1), cs["hess_nu"].reset_hat()
        for _ in range(b):
            nu, nu_st = mix_apply_c(W, nu, nu_st)
        p = prob.grad_y_f(x, y1)
        h = -torch.linalg.solve(nu + 1e-6 * eye, p)
        d = prob.grad_x_f(x, y1) + prob.cross_xy_g_times(x, y1, h)
        mixed_x, x_st = mix_apply_c(W, x, cs["outer_x"])
        x1 = mixed_x - hp_t.alpha * d
        cs = {"inner_y": y_st, "hess_nu": nu_st, "outer_x": x_st}
        return ((x1, y1), cs), default_metrics(prob, x, y1)

    with _cusolver(y0.device):          # the batched LU solve
        ((x, y), cs), metrics = _run_rounds(body, ((x0, y0), cs), hp,
                                            spec.K)
    W.ledger.charge_states(cs.values())
    # per-agent floats per round: x, y, grad-estimate vectors + b Hessian
    # matrices + one d1×d2 Jacobian (Appendix S1: b d2² + 2(d1+d2) +
    # d1 d2, plus the M inner exchanges)
    floats = b * d2 * d2 + 2 * (d1 + d2) + d1 * d2 + M * d2
    return x, y, metrics, cs, W.ledger, floats, "DGBO"


# ---------------------------------------------------------------------------
# DGTBO  [Chen, Huang & Ma, 2022] — gradient tracking + JHIP oracle that
# communicates d1×d2 matrices (Appendix S1-III).
# ---------------------------------------------------------------------------

def _cross_jacobians(prob: BilevelProblem, x: Tensor, y: Tensor) -> Tensor:
    """(n, d1, d2) full local Jacobians ∇²_xy g_i (what JHIP needs):
    reverse-mode Jacobian of ∇_y g_i over x_i, per agent."""
    def one(xi, yi, di):
        jac = jacrev(lambda xx: grad(prob.g, argnums=1)(xx, yi, di))(xi)
        return jac.transpose(0, 1)              # (d2, d1) -> (d1, d2)
    return vmap(one)(x, y, prob.data)


def dgtbo_solve(prob: BilevelProblem, net, spec, hp: RoundHP, x0=None,
                y0=None, seed: int = 0, device=None):
    """Deterministic DGTBO: JHIP solves Z ≈ −J H^{-1} (d1×d2) by N
    decentralized Richardson iterations, each gossiping the full Z."""
    W = _mixing_op(net, spec, device)
    n, d1, d2 = prob.n, prob.d1, prob.d2
    M, N = spec.M, spec.N
    x0, y0 = _init_xy(prob, x0, y0, seed)
    cs = _open_channels(
        W, {"inner_y": y0,
            "jhip_z": torch.zeros((n, d1, d2), device=y0.device),
            "outer_x": x0}, seed)

    def body(carry, hp_t):
        (x, y), cs = carry
        y1, y_st = _inner_loop(prob, W, hp_t.beta, x, y, cs["inner_y"], M)
        Hg = prob.hess_yy_g(x, y1)                      # (n,d2,d2) local
        Jg = _cross_jacobians(prob, x, y1)              # (n,d1,d2) local
        # JHIP: solve (mean H) Zᵀ = (mean J)ᵀ decentralized: Richardson
        # iterations with gossip averaging of Z (matrix communication)
        lam = 1.0 / (1.0 + torch.max(torch.abs(Hg)))
        Z = torch.zeros((n, d1, d2), dtype=Jg.dtype, device=Jg.device)
        z_st = cs["jhip_z"].reset_hat()
        for _ in range(N):
            Z = Z + lam * (Jg - torch.matmul(Z, Hg))    # local residual
            Z, z_st = mix_apply_c(W, Z, z_st)           # gossip Z (d1·d2)
        p = prob.grad_y_f(x, y1)
        d = prob.grad_x_f(x, y1) - torch.matmul(Z, p[:, :, None])[..., 0]
        mixed_x, x_st = mix_apply_c(W, x, cs["outer_x"])
        x1 = mixed_x - hp_t.alpha * d
        cs = {"inner_y": y_st, "jhip_z": z_st, "outer_x": x_st}
        return ((x1, y1), cs), default_metrics(prob, x, y1)

    ((x, y), cs), metrics = _run_rounds(body, ((x0, y0), cs), hp, spec.K)
    W.ledger.charge_states(cs.values())
    # Appendix S1: K n (M d2 + d1 + n N d1 d2) / n per agent per round
    floats = M * d2 + d1 + N * d1 * d2
    return x, y, metrics, cs, W.ledger, floats, "DGTBO"


# ---------------------------------------------------------------------------
# FedNest  [Tarzanagh et al., ICML 2022] — star topology (federated).
# ---------------------------------------------------------------------------

def fednest_solve(prob: BilevelProblem, net, spec, hp: RoundHP, x0=None,
                  y0=None, seed: int = 0, device=None):
    """Centralized-server bilevel: the server holds the global (x, y);
    each round clients send gradients/HVPs (vectors) up and receive the
    global iterate back.  Hyper-gradient via a U-term Neumann series on
    the *mean* Hessian from client HVPs (FedIHGP).  `net` is ignored
    (the star is implicit)."""
    n, d1, d2 = prob.n, prob.d1, prob.d2
    M, U = spec.M, spec.U
    dev = prob.device
    if x0 is None:
        xg = torch.zeros((d1,), dtype=torch.float32, device=dev)
    else:
        xg = torch.mean(x0, 0)
    if y0 is None:
        gen = torch.Generator(dev).manual_seed(seed)
        yg = 0.01 * torch.randn((d2,), generator=gen, dtype=torch.float32,
                                device=dev)
    else:
        yg = torch.mean(y0, 0)

    def stacked(z):
        return z.expand((n,) + tuple(z.shape))

    def body(carry, hp_t):
        x, y = carry
        xs = stacked(x)
        y1 = y
        for _ in range(M):
            y1 = y1 - hp_t.beta * torch.mean(
                prob.grad_y_g(xs, stacked(y1)), 0)
        ys = stacked(y1)
        p = torch.mean(prob.grad_y_f(xs, ys), 0)

        def hvp(v):
            return torch.mean(prob.hvp_yy_g(xs, ys, stacked(v)), 0)
        lam = 1.0 / (1.0 + torch.sqrt(torch.sum(
            hvp(p / (1e-12 + torch.linalg.norm(p))) ** 2)))
        h = -lam * p
        for _ in range(U):
            h = h - lam * hvp(h) - lam * p
        d = torch.mean(prob.grad_x_f(xs, ys), 0) \
            + torch.mean(prob.cross_xy_g_times(xs, ys, stacked(h)), 0)
        x1 = x - hp_t.alpha * d
        return (x1, y1), default_metrics(prob, stacked(x), ys)

    (x, y), metrics = _run_rounds(body, (xg, yg), hp, spec.K)
    # per client per round: M+U+2 vector up/downs through the center
    floats = 2 * ((M + 1) * d2 + (U + 1) * d2 + d1)
    # star routing never touches a MixingOp: a static ledger describing
    # the up+down transfers the simulation's means stand in for
    from ..comm import static_ledger
    ledger = static_ledger("identity", [
        ("inner_updown", (d2,), spec.K * 2 * (M + 1)),
        ("ihgp_updown", (d2,), spec.K * 2 * (U + 1)),
        ("outer_updown", (d1,), spec.K * 2),
    ], name="fednest")
    return stacked(x).contiguous(), stacked(y).contiguous(), metrics, \
        None, ledger, floats, "FedNest"


# ---------------------------------------------------------------------------
# MA-DBO  [Chen et al., ICML 2023] — momentum-assisted decentralized
# bilevel (vector communication, momentum on the hyper-gradient).
# ---------------------------------------------------------------------------

def madbo_solve(prob: BilevelProblem, net, spec, hp: RoundHP, x0=None,
                y0=None, seed: int = 0, device=None):
    W = _mixing_op(net, spec, device)
    M, U, momentum = spec.M, spec.U, spec.momentum
    x0, y0 = _init_xy(prob, x0, y0, seed)
    d1, d2 = prob.d1, prob.d2
    v0 = torch.zeros_like(x0)
    cs = _open_channels(
        W, {"inner_y": y0, "dihgp_h": y0, "lap_x": x0, "tracker_v": v0},
        seed)

    def body(carry, hp_t):
        (x, y, v), cs = carry
        y1, y_st = _inner_loop(prob, W, hp_t.beta, x, y, cs["inner_y"], M)
        h, h_st = dihgp_dense_c(prob, W, hp_t.beta, x, y1, U,
                                cs["dihgp_h"].reset_hat())
        lap_x, lx_st = laplacian_apply_c(W, x, cs["lap_x"])
        d = lap_x * hp_t.gamma + prob.grad_x_f(x, y1) \
            + hp_t.beta * prob.cross_xy_g_times(x, y1, h)
        v1 = momentum * v + (1.0 - momentum) * d
        v1, v_st = mix_apply_c(W, v1, cs["tracker_v"])  # gossip tracker
        x1 = x - hp_t.alpha * v1
        cs = {"inner_y": y_st, "dihgp_h": h_st, "lap_x": lx_st,
              "tracker_v": v_st}
        return ((x1, y1, v1), cs), default_metrics(prob, x, y1)

    with _cusolver(y0.device):          # dihgp_dense_c's factorisation
        ((x, y, _), cs), metrics = _run_rounds(body, ((x0, y0, v0), cs),
                                               hp, spec.K)
    W.ledger.charge_states(cs.values())
    floats = M * d2 + U * d2 + 2 * d1          # extra d1 for the tracker
    return x, y, metrics, cs, W.ledger, floats, "MA-DBO"


BASELINE_SOLVERS = {
    "dgbo": dgbo_solve,
    "dgtbo": dgtbo_solve,
    "fednest": fednest_solve,
    "ma_dbo": madbo_solve,
}
