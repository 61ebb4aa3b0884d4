"""Bilevel problem zoo (paper §6 + analytically solvable quadratics).

Counterpart of `repro.core.problems`.  A decentralized bilevel problem
(paper Eq. (1)/(3)) is described by per-agent objectives

    f_i(x_i, y_i; data_i)   (outer / validation)
    g_i(x_i, y_i; data_i)   (inner / training, strongly convex in y)

written as plain PyTorch functions of one agent's slice.  x is stacked
(n, d1), y is stacked (n, d2), and `data` is a dict of tensors with a
leading agent axis n.  The stacked helpers map the per-agent autodiff
terms over the agent axis with `torch.func.vmap`.

The synthetic data generators are `repro`'s numpy code unchanged, so
the same seed gives the same data in both packages.  Every constructor
takes ``device=`` (CUDA unless the caller names another); the
`_build_*` functions build a family from given numpy arrays, which is
how `repro_torch.interop.load_problem` carries `repro`'s data across.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch.func import grad, hessian, jvp, vmap

from .._device import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class BilevelProblem:
    """Per-agent bilevel objectives with stacked helpers."""
    name: str
    n: int
    d1: int
    d2: int
    f: Callable[[Tensor, Tensor, Any], Tensor]  # (x_i, y_i, data_i) -> scalar
    g: Callable[[Tensor, Tensor, Any], Tensor]
    data: dict                                   # tensors: (n, ...)
    mu_g: float                                  # strong-convexity lb of g
    # optional analytic pieces (quadratic problem only)
    y_star: Callable[[Tensor], Tensor] | None = None      # (n,d1)->(n,d2)
    hypergrad: Callable[[Tensor], Tensor] | None = None   # exact grad of
    #                                 (1/n) sum_i f_i(x, y*(x)) wrt shared x

    @property
    def device(self) -> torch.device:
        return next(iter(self.data.values())).device

    # ---- stacked conveniences (vmapped over the agent axis) ----
    def f_stacked(self, x: Tensor, y: Tensor) -> Tensor:
        return vmap(self.f)(x, y, self.data)

    def g_stacked(self, x: Tensor, y: Tensor) -> Tensor:
        return vmap(self.g)(x, y, self.data)

    def grad_y_g(self, x: Tensor, y: Tensor) -> Tensor:
        return vmap(grad(self.g, argnums=1))(x, y, self.data)

    def grad_x_f(self, x: Tensor, y: Tensor) -> Tensor:
        return vmap(grad(self.f, argnums=0))(x, y, self.data)

    def grad_y_f(self, x: Tensor, y: Tensor) -> Tensor:
        return vmap(grad(self.f, argnums=1))(x, y, self.data)

    def hess_yy_g(self, x: Tensor, y: Tensor) -> Tensor:
        """(n, d2, d2) local Hessians — reference tier only."""
        return vmap(hessian(self.g, argnums=1))(x, y, self.data)

    def hvp_yy_g(self, x: Tensor, y: Tensor, v: Tensor) -> Tensor:
        """Stacked HVP: (∇²_y g_i) v_i, matrix-free (jvp of grad)."""
        def one(xi, yi, di, vi):
            gy = lambda yy: grad(self.g, argnums=1)(xi, yy, di)
            return jvp(gy, (yi,), (vi,))[1]
        return vmap(one)(x, y, self.data, v)

    def cross_xy_g_times(self, x: Tensor, y: Tensor, h: Tensor) -> Tensor:
        """Stacked (∇²_xy g_i) h_i ∈ R^{d1}, matrix-free (grad of a
        vdot)."""
        def one(xi, yi, di, hi):
            inner = lambda xx: torch.dot(
                grad(self.g, argnums=1)(xx, yi, di), hi)
            return grad(inner)(xi)
        return vmap(one)(x, y, self.data, h)

    def mean_outer_at(self, xbar: Tensor, ybar_star: Tensor) -> Tensor:
        """(1/n) Σ_i f_i(x̄, ȳ) — the consensus objective tracked in Thm 7."""
        xs = xbar.expand((self.n,) + tuple(xbar.shape))
        ys = ybar_star.expand((self.n,) + tuple(ybar_star.shape))
        return torch.mean(self.f_stacked(xs, ys))

    # ---- job batching (repro_torch.serve) ----
    def with_data(self, data) -> "BilevelProblem":
        """Same objectives and shapes on another data dict — one job's
        view inside a serve bucket (`data` is one job's slice of a
        `stack_problem_data` stack, as `torch.func.vmap` hands it over).
        The optional analytic pieces (`y_star`, `hypergrad`) stay the
        template's, as in `repro`."""
        return dataclasses.replace(self, data=data)


def _tensors(data: dict, device) -> dict:
    """numpy data -> tensors on `device`: floats as float32, integer
    labels as int64 (the index dtype of `torch.gather`)."""
    dev = resolve_device(device)
    out = {}
    for key, val in data.items():
        arr = np.asarray(val)
        dtype = torch.int64 if np.issubdtype(arr.dtype, np.integer) \
            else torch.float32
        out[key] = torch.tensor(arr, device=dev).to(dtype)
    return out


# ---------------------------------------------------------------------------
# 1. Quadratic bilevel with closed forms (ground truth for tests)
# ---------------------------------------------------------------------------

def quadratic_bilevel(n: int, d1: int, d2: int, *, seed: int = 0,
                      mu_g: float = 1.0, mu_f: float = 0.1,
                      kappa: float = 5.0, device=None) -> BilevelProblem:
    """g_i(x,y) = 1/2 yᵀA_i y − (P_i x + b_i)ᵀ y,
       f_i(x,y) = 1/2 ||y − c_i||² + mu_f/2 ||x||².

    A_i ≻ 0 with spectrum in [mu_g, kappa·mu_g].  Closed forms:
    y*_i(x) = A_i^{-1}(P_i x + b_i); the hypergradient is the exact
    gradient of the consensus objective (autodiff through the consensus
    inner solution ȳ*(x) = Ā^{-1}(P̄ x + b̄))."""
    rng = np.random.default_rng(seed)

    def rand_spd(k):
        Q, _ = np.linalg.qr(rng.standard_normal((d2, d2)))
        ev = np.linspace(mu_g, kappa * mu_g, d2)
        return (Q * ev) @ Q.T

    A = np.stack([rand_spd(i) for i in range(n)])           # (n,d2,d2)
    P = rng.standard_normal((n, d2, d1)) / np.sqrt(d1)
    b = rng.standard_normal((n, d2))
    c = rng.standard_normal((n, d2))
    return _build_quadratic({"A": A, "P": P, "b": b, "c": c}, mu_g=mu_g,
                            mu_f=mu_f, device=device)


def _build_quadratic(data: dict, *, mu_g: float = 1.0, mu_f: float = 0.1,
                     device=None) -> BilevelProblem:
    t = _tensors(data, device)
    n, d2, d1 = t["P"].shape
    Abar, Pbar, bbar = (torch.as_tensor(np.asarray(data[k]).mean(0),
                                        dtype=torch.float32,
                                        device=t["A"].device)
                        for k in ("A", "P", "b"))

    def g(x_i, y_i, d):
        return 0.5 * y_i @ d["A"] @ y_i - (d["P"] @ x_i + d["b"]) @ y_i

    def f(x_i, y_i, d):
        return 0.5 * torch.sum((y_i - d["c"]) ** 2) \
            + 0.5 * mu_f * torch.sum(x_i ** 2)

    def y_star_consensus(x):           # shared x -> consensus inner argmin
        return torch.linalg.solve(Abar, Pbar @ x + bbar)

    def phi(x):                        # true outer objective at consensus
        y = y_star_consensus(x)
        return 0.5 * torch.mean(torch.sum((y[None] - t["c"]) ** 2, -1)) \
            + 0.5 * mu_f * torch.sum(x ** 2)

    def y_star_stacked(x):             # per-agent local solutions (Eq. 3b)
        rhs = (t["P"] @ x[..., None])[..., 0] + t["b"]
        return torch.linalg.solve(t["A"], rhs)

    return BilevelProblem(
        name="quadratic", n=n, d1=d1, d2=d2, f=f, g=g, data=t, mu_g=mu_g,
        y_star=y_star_stacked, hypergrad=grad(phi))


# ---------------------------------------------------------------------------
# Synthetic datasets for the HO experiments (no internet: generated)
# ---------------------------------------------------------------------------

def _split_agents(Z, b, n):
    m = (Z.shape[0] // n) * n
    return (Z[:m].reshape(n, -1, Z.shape[1]), b[:m].reshape(n, -1))


def synthetic_regression_data(n: int, d: int, m_per: int, *, seed: int = 0,
                              noise: float = 0.25):
    """Paper §6.1 synthetic: z ~ N(0,I), targets from a true signal."""
    rng = np.random.default_rng(seed)
    y_true = rng.standard_normal(d)
    Z = rng.standard_normal((n * m_per * 2, d))
    eps = rng.standard_normal(n * m_per * 2)
    b = Z @ y_true + noise * np.abs(Z @ y_true) + eps
    Ztr, btr = _split_agents(Z[: n * m_per], b[: n * m_per], n)
    Zv, bv = _split_agents(Z[n * m_per:], b[n * m_per:], n)
    return ({"Ztr": np.asarray(Ztr, np.float32),
             "btr": np.asarray(btr, np.float32),
             "Zval": np.asarray(Zv, np.float32),
             "bval": np.asarray(bv, np.float32)}, y_true)


def synthetic_classification_data(n: int, d: int, m_per: int, n_classes: int,
                                  *, seed: int = 0, long_tail: bool = False,
                                  q: float | None = None,
                                  margin: float = 2.0):
    """Gaussian-cluster classification (MNIST-like stand-in, offline).

    If `long_tail`, class c has ~ N0 * 0.5^c samples (imbalanced, §6.3).
    If `q` is given, agents are split with heterogeneity level q per the
    paper's §6.3 protocol: agent i gets q·100% of its 'own' class i (mod
    C), topped up uniformly from the remainder.
    """
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((n_classes, d)) * margin
    total = n * m_per * 2
    if long_tail:
        raw = np.array([0.5 ** c for c in range(n_classes)])
        counts = np.maximum((raw / raw.sum() * total).astype(int), 8)
    else:
        counts = np.full(n_classes, total // n_classes)
    Zs, bs = [], []
    for c in range(n_classes):
        Zs.append(means[c] + rng.standard_normal((counts[c], d)))
        bs.append(np.full(counts[c], c))
    Z = np.concatenate(Zs); lab = np.concatenate(bs)

    if q is None:
        perm = rng.permutation(len(Z))
        Z, lab = Z[perm], lab[perm]
    else:
        # heterogeneity-q split (§6.3): per-agent class-c share q
        per_agent = len(Z) // n
        own, rest = [], []
        for i in range(n):
            c = i % n_classes
            idx = np.nonzero(lab == c)[0]
            take = min(int(q * per_agent), len(idx))
            own.append(idx[:take])
        used = np.concatenate(own) if own else np.array([], int)
        mask = np.ones(len(Z), bool); mask[used] = False
        pool = rng.permutation(np.nonzero(mask)[0])
        ptr = 0; order = []
        for i in range(n):
            sel = list(own[i])
            need = per_agent - len(sel)
            sel += list(pool[ptr:ptr + need]); ptr += need
            order += sel
        order = np.asarray(order)
        Z, lab = Z[order], lab[order]

    m = (len(Z) // (2 * n))
    half = n * m
    Ztr = Z[:half].reshape(n, m, d); ltr = lab[:half].reshape(n, m)
    Zv = Z[half:2 * half].reshape(n, m, d); lv = lab[half:2 * half].reshape(n, m)
    return {"Ztr": np.asarray(Ztr, np.float32), "ltr": ltr,
            "Zval": np.asarray(Zv, np.float32), "lval": lv}


# ---------------------------------------------------------------------------
# 2. Hyper-parameter optimization problems (§6.1)
# ---------------------------------------------------------------------------
# Inner:  g_i(x, y) = loss(y; D_i^tr) + yᵀ diag(exp(x)) y      (paper §6.1)
# Outer:  f_i(x, y) = loss(y; D_i^val)

def _reg(x_i, y_i):
    return torch.sum(torch.exp(x_i) * y_i * y_i)


def _sign(lab):
    return 2.0 * lab.to(torch.float32) - 1.0


def _take_true(logits, lab):
    """logits[r, lab[r]] per row (jnp.take_along_axis(..., axis=-1))."""
    return torch.gather(logits, -1, lab[:, None])[:, 0]


def ho_regression(n: int, d: int, m_per: int = 30, *, seed: int = 0,
                  device=None) -> BilevelProblem:
    data, _ = synthetic_regression_data(n, d, m_per, seed=seed)
    return _build_ho_regression(data, device=device)


def _build_ho_regression(data: dict, *, device=None) -> BilevelProblem:
    t = _tensors(data, device)
    n, _, d = t["Ztr"].shape

    def g(x_i, y_i, di):
        r = di["Ztr"] @ y_i - di["btr"]
        return torch.mean(r * r) + _reg(x_i, y_i)

    def f(x_i, y_i, di):
        r = di["Zval"] @ y_i - di["bval"]
        return torch.mean(r * r)

    return BilevelProblem("ho_regression", n, d, d, f, g, t, mu_g=0.0)


def ho_logistic(n: int, d: int, m_per: int = 30, *, seed: int = 0,
                device=None) -> BilevelProblem:
    data = synthetic_classification_data(n, d, m_per, 2, seed=seed)
    return _build_ho_logistic(data, device=device)


def _build_ho_logistic(data: dict, *, device=None) -> BilevelProblem:
    t = _tensors(data, device)
    n, _, d = t["Ztr"].shape

    def loss(y_i, Z, lab):
        z = -_sign(lab) * (Z @ y_i)
        return torch.mean(torch.logaddexp(torch.zeros_like(z), z))

    def g(x_i, y_i, di):
        return loss(y_i, di["Ztr"], di["ltr"]) + _reg(x_i, y_i)

    def f(x_i, y_i, di):
        return loss(y_i, di["Zval"], di["lval"])

    return BilevelProblem("ho_logistic", n, d, d, f, g, t, mu_g=0.0)


def ho_svm(n: int, d: int, m_per: int = 30, *, seed: int = 0,
           smooth: float = 0.5, margin: float = 2.0,
           device=None) -> BilevelProblem:
    """SVM with a smoothed hinge (quadratic in the [0, smooth] region) so
    Assumption B's differentiability holds; smooth→0 recovers the hinge."""
    data = synthetic_classification_data(n, d, m_per, 2, seed=seed + 1,
                                         margin=margin)
    return _build_ho_svm(data, smooth=smooth, device=device)


def _build_ho_svm(data: dict, *, smooth: float = 0.5,
                  device=None) -> BilevelProblem:
    t = _tensors(data, device)
    n, _, d = t["Ztr"].shape

    def smoothed_hinge(z):
        # 0 for z>=1; quadratic for 1-smooth<z<1; linear below
        s = 1.0 - z
        return torch.where(s <= 0, torch.zeros_like(s),
                           torch.where(s < smooth, s * s / (2 * smooth),
                                       s - smooth / 2))

    def loss(y_i, Z, lab):
        return torch.mean(smoothed_hinge(_sign(lab) * (Z @ y_i)))

    def g(x_i, y_i, di):
        return loss(y_i, di["Ztr"], di["ltr"]) + _reg(x_i, y_i)

    def f(x_i, y_i, di):
        return loss(y_i, di["Zval"], di["lval"])

    return BilevelProblem("ho_svm", n, d, d, f, g, t, mu_g=0.0)


def ho_softmax(n: int, d: int, n_classes: int = 10, m_per: int = 30, *,
               seed: int = 0, device=None) -> BilevelProblem:
    """Softmax regression; y packs (W: d×C, u: C) -> d2 = (d+1)·C."""
    data = synthetic_classification_data(n, d, m_per, n_classes, seed=seed)
    return _build_ho_softmax(data, n_classes=n_classes, device=device)


def _build_ho_softmax(data: dict, *, n_classes: int = 10,
                      device=None) -> BilevelProblem:
    t = _tensors(data, device)
    n, _, d = t["Ztr"].shape
    d2 = (d + 1) * n_classes

    def ce(y_i, Z, lab):
        Wm = y_i[: d * n_classes].reshape(d, n_classes)
        logits = Z @ Wm + y_i[d * n_classes:]
        lse = torch.logsumexp(logits, dim=-1)
        return torch.mean(lse - _take_true(logits, lab))

    def g(x_i, y_i, di):
        return ce(y_i, di["Ztr"], di["ltr"]) + _reg(x_i, y_i)

    def f(x_i, y_i, di):
        return ce(y_i, di["Zval"], di["lval"])

    return BilevelProblem("ho_softmax", n, d2, d2, f, g, t, mu_g=0.0)


# ---------------------------------------------------------------------------
# 3. Hyper-representation learning (§6.2, Fig. 4)
# ---------------------------------------------------------------------------

def hyper_representation(n: int, d: int = 28, hidden: int = 200,
                         n_classes: int = 10, m_per: int = 30, *,
                         seed: int = 0, ridge: float = 1e-2,
                         device=None) -> BilevelProblem:
    """2-layer MLP: outer x = hidden layer (d·hidden + hidden), inner
    y = output head (hidden·C + C).  Paper: 157k outer / 2010 inner with
    d=784."""
    data = synthetic_classification_data(n, d, m_per, n_classes, seed=seed)
    return _build_hyper_representation(data, hidden=hidden,
                                       n_classes=n_classes, ridge=ridge,
                                       device=device)


def _build_hyper_representation(data: dict, *, hidden: int = 200,
                                n_classes: int = 10, ridge: float = 1e-2,
                                device=None) -> BilevelProblem:
    t = _tensors(data, device)
    n, _, d = t["Ztr"].shape
    d1 = d * hidden + hidden
    d2 = hidden * n_classes + n_classes

    def backbone(x_i, Z):
        W1 = x_i[: d * hidden].reshape(d, hidden)
        return torch.relu(Z @ W1 + x_i[d * hidden:])

    def head_ce(y_i, Hfeat, lab):
        W2 = y_i[: hidden * n_classes].reshape(hidden, n_classes)
        logits = Hfeat @ W2 + y_i[hidden * n_classes:]
        lse = torch.logsumexp(logits, dim=-1)
        return torch.mean(lse - _take_true(logits, lab))

    def g(x_i, y_i, di):
        return head_ce(y_i, backbone(x_i, di["Ztr"]), di["ltr"]) \
            + 0.5 * ridge * torch.sum(y_i * y_i)

    def f(x_i, y_i, di):
        return head_ce(y_i, backbone(x_i, di["Zval"]), di["lval"])

    return BilevelProblem("hyper_representation", n, d1, d2, f, g, t,
                          mu_g=ridge)


def hyperrep_accuracy(prob: BilevelProblem, x: Tensor, y: Tensor) -> float:
    """Mean validation accuracy across agents for hyper_representation
    (§6.2, Fig. 4): each agent's backbone x_i and head y_i on its Zval."""
    di = prob.data
    d = di["Zval"].shape[-1]
    hidden = prob.d1 // (d + 1)
    C = prob.d2 // (hidden + 1)

    def acc_one(x_i, y_i, Z, lab):
        W1 = x_i[: d * hidden].reshape(d, hidden)
        Hf = torch.relu(Z @ W1 + x_i[d * hidden:])
        W2 = y_i[: hidden * C].reshape(hidden, C)
        pred = torch.argmax(Hf @ W2 + y_i[hidden * C:], dim=-1)
        return torch.mean((pred == lab).to(torch.float32))

    return float(torch.mean(vmap(acc_one)(x, y, di["Zval"], di["lval"])))


# ---------------------------------------------------------------------------
# 4. Heterogeneous fair loss tuning (§6.3, Fig. 5)
# ---------------------------------------------------------------------------

def fair_loss_tuning(n: int, d: int = 28, n_classes: int = 10,
                     m_per: int = 30, *, q: float = 0.5, seed: int = 0,
                     ridge: float = 1e-2, device=None) -> BilevelProblem:
    """Outer x ∈ R^C = per-class loss weights (softplus-activated); inner
    y = linear classifier.  f_i = class-balanced validation CE; g_i =
    x-weighted train CE on the long-tail heterogeneous split."""
    data = synthetic_classification_data(
        n, d, m_per, n_classes, seed=seed, long_tail=True, q=q)
    return _build_fair_loss_tuning(data, n_classes=n_classes, ridge=ridge,
                                   device=device)


def _build_fair_loss_tuning(data: dict, *, n_classes: int = 10,
                            ridge: float = 1e-2,
                            device=None) -> BilevelProblem:
    t = _tensors(data, device)
    n, _, d = t["Ztr"].shape
    d2 = (d + 1) * n_classes
    classes = torch.arange(n_classes, device=t["Ztr"].device)

    def per_ex_ce(y_i, Z, lab):
        Wm = y_i[: d * n_classes].reshape(d, n_classes)
        lg = Z @ Wm + y_i[d * n_classes:]
        return torch.logsumexp(lg, dim=-1) - _take_true(lg, lab)

    def g(x_i, y_i, di):
        sp = torch.logaddexp(x_i, torch.zeros_like(x_i))   # softplus
        w = torch.gather(sp, 0, di["ltr"])
        return torch.mean(w * per_ex_ce(y_i, di["Ztr"], di["ltr"])) \
            + 0.5 * ridge * torch.sum(y_i * y_i)

    def f(x_i, y_i, di):
        # class-balanced: average of per-class mean losses
        ce = per_ex_ce(y_i, di["Zval"], di["lval"])
        onehot = (di["lval"][:, None] == classes).to(torch.float32)
        per_class = (onehot * ce[:, None]).sum(0) / (onehot.sum(0) + 1e-6)
        present = (onehot.sum(0) > 0).to(torch.float32)
        return (per_class * present).sum() / present.sum()

    return BilevelProblem("fair_loss_tuning", n, n_classes, d2, f, g, t,
                          mu_g=ridge)


def stack_problem_data(probs) -> dict:
    """Stack compatible problems' data along a new leading job axis:
    leaves go (n, ...) -> (jobs, n, ...).

    The problems must be instances of one family at one set of shapes
    (same `name`, n, d1, d2 and leaf shapes) — the members of one serve
    bucket; `f`/`g` are the template's and each job's slice is
    reattached with `BilevelProblem.with_data` inside the vmapped
    runner."""
    probs = list(probs)
    if not probs:
        raise ValueError("stack_problem_data needs at least one problem")
    t = probs[0]
    shapes = {k: tuple(v.shape) for k, v in t.data.items()}
    for p in probs[1:]:
        if (p.name, p.n, p.d1, p.d2) != (t.name, t.n, t.d1, t.d2):
            raise ValueError(
                f"cannot stack {p.name}(n={p.n},d1={p.d1},d2={p.d2}) "
                f"with {t.name}(n={t.n},d1={t.d1},d2={t.d2}): same "
                f"family/shapes required (one bucket = one compile "
                f"signature)")
        ps = {k: tuple(v.shape) for k, v in p.data.items()}
        if ps != shapes:
            raise ValueError(
                f"cannot stack {p.name} jobs with differing data leaf "
                f"shapes: {ps} vs {shapes}")
    return {k: torch.stack([p.data[k] for p in probs])
            for k in t.data}


#: Problem zoo registry: family name -> constructor.
PROBLEM_FAMILIES = {
    "quadratic": quadratic_bilevel,
    "ho_regression": ho_regression,
    "ho_logistic": ho_logistic,
    "ho_svm": ho_svm,
    "ho_softmax": ho_softmax,
    "hyper_representation": hyper_representation,
    "fair_loss_tuning": fair_loss_tuning,
}

def problem_family(name: str):
    """Constructor for a zoo family (KeyError with the menu otherwise)."""
    try:
        return PROBLEM_FAMILIES[name]
    except KeyError:
        raise KeyError(f"unknown problem family {name!r}; expected one "
                       f"of {sorted(PROBLEM_FAMILIES)}") from None


#: family name -> constructor from a dict of numpy data arrays (interop).
FAMILY_FROM_DATA = {
    "quadratic": _build_quadratic,
    "ho_regression": _build_ho_regression,
    "ho_logistic": _build_ho_logistic,
    "ho_svm": _build_ho_svm,
    "ho_softmax": _build_ho_softmax,
    "hyper_representation": _build_hyper_representation,
    "fair_loss_tuning": _build_fair_loss_tuning,
}


def balanced_accuracy(prob: BilevelProblem, y: Tensor) -> float:
    """Mean over agents of the class-balanced validation accuracy of the
    linear classifier y_i (§6.3, Fig. 5); classes absent from an agent's
    Zval do not count."""
    di = prob.data
    d = di["Zval"].shape[-1]
    C = prob.d1

    def acc_one(y_i, Z, lab):
        Wm = y_i[: d * C].reshape(d, C)
        pred = torch.argmax(Z @ Wm + y_i[d * C:], dim=-1)
        onehot = torch.nn.functional.one_hot(lab.long(), C).to(torch.float32)
        correct = (pred == lab).to(torch.float32)
        per_class = (onehot * correct[:, None]).sum(0) \
            / (onehot.sum(0) + 1e-6)
        present = (onehot.sum(0) > 0).to(torch.float32)
        return (per_class * present).sum() / present.sum()

    return float(torch.mean(vmap(acc_one)(y, di["Zval"], di["lval"])))
