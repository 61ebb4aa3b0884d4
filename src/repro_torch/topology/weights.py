"""Mixing-weight schemes and spectral diagnostics (paper §3).

Given an adjacency structure from `repro_torch.topology.graphs`, these build
the nonnegative, symmetric, doubly-stochastic mixing matrix W the
algorithms gossip through, and measure the spectral quantities the
convergence theory depends on:

  * Metropolis weights (Example 2 / Eq. 22) and maximum-degree weights
    (Example 1), plus the uniform-averaging 'centralized' limit,
  * the mixing rate sigma = ||W - (1/n)11^T|| (Eq. 2) and the spectral
    gap 1 - sigma,
  * theta / Theta self-weight bounds (A4) and rho of Lemma 5,
  * `check_assumption_a`, the validator every `Network` passes through.

W itself is small (n × n, n = number of agents) and always materialized
in numpy; how it is *applied* to stacked per-agent state is the concern
of `repro_torch.topology.ops`.
"""
from __future__ import annotations

import numpy as np


def metropolis_weights(adj: np.ndarray) -> np.ndarray:
    """Metropolis weights, paper Example 2 / Eq. (22).

    w_ij = 1 / (1 + max(deg i, deg j)) on edges; self-weights make rows
    sum to one.  Symmetric + doubly stochastic by construction.
    """
    n = adj.shape[0]
    deg = adj.sum(axis=1)
    W = np.zeros((n, n), dtype=np.float64)
    ii, jj = np.nonzero(adj)
    W[ii, jj] = 1.0 / (1.0 + np.maximum(deg[ii], deg[jj]))
    W[np.arange(n), np.arange(n)] = 1.0 - W.sum(axis=1)
    return W


def max_degree_weights(adj: np.ndarray) -> np.ndarray:
    """Maximum-degree weights, paper Example 1: uniform 1/n on edges."""
    n = adj.shape[0]
    deg = adj.sum(axis=1)
    W = adj.astype(np.float64) / n
    W[np.arange(n), np.arange(n)] = 1.0 - deg / n
    return W


def uniform_averaging(n: int) -> np.ndarray:
    """W = (1/n) 11^T — the 'centralized' limit (complete graph, sigma=0)."""
    return np.full((n, n), 1.0 / n)


# ---------------------------------------------------------------------------
# Spectral quantities + Assumption A checks
# ---------------------------------------------------------------------------

def mixing_rate(W: np.ndarray) -> float:
    """sigma = ||W - (1/n)11^T||_2 = max(|lambda_2|, |lambda_n|)  (Eq. 2)."""
    n = W.shape[0]
    M = W - np.full((n, n), 1.0 / n)
    return float(np.linalg.norm(M, 2))


def self_weight_bounds(W: np.ndarray) -> tuple[float, float]:
    """(theta, Theta) of Assumption A4: theta <= w_ii <= Theta."""
    d = np.diag(W)
    return float(d.min()), float(d.max())


def neumann_rho(W: np.ndarray, beta: float, mu_g: float) -> float:
    """rho = 2(1-theta) / (2(1-Theta) + beta*mu_g)  (Lemma 5)."""
    theta, Theta = self_weight_bounds(W)
    return 2.0 * (1.0 - theta) / (2.0 * (1.0 - Theta) + beta * mu_g)


def spectral_gap(W: np.ndarray) -> float:
    return 1.0 - mixing_rate(W)


def check_assumption_a(W: np.ndarray, adj: np.ndarray | None = None,
                       atol: float = 1e-10) -> None:
    """Raise AssertionError unless W satisfies Assumption A1–A4."""
    n = W.shape[0]
    assert W.shape == (n, n)
    assert np.all(W >= -atol), "W must be nonnegative"
    assert np.allclose(W, W.T, atol=atol), "W must be symmetric"
    assert np.allclose(W.sum(axis=1), 1.0, atol=atol), "rows must sum to 1"
    assert np.allclose(W.sum(axis=0), 1.0, atol=atol), "cols must sum to 1"
    if adj is not None:
        off = ~np.eye(n, dtype=bool)
        assert np.all((np.abs(W) > atol)[off] <= adj[off]), \
            "A1: w_ij != 0 only on edges"
    # A3: null(I - W) = span(1)  <=> eigenvalue 1 has multiplicity one
    evals = np.linalg.eigvalsh(W)
    assert np.sum(np.abs(evals - 1.0) < 1e-8) == 1, \
        "A3: eigenvalue 1 must be simple (graph connected)"
    assert evals.min() > -1.0 + 1e-12, "eigenvalues must lie in (-1, 1]"
    theta, Theta = self_weight_bounds(W)
    assert 0.0 < theta <= Theta <= 1.0, "A4: 0 < theta <= w_ii <= Theta <= 1"
