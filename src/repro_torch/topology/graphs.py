"""Graph generators and connectivity checks (paper §3, Assumption A1/A3).

The decentralized network G = (V, E) is a connected undirected graph;
this module builds the adjacency structures the paper's experiments run
on — ring / 2k-regular circulant (shift-invariant), Erdős–Rényi with a
connectivity ratio r (Figs. 2–3 use r = 0.5), star (the federated /
parameter-server topology) and complete — plus the connectivity check
that Assumption A3 (simple eigenvalue 1) rests on.

Adjacency matrices are boolean (n, n) numpy arrays with no self-loops;
weight schemes over them live in `repro_torch.topology.weights`, structure
extraction for the execution backends in `repro_torch.topology.structure`.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def ring_graph(n: int) -> np.ndarray:
    """Cycle graph C_n; each agent talks to left+right neighbors."""
    if n < 2:
        raise ValueError("ring requires n >= 2")
    adj = np.zeros((n, n), dtype=bool)
    idx = np.arange(n)
    adj[idx, (idx + 1) % n] = True
    adj[(idx + 1) % n, idx] = True
    return adj


def circulant_graph(n: int, offsets: Sequence[int]) -> np.ndarray:
    """2k-regular circulant: agent i adjacent to i +/- o for o in offsets."""
    adj = np.zeros((n, n), dtype=bool)
    idx = np.arange(n)
    for o in offsets:
        o = int(o) % n
        if o == 0:
            continue
        adj[idx, (idx + o) % n] = True
        adj[(idx + o) % n, idx] = True
    return adj


def complete_graph(n: int) -> np.ndarray:
    adj = np.ones((n, n), dtype=bool)
    np.fill_diagonal(adj, False)
    return adj


def star_graph(n: int) -> np.ndarray:
    """Star: node 0 is the center (the federated/parameter-server topology)."""
    adj = np.zeros((n, n), dtype=bool)
    adj[0, 1:] = True
    adj[1:, 0] = True
    return adj


def erdos_renyi_graph(n: int, r: float, seed: int = 0) -> np.ndarray:
    """Random connected graph with connectivity ratio r (paper uses r=0.5).

    Edges are sampled iid Bernoulli(r); a ring is superimposed to
    guarantee connectivity (standard practice, keeps W well defined).
    """
    rng = np.random.default_rng(seed)
    upper = rng.random((n, n)) < r
    adj = np.triu(upper, 1)
    adj = adj | adj.T
    adj |= ring_graph(n)
    np.fill_diagonal(adj, False)
    return adj


def is_connected(adj: np.ndarray) -> bool:
    n = adj.shape[0]
    seen = np.zeros(n, dtype=bool)
    stack = [0]
    seen[0] = True
    while stack:
        i = stack.pop()
        for j in np.nonzero(adj[i])[0]:
            if not seen[j]:
                seen[j] = True
                stack.append(int(j))
    return bool(seen.all())
