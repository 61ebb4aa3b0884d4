"""Fault injection: per-round gossip degradation for decentralized runs.

Counterpart of `repro.faults.faults`.  The paper's Assumption A3 fixes
one connected, doubly-stochastic W for every round.  Real fleets are
not so polite: links drop packets, agents straggle (skip a round's
sends) and churn (leave and rejoin mid-solve).  This module describes
those faults (`FaultSpec`, frozen and deterministic given its seed) and
lowers them to per-round boolean *edge masks* (`lower_faults` ->
`FaultTrace`).

Degradation semantics — the invariant every realized round preserves:

    W_k = W ⊙ M_k  off-diagonal,   (W_k)_ii = w_ii + Σ_j w_ij (1 − M_k,ij)

i.e. a dropped link's Metropolis weight folds back into BOTH endpoints'
self-weights (the mask is symmetric: a link is down for both directions
or neither).  Every W_k therefore stays nonnegative, symmetric and
doubly stochastic with self-weights in [θ, 1].  An agent with every
incident link masked (a straggler's round, a churned-out epoch) has
w_ii = 1 and holds its consensus terms; it keeps computing locally and
re-enters averaging when its links return.

Execution never materializes W_k: `MixingOp.masked`
(`repro_torch.topology.ops`) applies the masks in the padded
neighbor-table operand space (`FaultTrace.table_masks`), on the padded
sparse-gather kernels.

Random draws.  `lower_faults` draws link drops and straggler skips
with `np.random.default_rng` on two streams spawned from `spec.seed`
(`np.random.SeedSequence(seed).spawn(2)`), where `repro` folds
`jax.random.PRNGKey(seed)` into two Bernoulli streams.  The two
packages therefore realize drops and skips differently for one seed;
churn is a pure schedule and lowers identically.  `FaultTrace` holds
numpy arrays only, so a trace lowered by `repro` carries across as it
is (`FaultTrace(spec, trace.adj, trace.edge_masks)`), as
`interop.load_problem` carries its data.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """A deterministic fault model for one run (hashable; rides inside
    `repro_torch.solve.SolverSpec.faults`).

    drop_prob:     iid per-round, per-undirected-link drop probability.
    stragglers:    agent ids that intermittently skip a round's sends
                   (all their incident links mask for that round).
    straggle_prob: per-round probability each straggler skips.
    churn:         (agent, leave_round, rejoin_round) epochs — the agent
                   is absent (fully unlinked) for leave <= k < rejoin.
    seed:          seed of the draws; equal specs lower to identical
                   traces.
    """
    drop_prob: float = 0.0
    stragglers: tuple[int, ...] = ()
    straggle_prob: float = 0.5
    churn: tuple[tuple[int, int, int], ...] = ()
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "stragglers",
                           tuple(int(a) for a in self.stragglers))
        object.__setattr__(self, "churn", tuple(
            tuple(int(v) for v in epoch) for epoch in self.churn))
        if not 0.0 <= self.drop_prob < 1.0:
            raise ValueError(
                f"FaultSpec.drop_prob must be in [0, 1) (got "
                f"{self.drop_prob}); 1.0 would sever every link every "
                f"round — model permanent absence with churn instead")
        if not 0.0 < self.straggle_prob <= 1.0:
            raise ValueError(
                f"FaultSpec.straggle_prob must be in (0, 1] (got "
                f"{self.straggle_prob}); drop the agent from "
                f"`stragglers` rather than setting probability 0")
        for epoch in self.churn:
            if len(epoch) != 3:
                raise ValueError(
                    f"FaultSpec.churn entries are (agent, leave_round, "
                    f"rejoin_round) triples; got {epoch!r}")
            _, leave, rejoin = epoch
            if leave < 0 or rejoin <= leave:
                raise ValueError(
                    f"FaultSpec.churn epoch {epoch!r} needs "
                    f"0 <= leave_round < rejoin_round")

    @property
    def is_trivial(self) -> bool:
        """True when the spec injects nothing (all-alive every round)."""
        return self.drop_prob == 0.0 and not self.stragglers \
            and not self.churn


def realized_W(W, edge_mask) -> np.ndarray:
    """The round's effective mixing matrix for a symmetric boolean edge
    mask: dropped off-diagonal weights fold into the self-weights (see
    module docstring).  Reference and tests only — the gossip applies
    the mask in table space without materializing W_k."""
    W = np.asarray(W, np.float64)
    m = np.asarray(edge_mask, bool).copy()
    np.fill_diagonal(m, True)
    if not np.array_equal(m, m.T):
        raise ValueError("edge mask must be symmetric (a link is down "
                         "for both directions or neither)")
    off = ~np.eye(W.shape[0], dtype=bool)
    dropped = np.where(off & ~m, W, 0.0)
    Wk = np.where(m, W, 0.0)
    Wk[np.diag_indices_from(Wk)] += dropped.sum(axis=1)
    return Wk


@dataclasses.dataclass(frozen=True)
class FaultTrace:
    """A lowered fault schedule: one symmetric boolean edge mask per
    round (diagonal always True), plus the adjacency it masks."""
    spec: FaultSpec
    adj: np.ndarray           # (n, n) bool adjacency being degraded
    edge_masks: np.ndarray    # (K, n, n) bool, symmetric, diag True

    @property
    def n(self) -> int:
        return self.adj.shape[0]

    @property
    def rounds(self) -> int:
        return self.edge_masks.shape[0]

    def realized_W(self, W, k: int) -> np.ndarray:
        return realized_W(W, self.edge_masks[k])

    def table_masks(self, sp) -> np.ndarray:
        """(K, n, k_max) float32 masks in the padded neighbor-table
        layout of `topology.structure.SparseStructure` — the per-round
        operand `MixingOp.masked` consumes.  Padded slots (a row's own
        index, weight 0) read the diagonal and stay 1."""
        rows = np.arange(self.n)[:, None]
        return self.edge_masks[:, rows, sp.neighbors].astype(np.float32)

    def alive_fraction(self, rounds: int | None = None) -> float:
        """Realized directed sends / nominal directed sends over the
        first `rounds` rounds (all, when None) — the honest wire-byte
        scale for a faulted run (a dropped link moves no bytes)."""
        K = self.rounds if rounds is None else int(rounds)
        off = self.adj & ~np.eye(self.n, dtype=bool)
        nominal = K * int(off.sum())
        alive = int((self.edge_masks[:K] & off).sum())
        return alive / max(nominal, 1)

    def observe(self, reg=None, **labels) -> None:
        """Publish this trace's alive fraction and round count into a
        metrics registry (`repro_torch.obs.observe_fault_extras`, as a
        faulted solve's extras carry them)."""
        from ..obs import observe_fault_extras
        observe_fault_extras({"fault_trace": self,
                              "fault_alive_fraction": self.alive_fraction()},
                             reg, **labels)


def lower_faults(spec: FaultSpec, net, K: int) -> FaultTrace:
    """Lower a FaultSpec against a concrete network and round budget.

    Deterministic: the per-round Bernoulli draws come from two numpy
    generators spawned from `spec.seed` — link drops on the first,
    straggler skips on the second (module docstring); churn is a pure
    schedule."""
    adj = np.asarray(net.adj, bool)
    n = adj.shape[0]
    K = int(K)
    if K <= 0:
        raise ValueError(f"fault traces need K >= 1 rounds (got {K})")
    for a in spec.stragglers:
        if not 0 <= a < n:
            raise ValueError(f"FaultSpec straggler {a} out of range for "
                             f"an n={n} network")
    for a, leave, rejoin in spec.churn:
        if not 0 <= a < n:
            raise ValueError(f"FaultSpec.churn agent {a} out of range "
                             f"for an n={n} network")
        if leave >= K:
            raise ValueError(
                f"FaultSpec.churn epoch ({a}, {leave}, {rejoin}) starts "
                f"at or past the K={K} round budget — it would never "
                f"fire; drop it or raise K")

    drops, skips = (np.random.default_rng(s) for s in
                    np.random.SeedSequence(spec.seed).spawn(2))
    iu, ju = np.nonzero(np.triu(adj, 1))
    masks = np.ones((K, n, n), dtype=bool)

    if spec.drop_prob > 0.0 and iu.size:
        keep = drops.random((K, iu.size)) < 1.0 - spec.drop_prob
        masks[:, iu, ju] = keep
        masks[:, ju, iu] = keep

    agent_off = np.zeros((K, n), dtype=bool)
    if spec.stragglers:
        skip = skips.random((K, len(spec.stragglers))) \
            < spec.straggle_prob
        agent_off[:, list(spec.stragglers)] |= skip
    for a, leave, rejoin in spec.churn:
        agent_off[leave:min(rejoin, K), a] = True
    if agent_off.any():
        off_rows = agent_off[:, :, None] | agent_off[:, None, :]
        masks &= ~off_rows

    diag = np.eye(n, dtype=bool)
    masks |= diag[None]
    return FaultTrace(spec=spec, adj=adj, edge_masks=masks)
