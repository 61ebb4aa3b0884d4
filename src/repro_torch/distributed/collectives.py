"""Decentralized mixing over a ring of agents — the counterpart of
`repro.distributed.collectives`.

The paper's gossip step — each agent averages its state with its ring
neighbours through the mixing matrix W — is W·y at agent i = a weighted
sum of y from agents i ± o for the ring's offsets o.  `repro` runs it as
`lax.ppermute` inside `shard_map`; the port has two transports:

* `LocalRing(n, device)` — all n agents on one device.  Every leaf of a
  state tree carries a leading agent axis (`repro`'s global layout), and
  each leaf's gossip is one `MixingOp` call on its (n, numel) view: the
  circulant CUDA kernels (the comm-fused ones for int8/int4 ± EF) where
  `MixingOp` picks them, its composed path for bf16, top-k and rand-k.
  W comes from `RingWeights.matrix()`, where offsets ±o that reach the
  same agent add up (n = 2: W₀₁ = 2/3, as the gossip computes), never
  from `RingWeights.to_network()`, whose Metropolis W differs there.
* `ProcessRing(mesh, axis)` — one agent per rank of a `torch.distributed`
  group: the `DeviceMesh` dim(s) named by `axis`, as `repro` names the
  jax `Mesh` axis.  Leaves are the agent's own tensors, without the
  agent axis.  The exchange is `dist.batch_isend_irecv` to ranks i ± o
  in place of `lax.ppermute` (gloo on the CPU, NCCL across cards), and
  the received neighbours are added in the order `MixingOp` adds them
  for this n, so that on the CPU one gossip equals `LocalRing`'s plain
  version bit for bit (identity and int8/int4 ± EF).

Both transports expose one primitive, `shift` (agent i receives agent
(i − offset) mod n, as `ppermute_shift`), and the gossip built on it.
The self term w_self·x never crosses the wire; a `comm_dtype=bf16` mix
sends bf16 and accumulates in the leaf dtype.  No all-reduce appears in
the optimization path: the sharded DAGM reduces only its metrics.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from .._device import resolve_device
from ..topology.ops import MixingOp


@dataclasses.dataclass(frozen=True)
class RingWeights:
    """Shift-invariant mixing weights: w_self + {offset: weight}, agent i
    receiving agent (i − offset) mod n's value with that weight."""
    n: int
    w_self: float
    offsets: dict  # offset (±o) -> weight

    @classmethod
    def metropolis_ring(cls, n: int) -> "RingWeights":
        # ring: deg 2 everywhere -> w_edge = 1/3, w_self = 1/3
        return cls(n=n, w_self=1.0 / 3.0,
                   offsets={+1: 1.0 / 3.0, -1: 1.0 / 3.0})

    @classmethod
    def metropolis_circulant(cls, n: int, hops: int) -> "RingWeights":
        """2·hops-regular circulant with Metropolis weights."""
        deg = 2 * hops
        w = 1.0 / (1.0 + deg)
        offs = {}
        for o in range(1, hops + 1):
            offs[+o] = w
            offs[-o] = w
        return cls(n=n, w_self=1.0 - deg * w, offsets=offs)

    def table(self) -> dict:
        """{cyclic offset o: weight}, agent i reading agent (i + o) mod
        n — `MixingOp`'s circulant table — with the weights of offsets
        that reach the same agent added up."""
        acc: dict = {}
        for s, c in self.offsets.items():
            o = (-s) % self.n
            acc[o] = acc.get(o, 0.0) + c
        return acc

    def matrix(self) -> np.ndarray:
        """The (n, n) float64 W that the gossip applies."""
        W = np.zeros((self.n, self.n))
        i = np.arange(self.n)
        W[i, i] = self.w_self
        for o, c in self.table().items():
            W[i, (i + o) % self.n] += c
        return W

    def to_network(self):
        """`repro`'s dense-W Network equivalent (reference-tier
        comparisons): the Metropolis circulant of the same hops, which
        differs from `matrix()` where ±o coincide (n ≤ 2·hops)."""
        from ..topology import make_network
        hops = max(abs(o) for o in self.offsets)
        return make_network("circulant", self.n,
                            offsets=tuple(range(1, hops + 1)))


def _circulant_tier(W: np.ndarray) -> bool:
    """Whether "auto" `MixingOp` takes its circulant backend for W."""
    from ..topology.structure import circulant_structure
    s = circulant_structure(W)
    return s is not None and 2 * (len(s.offsets) + 1) <= s.n


def neighbor_order(w: RingWeights, rank: int) -> list[tuple[int, float]]:
    """(cyclic offset o, weight) of agent `rank`'s received terms, in the
    order `MixingOp`'s plain versions add them at this n: by offset on
    its circulant backend, else by source agent (the padded tables' and
    the dense matmul's column order).  At n = 1 both neighbours are the
    agent itself (o = 0)."""
    table = w.table()
    if _circulant_tier(w.matrix()):
        key = lambda oc: oc[0]
    else:
        key = lambda oc: (rank + oc[0]) % w.n
    return sorted(table.items(), key=key)


class _LeafOp(MixingOp):
    """A `MixingOp` whose channel state carries its send's seed (the
    `seed` field): the ring, not the op, derives each leaf's seed."""

    def _next_seed(self, st) -> int:
        return st.seed


class LocalRing:
    """All n agents on one device (see module docstring).  `device`:
    CUDA unless the caller names another.  `agent_chunk`: how many agents'
    autodiff `per_agent` runs at once (None: all n), each chunk's results
    written into the stacked outputs — an LM's per-agent gradients and
    HVPs hold several parameter trees each, which n at once may not fit
    on one card."""

    stacked = True

    def __init__(self, n: int, device=None, agent_chunk: int | None = None):
        if n < 1:
            raise ValueError(f"a ring needs n >= 1 agents, got {n}")
        if agent_chunk is not None and agent_chunk < 1:
            raise ValueError(f"agent_chunk must be None or >= 1, got "
                             f"{agent_chunk}")
        self.n = int(n)
        self.agent_chunk = agent_chunk
        self.device = resolve_device(device)
        self.w = RingWeights.metropolis_ring(self.n)
        self._W = self.w.matrix()
        self._ops: dict = {}

    def __repr__(self) -> str:
        return f"LocalRing(n={self.n}, device={self.device})"

    def op(self, spec: str = "identity"):
        """The ring's `MixingOp` on wire policy `spec` (built once)."""
        if spec not in self._ops:
            self._ops[spec] = _LeafOp(self._W, backend="auto", name="ring",
                                      comm=spec, device=self.device)
        return self._ops[spec]

    # -- the transport ------------------------------------------------------

    def shift(self, tensors, offsets):
        """[[agent (i − o) mod n's t for o in offsets] for t in tensors]."""
        return [[torch.roll(t, int(o), dims=0) for o in offsets]
                for t in tensors]

    def mix(self, leaves, *, laplacian: bool = False, comm_dtype=None):
        if comm_dtype is None:
            op = self.op("identity")
            return [op.laplacian(x) if laplacian else op.mix(x)
                    for x in leaves]
        if comm_dtype != torch.bfloat16:
            raise ValueError(f"comm_dtype must be None or torch.bfloat16, "
                             f"got {comm_dtype}")
        from ..comm import ChannelState
        op, st = self.op("bf16"), ChannelState(hat=None, sends=0)
        call = op.laplacian_c if laplacian else op.mix_c
        return [call(x, st)[0] for x in leaves]

    def mix_c(self, leaves, hats, policy, seeds, *, laplacian: bool = False):
        """One gossip of each leaf through the wire `policy`: (outputs,
        new hats), each leaf's send seeded by seeds[l]."""
        from ..comm import ChannelState
        op = self.op(policy.spec)
        call = op.laplacian_c if laplacian else op.mix_c
        outs, new_hats = [], []
        for x, hat, seed in zip(leaves, hats, seeds):
            out, st = call(x, ChannelState(hat=hat, sends=0, seed=seed))
            outs.append(out)
            new_hats.append(st.hat)
        return outs, new_hats

    # -- per-agent autodiff and agent reductions ----------------------------

    def per_agent(self, fn):
        """fn of one agent's (x, y, batch, ...) mapped over the agent
        axis (`torch.func.vmap`; a None argument is not mapped)."""
        from torch.func import vmap

        def call(*args):
            dims = tuple(None if a is None else 0 for a in args)
            k = self.agent_chunk
            if k is None or k >= self.n:
                return vmap(fn, in_dims=dims)(*args)
            # agent_chunk agents at a time, each chunk's results written
            # into the stacked outputs as they come
            out = None
            for a in range(0, self.n, k):
                rows = slice(a, a + k)
                part = vmap(fn, in_dims=dims)(*(
                    None if x is None else tree_map(lambda t: t[rows], x)
                    for x in args))
                if out is None:
                    out = tree_map(lambda t: t.new_empty(
                        (self.n,) + tuple(t.shape[1:])), part)
                tree_map(lambda o, p: o[rows].copy_(p), out, part)
                del part
            return out
        return call

    def agent_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Each agent's sum of t's elements: (n,)."""
        return t.reshape(t.shape[0], -1).sum(dim=1)

    def mean(self, values: dict) -> dict:
        """{name: the agent mean of a per-agent (n,) value}."""
        return {k: v.mean() for k, v in values.items()}

    def average(self, tree):
        """The agent mean of every leaf, broadcast back to each agent."""
        return tree_map(lambda t: t.mean(dim=0, keepdim=True), tree)


class ProcessRing:
    """One agent per rank of the `DeviceMesh` dim(s) `axis` (a name, or a
    tuple of names ringed over their flattened product, as `repro`'s
    ("pod", "data")).  Tensors live on the mesh's device type: gloo on
    the CPU, NCCL on the cards (each rank with its `torch.cuda` device
    set)."""

    stacked = False

    def __init__(self, mesh, axis="data"):
        import torch.distributed as dist
        names = axis if isinstance(axis, tuple) else (axis,)
        sub = mesh[names]._flatten() if len(names) > 1 else mesh
        self.group = sub.get_group(names[0] if len(names) == 1 else 0)
        self.n = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.axis = axis
        self.device = resolve_device(
            "cpu" if mesh.device_type == "cpu" else "cuda")
        self.w = RingWeights.metropolis_ring(self.n)
        self._order = neighbor_order(self.w, self.rank)
        self._peers = [dist.get_global_rank(self.group, r)
                       for r in range(self.n)]

    def __repr__(self) -> str:
        return (f"ProcessRing(n={self.n}, rank={self.rank}, "
                f"axis={self.axis!r}, device={self.device})")

    # -- the transport ------------------------------------------------------

    def shift(self, tensors, offsets):
        """[[agent (i − o) mod n's t for o in offsets] for t in tensors],
        every send and receive in one `batch_isend_irecv`."""
        import torch.distributed as dist
        ops, out = [], []
        for t in tensors:
            t = t.contiguous()
            row = []
            for o in offsets:
                buf = torch.empty_like(t)
                ops.append(dist.P2POp(dist.isend, t,
                                      self._peers[(self.rank + o) % self.n],
                                      self.group))
                ops.append(dist.P2POp(dist.irecv, buf,
                                      self._peers[(self.rank - o) % self.n],
                                      self.group))
                row.append(buf)
            out.append(row)
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out

    def _combine(self, leaves, sends, laplacian: bool):
        """w_self·x + Σ weight·(neighbour's send), in `neighbor_order`."""
        received = self.shift(sends, [-o for o, _ in self._order])
        outs = []
        for x, recv in zip(leaves, received):
            acc = self.w.w_self * x
            for (_, c), r in zip(self._order, recv):
                acc = acc + c * r.to(x.dtype)
            outs.append(x - acc if laplacian else acc)
        return outs

    def mix(self, leaves, *, laplacian: bool = False, comm_dtype=None):
        sends = leaves if comm_dtype is None \
            else [x.to(comm_dtype) for x in leaves]
        return self._combine(leaves, sends, laplacian)

    def mix_c(self, leaves, hats, policy, seeds, *, laplacian: bool = False):
        from ..comm import compressed_payload_local
        pays, new_hats = [], []
        for x, hat, seed in zip(leaves, hats, seeds):
            p, h = compressed_payload_local(policy, x, hat, seed,
                                            row=self.rank)
            pays.append(p)
            new_hats.append(h)
        return self._combine(leaves, pays, laplacian), new_hats

    # -- per-agent autodiff and agent reductions ----------------------------

    def per_agent(self, fn):
        return fn

    def agent_sum(self, t: torch.Tensor) -> torch.Tensor:
        return t.sum()

    def mean(self, values: dict) -> dict:
        """{name: agent mean}: one all-reduce SUM over the ring, / n
        (gloo has no AVG)."""
        import torch.distributed as dist
        keys = list(values)
        buf = torch.stack([values[k].to(torch.float32).reshape(())
                           for k in keys])
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        buf = buf / self.n
        return {k: buf[i] for i, k in enumerate(keys)}

    def average(self, tree):
        import torch.distributed as dist

        def one(t):
            t = t.clone()
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
            return t / self.n
        return tree_map(one, tree)


# ---------------------------------------------------------------------------
# Gossip on trees of tensors
# ---------------------------------------------------------------------------

def ring_shift(x: torch.Tensor, ring, offset: int) -> torch.Tensor:
    """Receive the value held by agent (i − offset) mod n."""
    return ring.shift([x], [offset])[0][0]


def ring_mix(tree, ring, comm_dtype=None):
    """(W ⊗ I) applied to a tree of per-agent state via neighbour
    exchange.  `comm_dtype` (torch.bfloat16) rounds only the sent
    copies; the self term and the accumulation stay in the leaf dtype."""
    leaves, spec = tree_flatten(tree)
    return tree_unflatten(ring.mix(leaves, comm_dtype=comm_dtype), spec)


def ring_laplacian(tree, ring, comm_dtype=None):
    """((I − W) ⊗ I) x."""
    leaves, spec = tree_flatten(tree)
    return tree_unflatten(ring.mix(leaves, laplacian=True,
                                   comm_dtype=comm_dtype), spec)


def leaf_send_seed(st, leaf: int) -> int:
    """The seed of leaf `leaf`'s part of the channel's next send: the
    leaf index folded into the channel's stream, then `send_seed`."""
    from ..comm import fold_seed, send_seed
    return send_seed(fold_seed(st.seed, leaf), st.sends)


def _gossip_c(tree, ring, policy, st, laplacian: bool):
    leaves, spec = tree_flatten(tree)
    if policy.is_identity or (policy.compressor.name == "bf16"
                              and not policy.ef):
        dt = None if policy.is_identity else torch.bfloat16
        return tree_unflatten(ring.mix(leaves, laplacian=laplacian,
                                       comm_dtype=dt), spec), st.bump()
    hats = tree_flatten(st.hat)[0] if policy.ef else [None] * len(leaves)
    seeds = [leaf_send_seed(st, i) if policy.stochastic else 0
             for i in range(len(leaves))]
    outs, new_hats = ring.mix_c(leaves, hats, policy, seeds,
                                laplacian=laplacian)
    hat = tree_unflatten(new_hats, spec) if policy.ef else st.hat
    return tree_unflatten(outs, spec), dataclasses.replace(
        st, hat=hat, sends=st.sends + 1)


def ring_mix_c(tree, ring, policy, st):
    """`ring_mix` through a `repro_torch.comm` channel -> (mixed, state).

    Identity and bf16 without EF take the plain mix (bf16 on the bf16
    wire); every other policy sends the decoded payload of each leaf as
    one wire row (under EF the innovation against the replica `st.hat`,
    a tree like `tree`), each leaf's stochastic draws seeded by
    `leaf_send_seed`.  One `sends` bump per exchange, not per leaf."""
    return _gossip_c(tree, ring, policy, st, laplacian=False)


def ring_laplacian_c(tree, ring, policy, st):
    """((I − W) ⊗ I) x through the compressed channel."""
    return _gossip_c(tree, ring, policy, st, laplacian=True)


# ---------------------------------------------------------------------------
# Tree vector-space helpers used by the sharded DAGM
# ---------------------------------------------------------------------------

def tadd(a, b):
    return tree_map(torch.add, a, b)


def tsub(a, b):
    return tree_map(torch.sub, a, b)


def tscale(c, a):
    return tree_map(lambda x: c * x, a)


def taxpy(c, a, b):
    """b + c * a."""
    return tree_map(lambda x, y: y + c * x, a, b)


def tdot(a, b):
    return sum(torch.sum(x * y) for x, y
               in zip(tree_flatten(a)[0], tree_flatten(b)[0]))


def tnorm(a):
    return torch.sqrt(tdot(a, a))
