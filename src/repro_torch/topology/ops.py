"""`Network` + the topology-aware `MixingOp` gossip executor.

W is small (n × n, n = number of agents) and always materialized; what
is hot is applying W ⊗ I to stacked per-agent states (n, d), M + U + 1
times per DAGM outer round.  The paper's communication-efficiency claim
rests on that being neighbor-only work (O(n·k·d) for k neighbors per
agent), so sparse topologies never go through a dense O(n²·d) matmul.

MixingOp backends (resolved once, at construction)
--------------------------------------------------
  * "dense"          — `torch.matmul(W, Y)`; any W (complete graphs).
  * "circulant"      — shift-invariant W (ring, 2k-regular circulant):
                       rolls of Y in plain PyTorch, or the
                       `circulant_mix_matvec` CUDA kernel and the fused
                       `circulant_neumann_step` kernel for DIHGP.
  * "sparse_gather"  — irregular sparse W (Erdős–Rényi, star): the
                       per-row gather over padded (n, k_max) tables on
                       near-regular degree distributions (n·k_max ≤
                       2·nnz — ER), in plain PyTorch or the
                       `sparse_mix_matvec` kernel; CSR `index_add_` in
                       plain PyTorch on skewed ones (star: k_max = n−1
                       but nnz = 2(n−1)).
  * "auto"           — circulant when shift-invariant and 2(k+1) ≤ n;
                       else sparse_gather when nnz + n < n²; else dense.

Which tier a gossip runs is `repro`'s rule (`repro.topology.ops
.MixingOp._resolve`), read at each call: "auto" takes the kernels on
its circulant or padded-gather tier while the kernel switch
`repro_torch.kernels.ops.kernels_enabled()` is on (on by default), and
never on a skewed graph's CSR path; an explicitly requested
"circulant" or "sparse_gather" stays on the plain PyTorch path, which
autograd differentiates (the kernels have no backward); the names of
`repro`'s Pallas tiers, "circulant_pallas" and "sparse_gather_pallas",
always take the kernels (`backend` then reads "circulant" /
"sparse_gather"; `requested` keeps the name asked for).  The kernels
mask the ragged edge, so `repro`'s (8, 128) tile constraints and their
fallbacks have no counterpart here: "auto" takes the kernels at any
shape.  On a CPU tensor the kernel wrappers run their plain PyTorch
versions.  Every gossip runs inside `repro_torch.strict_f32`.

Row tiles
---------
`_stripe_plan` mirrors `repro`'s three outcomes, with the card's shared
memory in place of VMEM (`repro_torch.kernels.mixing_matvec`, "Row
tiles and the shared-memory planner"): ("full", None) runs the
full-operand kernels, ("halo", bn) their row-tiled halo twins, and
("xla", None), where no row tile qualifies, the full-operand kernels
again (`repro` falls back to XLA there).  Those take any n: the plain
circulant ones read their neighbor rows from device memory, the plain
sparse gather stages a column stripe of all n rows in shared memory up
to n = 14,528 (`plan_stripe_cols`; f32 or bf16), and the comm-fused
circulant and sparse gossips stage and decode one up to the same n
(`plan_comm_stripe_cols`); past it these run their unstaged kernels.
The plan depends on n, the operand's itemsize and the variant's live buffers
(3 plain, 4 fused, 6 fused + EF), never on the data: the full operand
holds up to n = 151 (f32, plain), so the n = 16 runs keep the
full-operand kernels and n = 4096 takes the halo tier; `repro`
switches at n ≈ 4096, so for 151 < n < 4096 the two dispatch
differently and agree in result (the halo kernels equal the
full-operand ones bit for bit).  The plain full-operand circulant mix
runs the circulant halo's ring itself, at bn = n
(`circulant_ring_stages`).  The identity Neumann step keeps
`circulant_neumann_step` at any n, as `repro`'s does; that wrapper runs
it on the circulant ring at the row tile of `neumann_ring_plan` (bn =
n at n = 16, a shorter tile at n = 4096) and on its unstaged kernel
where no tile qualifies, one result either way.  The comm-fused Neumann
kernel runs on the full tier only, and on the halo tier the step
composes `mix_c` (a fused halo mix) with the update.

Mixing dtype
------------
`MixingOp(..., dtype="bf16")` stores the gossiped state in bfloat16 and
accumulates in f32: the operand is rounded to bf16 once, every backend
accumulates the rounded values in f32, and the result is rounded back
through bf16 before it is returned in the caller's dtype.

Compressed gossip
-----------------
`MixingOp(..., comm="int8+ef")` (any `repro_torch.comm` spec) routes the
`*_c` channel methods through the wire policy.  An int8/int4 quantizer
(± error feedback) on an f32 operand without bf16 storage, on the
circulant or padded-gather tier, runs the comm-fused CUDA kernels:
quantize → mix → decode in one pass (`_fused_plan`, `_apply_fused`).
Every other policy and tier — bf16, top-k, rand-k, the dense W, the
star's CSR path, bf16 storage — composes the compressor with the plain
mix (`compressed_payload`, then `_apply`, then the exact self term),
which is `repro`'s own dispatch (`repro.topology.ops
.MixingOp._fused_plan`).  On the halo tier the sparse gather with EF
composes too: its halo kernel has no payload write-back, as in `repro`.

Fault masks
-----------
`MixingOp.masked(mask)` is one round's degraded view (`MaskedMixingOp`,
`repro_torch.faults`): the (n, k_max) mask scales the padded
neighbor-table weights and folds each dropped weight into its row's
self-weight, once per round on the device.  The view is the padded
sparse-gather backend on those per-round tables whatever the base
backend (a mask breaks shift invariance), and gossips through the base
op's own dispatch: on the kernel tier — a `*_pallas` backend, or "auto"
with the switch on (`_kernel_tier`) — `sparse_mix_matvec` on its
column stripe, or `sparse_mix_matvec_halo` with the nominal tables' row
plan where the planner gives a row tile; elsewhere
`sparse_mix_padded_ref`, which `repro` always runs here and which the
kernels equal bit for bit.  A masked view never takes the comm-fused or
the circulant Neumann kernels: compressed gossip composes the
compressor with the masked mix and the effective self-weight.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .._device import resolve_device, strict_f32
from ..kernels.mixing_matvec import (circulant_mix_matvec,
                                     circulant_mix_matvec_halo,
                                     circulant_neumann_step,
                                     circulant_tables, halo_extents,
                                     plan_blocks, plan_row_tile,
                                     sparse_mix_matvec,
                                     sparse_mix_matvec_halo,
                                     sparse_row_plan)
from ..kernels.ops import kernels_enabled
from ..kernels.ref import circulant_mix_ref, sparse_mix_padded_ref
from ..kernels.ref import neumann_update as _neumann_update
from ..kernels.ref import sparse_mix_ref
from .graphs import (circulant_graph, complete_graph, erdos_renyi_graph,
                     is_connected, ring_graph, star_graph)
from .structure import circulant_structure, sparse_structure
from .weights import (check_assumption_a, max_degree_weights,
                      metropolis_weights, mixing_rate, self_weight_bounds,
                      uniform_averaging)


# ---------------------------------------------------------------------------
# Topology bundle
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Network:
    """A validated decentralized network: adjacency + mixing matrix."""
    adj: np.ndarray
    W: np.ndarray
    name: str = "network"

    @property
    def n(self) -> int:
        return self.W.shape[0]

    @property
    def sigma(self) -> float:
        return mixing_rate(self.W)

    @property
    def theta_bounds(self) -> tuple[float, float]:
        return self_weight_bounds(self.W)

    def neighbors(self, i: int) -> np.ndarray:
        return np.nonzero(self.adj[i])[0]

    @property
    def num_edges(self) -> int:
        return int(self.adj.sum()) // 2


def make_network(kind: str, n: int, *, weights: str = "metropolis",
                 r: float = 0.5, offsets: Sequence[int] = (1,),
                 seed: int = 0) -> Network:
    """Factory: kind in {ring, circulant, erdos_renyi, complete, star,
    uniform}; weights in {metropolis, max_degree}."""
    if kind == "ring":
        adj = ring_graph(n)
    elif kind == "circulant":
        adj = circulant_graph(n, offsets)
    elif kind == "erdos_renyi":
        adj = erdos_renyi_graph(n, r, seed)
    elif kind == "complete":
        adj = complete_graph(n)
    elif kind == "star":
        adj = star_graph(n)
    elif kind == "uniform":
        adj = complete_graph(n)
        W = uniform_averaging(n)
        check_assumption_a(W, adj)
        return Network(adj=adj, W=W, name=f"uniform-{n}")
    else:
        raise ValueError(f"unknown graph kind {kind!r}")
    if not is_connected(adj):
        raise ValueError(f"{kind} graph with n={n} is not connected")
    if weights == "metropolis":
        W = metropolis_weights(adj)
    elif weights == "max_degree":
        W = max_degree_weights(adj)
    else:
        raise ValueError(f"unknown weight scheme {weights!r}")
    check_assumption_a(W, adj)
    return Network(adj=adj, W=W, name=f"{kind}-{weights}-{n}")


# ---------------------------------------------------------------------------
# MixingOp
# ---------------------------------------------------------------------------

BACKENDS = ("auto", "dense", "circulant", "circulant_pallas",
            "sparse_gather", "sparse_gather_pallas")

MIXING_DTYPES = ("f32", "bf16")


def resolve_mixing_dtype(name: str):
    """"f32" -> None (full precision), "bf16" -> torch.bfloat16."""
    if name == "f32":
        return None
    if name == "bf16":
        return torch.bfloat16
    raise ValueError(f"unknown mixing dtype {name!r}; "
                     f"expected one of {MIXING_DTYPES}")


class MixingOp:
    """Topology-aware executor for W·Y, (I−W)·Y and the fused DIHGP
    Neumann step on stacked per-agent states (see module docstring).

    The backend is resolved once, at construction; whether a gossip
    takes the kernel tier is read at the call (`_kernel_tier`).  The
    kernels have no backward, so the operator is differentiable on the
    plain tiers only: "dense", an explicit "circulant" or
    "sparse_gather", and "auto" with the kernel switch off.  The
    algorithm never differentiates through a gossip."""

    # a per-round fault view (MaskedMixingOp) clears this: the
    # comm-fused kernels never see a mask
    _fusable_view = True

    def __init__(self, W, *, backend: str = "auto", name: str = "network",
                 dtype: str = "f32", comm: str = "identity", device=None):
        from ..comm import CommLedger, parse_comm_spec
        if backend not in BACKENDS:
            raise ValueError(f"unknown mixing backend {backend!r}; "
                             f"expected one of {BACKENDS}")
        self.device = resolve_device(device)
        self.requested = backend
        W_np = np.asarray(W.detach().cpu() if isinstance(W, torch.Tensor)
                          else W, dtype=np.float64)
        self.W = torch.as_tensor(W_np, dtype=torch.float32,
                                 device=self.device)
        self.name = name
        self.dtype = dtype
        self.storage_dtype = resolve_mixing_dtype(dtype)
        self.comm = parse_comm_spec(comm)
        self.ledger = CommLedger(name)
        # the self-weight term of a gossip, which never crosses the wire
        self._diag = torch.diagonal(self.W)
        self._masked_cache = None
        self.structure = circulant_structure(W_np)
        self.sparse = sparse_structure(W_np)
        base = backend.removesuffix("_pallas")
        if base == "auto":
            s, sp = self.structure, self.sparse
            if s is not None and 2 * (len(s.offsets) + 1) <= s.n:
                self.backend = "circulant"
            elif sp is not None and sp.nnz + sp.n < sp.n * sp.n:
                self.backend = "sparse_gather"
            else:
                self.backend = "dense"
        elif base == "circulant" and self.structure is None:
            raise ValueError(
                f"backend {backend!r} requires a circulant W "
                f"(ring/circulant topology); got a non-shift-invariant "
                f"matrix — use 'sparse_gather', 'dense' or 'auto'")
        elif base == "sparse_gather" and self.sparse is None:
            raise ValueError(
                f"backend {backend!r} requires a square mixing matrix "
                f"with n >= 2")
        else:
            self.backend = base
        if self.backend == "circulant":
            s = self.structure
            self._circ_off, self._circ_w = circulant_tables(
                s.n, s.offsets, s.weights, self.device)
        if self.backend == "sparse_gather":
            sp = self.sparse
            dev = self.device
            self._sp_wself = torch.as_tensor(sp.w_self, device=dev)
            self._sp_idx = torch.as_tensor(sp.neighbors, device=dev)
            self._sp_wts = torch.as_tensor(sp.weights, device=dev)
            # the plain slab gather's walk: rows in degree order, each
            # row's real slots (its padded ones come from registers)
            self._sp_plan = tuple(torch.as_tensor(a, device=dev) for a in
                                  sparse_row_plan(sp.neighbors, sp.weights))
            self._sp_row = torch.as_tensor(sp.row, dtype=torch.int64,
                                           device=dev)
            self._sp_col = torch.as_tensor(sp.col, dtype=torch.int64,
                                           device=dev)
            self._sp_val = torch.as_tensor(sp.val, device=dev)
            # padded row-gather when the degree distribution is
            # near-regular (its n·k_max work within 2× of the CSR nnz —
            # ER graphs), CSR index_add_ when skewed (star)
            self._sp_use_padded = sp.n * sp.k <= 2 * sp.nnz

    @property
    def n(self) -> int:
        return self.W.shape[0]

    def __repr__(self) -> str:
        if self.structure is not None:
            k = len(self.structure.offsets)
        elif self.sparse is not None:
            k = self.sparse.k
        else:
            k = None
        return (f"MixingOp({self.name}, n={self.n}, "
                f"backend={self.backend}, neighbors={k}, "
                f"dtype={self.dtype})")

    def _kernel_tier(self) -> bool:
        """Whether this gossip runs the CUDA kernels (their plain
        versions on a CPU tensor), by `repro`'s `_resolve`: a
        `*_pallas` backend always; "auto" on the circulant or
        padded-gather tier while the kernel switch is on, read now;
        an explicit "circulant" or "sparse_gather", "dense" and the
        skewed graphs' CSR path never."""
        if self.backend not in ("circulant", "sparse_gather"):
            return False
        if self.requested.endswith("_pallas"):
            return True
        if self.requested != "auto":
            return False
        if self.backend == "sparse_gather" and not self._sp_use_padded:
            return False
        return kernels_enabled()

    def _stripe_plan(self, flat: torch.Tensor, *, blocks: int,
                     circulant: bool):
        """("full", None) when the full (n, 128) stripe's `blocks` live
        buffers fit the shared-memory budget, ("halo", bn) for the
        row-tiled kernels, ("xla", None) when no row tile qualifies (the
        full-operand kernels run).  `blocks`: `plan_blocks` of the
        variant (3 plain, 4 fused, 6 fused + EF)."""
        n = flat.shape[0]
        h_lo, h_hi = halo_extents(self.structure.offsets, n) if circulant \
            else (0, 0)
        return plan_row_tile(n, h_lo=h_lo, h_hi=h_hi,
                             itemsize=flat.element_size(), blocks=blocks)

    # -- primitives --------------------------------------------------------

    @strict_f32()
    def mix(self, y: torch.Tensor) -> torch.Tensor:
        """(W ⊗ I) y on stacked y of shape (n, ...)."""
        return self._apply(y, laplacian=False)

    @strict_f32()
    def laplacian(self, y: torch.Tensor) -> torch.Tensor:
        """((I − W) ⊗ I) y."""
        return self._apply(y, laplacian=True)

    def _apply(self, y: torch.Tensor, laplacian: bool) -> torch.Tensor:
        flat = y.reshape(y.shape[0], -1)
        out_dtype = flat.dtype
        if self.storage_dtype is not None \
                and flat.dtype != self.storage_dtype:
            # bf16 storage: round the operand once; every backend then
            # accumulates the rounded values in f32
            flat = flat.to(self.storage_dtype)
        bn = None
        kernel = self._kernel_tier()
        if kernel:
            _, bn = self._stripe_plan(
                flat, blocks=plan_blocks(False),
                circulant=self.backend == "circulant")
        if not kernel:
            acc = flat if self.storage_dtype is None else flat.float()
            if self.backend == "dense":
                out = torch.matmul(self.W.to(acc.dtype), acc)
                if laplacian:
                    out = acc - out
            elif self.backend == "circulant":
                s = self.structure
                out = circulant_mix_ref(acc, s.w_self, s.offsets,
                                        s.weights, laplacian)
            elif self._sp_use_padded:
                out = sparse_mix_padded_ref(acc, self._sp_wself,
                                            self._sp_idx, self._sp_wts,
                                            laplacian)
            else:
                out = sparse_mix_ref(acc, self._sp_wself, self._sp_row,
                                     self._sp_col, self._sp_val,
                                     laplacian=laplacian)
        elif self.backend == "circulant" and bn is not None:
            s = self.structure
            out = circulant_mix_matvec_halo(flat.contiguous(),
                                            w_self=s.w_self,
                                            offsets=s.offsets,
                                            weights=s.weights,
                                            laplacian=laplacian, bn=bn)
        elif self.backend == "circulant":
            s = self.structure
            out = circulant_mix_matvec(flat.contiguous(), w_self=s.w_self,
                                       offsets=s.offsets, weights=s.weights,
                                       laplacian=laplacian)
        elif bn is not None:
            out = sparse_mix_matvec_halo(flat.contiguous(), self._sp_wself,
                                         self._sp_idx, self._sp_wts,
                                         laplacian=laplacian, bn=bn,
                                         row_plan=self._sp_plan)
        else:
            out = sparse_mix_matvec(flat.contiguous(), self._sp_wself,
                                    self._sp_idx, self._sp_wts,
                                    laplacian=laplacian)
        if self.storage_dtype is not None:
            # round the result back through storage precision so every
            # backend returns identically-quantized values
            out = out.to(self.storage_dtype)
        return out.to(out_dtype).reshape(y.shape)

    @strict_f32()
    def neumann_step(self, h: torch.Tensor, hvp_h: torch.Tensor,
                     p: torch.Tensor, d_scalar: torch.Tensor,
                     beta: float) -> torch.Tensor:
        """Fused DIHGP iteration h⁺ = (D̃h − (I−W)h − β·hvp_h − p)/D̃.

        d_scalar: per-agent D̃ diagonal, broadcastable against h as
        (n,) + (1,)*…; beta: a Python number."""
        if self.backend == "circulant" and self.storage_dtype is None \
                and self._kernel_tier():
            flat = h.reshape(h.shape[0], -1).contiguous()
            s = self.structure
            out = circulant_neumann_step(
                flat, hvp_h.reshape(flat.shape).contiguous(),
                p.reshape(flat.shape).contiguous(),
                d_scalar.reshape(h.shape[0], 1).float().contiguous(),
                w_self=s.w_self, offsets=s.offsets, weights=s.weights,
                beta=float(beta))
            return out.reshape(h.shape)
        # the plain, sparse, dense and bf16-storage tiers compose the
        # same algebra from the backend mix (only the W·h term is
        # storage-quantized)
        return _neumann_update(self._apply(h, laplacian=False), h, hvp_h,
                               p, d_scalar, beta)

    # -- gossip channels (repro_torch.comm) --------------------------------

    def comm_channel(self, name: str, x, seed: int = 0):
        """Open a gossip channel for stacked variable template `x`:
        registers the payload shape in the ledger and returns the
        ChannelState (random stream `seed`) to thread through the round
        loop."""
        from ..comm import channel_init
        self.ledger.register(name, x.shape[1:], self.comm)
        return channel_init(self.comm, name, x, seed)

    def _fused_plan(self, flat: torch.Tensor):
        """(backend, bn) when this gossip runs the comm-fused kernels —
        bn None for the full-operand kernel, else the halo kernel's row
        tile — and None when the compressor composes with the plain
        mix, as in `repro`: a policy that is not int8/int4 (± EF), bf16
        storage, a non-f32 operand, a tier without kernels, the
        sparse gather with EF on the halo tier (no payload write-back
        there), or a fault-masked view."""
        if not (self._fusable_view and self.comm.fusable
                and self.storage_dtype is None
                and flat.dtype == torch.float32 and self._kernel_tier()):
            return None
        ef = self.comm.ef
        circulant = self.backend == "circulant"
        tier, bn = self._stripe_plan(flat, blocks=plan_blocks(True, ef),
                                     circulant=circulant)
        if tier == "halo" and ef and not circulant:
            return None
        return self.backend, bn

    def _next_seed(self, st) -> int:
        """The seed of the channel's next send: a host integer from the
        channel's stream (`repro_torch.comm.send_seed`), so no device
        synchronization.  Every stochastic send, fused or composed,
        draws its seed here."""
        from ..comm import send_seed
        return send_seed(st.seed, st.sends)

    def _fused_gossip(self, flat, zp, scale, seed, hat, laplacian: bool,
                      bn: int | None):
        """One comm-fused kernel call on the (n, D) operand: the halo
        kernel with row tile bn, or the full-operand one.  seed: one
        send's, or a bucket's table of per-job seeds (zp, scale (n, B))."""
        comm = f"int{self.comm.compressor.bits}" + \
            ("+ef" if self.comm.ef else "")
        if self.backend == "circulant" and bn is not None:
            s = self.structure
            return circulant_mix_matvec_halo(flat, zp, scale, seed, hat,
                                             w_self=s.w_self,
                                             offsets=s.offsets,
                                             weights=s.weights,
                                             laplacian=laplacian, bn=bn,
                                             comm=comm)
        if self.backend == "circulant":
            return circulant_mix_matvec(flat, zp, scale, seed, hat,
                                        w_self=self.structure.w_self,
                                        offsets=self._circ_off,
                                        weights=self._circ_w,
                                        laplacian=laplacian, comm=comm)
        if bn is not None:
            return sparse_mix_matvec_halo(flat, self._sp_wself,
                                          self._sp_idx, self._sp_wts, zp,
                                          scale, seed, laplacian=laplacian,
                                          bn=bn, comm=comm)
        return sparse_mix_matvec(flat, self._sp_wself, self._sp_idx,
                                 self._sp_wts, zp, scale, seed, hat,
                                 laplacian=laplacian, comm=comm)

    def _apply_fused(self, y: torch.Tensor, flat: torch.Tensor, st,
                     laplacian: bool, bn: int | None = None):
        """One comm-fused gossip: the same `row_quant_params` wire
        metadata and state advance (sends + 1, hat ← payload under EF)
        as `compressed_payload` + `_apply`, in one kernel
        (`_fused_gossip`)."""
        from ..comm import row_quant_params
        ef = self.comm.ef
        seed = self._next_seed(st)
        flat = flat.contiguous()
        hat = st.hat.reshape(flat.shape).contiguous() if ef else None
        zp, scale = row_quant_params(flat - hat if ef else flat,
                                     self.comm.compressor.bits)
        res = self._fused_gossip(flat, zp, scale, seed, hat, laplacian, bn)
        if ef:
            out, pay = res
            st = dataclasses.replace(st, hat=pay.reshape(y.shape),
                                     sends=st.sends + 1)
        else:
            out, st = res, st.bump()
        return out.reshape(y.shape), st

    def _apply_c(self, y: torch.Tensor, st, laplacian: bool):
        """compress → mix → decompress around one gossip of y (n, ...).

        The neighbors mix the decoded payload ŷ; the self-weight term
        w_ii·y_i never crosses the wire, so the backend result W·ŷ is
        corrected by diag(W)·(y − ŷ) before the (I−W) algebra.  A
        fusable policy on a kernel tier runs the whole sequence in the
        comm-fused kernel instead (`_fused_plan`)."""
        from ..comm import compressed_payload
        if self.comm.is_identity:
            return self._apply(y, laplacian), st.bump()
        flat = y.reshape(y.shape[0], -1)
        plan = self._fused_plan(flat)
        if plan is not None:
            return self._apply_fused(y, flat, st, laplacian, plan[1])
        y_hat, st = compressed_payload(self.comm, y, st,
                                       self._next_seed(st))
        mixed = self._apply(y_hat, laplacian=False)
        expand = (slice(None),) + (None,) * (y.dim() - 1)
        diag = self._diag[expand].to(y.dtype)
        if mixed.requires_grad or y.requires_grad:
            mixed = mixed + diag * (y - y_hat)
        else:
            # the same products and sum, in place: a model-sized leaf
            # then holds one temporary fewer
            mixed.add_((y - y_hat).mul_(diag))
        return (y - mixed) if laplacian else mixed, st

    @strict_f32()
    def mix_c(self, y: torch.Tensor, st):
        """(W ⊗ I) y through the gossip channel -> (out, state)."""
        return self._apply_c(y, st, laplacian=False)

    @strict_f32()
    def laplacian_c(self, y: torch.Tensor, st):
        """((I − W) ⊗ I) y through the gossip channel."""
        return self._apply_c(y, st, laplacian=True)

    @strict_f32()
    def neumann_step_c(self, h, hvp_h, p, d_scalar, beta: float, st):
        """Fused DIHGP step with the W·h gossip on the channel.  The
        identity wire keeps the plain fused step; a fusable quantizer
        without EF on the circulant tier's full operand runs the
        comm-fused Neumann kernel (quantize + mix + the Eq. 14 update in
        one pass); EF, the halo tier and the other tiers compose `mix_c`
        (itself fused where possible) with the update."""
        if self.comm.is_identity:
            return self.neumann_step(h, hvp_h, p, d_scalar, beta), \
                st.bump()
        flat = h.reshape(h.shape[0], -1)
        if not self.comm.ef \
                and self._fused_plan(flat) == ("circulant", None):
            from ..comm import row_quant_params
            bits = self.comm.compressor.bits
            seed = self._next_seed(st)
            flat = flat.contiguous()
            zp, scale = row_quant_params(flat, bits)
            out = circulant_neumann_step(
                flat, hvp_h.reshape(flat.shape).contiguous(),
                p.reshape(flat.shape).contiguous(),
                d_scalar.reshape(h.shape[0], 1).float().contiguous(),
                zp, scale, seed, w_self=self.structure.w_self,
                offsets=self._circ_off, weights=self._circ_w,
                beta=float(beta), comm=f"int{bits}")
            return out.reshape(h.shape), st.bump()
        mix, st = self.mix_c(h, st)
        return _neumann_update(mix, h, hvp_h, p, d_scalar, beta), st

    # -- a serve bucket's job axis (repro_torch.serve) ----------------------
    #
    # A bucket of B jobs holds each gossiped state as (n, B, d), so that
    # its (n, B·d) view is one operand: every gossip of the bucket is one
    # launch for all of its jobs.  The plain gossips compute each column
    # alone and need nothing more; the Neumann step takes β as a (B,)
    # device table and D̃ as (n, B), the comm-fused gossips each job's
    # zp/scale ((n, B), from its own d columns) and seed (the slot's
    # `send_seed`), so each job's result is bitwise its solo gossip's.
    # Channel states are `repro_torch.comm.JobChannelState`s.

    @strict_f32()
    def mix_jobs_c(self, y: torch.Tensor, st, laplacian: bool = False):
        """(W ⊗ I) y (or (I − W)) of every job of y (n, B, d) through the
        bucket's channel `st` (a `JobChannelState`) -> (out, state)."""
        if self.comm.is_identity:
            return self._apply(y, laplacian), st.bump()
        n, B = y.shape[:2]
        flat = y.reshape(n, -1)
        plan = self._fused_plan(flat)
        if plan is not None:
            return self._apply_fused_jobs(y, flat, st, laplacian, plan[1])
        # the composed wire, one job at a time (as its solo send), then
        # one mix of the bucket's decoded payload
        from ..comm import compressed_payload
        seeds = st.send_seeds()
        y_hat = torch.empty_like(y)
        for j in range(B):
            y_hat[:, j], _ = compressed_payload(self.comm, y[:, j],
                                                st.slot(j), seeds[j])
        mixed = self._apply(y_hat, laplacian=False)
        expand = (slice(None),) + (None,) * (y.dim() - 1)
        mixed = mixed + self._diag[expand].to(y.dtype) * (y - y_hat)
        st = dataclasses.replace(st, hat=y_hat if self.comm.ef else st.hat,
                                 sends=st.sends + 1)
        return (y - mixed) if laplacian else mixed, st

    def _jobs_wire(self, flat: torch.Tensor, B: int, hat=None):
        """Each job's (zp, scale) of a bucket's (n, B·d) send, (n, B)
        each: `row_quant_params` over each job's own d columns."""
        from ..comm import row_quant_params
        n = flat.shape[0]
        q = flat if hat is None else flat - hat
        zp, scale = row_quant_params(q.reshape(n * B, -1),
                                     self.comm.compressor.bits)
        return zp.reshape(n, B), scale.reshape(n, B)

    def _apply_fused_jobs(self, y, flat, st, laplacian: bool,
                          bn: int | None):
        """One comm-fused gossip of every job of the bucket: one launch
        on the job axis of the full-operand or the halo kernels
        (`_apply_fused`'s state advance, per slot)."""
        B = y.shape[1]
        ef = self.comm.ef
        flat = flat.contiguous()
        hat = st.hat.reshape(flat.shape).contiguous() if ef else None
        zp, scale = self._jobs_wire(flat, B, hat)
        res = self._fused_gossip(flat, zp, scale, st.send_seeds(), hat,
                                 laplacian, bn)
        if ef:
            out, pay = res
            st = dataclasses.replace(st, hat=pay.reshape(y.shape),
                                     sends=st.sends + 1)
        else:
            out, st = res, st.bump()
        return out.reshape(y.shape), st

    @strict_f32()
    def neumann_step_jobs(self, h, hvp_h, p, d_scalar, beta):
        """The fused DIHGP step of every job of h (n, B, d): d_scalar
        (n, B) per-agent, per-job D̃; beta a (B,) f32 device table."""
        n, B = h.shape[:2]
        flat = h.reshape(n, -1)
        if self.backend == "circulant" and self.storage_dtype is None \
                and self._kernel_tier():
            s = self.structure
            out = circulant_neumann_step(
                flat.contiguous(), hvp_h.reshape(flat.shape).contiguous(),
                p.reshape(flat.shape).contiguous(),
                d_scalar.float().contiguous(), w_self=s.w_self,
                offsets=s.offsets, weights=s.weights, beta=beta)
            return out.reshape(h.shape)
        mix = self._apply(h, laplacian=False).reshape(flat.shape)
        return _neumann_update(mix, flat, hvp_h.reshape(flat.shape),
                               p.reshape(flat.shape), d_scalar,
                               beta).reshape(h.shape)

    @strict_f32()
    def neumann_step_jobs_c(self, h, hvp_h, p, d_scalar, beta, st):
        """`neumann_step_jobs` with the W·h gossip on the bucket's
        channel: the comm-fused Neumann kernel on the job axis where the
        solo step runs it, else `mix_jobs_c` and the update."""
        if self.comm.is_identity:
            return self.neumann_step_jobs(h, hvp_h, p, d_scalar, beta), \
                st.bump()
        n, B = h.shape[:2]
        flat = h.reshape(n, -1)
        if not self.comm.ef \
                and self._fused_plan(flat) == ("circulant", None):
            bits = self.comm.compressor.bits
            seeds = st.send_seeds()
            flat = flat.contiguous()
            zp, scale = self._jobs_wire(flat, B)
            out = circulant_neumann_step(
                flat, hvp_h.reshape(flat.shape).contiguous(),
                p.reshape(flat.shape).contiguous(),
                d_scalar.float().contiguous(), zp, scale, seeds,
                w_self=self.structure.w_self, offsets=self._circ_off,
                weights=self._circ_w, beta=beta, comm=f"int{bits}")
            return out.reshape(h.shape), st.bump()
        mix, st = self.mix_jobs_c(h, st)
        return _neumann_update(mix.reshape(flat.shape), flat,
                               hvp_h.reshape(flat.shape),
                               p.reshape(flat.shape), d_scalar,
                               beta).reshape(h.shape), st

    # -- fault-masked mixing (repro_torch.faults) --------------------------

    def _masked_tables(self):
        """Device tables (w_self, neighbors, weights, row plan) of the
        padded sparse structure: the operand space per-round fault masks
        degrade (built on first use, then kept).  `self.sparse` exists
        for any backend with n >= 2, a ring's circulant op too, so these
        do not rely on the `_sp_*` tensors of the sparse_gather backend.

        The row plan is the nominal tables' and serves every round:
        `sparse_row_plan` counts a slot as padded only where it holds
        the row's own index with weight +0.0, and a dropped link keeps
        its neighbor's index (its weight w·0 = +0.0 is gathered), while
        a padded slot's mask is 1."""
        if self._masked_cache is None:
            sp = self.sparse
            if sp is None:
                raise ValueError(
                    f"fault masks need the padded sparse tables, which "
                    f"require a square mixing matrix with n >= 2 (got "
                    f"n={self.n})")
            dev = self.device
            plan = tuple(torch.as_tensor(a, device=dev) for a in
                         sparse_row_plan(sp.neighbors, sp.weights))
            self._masked_cache = (torch.as_tensor(sp.w_self, device=dev),
                                  torch.as_tensor(sp.neighbors, device=dev),
                                  torch.as_tensor(sp.weights, device=dev),
                                  plan)
        return self._masked_cache

    def masked(self, mask) -> "MaskedMixingOp":
        """This round's degraded view of the op: mask is (n, k_max) in
        the padded `sparse_structure` table layout (1 = link alive, 0 =
        dropped; symmetric in edge space — see repro_torch.faults).
        Build one per round; it shares this op's ledger and comm
        policy."""
        return MaskedMixingOp(self, mask)


class MaskedMixingOp(MixingOp):
    """A per-round degraded view of a base MixingOp (see `MixingOp
    .masked`): applies W_k = W ⊙ M with the dropped weight folded into
    the self-weight, in the padded neighbor-table space.

    Shares the base op's comm policy, ledger and requested backend by
    reference, and is the padded sparse-gather backend on this round's
    tables: `_apply` and `neumann_step` are the base op's, so a masked
    gossip takes the kernel tier exactly when an unmasked padded gather
    would (a `*_pallas` backend, or "auto" with the switch on; module
    docstring, "Fault masks").  The effective self-weight stands in for
    diag(W) in the compressed gossip's exact self term (`_diag`); the
    DIHGP preconditioner keeps the nominal diagonal (`as_matrix` reads
    the base W), as in `repro`."""

    _fusable_view = False     # comm-fused kernels never see a mask

    def __init__(self, base: MixingOp, mask):
        self.__dict__.update(base.__dict__)  # view: share, don't rebuild
        w_self, idx, wts, plan = base._masked_tables()
        mask = torch.as_tensor(mask, dtype=wts.dtype, device=wts.device)
        if tuple(mask.shape) != tuple(idx.shape):
            raise ValueError(
                f"fault mask shape {tuple(mask.shape)} does not match the "
                f"padded neighbor table {tuple(idx.shape)} of "
                f"{base.name}; lower it with FaultTrace.table_masks")
        # not circulant, so no circulant Neumann kernel under a mask
        self.backend, self._sp_use_padded = "sparse_gather", True
        self._sp_idx, self._sp_plan = idx, plan
        # once per round for all of its gossips; an all-ones mask gives
        # wts·1 and w_self + 0, the nominal tables bit for bit
        self._sp_wts = wts * mask
        self._sp_wself = w_self + torch.sum(wts * (1.0 - mask), dim=1)
        self._diag = self._sp_wself

    def __repr__(self) -> str:
        return (f"MaskedMixingOp({self.name}, n={self.n}, "
                f"backend=sparse_gather[masked], dtype={self.dtype})")


def make_mixing_op(net: Network, backend: str = "auto", dtype: str = "f32",
                   comm: str = "identity", device=None) -> MixingOp:
    """Build the gossip executor for a validated Network on `device`
    (CUDA unless the caller names another)."""
    return MixingOp(net.W, backend=backend, name=net.name, dtype=dtype,
                    comm=comm, device=device)


def as_matrix(W) -> torch.Tensor:
    """Raw (n, n) mixing matrix from either a MixingOp or a tensor."""
    return W.W if isinstance(W, MixingOp) else W


# ---------------------------------------------------------------------------
# Applying W to stacked per-agent states (free-function façade)
# ---------------------------------------------------------------------------

def mix_apply(W, y: torch.Tensor) -> torch.Tensor:
    """(W ⊗ I_d) y for stacked y of shape (n, d) [or (n, ...)]; W a raw
    (n, n) tensor (dense matmul) or a MixingOp (backend dispatch)."""
    if isinstance(W, MixingOp):
        return W.mix(y)
    flat = y.reshape(y.shape[0], -1)
    return torch.matmul(W.to(flat.dtype), flat).reshape(y.shape)


def laplacian_apply(W, y: torch.Tensor) -> torch.Tensor:
    """((I - W) ⊗ I_d) y — the penalty-gradient mixing term."""
    if isinstance(W, MixingOp):
        return W.laplacian(y)
    return y - mix_apply(W, y)


def fused_neumann_step(W, h, hvp_h, p, d_scalar, beta: float):
    """One DIHGP Neumann iteration (Eq. 14),
    h⁺ = (D̃h − (I−W)h − β·hvp_h − p) / D̃: the fused kernel on the
    circulant tier, the composed algebra elsewhere."""
    if isinstance(W, MixingOp):
        return W.neumann_step(h, hvp_h, p, d_scalar, beta)
    return _neumann_update(mix_apply(W, h), h, hvp_h, p, d_scalar, beta)


# Channel façade: every caller threads a ChannelState and gets (result,
# state) back.  Raw W tensors carry no comm policy and gossip on the
# identity wire.

def mix_apply_c(W, y: torch.Tensor, st):
    """(W ⊗ I) y through the gossip channel -> (mixed, state)."""
    if isinstance(W, MixingOp):
        return W.mix_c(y, st)
    return mix_apply(W, y), st.bump()


def laplacian_apply_c(W, y: torch.Tensor, st):
    """((I − W) ⊗ I) y through the gossip channel -> (out, state)."""
    if isinstance(W, MixingOp):
        return W.laplacian_c(y, st)
    return laplacian_apply(W, y), st.bump()


def fused_neumann_step_c(W, h, hvp_h, p, d_scalar, beta: float, st):
    """Channel twin of `fused_neumann_step`."""
    if isinstance(W, MixingOp):
        return W.neumann_step_c(h, hvp_h, p, d_scalar, beta, st)
    return _neumann_update(mix_apply(W, h), h, hvp_h, p, d_scalar,
                           beta), st.bump()
