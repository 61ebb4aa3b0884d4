"""Mixture-of-Experts layer: top-k token-choice routing, capacity-bounded
sort/gather dispatch, SwiGLU experts, load-balance auxiliary loss.

Counterpart of `repro.models.moe`.  With `moe_route_groups` G > 1 the
tokens route in G independent groups (`_moe_grouped`); on one device
`repro`'s "shard_map" implementation takes that same batched route (it
does so whenever no mesh rules are installed), so both settings run
`_moe_grouped` here.  No shipped configuration sets `moe_route_groups`,
so mixtral and granite-moe take `_moe_dispatch`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.sharding import is_sharded, shard
from .layers import Maker, Params


def init_moe(mk: Maker, cfg) -> dict:
    d, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": mk((d, E), (None, "experts"), scale=0.02),
        "wg": mk((E, d, Fd), ("experts", "fsdp", "ffn")),
        "wu": mk((E, d, Fd), ("experts", "fsdp", "ffn")),
        "wd": mk((E, Fd, d), ("experts", "ffn", "fsdp")),
    }


def expert_capacity(T: int, E: int, k: int, factor: float) -> int:
    c = int(T * k * factor / E) + 1
    return max(4, -(-c // 4) * 4)          # round up to a multiple of 4


def moe(p: Params, x, cfg):
    """Returns (out, aux_loss).  x: (B, S, D)."""
    B, S, D = x.shape
    if max(cfg.moe_route_groups, 1) > 1:
        out, aux = _moe_grouped(p, x, cfg)
        if out is not None:
            return out, aux
    out, aux = _moe_dispatch(p, x.reshape(B * S, D), cfg)
    return out.reshape(B, S, D), aux


def _route(logits, k: int):
    """Softmax router probabilities, the top-k gates renormalised, and the
    experts (descending probability, ties to the lower index)."""
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = torch.topk(probs, k, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, eidx


def _expert_ffn(p, buf):
    """SwiGLU of every expert on its (E, C, D) slice of the buffer."""
    a = F.silu(torch.einsum("ecd,edf->ecf", buf, p["wg"])) \
        * torch.einsum("ecd,edf->ecf", buf, p["wu"])
    a = shard(a, "experts", None, "ffn")
    return torch.einsum("ecf,efd->ecd", a, p["wd"])


def _moe_grouped(p: Params, x, cfg):
    """Group-local dispatch: G independent routing domains of the batch's
    B / G rows each, capacity enforced per group; (None, None) where G
    does not divide B (the caller then routes globally)."""
    B, S, D = x.shape
    G = cfg.moe_route_groups
    if B % G:
        return None, None
    E, k = cfg.num_experts, cfg.top_k
    xg = shard(x.reshape(G, (B // G) * S, D), "batch", None, None)
    outs, auxes = [], []
    for g in range(G):
        o, a = _moe_dispatch(p, xg[g], cfg)
        outs.append(o)
        auxes.append(a)
    return torch.stack(outs).reshape(B, S, D), torch.stack(auxes).mean()


def _moe_dispatch(p: Params, xt, cfg):
    """Single routing domain: xt (T, D) -> (out (T, D), aux scalar)."""
    if is_sharded(xt):
        return _moe_dispatch_sharded(p, xt, cfg)
    T, D = xt.shape
    E = cfg.num_experts
    logits = (xt @ p["router"]).float()                        # (T, E)
    aux, st, sg, keep, dest, C = _route_plan(logits, cfg)
    buf = torch.zeros((E * C + 1, D), dtype=xt.dtype, device=xt.device)
    buf[dest] = xt[st]
    buf = shard(buf[:E * C].reshape(E, C, D), "experts", None, None)
    out_flat = _expert_ffn(p, buf).reshape(E * C, D)
    return _combine(out_flat, st, sg, keep, dest, T), aux


def _route_plan(logits, cfg):
    """The router's plan for (T, E) logits: (aux, and of the T·k choices
    sorted by expert: token st, gate sg, kept under capacity C, buffer
    slot dest (E·C where dropped), C)."""
    T, E = logits.shape
    k = cfg.top_k
    C = expert_capacity(T, E, k, cfg.capacity_factor)
    probs, gate, eidx = _route(logits, k)                      # (T, k)

    # ---- load-balance auxiliary loss (Switch-style) ----
    me = torch.mean(probs, dim=0)                              # (E,)
    ce = torch.mean(F.one_hot(eidx[:, 0], E).float(), dim=0)
    aux = E * torch.sum(me * ce)

    # ---- sort/gather dispatch ----
    flat_e = eidx.reshape(-1)                                  # (T*k,)
    flat_t = torch.arange(T, device=logits.device).repeat_interleave(k)
    flat_g = gate.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st, sg = flat_e[order], flat_t[order], flat_g[order]
    # rank within expert group = position - group start
    # (an index_add_ of ones rather than bincount, which the meta device
    # of the dry run cannot trace; the counts are exact integers either way)
    counts = torch.zeros(E, dtype=se.dtype, device=se.device).index_add_(
        0, se, torch.ones_like(se))
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(T * k, device=logits.device) - starts[se]
    keep = slot < C                                            # drop overflow
    dest = torch.where(keep, se * C + slot, E * C)             # E*C: dropped
    return aux, st, sg, keep, dest, C


def _combine(out_flat, st, sg, keep, dest, T: int):
    """Each token's gate-weighted sum of its kept experts' outputs."""
    EC, D = out_flat.shape
    dtype, device = out_flat.dtype, out_flat.device
    contrib = torch.where(
        keep[:, None],
        out_flat[torch.clamp(dest, max=EC - 1)] * sg[:, None].to(dtype),
        torch.zeros((), dtype=dtype, device=device))
    return torch.zeros((T, D), dtype=dtype, device=device).index_add_(
        0, st, contrib)


def _moe_dispatch_sharded(p: Params, xt, cfg):
    """`_moe_dispatch` on a `DTensor` xt: routing is over all T tokens, as
    in one process, so every rank routes every token (xt and the router's
    logits gathered whole) and fills the capacity buffer from its own
    copy; the experts run on the buffer as DTensor ops (their FFN sharded
    on "ffn"), and each rank combines the gathered outputs.  out keeps
    xt's layout; aux is replicated."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = xt.device_mesh
    whole = (Replicate(),) * mesh.ndim
    xw = xt.redistribute(mesh, whole)
    logits = (xw @ p["router"]).float().redistribute(mesh, whole).to_local()
    x_local = xw.to_local()
    T, D = x_local.shape
    E = cfg.num_experts
    aux, st, sg, keep, dest, C = _route_plan(logits, cfg)
    buf = torch.zeros((E * C + 1, D), dtype=x_local.dtype,
                      device=x_local.device)
    buf[dest] = x_local[st]
    buf = DTensor.from_local(buf[:E * C].reshape(E, C, D), mesh, whole,
                             run_check=False)
    buf = shard(buf, "experts", None, None)
    out_flat = _expert_ffn(p, buf).redistribute(mesh, whole).to_local()
    out = _combine(out_flat.reshape(E * C, D), st, sg, keep, dest, T)
    out = DTensor.from_local(out, mesh, whole, run_check=False)
    return out.redistribute(mesh, xt.placements), \
        DTensor.from_local(aux, mesh, whole, run_check=False)
