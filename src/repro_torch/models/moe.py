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

from ..distributed.sharding import shard
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
    T, D = xt.shape
    E, k = cfg.num_experts, cfg.top_k
    C = expert_capacity(T, E, k, cfg.capacity_factor)

    logits = (xt @ p["router"]).float()                        # (T, E)
    probs, gate, eidx = _route(logits, k)                      # (T, k)

    # ---- load-balance auxiliary loss (Switch-style) ----
    me = torch.mean(probs, dim=0)                              # (E,)
    ce = torch.mean(F.one_hot(eidx[:, 0], E).float(), dim=0)
    aux = E * torch.sum(me * ce)

    # ---- sort/gather dispatch ----
    flat_e = eidx.reshape(-1)                                  # (T*k,)
    flat_t = torch.arange(T, device=xt.device).repeat_interleave(k)
    flat_g = gate.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st, sg = flat_e[order], flat_t[order], flat_g[order]
    # rank within expert group = position - group start
    # (an index_add_ of ones rather than bincount, which the meta device
    # of the dry run cannot trace; the counts are exact integers either way)
    counts = torch.zeros(E, dtype=se.dtype, device=se.device).index_add_(
        0, se, torch.ones_like(se))
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(T * k, device=xt.device) - starts[se]
    keep = slot < C                                            # drop overflow
    dest = torch.where(keep, se * C + slot, E * C)             # E*C: dropped

    buf = torch.zeros((E * C + 1, D), dtype=xt.dtype, device=xt.device)
    buf[dest] = xt[st]
    buf = shard(buf[:E * C].reshape(E, C, D), "experts", None, None)
    out_flat = _expert_ffn(p, buf).reshape(E * C, D)
    contrib = torch.where(
        keep[:, None],
        out_flat[torch.clamp(dest, max=E * C - 1)] * sg[:, None].to(xt.dtype),
        torch.zeros((), dtype=xt.dtype, device=xt.device))
    out = torch.zeros((T, D), dtype=xt.dtype,
                      device=xt.device).index_add_(0, st, contrib)
    return out, aux
