"""Generic decoder-only LM stack covering dense / GQA / MoE / RWKV6 /
Mamba2 / Zamba2-hybrid families (whisper's enc-dec lives in whisper.py).

Counterpart of `repro.models.transformer`.  `repro` stacks its layers on
a leading axis and scans over them; here the layers are an
`nn.ModuleList` walked by a Python loop, and a cache is a list of
per-layer dicts.  Zamba2's shared attention block (one weight set invoked
every k layers with per-invocation input projectors) is applied in the
same loop.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from .layers import (Maker, ParamTree, Params, attention, embed,
                     init_attention, init_embedding, init_mlp,
                     init_rmsnorm, logits_out, mlp, rmsnorm)
from .moe import init_moe, moe
from .ssm import (init_mamba2, init_rwkv_channel_mix, init_rwkv_time_mix,
                  mamba2, mamba_dims, rwkv_channel_mix, rwkv_time_mix)

AUX_LOSS_WEIGHT = 0.01


# ---------------------------------------------------------------------------
# Per-layer block init / apply
# ---------------------------------------------------------------------------

def block_kind(cfg: ArchConfig) -> str:
    if cfg.attn_free:
        return "rwkv6"
    if cfg.shared_attn_every:
        return "mamba2"
    return "attn"


def init_block(mk: Maker, cfg: ArchConfig) -> dict:
    kind = block_kind(cfg)
    if kind == "attn":
        ffn = init_moe(mk, cfg) if cfg.num_experts else \
            init_mlp(mk, cfg.d_model, cfg.d_ff)
        return {"ln1": init_rmsnorm(mk, cfg.d_model),
                "attn": init_attention(mk, cfg),
                "ln2": init_rmsnorm(mk, cfg.d_model),
                "ffn": ffn}
    if kind == "rwkv6":
        return {"ln1": init_rmsnorm(mk, cfg.d_model),
                "tm": init_rwkv_time_mix(mk, cfg),
                "ln2": init_rmsnorm(mk, cfg.d_model),
                "cm": init_rwkv_channel_mix(mk, cfg)}
    if kind == "mamba2":
        return {"ln": init_rmsnorm(mk, cfg.d_model),
                "mamba": init_mamba2(mk, cfg)}
    raise ValueError(kind)


def empty_block_cache(cfg: ArchConfig, batch: int, cache_len: int, dtype,
                      device):
    """One layer's cache."""
    kind = block_kind(cfg)
    z = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt, device=device)
    if kind == "attn":
        C = min(cache_len, cfg.sliding_window) if cfg.sliding_window \
            else cache_len
        hd = cfg.resolved_head_dim
        return {"k": z(batch, C, cfg.num_kv_heads, hd),
                "v": z(batch, C, cfg.num_kv_heads, hd)}
    if kind == "rwkv6":
        hd = cfg.rwkv_head_size
        H = cfg.d_model // hd
        return {"tm_x": z(batch, cfg.d_model),
                "S": z(batch, H, hd, hd, dt=torch.float32),
                "cm_x": z(batch, cfg.d_model)}
    if kind == "mamba2":
        d_inner, H, N = mamba_dims(cfg)
        return {"conv": z(batch, cfg.conv_kernel - 1, d_inner),
                "S": z(batch, H, cfg.mamba_head_dim, N, dt=torch.float32)}
    raise ValueError(kind)


def block_apply(p: Params, h, cfg: ArchConfig, *, positions,
                cache=None, pos=None, prefill=False):
    """Apply one block.  Returns (h, new_cache, aux_loss)."""
    kind = block_kind(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if kind == "attn":
        att_cache = None if cache is None else \
            {"k": cache["k"], "v": cache["v"], "pos": pos}
        a, new_kv = attention(p["attn"], rmsnorm(p["ln1"], h), cfg,
                              positions=positions, cache=att_cache,
                              prefill=prefill)
        h = h + a
        hn = rmsnorm(p["ln2"], h)
        if cfg.num_experts:
            f, aux = moe(p["ffn"], hn, cfg)
        else:
            f = mlp(p["ffn"], hn)
        h = h + f
        new_cache = None if cache is None else \
            {"k": new_kv["k"], "v": new_kv["v"]}
        return h, new_cache, aux
    if kind == "rwkv6":
        tm_state = None if cache is None else \
            {"x": cache["tm_x"], "S": cache["S"]}
        a, tm_new = rwkv_time_mix(p["tm"], rmsnorm(p["ln1"], h), cfg,
                                  tm_state, fresh=prefill)
        h = h + a
        cm_state = None if cache is None else {"x": cache["cm_x"]}
        f, cm_new = rwkv_channel_mix(p["cm"], rmsnorm(p["ln2"], h),
                                     cm_state)
        h = h + f
        new_cache = None if cache is None else \
            {"tm_x": tm_new["x"], "S": tm_new["S"], "cm_x": cm_new["x"]}
        return h, new_cache, aux
    if kind == "mamba2":
        m, new_st = mamba2(p["mamba"], rmsnorm(p["ln"], h), cfg, cache)
        return h + m, (None if cache is None else new_st), aux
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Model init
# ---------------------------------------------------------------------------

def init_lm(cfg: ArchConfig, mk: Maker) -> ParamTree:
    """The LM's parameters, drawn by `mk` (shapes and axes only on the
    meta device)."""
    p = {
        "embed": init_embedding(mk, cfg.padded_vocab, cfg.d_model),
        "blocks": [init_block(mk, cfg) for _ in range(cfg.num_layers)],
        "final_norm": init_rmsnorm(mk, cfg.d_model),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = init_embedding(mk, cfg.padded_vocab, cfg.d_model)
    if cfg.shared_attn_every:            # zamba2 shared attention block
        n_inv = len(cfg.shared_attn_positions())
        p["shared"] = {"ln": init_rmsnorm(mk, cfg.d_model),
                       "attn": init_attention(mk, cfg),
                       "ln2": init_rmsnorm(mk, cfg.d_model),
                       "mlp": init_mlp(mk, cfg.d_model, cfg.d_ff)}
        p["shared_proj"] = mk((n_inv, cfg.d_model, cfg.d_model),
                              (None, "fsdp", None))
    return ParamTree(p)


def param_axes(cfg: ArchConfig) -> dict[str, tuple]:
    """{state-dict name: logical axes} of every parameter."""
    return {name: t.logical_axes
            for name, t in init_lm(cfg, Maker(None)).named_parameters()}


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _shared_attn_apply(p, h, cfg, inv_idx, *, positions, cache=None,
                       pos=None, prefill=False):
    """Zamba2 shared block: per-invocation projector + shared attn+mlp."""
    sp = p["shared"]
    proj = p["shared_proj"][inv_idx]
    hin = rmsnorm(sp["ln"], h @ proj)
    att_cache = None if cache is None else \
        {"k": cache["k"][inv_idx], "v": cache["v"][inv_idx], "pos": pos}
    a, new_kv = attention(sp["attn"], hin, cfg, positions=positions,
                          cache=att_cache, prefill=prefill)
    hin = hin + a
    hin = hin + mlp(sp["mlp"], rmsnorm(sp["ln2"], hin))
    if cache is not None:
        cache["k"][inv_idx] = new_kv["k"]
        cache["v"][inv_idx] = new_kv["v"]
    return h + hin, cache


def forward(params: Params, cfg: ArchConfig, tokens, *, cache=None,
            pos=None, prefill: bool = False):
    """Shared forward.  tokens (B, S) integer.

    * cache=None: full-sequence forward → (logits (B,S,V), aux_loss).
    * cache given ({"blocks": [per-layer dicts], ...}): stateful step
      (decode S=1, or prefill from pos 0) → (logits, new_cache, aux).
    """
    B, S = tokens.shape
    h = embed(params["embed"], tokens) * (cfg.d_model ** 0.5)
    h = h.to(params["final_norm"]["scale"].dtype)
    start = 0 if cache is None else int(pos)
    positions = (start + torch.arange(S, device=tokens.device)
                 )[None, :].repeat(B, 1)
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    shared_cache = None if cache is None else cache.get("shared")
    shared_pos = cfg.shared_attn_positions()
    new_blocks = []
    for i, lp in enumerate(params["blocks"]):
        lcache = None if cache is None else cache["blocks"][i]
        h, nc, aux = block_apply(lp, h, cfg, positions=positions,
                                 cache=lcache, pos=pos, prefill=prefill)
        aux_total = aux_total + aux
        new_blocks.append(nc)
        if i in shared_pos:
            h, shared_cache = _shared_attn_apply(
                params, h, cfg, shared_pos.index(i), positions=positions,
                cache=shared_cache, pos=pos, prefill=prefill)

    new_cache = None
    if cache is not None:
        new_cache = {"blocks": new_blocks, "pos": start + S}
        if shared_cache is not None:
            new_cache["shared"] = shared_cache
    if prefill:
        h = h[:, -1:]          # serving prefill only needs the last token
    h = rmsnorm(params["final_norm"], h)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    logits = logits_out(table, h)
    if cache is None:
        return logits, aux_total
    return logits, new_cache, aux_total


def init_cache(cfg: ArchConfig, batch: int, cache_len: int,
               dtype=torch.float32, device=None):
    """Decode cache: per-layer dicts + int pos (+ zamba2's shared KV)."""
    blocks = [empty_block_cache(cfg, batch, cache_len, dtype, device)
              for _ in range(cfg.num_layers)]
    cache = {"blocks": blocks, "pos": 0}
    if cfg.shared_attn_every:
        n_inv = len(cfg.shared_attn_positions())
        shape = (n_inv, batch, cache_len, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        cache["shared"] = {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
    return cache
