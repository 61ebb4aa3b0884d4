"""Transformer building blocks: parameter trees as `nn.Module`s, layers as
plain functions over them.

Counterpart of `repro.models.layers`.  Parameters live in `ParamTree`s,
`nn.Module`s whose entries are read as `p["wq"]`, the same spelling as
`repro`'s nested dicts, so each function here reads as its counterpart
and a state-dict key (`blocks.0.attn.wq`) is `repro`'s pytree path with
the stacked layer axis unstacked (`repro_torch.interop.load_lm_params`).
`Maker` draws them from a seeded `torch.Generator` with `repro`'s init
rules and scales, and tags each with its logical sharding axes.

Conventions:
  x:        (B, S, D) activations
  q:        (B, S, H, hd);  k/v: (B, S, Hkv, hd)
  KV cache: {"k": (B, C, Hkv, hd), "v": ..., "pos": int} with C = cache len

Self-attention whose query and key lengths match goes to
`repro_torch.kernels.ops.attention` (the flash-attention kernel) where
the kernel switch is on, S % 128 == 0 and hd ≤ 256: the forward with no
cache and the prefill.  Grouped kv heads are expanded to the query heads
for it (query head h reads kv head h // group, as `_sdpa`'s grouping).
Other shapes, decode over the rolling cache and cross-attention take the
plain `_sdpa` route, as in `repro`.
"""
from __future__ import annotations

import math
from typing import Any

import torch
from torch import nn

from ..distributed.sharding import shard
from ..kernels import ops as kops
from ..kernels.flash_attention import MAX_HEAD_DIM

Params = Any


class ParamTree(nn.Module):
    """A tree of parameters: dict entries become parameters, sub-trees or
    (for lists) `nn.ModuleList`s; `p[name]` reads an entry."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, ParamTree(value))
            elif isinstance(value, list):
                self.add_module(name, nn.ModuleList(map(ParamTree, value)))
            else:
                self.register_parameter(name, value)

    def __getitem__(self, name: str):
        return getattr(self, name)


def param_tree(module: nn.Module):
    """A `ParamTree`'s parameters as a plain tree — dicts, lists (for a
    `ModuleList`) and detached tensors sharing the parameters' storage —
    which every model function takes in the module's place, and which
    `repro_torch.optim` and `torch.func` map over (the trainer's and the
    decentralized LM round's parameter trees)."""
    if isinstance(module, nn.ModuleList):
        return [param_tree(m) for m in module]
    tree = {name: p.detach()
            for name, p in module.named_parameters(recurse=False)}
    tree.update((name, param_tree(m)) for name, m in module.named_children())
    return tree


class Maker:
    """Parameter factory: each call draws one parameter from the seeded
    generator (normal × scale, default 1/√fan_in with fan_in = shape[0];
    or zeros, ones) in f32 and casts it to `dtype`, as `repro.models
    .layers.Maker`.  On the meta device it allocates nothing (shapes and
    axes only).  Each parameter carries its logical axes as
    `logical_axes`."""

    def __init__(self, generator: torch.Generator | None, dtype=torch.float32,
                 device=None):
        self.generator = generator
        self.dtype = dtype
        self.device = torch.device("meta" if device is None else device)

    def __call__(self, shape, axes, *, scale=None, init="normal"
                 ) -> nn.Parameter:
        assert len(shape) == len(axes), (shape, axes)
        shape = tuple(int(s) for s in shape)
        if self.device.type == "meta":
            t = torch.empty(shape, dtype=self.dtype, device="meta")
        elif init == "zeros":
            t = torch.zeros(shape, dtype=self.dtype, device=self.device)
        elif init == "ones":
            t = torch.ones(shape, dtype=self.dtype, device=self.device)
        else:
            if scale is None:
                scale = 1.0 / math.sqrt(max(shape[0], 1))
            t = torch.randn(shape, generator=self.generator,
                            dtype=torch.float32, device=self.device)
            t = t.mul_(scale).to(self.dtype)
        p = nn.Parameter(t)
        p.logical_axes = tuple(axes)
        return p


# ---------------------------------------------------------------------------
# Norms / RoPE / embedding
# ---------------------------------------------------------------------------

def init_rmsnorm(mk: Maker, d: int) -> dict:
    return {"scale": mk((d,), (None,), init="ones")}


def rmsnorm(p: Params, x, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, -1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p["scale"].float()).to(x.dtype)


def head_rmsnorm(scale, x, eps: float = 1e-5):
    """qk-norm: RMS over head_dim of (B, S, H, hd)."""
    xf = x.float()
    var = torch.mean(xf * xf, -1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def rope(x, positions, theta: float = 10_000.0):
    """Rotary embedding on (B, S, H, hd); positions (B, S) or (S,)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs              # (B,S,half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def init_embedding(mk: Maker, vocab: int, d: int) -> dict:
    return {"table": mk((vocab, d), ("vocab", "fsdp"), scale=0.02)}


def embed(p: Params, tokens):
    out = p["table"][tokens]
    return shard(out, "batch", None, None)


def logits_out(p: Params, x):
    out = torch.einsum("bsd,vd->bsv", x, p["table"])
    return shard(out, "batch", None, "vocab")


# ---------------------------------------------------------------------------
# Attention (GQA, optional qk-norm, RoPE, causal / sliding-window / full)
# ---------------------------------------------------------------------------

def init_attention(mk: Maker, cfg) -> dict:
    d, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    p = {
        "wq": mk((d, H, hd), ("fsdp", "heads", None)),
        "wk": mk((d, Hkv, hd), ("fsdp", "kv_heads", None)),
        "wv": mk((d, Hkv, hd), ("fsdp", "kv_heads", None)),
        "wo": mk((H, hd, d), ("heads", None, "fsdp")),
    }
    if cfg.qk_norm:
        p["q_norm"] = mk((hd,), (None,), init="ones")
        p["k_norm"] = mk((hd,), (None,), init="ones")
    return p


ATTN_Q_CHUNK = 256          # q-block for memory-efficient attention
ATTN_CHUNK_THRESHOLD = 4096  # chunk whenever S exceeds this


def _sdpa(q, k, v, mask, dtype):
    """Reference scaled-dot-product attention with GQA broadcast.

    q: (B,S,H,hd)  k/v: (B,T,Hkv,hd)  mask: broadcastable (B,1,1,S,T)."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    group = H // Hkv
    qg = q.reshape(B, S, Hkv, group, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(),
                          k.float()) / math.sqrt(hd)
    if mask is not None:               # broadcastable to (B,Hkv,g,S,T)
        scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", w, v.float())
    return out.reshape(B, S, H, hd).to(dtype)


def sdpa_with_spec(q, k, v, dtype, *, causal: bool, window: int = 0):
    """SDPA with a *structured* mask (never materializes S×T for long S):
    for S > ATTN_CHUNK_THRESHOLD the query axis goes in chunks of
    ATTN_Q_CHUNK (O(bq·T) live scores instead of O(S·T)).  `repro`'s
    `kv_valid` is not needed: the prefill attends over the slots it just
    wrote (`attention`)."""
    B, S, H, hd = q.shape
    T = k.shape[1]

    def mask_for(q0, bq):
        if not causal and not window:
            return None
        qi = q0 + torch.arange(bq, device=q.device)[:, None]
        kj = torch.arange(T, device=q.device)[None, :]
        m = torch.ones((bq, T), dtype=torch.bool, device=q.device)
        if causal:
            m &= kj <= qi
        if window:
            m &= (qi - kj) < window
        return m[None, None, None]                 # (1,1,1,bq,T)

    if S <= ATTN_CHUNK_THRESHOLD or S % ATTN_Q_CHUNK:
        return _sdpa(q, k, v, mask_for(0, S), dtype)
    bq = ATTN_Q_CHUNK
    return torch.cat([_sdpa(q[:, q0:q0 + bq], k, v, mask_for(q0, bq), dtype)
                      for q0 in range(0, S, bq)], dim=1)


def kernel_route(S: int, hd: int) -> bool:
    """Whether a self-attention of S queries over the same S keys goes to
    the flash-attention kernel (`ops.attention`): the switch on, S % 128
    == 0 (its dispatch rule) and hd ≤ 256 (the CUDA kernel's limit)."""
    return kops.kernels_enabled() and S % 128 == 0 and hd <= MAX_HEAD_DIM


def self_attention(q, k, v, dtype, *, causal: bool, window: int = 0):
    """Attention of S queries over the same S fresh keys: the flash-
    attention kernel where `kernel_route`, else `sdpa_with_spec`.  Grouped
    kv heads are expanded to the query heads for the kernel; inputs are
    cast to `dtype`, the output is in `dtype`."""
    B, S, H, hd = q.shape
    if not kernel_route(S, hd):
        return sdpa_with_spec(q, k, v, dtype, causal=causal, window=window)
    group = H // k.shape[2]
    if group > 1:
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    q, k, v = (a.to(dtype) for a in (q, k, v))
    return kops.attention(q, k, v, causal=causal, window=window)


def attention(p: Params, x, cfg, *, positions, causal=True,
              kv_override=None, cache=None, prefill=False):
    """Full attention layer.  Returns (out, new_cache).

    * train: cache is None → keys/values from x, structured
      causal(+window) mask.
    * prefill: cache given, pos == 0, S <= C → KV written at slots
      0..S-1; attending over those slots under kv_valid = S is causal
      attention over the fresh k and v (as the cache holds them).
    * decode: cache = {"k", "v", "pos"}; x is (B,1,D); new KV written at
      pos % C (rolling when the cache is shorter than the stream).
    * cross-attention: kv_override = encoder output (B,T,D); no cache
      update, no mask, no rope.

    The cache's k and v are written in place and returned.
    """
    B, S, D = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    q = shard(q, "batch", None, "heads", None)
    src = x if kv_override is None else kv_override
    k = torch.einsum("bsd,dhk->bshk", src, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", src, p["wv"])
    if cfg.qk_norm:
        q = head_rmsnorm(p["q_norm"], q)
        k = head_rmsnorm(p["k_norm"], k)
    if kv_override is None:            # self-attention: rope q and k
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    if cache is not None:
        ck, cv = cache["k"], cache["v"]
        C = ck.shape[1]
        pos = int(cache["pos"])        # tokens seen so far
        if prefill and S > C:
            # SWA cache shorter than the prompt: attend over the full
            # fresh KV with the causal+window mask, then retain only the
            # last C tokens at their rolling slots (abs position % C).
            out = self_attention(q, k, v, x.dtype, causal=True,
                                 window=cfg.sliding_window)
            shift = (S - C) % C
            ck = torch.roll(k[:, S - C:].to(ck.dtype), shift, dims=1)
            cv = torch.roll(v[:, S - C:].to(cv.dtype), shift, dims=1)
            new_cache = {"k": ck, "v": cv, "pos": pos + S}
            out = torch.einsum("bshk,hkd->bsd", out, p["wo"])
            return shard(out, "batch", None, None), new_cache
        slot = pos % C                 # rolling write for SWA caches
        ck[:, slot:slot + S] = k.to(ck.dtype)
        cv[:, slot:slot + S] = v.to(cv.dtype)
        new_cache = {"k": ck, "v": cv, "pos": pos + S}
        if prefill:                    # pos == 0, S <= C, slots = abs pos
            out = self_attention(q, ck[:, :S], cv[:, :S], x.dtype,
                                 causal=True, window=cfg.sliding_window)
        else:                          # decode: S == 1, rolling ages
            kj = torch.arange(C, device=x.device)
            age = (slot - kj) % C                   # 0 = newest
            valid = age <= min(pos, C - 1)
            if cfg.sliding_window:
                valid &= age < cfg.sliding_window
            out = _sdpa(q, ck, cv, valid[None, None, None, None, :], x.dtype)
    else:
        new_cache = {"k": k, "v": v, "pos": S}
        out = self_attention(q, k, v, x.dtype, causal=causal,
                             window=cfg.sliding_window if causal else 0)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return shard(out, "batch", None, None), new_cache


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def init_mlp(mk: Maker, d: int, d_ff: int) -> dict:
    return {
        "wg": mk((d, d_ff), ("fsdp", "ffn")),
        "wu": mk((d, d_ff), ("fsdp", "ffn")),
        "wd": mk((d_ff, d), ("ffn", "fsdp")),
    }


def mlp(p: Params, x):
    h = torch.nn.functional.silu(x @ p["wg"]) * (x @ p["wu"])
    h = shard(h, "batch", None, "ffn")
    return shard(h @ p["wd"], "batch", None, None)
