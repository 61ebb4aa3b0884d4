"""Whisper-style encoder–decoder transformer backbone.

Counterpart of `repro.models.whisper`.  The mel-spectrogram + conv
feature extractor is a stub: the caller supplies frame embeddings of
shape (B, encoder_frames, d_model).  This module implements everything
after that: sinusoidal positions, the encoder self-attention stack, and
the decoder (causal self-attention + cross-attention + MLP) with KV
caches for serving.  Self-attention takes the flash-attention kernel
where `layers.kernel_route` allows; cross-attention, whose key length
differs from its query length, keeps the plain `sdpa_with_spec`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ArchConfig
from .layers import (Maker, ParamTree, Params, attention, embed,
                     init_attention, init_embedding, init_mlp,
                     init_rmsnorm, logits_out, mlp, rmsnorm, sdpa_with_spec)


def sinusoidal_positions(length: int, d: int) -> np.ndarray:
    pos = np.arange(length)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / (10_000 ** (2 * dim / d))
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)


def init_enc_layer(mk: Maker, cfg) -> dict:
    return {"ln1": init_rmsnorm(mk, cfg.d_model),
            "attn": init_attention(mk, cfg),
            "ln2": init_rmsnorm(mk, cfg.d_model),
            "mlp": init_mlp(mk, cfg.d_model, cfg.d_ff)}


def init_dec_layer(mk: Maker, cfg) -> dict:
    return {"ln1": init_rmsnorm(mk, cfg.d_model),
            "self_attn": init_attention(mk, cfg),
            "ln_x": init_rmsnorm(mk, cfg.d_model),
            "cross_attn": init_attention(mk, cfg),
            "ln2": init_rmsnorm(mk, cfg.d_model),
            "mlp": init_mlp(mk, cfg.d_model, cfg.d_ff)}


def init_whisper(cfg: ArchConfig, mk: Maker) -> ParamTree:
    return ParamTree({
        "embed": init_embedding(mk, cfg.padded_vocab, cfg.d_model),
        "enc_layers": [init_enc_layer(mk, cfg)
                       for _ in range(cfg.encoder_layers)],
        "enc_norm": init_rmsnorm(mk, cfg.d_model),
        "dec_layers": [init_dec_layer(mk, cfg)
                       for _ in range(cfg.num_layers)],
        "dec_norm": init_rmsnorm(mk, cfg.d_model),
        "unembed": init_embedding(mk, cfg.padded_vocab, cfg.d_model),
    })


def whisper_param_axes(cfg: ArchConfig) -> dict[str, tuple]:
    return {name: t.logical_axes
            for name, t in init_whisper(cfg, Maker(None)).named_parameters()}


def encode(params: Params, cfg: ArchConfig, frames):
    """frames: (B, F, D) stub frontend output → encoder states."""
    B, Fr, D = frames.shape
    pe = torch.as_tensor(sinusoidal_positions(Fr, D), dtype=frames.dtype,
                         device=frames.device)
    h = frames + pe[None]
    positions = torch.arange(Fr, device=frames.device)[None, :].repeat(B, 1)
    for lp in params["enc_layers"]:
        a, _ = attention(lp["attn"], rmsnorm(lp["ln1"], h), cfg,
                         positions=positions, causal=False)
        h = h + a
        h = h + mlp(lp["mlp"], rmsnorm(lp["ln2"], h))
    return rmsnorm(params["enc_norm"], h)


def cross_kv(params: Params, cfg: ArchConfig, enc_out):
    """Per-decoder-layer cross-attention K/V from the encoder states: a
    list of {"k", "v"} (B, F, H, hd)."""
    return [{"k": torch.einsum("bsd,dhk->bshk", enc_out,
                               lp["cross_attn"]["wk"]),
             "v": torch.einsum("bsd,dhk->bshk", enc_out,
                               lp["cross_attn"]["wv"])}
            for lp in params["dec_layers"]]


def _cross_attend(lp, h, cfg, kv):
    """Cross-attention with precomputed KV (no mask, no rope)."""
    ca = lp["cross_attn"]
    q = torch.einsum("bsd,dhk->bshk", rmsnorm(lp["ln_x"], h), ca["wq"])
    out = sdpa_with_spec(q, kv["k"], kv["v"], h.dtype, causal=False)
    return torch.einsum("bshk,hkd->bsd", out, ca["wo"])


def decode_tokens(params: Params, cfg: ArchConfig, tokens, enc_out=None,
                  *, xkv=None, cache=None, pos=None, prefill=False):
    """Decoder forward.  Either enc_out or precomputed xkv must be given.

    cache=None → teacher-forced full sequence (training);
    cache given → incremental decode, returns (logits, new_cache)."""
    B, S = tokens.shape
    h = embed(params["embed"], tokens) * (cfg.d_model ** 0.5)
    h = h.to(params["dec_norm"]["scale"].dtype)
    if xkv is None:
        xkv = cross_kv(params, cfg, enc_out)
    start = 0 if cache is None else int(pos)
    positions = (start + torch.arange(S, device=tokens.device)
                 )[None, :].repeat(B, 1)
    new_blocks = []
    for i, lp in enumerate(params["dec_layers"]):
        if cache is None:
            a, _ = attention(lp["self_attn"], rmsnorm(lp["ln1"], h), cfg,
                             positions=positions)
        else:
            lcache = cache["blocks"][i]
            att_cache = {"k": lcache["k"], "v": lcache["v"], "pos": pos}
            a, new_kv = attention(lp["self_attn"], rmsnorm(lp["ln1"], h),
                                  cfg, positions=positions,
                                  cache=att_cache, prefill=prefill)
            new_blocks.append({"k": new_kv["k"], "v": new_kv["v"]})
        h = h + a
        h = h + _cross_attend(lp, h, cfg, xkv[i])
        h = h + mlp(lp["mlp"], rmsnorm(lp["ln2"], h))
    new_cache = None if cache is None else \
        {"blocks": new_blocks, "pos": start + S}
    if prefill:
        h = h[:, -1:]          # serving prefill only needs the last token
    h = rmsnorm(params["dec_norm"], h)
    logits = logits_out(params["unembed"], h)
    if cache is None:
        return logits
    return logits, new_cache


def whisper_init_cache(cfg: ArchConfig, batch: int, cache_len: int,
                       dtype=torch.float32, device=None):
    shape = (batch, cache_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"blocks": [{"k": torch.zeros(shape, dtype=dtype, device=device),
                        "v": torch.zeros(shape, dtype=dtype, device=device)}
                       for _ in range(cfg.num_layers)],
            "pos": 0}
