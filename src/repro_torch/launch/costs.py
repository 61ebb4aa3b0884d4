"""Analytic cost model of the LM workload (counterpart of
`repro.launch.costs`, the same floats).

1. `flops_estimate` — a hand cost model per architecture (projections,
   quadratic attention with causality and windowing, MoE active
   experts, recurrence updates), and `model_flops_convention`, the
   6·N·D / 2·N·D "useful compute" convention.  Over the H100's dense
   bf16 peak (`repro_torch.launch.mesh.H100_PEAK_FLOPS_BF16`) they give
   a step's compute bound and its model-FLOPs share.

2. `affine_correct` — every cost of a step is affine in its depth L
   (an out-of-loop a plus a per-layer b), so two traces at reduced depth
   (`reduced_depth`, `depth_pair`) give cost(L_full) = a + L_full·b.
   `repro` fits it because XLA's `cost_analysis()` counts a scanned
   layer once; the port's dry run (`launch.dryrun`) traces on the meta
   device, where the fit keeps the trace of a deep model short.
"""
from __future__ import annotations

import dataclasses

from ..configs.base import ArchConfig, InputShape


def _attn_flops_per_token(cfg: ArchConfig, ctx: float) -> float:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    proj = 2 * d * (cfg.q_dim * 2 + cfg.kv_dim * 2)
    sdpa = 4 * ctx * cfg.num_heads * hd
    return proj + sdpa


def _ffn_flops_per_token(cfg: ArchConfig) -> float:
    if cfg.num_experts:
        router = 2 * cfg.d_model * cfg.num_experts
        return router + cfg.top_k * 6 * cfg.d_model * cfg.d_ff
    return 6 * cfg.d_model * cfg.d_ff


def _rwkv_flops_per_token(cfg: ArchConfig) -> float:
    d = cfg.d_model
    time_mix = 10 * d * d + 6 * cfg.rwkv_head_size * d + 2 * d * d
    channel_mix = 4 * d * cfg.d_ff + 2 * d * d
    return time_mix + channel_mix


def _mamba_flops_per_token(cfg: ArchConfig) -> float:
    d = cfg.d_model
    d_inner = 2 * d
    H = d_inner // cfg.mamba_head_dim
    N = cfg.ssm_state
    proj = 2 * d * (2 * d_inner + 2 * N + H) + 2 * d_inner * d
    conv = 2 * cfg.conv_kernel * d_inner
    scan = 6 * d_inner * N
    return proj + conv + scan


def forward_flops(cfg: ArchConfig, seq_len: int, ctx: float | None = None,
                  batch: int = 1) -> float:
    """Analytic forward flops for `batch` sequences of `seq_len` tokens.

    ctx: average attention context per token (defaults to causal S/2,
    capped by the sliding window if set)."""
    tokens = batch * seq_len
    if ctx is None:
        ctx = seq_len / 2.0
        if cfg.sliding_window:
            ctx = min(ctx, float(cfg.sliding_window))
    per_tok = 0.0
    for kind in (["rwkv6"] * cfg.num_layers if cfg.attn_free else
                 ["mamba2"] * cfg.num_layers if cfg.shared_attn_every else
                 ["attn"] * cfg.num_layers):
        if kind == "attn":
            per_tok += _attn_flops_per_token(cfg, ctx) \
                + _ffn_flops_per_token(cfg)
        elif kind == "rwkv6":
            per_tok += _rwkv_flops_per_token(cfg)
        elif kind == "mamba2":
            per_tok += _mamba_flops_per_token(cfg)
    if cfg.shared_attn_every:    # zamba2 shared attention invocations
        n_inv = len(cfg.shared_attn_positions())
        per_tok += n_inv * (_attn_flops_per_token(cfg, ctx)
                            + 6 * cfg.d_model * cfg.d_ff
                            + 2 * cfg.d_model * cfg.d_model)
    if cfg.encoder_decoder:
        # encoder (full attn over frames) + decoder cross-attention
        F = cfg.encoder_frames
        enc_per_frame = _attn_flops_per_token(cfg, F) \
            + _ffn_flops_per_token(cfg)
        enc = cfg.encoder_layers * enc_per_frame * batch * F
        cross_per_tok = 2 * cfg.d_model * cfg.q_dim * 2 \
            + 4 * F * cfg.num_heads * cfg.resolved_head_dim
        per_tok += cfg.num_layers * cross_per_tok
        return enc + tokens * (per_tok + 2 * cfg.d_model
                               * cfg.padded_vocab)
    per_tok += 2 * cfg.d_model * cfg.padded_vocab      # logits
    return tokens * per_tok


def flops_estimate(cfg: ArchConfig, shape: InputShape) -> float:
    """Analytic flops of the lowered step (global, all chips)."""
    if shape.kind == "train":
        return 3.0 * forward_flops(cfg, shape.seq_len,
                                   batch=shape.global_batch)
    if shape.kind == "prefill":
        return forward_flops(cfg, shape.seq_len, batch=shape.global_batch)
    # decode: 1 token, full-context attention reads
    ctx = float(shape.seq_len)
    if cfg.sliding_window:
        ctx = min(ctx, float(cfg.sliding_window))
    return forward_flops(cfg, 1, ctx=ctx, batch=shape.global_batch)


def model_flops_convention(cfg: ArchConfig, shape: InputShape,
                           n_params_active: int) -> float:
    """The useful-compute MODEL_FLOPS: 6·N·D (train) / 2·N·D (inference),
    N = active params, D = tokens processed."""
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_params_active * tokens


def affine_correct(cost_small: float, cost_large: float, l_small: int,
                   l_large: int, l_full: int) -> float:
    """cost(L) = a + L·b fitted at two unrolled depths."""
    b = (cost_large - cost_small) / (l_large - l_small)
    a = cost_small - l_small * b
    return a + l_full * b


def reduced_depth(cfg: ArchConfig, layers: int) -> ArchConfig:
    """Same width, reduced depth (for the unrolled accounting compiles).

    shared_attn_every is preserved so the zamba2 shared-block-per-layer
    ratio matches the full model (use depth pairs that are multiples of
    shared_attn_every)."""
    repl = {"num_layers": layers}
    if cfg.encoder_decoder:
        repl["encoder_layers"] = layers
    return dataclasses.replace(cfg, **repl)


def depth_pair(cfg: ArchConfig) -> tuple[int, int]:
    if cfg.shared_attn_every:
        return cfg.shared_attn_every, 2 * cfg.shared_attn_every
    return 2, 4
