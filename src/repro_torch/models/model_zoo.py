"""Model facade: one `Model` object per architecture family, uniform
init/loss/prefill/decode API.

Counterpart of `repro.models.model_zoo`.  `Model.init` builds the
parameters as an `nn.Module` (`layers.ParamTree`) drawn on the device
from a seeded `torch.Generator`, which the other methods take where
`repro`'s take its parameter pytree; `repro_torch.interop
.load_lm_params` carries `repro`'s parameters across instead.

Batch conventions:
  loss:    {"tokens": (B,S), "labels": (B,S)} integer (+ "frames" audio)
  prefill: {"tokens": (B,S)}                          (+ "frames" audio)
  decode:  tokens (B,1) + the cache `prefill` returned

Serving (`prefill`, `decode_step`) runs without autograd.  The
attention and WKV kernels have no backward, so a `loss` that would
build a gradient through a kernel route raises (the wrappers refuse
operands that require grad); take it under `torch.no_grad()` or with the
kernel switch off, as `steps.make_train_step` does.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .._device import resolve_device
from ..configs.base import ArchConfig
from . import transformer as tf
from . import whisper as wp
from .layers import Maker

Params = Any

AUX_LOSS_WEIGHT = 0.01


def cross_entropy(logits, labels, vocab_size: int):
    """Mean next-token CE; ignores labels < 0; masks vocab padding."""
    V = logits.shape[-1]
    if V > vocab_size:
        pad = torch.arange(V, device=logits.device) >= vocab_size
        logits = torch.where(pad[None, None], torch.full_like(logits, -1e30),
                             logits)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    true = torch.gather(logits, -1,
                        torch.clamp(labels, min=0)[..., None].long())[..., 0]
    mask = (labels >= 0).float()
    return torch.sum((lse - true) * mask) / torch.clamp(mask.sum(), min=1.0)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    # ---- params ----
    def init(self, seed: int = 0, dtype=torch.float32, device=None):
        """The parameters (an `nn.Module`) drawn from a `torch.Generator`
        seeded with `seed` on `device` (CUDA unless named; "meta" for
        shapes only)."""
        if device is not None and torch.device(device).type == "meta":
            mk = Maker(None, dtype)
        else:
            dev = resolve_device(device)
            mk = Maker(torch.Generator(device=dev).manual_seed(seed), dtype,
                       dev)
        if self.cfg.encoder_decoder:
            return wp.init_whisper(self.cfg, mk)
        return tf.init_lm(self.cfg, mk)

    def param_axes(self) -> dict[str, tuple]:
        """{state-dict name: logical axes} (`distributed.sharding`)."""
        if self.cfg.encoder_decoder:
            return wp.whisper_param_axes(self.cfg)
        return tf.param_axes(self.cfg)

    def param_count(self, dtype=torch.float32) -> int:
        return sum(p.numel() for p in
                   self.init(dtype=dtype, device="meta").parameters())

    # ---- losses / steps ----
    def loss(self, params: Params, batch):
        cfg = self.cfg
        if cfg.encoder_decoder:
            enc = wp.encode(params, cfg, batch["frames"])
            logits = wp.decode_tokens(params, cfg, batch["tokens"],
                                      enc_out=enc)
            return cross_entropy(logits, batch["labels"], cfg.vocab_size), {}
        logits, aux = tf.forward(params, cfg, batch["tokens"])
        ce = cross_entropy(logits, batch["labels"], cfg.vocab_size)
        loss = ce + (AUX_LOSS_WEIGHT * aux if cfg.num_experts else 0.0)
        return loss, {"ce": ce, "aux": aux}

    @torch.no_grad()
    def prefill(self, params: Params, batch, cache_dtype=torch.float32,
                cache_len: int | None = None):
        """Full-sequence forward building the serving cache (sized
        `cache_len`, default = prompt length).  Returns (last-token
        logits (B,V), cache)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        C = cache_len or S
        assert C >= S, "prefill requires cache_len >= prompt length"
        if cfg.encoder_decoder:
            enc = wp.encode(params, cfg, batch["frames"])
            xkv = wp.cross_kv(params, cfg, enc)
            cache = wp.whisper_init_cache(cfg, B, C, cache_dtype,
                                          tokens.device)
            logits, new_cache = wp.decode_tokens(
                params, cfg, tokens, xkv=xkv, cache=cache, pos=0,
                prefill=True)
            new_cache["xkv"] = xkv
            return logits[:, -1], new_cache
        cache = self.init_cache(B, C, cache_dtype, device=tokens.device)
        logits, new_cache, _ = tf.forward(params, cfg, tokens, cache=cache,
                                          pos=0, prefill=True)
        return logits[:, -1], new_cache

    @torch.no_grad()
    def decode_step(self, params: Params, tokens, cache):
        """One-token decode.  tokens (B,1); returns (logits (B,V), cache);
        the cache's tensors are updated in place."""
        cfg = self.cfg
        if cfg.encoder_decoder:
            logits, new_cache = wp.decode_tokens(
                params, cfg, tokens, xkv=cache["xkv"], cache=cache,
                pos=cache["pos"])
            new_cache["xkv"] = cache["xkv"]
            return logits[:, -1], new_cache
        logits, new_cache, _ = tf.forward(params, cfg, tokens, cache=cache,
                                          pos=cache["pos"])
        return logits[:, -1], new_cache

    def init_cache(self, batch: int, cache_len: int, dtype=torch.float32,
                   window_override: int = 0, device=None):
        cfg = self.cfg
        dev = resolve_device(device)
        if window_override:
            cfg = dataclasses.replace(cfg, sliding_window=window_override)
        if cfg.encoder_decoder:
            cache = wp.whisper_init_cache(cfg, batch, cache_len, dtype, dev)
            shape = (batch, cfg.encoder_frames, cfg.num_kv_heads,
                     cfg.resolved_head_dim)
            cache["xkv"] = [
                {"k": torch.zeros(shape, dtype=dtype, device=dev),
                 "v": torch.zeros(shape, dtype=dtype, device=dev)}
                for _ in range(cfg.num_layers)]
            return cache
        return tf.init_cache(cfg, batch, cache_len, dtype, dev)


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
