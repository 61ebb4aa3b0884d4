"""Serving step functions: prefill and one-token decode, and greedy
sampling (counterpart of `repro.models.steps`; its training step,
`make_train_step`, comes with the launcher)."""
from __future__ import annotations

import torch

from .model_zoo import Model


def make_prefill_step(model: Model, cache_dtype=torch.float32):
    def prefill_step(params, batch, cache_len: int | None = None):
        return model.prefill(params, batch, cache_dtype=cache_dtype,
                             cache_len=cache_len)
    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params, tokens, cache):
        return model.decode_step(params, tokens, cache)
    return decode_step


def sample_greedy(logits):
    """argmax over the vocabulary (int64, the port's token dtype)."""
    return torch.argmax(logits, dim=-1)
