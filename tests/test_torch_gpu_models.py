"""The model zoo's kernel routes on the card: at `reduced()` size each
model's prefill launches the flash-attention kernel (S % 128 == 0) or
the WKV scan with its final state (T % 64 == 0) once per layer, and is
held against the same model with the kernel switch off; and the WKV
scan's state output against `kernels.ref.rwkv6_ref(...)[1]`.  Every test
needs a CUDA device and skips without one; on the H100 run

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_models.py

Tolerances.  The WKV scan, output and state, (atol, rtol) = (1e-4, 1e-4)
as `tests/test_torch_gpu_ops.py`; its output with the state is bitwise
the output-only launch's (the same kernel walk).  Models in f32: the
kernels are held to 2e-5 (attention) and 1e-4 (WKV) of their plain
versions, and two layers of O(1) weights carry that to the logits
within atol = rtol = 1e-3.  Models in bf16: each layer's kernel and
plain outputs are f32-accurate and rounded once to bf16, so the logits
are held to 2^-7·√L of the largest plain logit (chip_smoke's lm phase).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.kernels import (kernel_mode, launch_counts, ref,
                                 reset_launch_counts)
from repro_torch.kernels import rwkv6_scan as twkv
from repro_torch.models import build_model
from repro_torch.models.steps import sample_greedy

pytestmark = pytest.mark.gpu

WKV_TOL = (1e-4, 1e-4)
F32_LOGIT_TOL = (1e-3, 1e-3)


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on "
                    "the card")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def _close(got, want, tol):
    atol, rtol = tol
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


def _wkv_inputs(B, T, H, hd, dtype, dev, seed):
    rng = np.random.default_rng(seed)
    mk = lambda s=0.5: torch.as_tensor(
        (s * rng.standard_normal((B, T, H, hd))).astype(np.float32),
        device=dev).to(dtype)
    logw = torch.as_tensor(-np.exp(np.clip(rng.standard_normal(
        (B, T, H, hd)), -8, 2)).astype(np.float32), device=dev).to(dtype)
    u = torch.as_tensor((0.5 * rng.standard_normal((H, hd))
                         ).astype(np.float32), device=dev)
    return mk(), mk(), mk(), logw, u


@pytest.mark.parametrize("shape,chunk", [
    ((1, 1024, 64, 64), 64),      # rwkv6-7b's head shape, a 1k prompt
    ((2, 256, 4, 96), 64),        # half a row tile past 64
    ((1, 100, 2, 64), 4),         # T off the 16-step chunks
    ((3, 64, 3, 16), 16),
    ((1, 128, 2, 320), 32),       # five row tiles
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv_state_output_matches_rwkv6_ref(cuda, shape, chunk, dtype):
    ins = _wkv_inputs(*shape, dtype, cuda, seed=sum(shape))
    before = launch_counts()
    out, state = twkv.rwkv6_scan(*ins, chunk=chunk, return_state=True)
    after = launch_counts()
    assert after["rwkv6_scan_state"] == before["rwkv6_scan_state"] + 1
    assert after["rwkv6_scan"] == before["rwkv6_scan"]
    B, T, H, hd = shape
    assert state.shape == (B, H, hd, hd) and state.dtype == torch.float32
    want, want_state = ref.rwkv6_ref(*ins)
    _close(out, want, WKV_TOL)
    _close(state, want_state, WKV_TOL)
    assert torch.equal(out, twkv.rwkv6_scan(*ins, chunk=chunk))


def _served(model, params, tokens, steps):
    logits, cache = model.prefill(params, {"tokens": tokens},
                                  cache_dtype=next(params.parameters()).dtype,
                                  cache_len=tokens.shape[1] + steps)
    out = [logits]
    for _ in range(steps):
        logits, cache = model.decode_step(params, sample_greedy(out[-1])
                                          [:, None], cache)
        out.append(logits)
    return out


CASES = {
    # name: (arch, config changes, the prefill kernel's counter)
    "gqa": ("qwen3-4b", {"num_kv_heads": 2}, "flash_attention"),
    "window": ("mixtral-8x7b", {"capacity_factor": 8.0}, "flash_attention"),
    "rwkv": ("rwkv6-7b", {}, "rwkv6_scan_state"),
    "zamba2_shared": ("zamba2-1.2b", {}, "flash_attention"),
    "whisper_decoder": ("whisper-large-v3", {}, "flash_attention"),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(CASES))
def test_prefill_on_the_kernels_matches_the_switch_off(cuda, name, dtype):
    arch, changes, kname = CASES[name]
    cfg = dataclasses.replace(ARCHS[arch].reduced(), **changes)
    model = build_model(cfg)
    params = model.init(seed=3, dtype=dtype, device=cuda)
    gen = torch.Generator(cuda).manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size, (1, 128), generator=gen,
                           device=cuda)
    batch = {"tokens": tokens}
    if cfg.encoder_decoder:
        batch["frames"] = 0.02 * torch.randn(
            (1, cfg.encoder_frames, cfg.d_model), generator=gen,
            device=cuda).to(dtype)
    reset_launch_counts()
    logits, cache = model.prefill(params, batch, cache_dtype=dtype,
                                  cache_len=132)
    counts = launch_counts()
    calls = 1 if cfg.shared_attn_every else cfg.num_layers
    assert counts == {**dict.fromkeys(counts, 0), kname: calls}
    with kernel_mode(False):
        plain, _ = model.prefill(params, batch, cache_dtype=dtype,
                                 cache_len=132)
    assert sum(launch_counts().values()) == calls
    if dtype == torch.float32:
        _close(logits, plain, F32_LOGIT_TOL)
    else:
        tol = 2.0 ** -7 * math.sqrt(cfg.num_layers) \
            * plain.float().abs().max().item()
        assert (logits.float() - plain.float()).abs().max().item() <= tol
    # greedy decode after it: the plain rolling-cache route, no launch
    tok = sample_greedy(logits)[:, None]
    nxt, _ = model.decode_step(params, tok, cache)
    assert sum(launch_counts().values()) == calls
    assert bool(nxt.float().isfinite().all())


def test_prompts_off_the_kernel_shapes_launch_nothing(cuda):
    cfg = ARCHS["qwen3-4b"].reduced()
    model = build_model(cfg)
    params = model.init(seed=5, device=cuda)
    reset_launch_counts()
    out = _served(model, params, torch.zeros((1, 100), dtype=torch.int64,
                                             device=cuda), 2)
    assert sum(launch_counts().values()) == 0
    assert all(bool(o.isfinite().all()) for o in out)


def test_a_gradient_through_the_kernels_raises(cuda):
    for arch in ("qwen3-4b", "rwkv6-7b"):
        cfg = ARCHS[arch].reduced()
        model = build_model(cfg)
        params = model.init(seed=6, device=cuda)
        tokens = torch.zeros((1, 128), dtype=torch.int64, device=cuda)
        with pytest.raises(ValueError, match="requires grad"):
            model.loss(params, {"tokens": tokens, "labels": tokens})
        with torch.no_grad():
            loss, _ = model.loss(params, {"tokens": tokens,
                                          "labels": tokens})
        assert bool(loss.isfinite())
