"""Head dims outside the powers of two: the plain versions of the port's
flash-attention and WKV-scan kernels against `repro`'s Pallas kernels (in
interpret mode), which take any hd, on the same numpy inputs.  The CUDA
attention kernel pads hd in shared memory up to 256 and the chunked WKV
scan takes any hd by row tiles of 64; `tests/test_torch_gpu_ops.py`
holds them against these plain versions on the card.

Tolerances as `tests/test_kernels.py` holds `repro`'s kernels: attention
2e-5 and the WKV scan 1e-4 (atol = rtol), f32 in other operation orders.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.rwkv6_scan import rwkv6_scan as j_scan

from repro_torch import kernels as tk
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import rwkv6_scan as twkv

ATTN_TOL, WKV_TOL = 2e-5, 1e-4
HEAD_DIMS = [24, 80, 96, 256]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 32),
                                           (False, 40)])
def test_flash_attention_head_dims_match_pallas(hd, causal, window):
    rng = np.random.default_rng(hd + window)
    q, k, v = (rng.standard_normal((1, 128, 2, hd)).astype(np.float32)
               for _ in range(3))
    want = j_flash(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                   window=window, bq=64, bk=64, interpret=True)
    tk.reset_launch_counts()
    got = tfa.flash_attention(*(torch.as_tensor(a) for a in (q, k, v)),
                              causal=causal, window=window, bq=64, bk=64)
    assert got.shape == (1, 128, 2, hd) and got.dtype == torch.float32
    _close(got.numpy(), want, ATTN_TOL)
    assert tk.launch_counts()["flash_attention"] == 0   # CPU: plain version


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_rwkv6_scan_head_dims_match_pallas(hd):
    rng = np.random.default_rng(hd)
    r, k, v = (0.5 * rng.standard_normal((2, 64, 2, hd)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(np.clip(rng.standard_normal((2, 64, 2, hd)), -8, 2)
                   ).astype(np.float32)
    u = (0.5 * rng.standard_normal((2, hd))).astype(np.float32)
    ins = (r, k, v, logw, u)
    want = j_scan(*(jnp.asarray(a) for a in ins), chunk=32, interpret=True)
    want_ref, _ = jref.rwkv6_ref(*(jnp.asarray(a) for a in ins))
    got = twkv.rwkv6_scan(*(torch.as_tensor(a) for a in ins), chunk=32)
    assert got.shape == (2, 64, 2, hd) and got.dtype == torch.float32
    _close(got.numpy(), want, WKV_TOL)
    _close(got.numpy(), want_ref, WKV_TOL)


def test_kernel_head_dim_limit_is_256():
    """The CUDA kernels' one limit left against `repro` (ROADMAP queue 3):
    attention's hd ≤ 256, stated by its wrapper; the chunked WKV scan
    takes any hd, as `repro`'s kernels do, and states no limit.  The CPU
    plain versions take any hd."""
    assert tfa.MAX_HEAD_DIM == 256
    assert not hasattr(twkv, "MAX_HEAD_DIM")
    x = torch.zeros((1, 128, 1, 264))
    assert tfa.flash_attention(x, x, x).shape == x.shape
    assert twkv.rwkv6_scan(x, x, x, x, torch.zeros((1, 264))).shape \
        == x.shape
