"""The plain versions of the port's flash-attention kernel and of its
attention oracle, against `repro`'s flash-attention Pallas kernel (in
interpret mode) and `attention_ref`, on the same numpy inputs; and the
window semantics in which the two differ, in both packages.
(`tests/test_torch_ops.py` covers the WKV scan, `kernels.ops` and the
switch.)

Tolerances: both sides compute in f32 in other operation orders; the
attention outputs (averages of N(0, 1) values) agree to 2e-5, as
`tests/test_kernels.py` holds `repro`'s kernel against its oracle; bf16
outputs to 3e-2 (a few bf16 ulp of values ≤ ~4).  Chunking the plain
attention only reorders f32 sums: 1e-6.
Every switch is set through a context manager (`kernel_mode`,
`pallas_mode`), so no state outlives a test.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as j_flash

from repro_torch import kernels as tk
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

ATTN_TOL, BF16_TOL, CHUNK_TOL = 2e-5, 3e-2, 1e-6
MASKS = [(True, 0), (True, 32), (False, 0), (False, 32)]


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for _ in range(3))


def _t(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


# -- flash attention: the plain version against repro's kernel -----------

@pytest.mark.parametrize("S,bq,bk", [(128, 64, 64), (256, 128, 64),
                                     (256, 64, 128)])
@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_attention_matches_pallas(S, bq, bk, causal, window):
    q, k, v = _qkv((2, S, 2, 64), seed=S + bq)
    want = j_flash(*_j(q, k, v), causal=causal, window=window, bq=bq,
                   bk=bk, interpret=True)
    tk.reset_launch_counts()
    got = tfa.flash_attention(*_t(q, k, v), causal=causal, window=window,
                              bq=bq, bk=bk)
    assert got.dtype == torch.float32 and got.shape == (2, S, 2, 64)
    _close(got.numpy(), want, ATTN_TOL)
    assert tk.launch_counts()["flash_attention"] == 0   # CPU: plain version


def test_flash_attention_bf16_matches_pallas():
    q, k, v = (a.astype(jnp.bfloat16) for a in _j(*_qkv((1, 128, 2, 64),
                                                         seed=7)))
    want = j_flash(q, k, v, bq=64, bk=64, interpret=True)
    tq, tk_, tv = (torch.as_tensor(np.asarray(a, np.float32)).to(
        torch.bfloat16) for a in (q, k, v))
    got = tfa.flash_attention(tq, tk_, tv, bq=64, bk=64)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), want, BF16_TOL)
    # and against the f32 oracle, as tests/test_kernels.py holds repro's
    want32 = jref.attention_ref(*(a.astype(jnp.float32) for a in (q, k, v)))
    _close(got.float().numpy(), want32, BF16_TOL)


@pytest.mark.parametrize("causal,window", MASKS + [(True, 100),
                                                   (False, 300)])
@pytest.mark.parametrize("fn", ["flash_attention_ref", "attention_ref"])
def test_chunked_attention_equals_unchunked(fn, causal, window):
    q, k, v = _t(*_qkv((2, 160, 3, 32), seed=window + causal))
    f = getattr(tref, fn)
    whole = f(q, k, v, causal=causal, window=window, q_chunk=160)
    for chunk in (1, 16, 48, None):
        got = f(q, k, v, causal=causal, window=window, q_chunk=chunk)
        _close(got.numpy(), whole.numpy(), CHUNK_TOL)


@pytest.mark.parametrize("causal,window", MASKS)
def test_attention_ref_matches_repro_oracle(causal, window):
    q, k, v = _qkv((2, 96, 2, 32), seed=3)
    want = jref.attention_ref(*_j(q, k, v), causal=causal, window=window)
    got = tref.attention_ref(*_t(q, k, v), causal=causal, window=window)
    _close(got.numpy(), want, ATTN_TOL)


def test_window_without_causal_differs_in_both_packages():
    """`repro`'s kernel masks (q − k) < window even with causal=False;
    its oracle applies the window only under causal.  The port keeps
    both: the kernel route and the oracle route differ in the same way
    in both packages, and each route matches its counterpart."""
    q, k, v = _qkv((1, 128, 2, 32), seed=11)
    kw = dict(causal=False, window=32)
    with jops.pallas_mode(True, interpret=True):
        j_kernel = np.asarray(jops.attention(*_j(q, k, v), **kw))
    with jops.pallas_mode(False):
        j_oracle = np.asarray(jops.attention(*_j(q, k, v), **kw))
    with tops.kernel_mode(True):
        t_kernel = tops.attention(*_t(q, k, v), **kw).numpy()
    with tops.kernel_mode(False):
        t_oracle = tops.attention(*_t(q, k, v), **kw).numpy()
    gap = np.abs(j_kernel - j_oracle).max()
    assert gap > 0.1, gap
    assert np.abs(t_kernel - t_oracle).max() > 0.1
    _close(t_kernel, j_kernel, ATTN_TOL)
    _close(t_oracle, j_oracle, ATTN_TOL)
    # the oracle route is plain non-causal attention
    _close(t_oracle, tref.flash_attention_ref(*_t(q, k, v), causal=False,
                                              window=0).numpy(), ATTN_TOL)
