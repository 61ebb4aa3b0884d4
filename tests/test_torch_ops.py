"""The port's `kernels.ops` entry points (attention, wkv, ring_laplacian
and the kernel switch) and the plain version of its WKV-scan kernel,
against `repro` on the same numpy inputs: `repro`'s Pallas kernels run
in interpret mode, its oracles as they are.
(`tests/test_torch_attention.py` covers the attention plain versions.)

Tolerances: both sides compute in f32 in other operation orders; the
attention outputs (averages of N(0, 1) values) agree to 2e-5 and the WKV
outputs to 1e-4, as `tests/test_kernels.py` holds `repro`'s kernels
against its oracles; the ring Laplacian to 1e-6 in f32 and one bf16 ulp
(2⁻⁷ of the largest output) in bf16.
Every switch is set through a context manager (`kernel_mode`,
`pallas_mode`), so no state outlives a test.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.rwkv6_scan import rwkv6_scan as j_scan

from repro_torch import kernels as tk
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv6_scan as twkv

SRC = Path(__file__).resolve().parents[1] / "src"
ATTN_TOL, WKV_TOL = 2e-5, 1e-4


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for _ in range(3))


def _wkv_inputs(B, T, H, hd, seed):
    """Drawn as `tests/test_kernels.py` draws them: 0.5·N(0, 1) for r, k,
    v; logw = −exp(clip(N, −8, 2)); u = 0.5·N."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((B, T, H, hd)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(np.clip(rng.standard_normal((B, T, H, hd)), -8, 2)
                   ).astype(np.float32)
    u = (0.5 * rng.standard_normal((H, hd))).astype(np.float32)
    return r, k, v, logw, u


def _t(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


# -- the WKV recurrence -------------------------------------------------

@pytest.mark.parametrize("T,chunk", [(64, 16), (128, 32), (96, 32)])
@pytest.mark.parametrize("hd", [16, 32])
def test_rwkv6_scan_matches_pallas(T, chunk, hd):
    ins = _wkv_inputs(2, T, 2, hd, seed=T + hd)
    want = j_scan(*_j(*ins), chunk=chunk, interpret=True)
    want_ref, _ = jref.rwkv6_ref(*_j(*ins))
    tk.reset_launch_counts()
    got = twkv.rwkv6_scan(*_t(*ins), chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == (2, T, 2, hd)
    _close(got.numpy(), want, WKV_TOL)
    _close(tref.rwkv6_scan_ref(*_t(*ins), chunk=chunk).numpy(), want_ref,
           WKV_TOL)
    assert tk.launch_counts()["rwkv6_scan"] == 0


def test_rwkv6_ref_carries_state_like_repro():
    """Two halves chained through S0 give the whole run, in both
    packages, and the port's final state matches repro's
    (`tests/test_kernels.py::test_rwkv6_scan_state_continuity`)."""
    ins = _wkv_inputs(1, 64, 1, 16, seed=0)
    r, k, v, logw, u = _t(*ins)
    whole = twkv.rwkv6_scan(r, k, v, logw, u, chunk=16)
    o1, S = tref.rwkv6_ref(r[:, :32], k[:, :32], v[:, :32], logw[:, :32], u)
    o2, S_T = tref.rwkv6_ref(r[:, 32:], k[:, 32:], v[:, 32:], logw[:, 32:],
                             u, S0=S)
    _close(torch.cat([o1, o2], dim=1).numpy(), whole.numpy(), 1e-5)
    jr, jk, jv, jw, ju = _j(*ins)
    j1, jS = jref.rwkv6_ref(jr[:, :32], jk[:, :32], jv[:, :32], jw[:, :32],
                            ju)
    j2, jS_T = jref.rwkv6_ref(jr[:, 32:], jk[:, 32:], jv[:, 32:],
                              jw[:, 32:], ju, S0=jS)
    _close(o2.numpy(), j2, 1e-5)
    _close(S_T.numpy(), jS_T, 1e-5)


# -- kernels.ops against repro.kernels.ops, both routes ------------------

@pytest.mark.parametrize("enabled", [True, False])
@pytest.mark.parametrize("S,causal,window", [(128, True, 0), (128, True, 32),
                                             (128, False, 32),
                                             (96, True, 32), (96, False, 0)])
def test_ops_attention_matches_repro(enabled, S, causal, window):
    q, k, v = _qkv((1, S, 2, 32), seed=S + window)
    with jops.pallas_mode(enabled, interpret=True):
        want = jops.attention(*_j(q, k, v), causal=causal, window=window)
    tk.reset_launch_counts()
    with tops.kernel_mode(enabled):
        got = tops.attention(*_t(q, k, v), causal=causal, window=window)
    _close(got.numpy(), want, ATTN_TOL)
    assert set(tk.launch_counts().values()) == {0}


@pytest.mark.parametrize("enabled", [True, False])
@pytest.mark.parametrize("T,chunk", [(64, 16), (72, 16)])
def test_ops_wkv_matches_repro(enabled, T, chunk):
    ins = _wkv_inputs(1, T, 2, 16, seed=T)
    with jops.pallas_mode(enabled, interpret=True):
        want = jops.wkv(*_j(*ins), chunk=chunk)
    with tops.kernel_mode(enabled):
        got = tops.wkv(*_t(*ins), chunk=chunk)
    assert got.dtype == torch.float32
    _close(got.numpy(), want, WKV_TOL)


@pytest.mark.parametrize("enabled", [True, False])
@pytest.mark.parametrize("n,d,dtype", [(16, 128, "float32"),
                                       (12, 128, "float32"),
                                       (16, 100, "float32"),
                                       (16, 256, "bfloat16"),
                                       (8, 128, "bfloat16")])
def test_ops_ring_laplacian_matches_repro(enabled, n, d, dtype):
    y = np.random.default_rng(n + d).standard_normal((n, d)).astype(
        np.float32)
    jy = jnp.asarray(y).astype(jnp.bfloat16 if dtype == "bfloat16"
                               else jnp.float32)
    ty = torch.as_tensor(y).to(getattr(torch, dtype))
    with jops.pallas_mode(enabled, interpret=True):
        want = np.asarray(jops.ring_laplacian(jy, 1 / 3, 1 / 3), np.float32)
    with tops.kernel_mode(enabled):
        got = tops.ring_laplacian(ty, 1 / 3, 1 / 3)
    assert got.dtype == ty.dtype and got.shape == (n, d)
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


def test_ops_routes_follow_repros_rules(monkeypatch):
    """Which inputs take the kernel route: the same shape conditions as
    `repro.kernels.ops`, read through the wrappers the entry points
    call."""
    seen = []
    monkeypatch.setattr(tops, "flash_attention",
                        lambda *a, **kw: seen.append("attn"))
    monkeypatch.setattr(tops, "rwkv6_scan",
                        lambda *a, **kw: seen.append("wkv") or a[0])
    monkeypatch.setattr(tops, "ring_laplacian_matvec",
                        lambda *a, **kw: seen.append("ring"))
    z = torch.zeros
    with tops.kernel_mode(True):
        tops.attention(z(1, 256, 1, 16), z(1, 256, 1, 16), z(1, 256, 1, 16))
        tops.attention(z(1, 64, 1, 16), z(1, 64, 1, 16), z(1, 64, 1, 16))
        tops.wkv(*(z(1, 32, 1, 16),) * 4, z(1, 16), chunk=16)
        tops.wkv(*(z(1, 24, 1, 16),) * 4, z(1, 16), chunk=16)
        tops.ring_laplacian(z(8, 128), 0.5, 0.25)
        tops.ring_laplacian(z(8, 128, dtype=torch.bfloat16), 0.5, 0.25)
        tops.ring_laplacian(z(16, 128, dtype=torch.float64), 0.5, 0.25)
    with tops.kernel_mode(False):
        tops.attention(z(1, 256, 1, 16), z(1, 256, 1, 16), z(1, 256, 1, 16))
        tops.wkv(*(z(1, 32, 1, 16),) * 4, z(1, 16), chunk=16)
        tops.ring_laplacian(z(8, 128), 0.5, 0.25)
    assert seen == ["attn", "wkv", "ring"]


# -- the switch ----------------------------------------------------------

def test_kernel_mode_nests_and_restores():
    start = tops.kernels_enabled()
    with tops.kernel_mode(False):
        assert not tops.kernels_enabled()
        with tops.kernel_mode(True):
            assert tops.kernels_enabled()
        assert not tops.kernels_enabled()
        with pytest.raises(RuntimeError, match="boom"):
            with tops.kernel_mode(True):
                raise RuntimeError("boom")
        assert not tops.kernels_enabled()
        tops.use_kernels(True)              # imperative, inside the scope
        assert tops.kernels_enabled()
    assert tops.kernels_enabled() == start
    assert tk.kernel_mode is tops.kernel_mode


def test_kernel_switch_defaults_to_on():
    """In a fresh interpreter (no other test's state): on."""
    code = ("from repro_torch.kernels import ops\n"
            "assert ops.kernels_enabled() is True\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert out.returncode == 0, out.stderr


# -- the wrappers' checks ------------------------------------------------

def test_wrappers_refuse_what_the_kernels_do_not_take():
    z = torch.zeros
    with pytest.raises(ValueError, match="multiple of bq"):
        tfa.flash_attention(*(z(1, 96, 1, 16),) * 3)
    with pytest.raises(ValueError, match="expected"):
        tfa.flash_attention(z(1, 128, 1, 16), z(1, 128, 2, 16),
                            z(1, 128, 1, 16))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfa.flash_attention(*(z(1, 128, 1, 16, dtype=torch.float64),) * 3)
    with pytest.raises(ValueError, match="contiguous last"):
        t = z(1, 128, 1, 32)[..., ::2]
        tfa.flash_attention(t, t, t)
    with pytest.raises(ValueError, match="requires grad"):
        t = z(1, 128, 1, 16, requires_grad=True)
        tfa.flash_attention(t, t, t)
    with pytest.raises(ValueError, match="window"):
        tfa.flash_attention(*(z(1, 128, 1, 16),) * 3, window=-1)
    with pytest.raises(ValueError, match="multiple of chunk"):
        twkv.rwkv6_scan(*(z(1, 24, 1, 16),) * 4, z(1, 16), chunk=16)
    with pytest.raises(ValueError, match="u must be"):
        twkv.rwkv6_scan(*(z(1, 32, 1, 16),) * 4, z(2, 16), chunk=16)


def test_strided_views_match_contiguous_operands():
    """The wrappers take (B, S, H, hd) views of (B, H, S, hd) storage, as
    the kernels read through strides."""
    q, k, v = _t(*_qkv((1, 2, 128, 16), seed=5))
    views = [a.transpose(1, 2) for a in (q, k, v)]
    got = tfa.flash_attention(*views, causal=True, window=0)
    want = tfa.flash_attention(*(a.contiguous() for a in views))
    assert torch.equal(got, want)
    r, k, v, logw, u = _t(*_wkv_inputs(1, 32, 2, 16, seed=1))
    views = [a.transpose(1, 2).contiguous().transpose(1, 2)
             for a in (r, k, v, logw)]
    assert not views[0].is_contiguous()
    got = twkv.rwkv6_scan(*views, u, chunk=16)
    want = twkv.rwkv6_scan(*(a.contiguous() for a in views), u, chunk=16)
    assert torch.equal(got, want)
