"""The port's flash-attention and WKV-scan CUDA kernels, and the
`kernels.ops` entry points over them, against their plain PyTorch
versions on the card.  Every test here needs a CUDA device and skips
without one; on the H100 run them with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_ops.py

Tolerances, as (atol, rtol).  f32 attention 2e-5 and WKV 1e-4 (atol =
rtol), as `tests/test_kernels.py` holds `repro`'s Pallas kernels against
its oracles; the kernels sum in other orders than the plain versions'
matmuls.  bf16 attention: the kernel and its plain version both compute
in f32 from the same bf16 inputs and round once to bf16, so they may
differ by one bf16 rounding, atol 1e-6 and rtol 2^-7.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import rwkv6_scan as twkv

pytestmark = pytest.mark.gpu

ATTN_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-6, 2.0 ** -7)}
WKV_TOL = (1e-4, 1e-4)


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on "
                    "the card")
    # the plain versions' matmuls in full f32 (the default, pinned here)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def _close(got, want, tol):
    """|got − want| ≤ atol + rtol·|want| everywhere, (atol, rtol) = tol."""
    atol, rtol = tol
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


def _randn(shape, dtype, dev, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(scale * rng.standard_normal(shape),
                        dtype=torch.float32)
    return x.to(dev).to(dtype)


def _wkv_inputs(B, T, H, hd, dtype, dev, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (torch.as_tensor(0.5 * rng.standard_normal((B, T, H, hd)),
                               dtype=torch.float32) for _ in range(3))
    logw = -torch.exp(torch.as_tensor(
        np.clip(rng.standard_normal((B, T, H, hd)), -8, 2),
        dtype=torch.float32))
    u = torch.as_tensor(0.5 * rng.standard_normal((H, hd)),
                        dtype=torch.float32)
    return tuple(a.to(dev).to(dtype) for a in (r, k, v, logw)) + (u.to(dev),)


@pytest.mark.parametrize("shape", [(1, 128, 2, 64), (2, 256, 3, 128),
                                   (1, 384, 2, 32), (1, 128, 1, 16),
                                   (1, 256, 2, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 32),
                                           (False, 0), (False, 32),
                                           (True, 200), (False, 200)])
def test_flash_attention_kernel(cuda, shape, dtype, causal, window):
    """Windows shorter than the kernel's 64-row tile leave wholly masked
    leading kv tiles (skipped) and rows whose first keys are masked."""
    q, k, v = (_randn(shape, dtype, cuda, seed) for seed in (1, 2, 3))
    before = tfa.launch_counts()["flash_attention"]
    got = tfa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tfa.launch_counts()["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got.float()).all()
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    _close(got, want, ATTN_TOL[dtype])


@pytest.mark.parametrize("S", [96, 160])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 40)])
def test_flash_attention_kernel_ragged_tiles(cuda, S, causal, window):
    """S not a multiple of the kernel's 64-row tiles (bq = bk = 32 here,
    as `repro` allows): the last q tile's extra rows are not stored and
    the last kv tile's extra keys are masked."""
    q, k, v = (_randn((2, S, 2, 64), torch.float32, cuda, seed)
               for seed in (4, 5, 6))
    got = tfa.flash_attention(q, k, v, causal=causal, window=window, bq=32,
                              bk=32)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    _close(got, want, ATTN_TOL[torch.float32])


@pytest.mark.parametrize("B,S,H,KV,window", [(2, 4096, 32, 8, 0),
                                             (1, 8192, 32, 8, 4096)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_full_width(cuda, B, S, H, KV, window,
                                           dtype):
    """qwen3-4b's heads (32 q, 8 kv, hd 128) at train_4k, causal; and
    mixtral-8x7b's with its 4096 sliding window, at 8192 tokens; kv
    heads broadcast with repeat_interleave."""
    q = _randn((B, S, H, 128), dtype, cuda, 1)
    k, v = (_randn((B, S, KV, 128), dtype, cuda, s)
            .repeat_interleave(H // KV, dim=2) for s in (2, 3))
    got = tfa.flash_attention(q, k, v, causal=True, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    _close(got, want, ATTN_TOL[dtype])


def test_flash_attention_reads_strided_views(cuda):
    qkv = [_randn((2, 3, 256, 64), torch.float32, cuda, s).transpose(1, 2)
           for s in (1, 2, 3)]
    assert not qkv[0].is_contiguous()
    got = tfa.flash_attention(*qkv, causal=True, window=48)
    want = tfa.flash_attention(*(a.contiguous() for a in qkv), causal=True,
                               window=48)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(2, 64, 2, 16), (2, 128, 2, 32),
                                   (1, 256, 3, 64), (1, 64, 2, 128),
                                   (3, 32, 1, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_scan_kernel(cuda, shape, dtype):
    r, k, v, logw, u = _wkv_inputs(*shape, dtype, cuda, seed=sum(shape))
    before = twkv.launch_counts()["rwkv6_scan"]
    got = twkv.rwkv6_scan(r, k, v, logw, u, chunk=16)
    torch.cuda.synchronize()
    assert twkv.launch_counts()["rwkv6_scan"] == before + 1
    assert got.dtype == torch.float32 and got.shape == r.shape
    _close(got, ref.rwkv6_scan_ref(r, k, v, logw, u), WKV_TOL)


def test_rwkv6_scan_kernel_full_width(cuda):
    """rwkv6-7b's 64 heads of 64 at train_4k, B = 4, f32."""
    ins = _wkv_inputs(4, 4096, 64, 64, torch.float32, cuda, seed=0)
    got = twkv.rwkv6_scan(*ins)
    _close(got, ref.rwkv6_scan_ref(*ins), WKV_TOL)


def test_rwkv6_scan_reads_strided_views(cuda):
    r, k, v, logw, u = _wkv_inputs(2, 3, 64, 32, torch.float32, cuda, 4)
    views = [a.transpose(1, 2) for a in (r, k, v, logw)]
    u = u.reshape(64, 32)[:3].contiguous()
    got = twkv.rwkv6_scan(*views, u, chunk=32)
    want = twkv.rwkv6_scan(*(a.contiguous() for a in views), u, chunk=32)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape,cols", [
    ((1, 40, 132, 64), 64), ((1, 40, 66, 64), 32), ((1, 33, 2, 100), 16),
    ((1, 40, 132, 32), 32), ((1, 20, 17, 520), 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_scan_every_route(cuda, shape, cols, dtype):
    """Each state-tile width the planner gives, reached by shape, T past
    a multiple of the kernel's 16-step chunk; at hd 520 on 64 columns the
    state tile lives in device memory (f32; bf16 keeps it in shared
    memory up to hd 640)."""
    B, T, H, hd = shape
    assert twkv.plan_wkv_cols(B, H, hd) == cols
    ins = _wkv_inputs(*shape, dtype, cuda, seed=sum(shape))
    got = twkv.rwkv6_scan(*ins, chunk=T)
    torch.cuda.synchronize()
    _close(got, ref.rwkv6_scan_ref(*ins), WKV_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_scan_staging_routes_agree(cuda, dtype):
    """The same operands staged by TMA (every row 16-byte aligned) and by
    cp.async (the operands 4 bytes past alignment in f32, 2 in bf16):
    the same bits."""
    ins = _wkv_inputs(2, 48, 3, 64, dtype, cuda, seed=9)

    def offset(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        buf[1:] = t.flatten()
        return buf[1:].view(t.shape)
    aligned = twkv.rwkv6_scan(*ins, chunk=16)
    shifted = twkv.rwkv6_scan(*(offset(a) for a in ins[:4]), ins[4],
                              chunk=16)
    torch.cuda.synchronize()
    assert torch.equal(aligned, shifted)
    _close(aligned, ref.rwkv6_scan_ref(*ins), WKV_TOL)


def test_rwkv6_scan_kernel_full_width_bf16(cuda):
    """rwkv6-7b's 64 heads of 64 at train_4k, B = 4, bf16 inputs."""
    ins = _wkv_inputs(4, 4096, 64, 64, torch.bfloat16, cuda, seed=1)
    got = twkv.rwkv6_scan(*ins)
    _close(got, ref.rwkv6_scan_ref(*ins), WKV_TOL)


def test_ops_route_and_switch_on_the_card(cuda):
    q, k, v = (_randn((1, 256, 2, 64), torch.bfloat16, cuda, s)
               for s in (1, 2, 3))
    ins = _wkv_inputs(1, 128, 2, 32, torch.float32, cuda, seed=5)
    n_attn = tfa.launch_counts()["flash_attention"]
    n_wkv = twkv.launch_counts()["rwkv6_scan"]
    with ops.kernel_mode(True):
        a_on = ops.attention(q, k, v, causal=True, window=0)
        w_on = ops.wkv(*ins, chunk=64)
        ops.attention(q[:, :192], k[:, :192], v[:, :192])   # S % 128 != 0
        ops.wkv(*(a[:, :96] for a in ins[:4]), ins[4], chunk=64)
    with ops.kernel_mode(False):
        a_off = ops.attention(q, k, v, causal=True, window=0)
        w_off = ops.wkv(*ins, chunk=64)
    torch.cuda.synchronize()
    assert tfa.launch_counts()["flash_attention"] == n_attn + 1
    assert twkv.launch_counts()["rwkv6_scan"] == n_wkv + 1
    _close(a_on, a_off, ATTN_TOL[torch.bfloat16])
    _close(w_on, w_off, WKV_TOL)


def test_launch_errors_raise(cuda):
    """A dtype code or a head dim the C entry points refuse fails the
    launch (attention above 256, the WKV scan below 1); the attention
    wrapper refuses hd > 256, the one limit left, and the WKV scan runs
    hd 264 and 320 against its plain version."""
    q = torch.zeros((1, 128, 1, 64), device=cuda)
    out = torch.empty_like(q)
    with pytest.raises(RuntimeError, match="launch failed"):
        tfa._LIB.launch("flash_attention", q.device, q.data_ptr(),
                        q.data_ptr(), q.data_ptr(), out.data_ptr(), 1, 128,
                        1, 64, 7, *(0,) * 9, 0.125, 1, 0)
    with pytest.raises(RuntimeError, match="launch failed"):
        tfa._LIB.launch("flash_attention", q.device, q.data_ptr(),
                        q.data_ptr(), q.data_ptr(), out.data_ptr(), 1, 128,
                        1, 264, 0, *(0,) * 9, 0.125, 1, 0)
    for hd, cols in ((0, 64), (-1, 64), (64, 8)):
        with pytest.raises(RuntimeError, match="launch failed"):
            twkv._LIB.launch("rwkv6_scan", q.device, *(q.data_ptr(),) * 5,
                             out.data_ptr(), None, None, 1, 128, 1, hd, 0,
                             cols, *(0,) * 12)
    z = torch.zeros((1, 128, 1, 264), device=cuda)
    with pytest.raises(ValueError, match="up to 256"):
        tfa.flash_attention(z, z, z)
    for hd in (264, 320):
        ins = _wkv_inputs(1, 128, 2, hd, torch.float32, cuda, seed=hd)
        _close(twkv.rwkv6_scan(*ins), ref.rwkv6_scan_ref(*ins), WKV_TOL)


# -- head dims outside the powers of two (padded in shared memory) -------

HEAD_DIMS = [24, 80, 96, 256]


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 32),
                                           (False, 0), (False, 40)])
def test_flash_attention_kernel_any_head_dim(cuda, hd, dtype, causal,
                                             window):
    q, k, v = (_randn((2, 256, 3, hd), dtype, cuda, seed)
               for seed in (hd, hd + 1, hd + 2))
    before = tfa.launch_counts()["flash_attention"]
    got = tfa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tfa.launch_counts()["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    _close(got, want, ATTN_TOL[dtype])


@pytest.mark.parametrize("hd", HEAD_DIMS + [5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_any_head_dim_ragged_strided(cuda, hd,
                                                            dtype):
    """S = 160 (a ragged last q and kv tile, bq = bk = 32 as `repro`
    allows), a window, and (B, H, S, hd) views read through their strides,
    whose rows are not whole 16-byte chunks at hd = 5 (the element-wise
    staging) — against the plain version and the contiguous launch."""
    q, k, v = (_randn((2, 3, 160, hd), dtype, cuda, seed).transpose(1, 2)
               for seed in (7, 8, 9))
    got = tfa.flash_attention(q, k, v, causal=True, window=48, bq=32, bk=32)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=48)
    _close(got, want, ATTN_TOL[dtype])
    assert torch.equal(got, tfa.flash_attention(
        *(a.contiguous() for a in (q, k, v)), causal=True, window=48, bq=32,
        bk=32))


@pytest.mark.parametrize("hd", [5, 24, 96, 130, 256, 264, 320])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_scan_kernel_any_head_dim(cuda, hd, dtype):
    """Row tiles of 64 with rows past hd (hd 5, 24, 96, 130, 264, 320),
    state tiles with columns past hd, several column tiles a head; hd 5
    takes 4-byte copies in f32 and 2-byte loads in bf16, the others the
    TMA route."""
    r, k, v, logw, u = _wkv_inputs(2, 96, 3, hd, dtype, cuda, seed=hd)
    before = twkv.launch_counts()["rwkv6_scan"]
    got = twkv.rwkv6_scan(r, k, v, logw, u, chunk=32)
    torch.cuda.synchronize()
    assert twkv.launch_counts()["rwkv6_scan"] == before + 1
    assert got.dtype == torch.float32 and got.shape == r.shape
    _close(got, ref.rwkv6_scan_ref(r, k, v, logw, u), WKV_TOL)


def test_entry_points_leave_the_tf32_flags(cuda, monkeypatch):
    """`ops.attention`, `ops.wkv` and `solve` run inside strict_f32 on the
    card and hand the caller's flags back."""
    from repro_torch.core.problems import quadratic_bilevel
    from repro_torch.solve import SolverSpec, solve
    from repro_torch.topology import make_network
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    q = _randn((1, 128, 2, 64), torch.float32, cuda, 1)
    ops.attention(q, q, q)
    ops.wkv(*_wkv_inputs(1, 64, 2, 32, torch.float32, cuda, seed=2))
    prob = quadratic_bilevel(8, 4, 4, device="cuda")
    solve(prob, make_network("ring", 8), SolverSpec(K=1, M=1, U=1),
          device="cuda")
    torch.cuda.synchronize()
    assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32
