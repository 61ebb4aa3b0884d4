"""The chunked WKV scan of the port's CUDA kernel (`csrc/rwkv6_scan.cu`),
emulated in plain PyTorch on the CPU.

The emulation keeps the kernel's structure: chunks of `WKV_CHUNK` = 16
steps (the last one padded with zero steps, so T need not be a multiple),
rows in tiles of `WKV_ROWS` = 64 (padded with zero rows), each row's
running sum of logw in log2 units taken over the chunk's four quarters of
4 steps, each quarter starting from the previous quarter's last sum; the
inter product r~ S0, the scores factored over the quarters (a cross-quarter
pair as (r_t e^{a_{t-1} - a_end(sb)}) (k_s e^{a_end(sb) - a_s}), an
in-quarter pair with its own exponential, r u k on the diagonal), each
score summed over the rows in the kernel's order (lane part p takes rows
p, p + 4, ... of every row tile, then (p0 + p1) + (p2 + p3)), the intra
term A v and the state update S = e^{a_last} S + k^T v.  It records every
exponent it forms.

It is held against `repro`'s step-by-step recurrence
(`repro.kernels.ref.rwkv6_ref`) and, at a small size, `repro`'s Pallas
kernel in interpret mode, within (1e-4, 1e-4) (atol = rtol, as
`tests/test_kernels.py` holds `repro`'s kernel), at hd 16, 64, 96, 256 and
320, T = 40 (not a multiple of the chunk), logw at -7.39 on every step
(-e^2, the steepest the tests' draw gives), at -3.4e-4 on every step
(-e^-8, the flattest) and mixed, and with bf16 inputs; and no exponent it
forms is positive.  `tests/test_torch_gpu_ops.py` holds the kernel against
the plain version on the card.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from repro.kernels import ref as jref
from repro.kernels.rwkv6_scan import rwkv6_scan as j_scan

from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv6_scan as twkv

WKV_TOL = 1e-4
LOG2E = 1.4426950408889634
L, ROWS = twkv.WKV_CHUNK, twkv.WKV_ROWS
HEAD_DIMS = [16, 64, 96, 256, 320]
LOGW = ["steep", "flat", "mixed"]


def _inputs(B, T, H, hd, logw_kind, seed):
    """0.5·N(0, 1) for r, k, v and u; logw constant at −e² or −e⁻⁸, or
    −exp(clip(N, −8, 2)) as `tests/test_kernels.py` draws it."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((B, T, H, hd)).astype(np.float32)
               for _ in range(3))
    if logw_kind == "steep":
        logw = np.full((B, T, H, hd), -np.exp(2.0), np.float32)
    elif logw_kind == "flat":
        logw = np.full((B, T, H, hd), -np.exp(-8.0), np.float32)
    else:
        logw = -np.exp(np.clip(rng.standard_normal((B, T, H, hd)), -8, 2)
                       ).astype(np.float32)
    u = (0.5 * rng.standard_normal((H, hd))).astype(np.float32)
    return r, k, v, logw, u


def _row_sums(terms: torch.Tensor) -> torch.Tensor:
    """Σ over the last (row) axis of terms (..., P) in the kernel's order:
    part p sums rows p, p + 4, ... of each 64-row tile, tile after tile;
    then (p0 + p1) + (p2 + p3)."""
    parts = terms.reshape(*terms.shape[:-1], -1, 4)     # (..., P/4, 4)
    acc = torch.zeros(parts.shape[:-2] + (4,), dtype=torch.float32)
    for m in range(parts.shape[-2]):
        acc = acc + parts[..., m, :]
    return (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])


def chunked_wkv(r, k, v, logw, u):
    """The kernel's chunked scan, f32 from a zero state; returns (out
    (B, T, H, hd), every exponent formed, concatenated)."""
    r, k, v, logw = (torch.as_tensor(a).float() for a in (r, k, v, logw))
    u = torch.as_tensor(u).float()
    B, T, H, hd = r.shape
    P = -(-hd // ROWS) * ROWS
    Tp = -(-T // L) * L
    rows_steps = (0, P - hd, 0, 0, 0, Tp - T)
    rp, kp, wp = (F.pad(a, rows_steps).permute(0, 2, 1, 3)
                  for a in (r, k, logw))                  # (B, H, Tp, P)
    vp = F.pad(v, (0, 0, 0, 0, 0, Tp - T)).permute(0, 2, 1, 3)
    up = F.pad(u, (0, P - hd))[None, :, None, :]          # (1, H, 1, P)
    S = torch.zeros((B, H, P, hd))
    out = torch.empty((B, H, Tp, hd))
    exps = []

    def ex2(x):
        exps.append(x.reshape(-1))
        return torch.exp2(x)

    tt = torch.arange(L)
    for c in range(Tp // L):
        sl = slice(c * L, c * L + L)
        rc, kc, vc = rp[:, :, sl], kp[:, :, sl], vp[:, :, sl]
        lw = wp[:, :, sl] * np.float32(LOG2E)
        a2 = torch.empty_like(lw)
        start = torch.zeros_like(lw[:, :, 0])
        starts = []
        for q in range(4):
            cs = torch.cumsum(lw[:, :, 4 * q:4 * q + 4], dim=2)
            starts.append(start)
            a2[:, :, 4 * q:4 * q + 4] = cs if q == 0 else start[:, :, None] \
                + cs
            start = a2[:, :, 4 * q + 3]
        # a_{t-1}: the previous step's sum, or the quarter's start
        before = torch.cat([starts[0][:, :, None], a2[:, :, :-1]], dim=2)
        for q in range(1, 4):
            before[:, :, 4 * q] = starts[q]
        qend = a2[:, :, 3::4]                           # (B, H, 4, P)
        alast = a2[:, :, L - 1]
        rt = rc * ex2(before)
        kh = kc * ex2(alast[:, :, None] - a2)
        dec = ex2(alast)
        kf = kc * ex2(qend[:, :, tt // 4] - a2)
        # the scores' terms, (B, H, t, s, P); 0 where s > t
        terms = torch.zeros((B, H, L, L, P))
        for t in range(L):
            for s in range(t + 1):
                if s // 4 < t // 4:
                    rf = rc[:, :, t] * ex2(before[:, :, t]
                                           - qend[:, :, s // 4])
                    terms[:, :, t, s] = rf * kf[:, :, s]
                elif s < t:
                    terms[:, :, t, s] = rc[:, :, t] * kc[:, :, s] * ex2(
                        before[:, :, t] - a2[:, :, s])
                else:
                    terms[:, :, t, s] = rc[:, :, t] * up[:, :, 0] \
                        * kc[:, :, t]
        A = _row_sums(terms)                            # (B, H, L, L)
        out[:, :, sl] = torch.matmul(rt, S) + torch.matmul(A, vc)
        S = dec[..., None] * S + torch.matmul(kh.transpose(2, 3), vc)
    return out[:, :, :T].permute(0, 2, 1, 3), torch.cat(exps)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=WKV_TOL,
                               rtol=WKV_TOL)


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("logw_kind", LOGW)
def test_chunked_scan_matches_repro_ref(hd, logw_kind):
    """T = 40: two whole chunks and a half one; every exponent ≤ 0."""
    ins = _inputs(1, 40, 2, hd, logw_kind, seed=hd)
    got, exps = chunked_wkv(*ins)
    want, _ = jref.rwkv6_ref(*(jnp.asarray(a) for a in ins))
    _close(got.numpy(), want)
    assert torch.isfinite(exps).all()
    assert exps.max().item() <= 0.0


@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("logw_kind", LOGW)
def test_chunked_scan_matches_repro_pallas_interpret(hd, logw_kind):
    """`repro`'s Pallas kernel in interpret mode (T % chunk == 0)."""
    ins = _inputs(2, 48, 2, hd, logw_kind, seed=7 + hd)
    got, _ = chunked_wkv(*ins)
    want = j_scan(*(jnp.asarray(a) for a in ins), chunk=16, interpret=True)
    _close(got.numpy(), want)


@pytest.mark.parametrize("hd", [64, 96])
def test_chunked_scan_bf16_inputs(hd):
    """bf16 r, k, v, logw: both sides compute in f32 from the same
    rounded values."""
    ins = _inputs(1, 40, 2, hd, "mixed", seed=3)
    rounded = [torch.as_tensor(a).bfloat16() for a in ins[:4]]
    got, exps = chunked_wkv(*rounded, ins[4])
    want, _ = jref.rwkv6_ref(*(jnp.asarray(t.float().numpy())
                               for t in rounded), jnp.asarray(ins[4]))
    _close(got.numpy(), want)
    assert exps.max().item() <= 0.0


@pytest.mark.parametrize("T", [1, 15, 16, 17])
def test_chunk_edges(T):
    """One step, a chunk less one, one chunk and one more step."""
    ins = _inputs(1, T, 1, 24, "mixed", seed=T)
    got, exps = chunked_wkv(*ins)
    want, _ = jref.rwkv6_ref(*(jnp.asarray(a) for a in ins))
    _close(got.numpy(), want)
    assert exps.max().item() <= 0.0


def test_the_plain_version_agrees_at_hd_320():
    """The wrapper's CPU route (the plain version, no launch) at an hd the
    old kernel refused, against the emulation."""
    ins = _inputs(1, 32, 1, 320, "mixed", seed=11)
    reset_launch_counts()
    got = twkv.rwkv6_scan(*(torch.as_tensor(a) for a in ins), chunk=16)
    assert sum(launch_counts().values()) == 0
    want, _ = chunked_wkv(*ins)
    _close(got.numpy(), want.numpy())
    _close(got.numpy(), tref.rwkv6_scan_ref(
        *(torch.as_tensor(a) for a in ins)).numpy())


# -- the launch plan --------------------------------------------------------

@pytest.mark.parametrize("B,H,hd,cols", [
    (4, 64, 64, 64),      # rwkv6-7b train_4k: 256 blocks of 64 columns
    (1, 16, 96, 16),      # 16 heads: the narrowest tile, 96 blocks
    (1, 8, 256, 16),
    (1, 8, 320, 16),      # 8 x 20 = 160 blocks
    (2, 3, 16, 16),       # hd 16 caps the tile at 16
    (1, 2, 24, 16),       # ... hd 24 at 32, whose 2 blocks are too few
    (66, 2, 32, 32),      # 132 blocks of 32 fill the card
    (33, 2, 64, 32),      # 66 blocks of 64 do not; 132 of 32 do
    (1, 132, 64, 64),
    (1, 17, 520, 64),     # 153 blocks, the state tile in device memory
])
def test_plan_wkv_cols(B, H, hd, cols):
    assert twkv.plan_wkv_cols(B, H, hd) == cols
    assert cols in twkv.WKV_COLS


def test_wkv_smem_bytes():
    """The ring (3 stages of r, k, logw row tiles and v's columns), the
    derived arrays and scores, and the state tile where it lies in shared
    memory; rwkv6-7b's launch leaves room for two blocks an SM."""
    stage = (3 * L * ROWS + L * 64) * 4
    derived = 4 * (L * (ROWS + 8) + ROWS * (L + 4) + ROWS * 108 + ROWS
                   + L * (L + 4))
    assert twkv.wkv_smem_bytes(64, 64) == 3 * stage + derived \
        + 4 * 64 * (64 + 4)
    assert twkv.wkv_smem_bytes(64, 64, state_shared=False) \
        == 3 * stage + derived
    assert 2 * (twkv.wkv_smem_bytes(64, 64) + 1024) <= 233_472
    assert twkv.wkv_state_rows(64) == 68
    assert twkv.wkv_state_rows(65) == 132
    assert twkv.wkv_state_rows(320) == 324
    # where the state tile outgrows a block, it lives in device memory
    assert twkv.wkv_smem_bytes(4096, 64) > twkv.WKV_SMEM_BYTES
    assert twkv.wkv_smem_bytes(4096, 64, 4, False) <= twkv.WKV_SMEM_BYTES


def test_the_device_route_by_shape():
    """Where the state tile outgrows a block's shared memory it lives in
    device memory: the planner's width decides where that happens (hd 513
    at 64 columns, 2,369 at 16, f32), so `tests/test_torch_gpu_ops.py`
    reaches the route by shape."""
    assert twkv.plan_wkv_cols(1, 17, 520) == 64
    assert twkv.wkv_smem_bytes(512, 64) <= twkv.WKV_SMEM_BYTES
    assert twkv.wkv_smem_bytes(513, 64) > twkv.WKV_SMEM_BYTES
    assert twkv.wkv_smem_bytes(2368, 16) <= twkv.WKV_SMEM_BYTES
    assert twkv.wkv_smem_bytes(2369, 16) > twkv.WKV_SMEM_BYTES


def test_wrapper_checks_on_the_cpu():
    """T % chunk stays `repro`'s assertion; the CPU runs the plain version
    and launches nothing."""
    x = torch.zeros((1, 32, 1, 8))
    u = torch.zeros((1, 8))
    with pytest.raises(ValueError, match="multiple of chunk"):
        twkv.rwkv6_scan(x, x, x, x, u, chunk=64)
    reset_launch_counts()
    out = twkv.rwkv6_scan(x, x, x, x, u, chunk=16)
    assert out.shape == x.shape and not out.any()
    assert sum(launch_counts().values()) == 0
