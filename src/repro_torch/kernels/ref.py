"""Plain PyTorch versions of the port's CUDA kernels.

Each function computes exactly what its kernel in `csrc/` computes, in
the same order of operations, on any device.  The row-tiled halo
kernels' result does not depend on the tile, so their plain versions
(`*_halo_ref`) are the full-operand ones behind `repro`'s argument
checks (`check_halo_tile`).  The wrappers in
`repro_torch.kernels.mixing_matvec` run these for CPU tensors; the
tests and `chip_smoke.py` hold the kernels against them on the card.
Counterparts of `repro.kernels.ref`, and of the in-kernel quantizer
helpers of `repro.kernels.mixing_matvec` (`_fmix32`, `_hash_uniform`,
`_quantize`) with the comm-fused kernel bodies built on them.

Job axis (a serve bucket's gossip, `repro_torch.serve`): B jobs share
one (n, B·d) operand, column c belonging to job c // d at in-job column
c mod d.  The Neumann step then takes β as a (B,) tensor and D̃ as
(n, B); the comm-fused gossips take zp/scale as (n, B) and one seed per
job (a sequence of B ints), the hash keyed on (the job's seed, row,
in-job column).  Every job's columns are computed exactly as its solo
call computes them, so each job's output and payload are bitwise its
solo call's, and with B = 1 these are the solo calls.
"""
from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF


def ring_laplacian_ref(y: torch.Tensor, w_self: float, w_edge: float,
                       hops: int = 1) -> torch.Tensor:
    """(I − W)·Y for a circulant 2·hops-regular graph; y: (n, d).

    W row: w_self on the diagonal, w_edge at offsets ±1..±hops
    (wraparound); where ±o coincide (o = n/2) the neighbor counts once."""
    out = (1.0 - w_self) * y
    n = y.shape[0]
    for o in range(1, hops + 1):
        if (2 * o) % n == 0:
            out = out - w_edge * torch.roll(y, o, dims=0)
        else:
            out = out - w_edge * (torch.roll(y, o, dims=0)
                                  + torch.roll(y, -o, dims=0))
    return out


def circulant_mix_ref(y: torch.Tensor, w_self: float, offsets, weights,
                      laplacian: bool = False) -> torch.Tensor:
    """W·Y (or (I−W)·Y) for circulant W with W[i,(i+o)%n] = c_o; y (n,d).

    acc = w_self·y_i, then + c_o·y_{(i+o) mod n} in offset order, then
    y_i − acc for the Laplacian."""
    acc = w_self * y
    for o, c in zip(offsets, weights):
        acc = acc + c * torch.roll(y, -int(o), dims=0)
    return y - acc if laplacian else acc


def sparse_mix_ref(y: torch.Tensor, w_self: torch.Tensor,
                   row: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
                   laplacian: bool = False) -> torch.Tensor:
    """W·Y (or (I−W)·Y) from CSR triplets — the skewed-degree (star)
    path, O((nnz+n)·d); y (n, d).

    w_self: (n,) diagonal of W; row/col/val: the off-diagonal nonzeros
    (`repro_torch.topology.structure.SparseStructure`)."""
    gathered = y.index_select(0, col) * val.to(y.dtype)[:, None]
    neigh = torch.zeros_like(y).index_add_(0, row, gathered)
    acc = w_self.to(y.dtype)[:, None] * y + neigh
    return y - acc if laplacian else acc


def sparse_mix_padded_ref(y: torch.Tensor, w_self: torch.Tensor,
                          neighbors: torch.Tensor, weights: torch.Tensor,
                          laplacian: bool = False) -> torch.Tensor:
    """Same operator from the padded fixed-degree (n, k) tables,
    O(n·k·d): acc = w_self_i·y_i, then + w_ij·y_{nbr_ij} slot by slot.
    Padded slots hold the row's own index with weight 0."""
    acc = w_self.to(y.dtype)[:, None] * y
    for j in range(neighbors.shape[1]):
        acc = acc + weights[:, j:j + 1].to(y.dtype) \
            * y.index_select(0, neighbors[:, j].long())
    return y - acc if laplacian else acc


def job_columns(t: torch.Tensor, width: int) -> torch.Tensor:
    """(..., B) per-job values -> (..., B·width), each repeated over its
    job's columns."""
    return t.repeat_interleave(width, dim=-1)


def neumann_update(mix, h, hvp_h, p, d_scalar, beta):
    """One DIHGP Neumann iteration given mix = W·h (Eq. 14):

        h⁺ = (D̃h − (h − W h) − β·hvp_h − p) / D̃

    Solo: d_scalar broadcastable against h, β a number.  On a job axis
    (β a (B,) tensor): h (n, B·d) and d_scalar (n, B), each job's D̃ and
    β on its own columns."""
    if isinstance(beta, torch.Tensor):
        width = h.shape[-1] // beta.shape[0]
        d_scalar = job_columns(d_scalar, width)
        beta = job_columns(beta, width)[None, :]
    return (d_scalar * h - (h - mix) - beta * hvp_h - p) / d_scalar


def neumann_step_ref(h, hvp_h, p, d_scalar, *, w_self: float, offsets,
                     weights, beta: float) -> torch.Tensor:
    """The fused circulant Neumann step: `neumann_update` over
    `circulant_mix_ref`; d_scalar (n, 1)."""
    mix = circulant_mix_ref(h, w_self, offsets, weights)
    return neumann_update(mix, h, hvp_h, p, d_scalar, beta)


# ---------------------------------------------------------------------------
# The comm-fused kernels' quantizer (int8/int4 stochastic rounding)
# ---------------------------------------------------------------------------

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2³² for int64 x in [0, 2³²) and a 32-bit constant c,
    in two 16-bit halves so no int64 product overflows.  The hash runs
    in int64 because torch on the CPU has no right shift for uint32."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on int64 tensors holding uint32
    values (`repro.kernels.mixing_matvec._fmix32`)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def hash_uniform(seed: int, rows: torch.Tensor, cols: torch.Tensor
                 ) -> torch.Tensor:
    """U[0, 1) f32 draws keyed on (seed, global row, global column),
    bitwise `repro.kernels.mixing_matvec._hash_uniform`: the same
    element gets the same draw in every layout and on every device.
    rows/cols: integer tensors (broadcastable); seed: a Python int."""
    smix = ((int(seed) & _M32) * 0xC2B2AE3D) & _M32
    base = (_mul32(rows.long() & _M32, 0x9E3779B9) + (cols.long() & _M32)) \
        & _M32
    h = fmix32(fmix32(base ^ smix))
    return (h >> 8).to(torch.float32) * 2.0 ** -24


def quantize(x, zp, scale, u, levels: float) -> torch.Tensor:
    """Decoded stochastic-quantizer roundtrip of x given the per-row
    wire metadata: zp + scale·clip(⌊(x − zp)/scale + u⌋, 0, levels)."""
    q = torch.clamp(torch.floor((x - zp) / scale + u), 0.0, levels)
    return zp + scale * q


# elements per block of rows in `_payload`: the int64 hash temporaries
# of one block stay near 128 MB each, also for (4096, 157000) operands
_PAYLOAD_BLOCK = 1 << 24


def is_seed_table(seed) -> bool:
    """Whether `seed` is a job axis's table of seeds (a list or tuple of
    ints) rather than one send's seed."""
    return isinstance(seed, (list, tuple))


def _payload(y, zp, scale, seed, hat, bits: int) -> torch.Tensor:
    """The decoded broadcast of every row of y (n, d), quantized once:
    C(y), or hat + C(y − hat) with error feedback.  Elementwise, so
    computing it by blocks of rows changes no bit.  On a job axis (seed
    a sequence of B seeds, zp/scale (n, B)) each job's columns are its
    solo payload."""
    if is_seed_table(seed):
        seeds = [int(s) for s in seed]
        width = y.shape[1] // len(seeds)
        out = torch.empty_like(y)
        for j, s in enumerate(seeds):
            cols = slice(j * width, (j + 1) * width)
            out[:, cols] = _payload(
                y[:, cols], zp[:, j:j + 1], scale[:, j:j + 1], s,
                None if hat is None else hat[:, cols], bits)
        return out
    n, d = y.shape
    levels = float(2 ** bits - 1)
    cols = torch.arange(d, device=y.device)[None, :]
    step = max(1, _PAYLOAD_BLOCK // d)
    out = torch.empty_like(y)
    for r0 in range(0, n, step):
        rows = slice(r0, min(n, r0 + step))
        u = hash_uniform(seed, torch.arange(rows.start, rows.stop,
                                            device=y.device)[:, None], cols)
        if hat is None:
            out[rows] = quantize(y[rows], zp[rows], scale[rows], u, levels)
        else:
            out[rows] = hat[rows] + quantize(y[rows] - hat[rows], zp[rows],
                                             scale[rows], u, levels)
    return out


def circulant_mix_fused_ref(y, zp, scale, seed, hat=None, *,
                            w_self: float, offsets, weights,
                            laplacian: bool = False, bits: int = 8):
    """Comm-fused circulant mix (`_mix_fused_body`): the neighbor terms
    mix the quantized payload, the self term w_self·y_i stays exact.
    Returns out, or (out, payload) when `hat` is given (EF)."""
    pay = _payload(y, zp, scale, seed, hat, bits)
    acc = w_self * y
    for o, c in zip(offsets, weights):
        acc = acc + c * torch.roll(pay, -int(o), dims=0)
    out = y - acc if laplacian else acc
    return out if hat is None else (out, pay)


def sparse_mix_fused_ref(y, w_self, neighbors, weights, zp, scale,
                         seed, hat=None, *, laplacian: bool = False,
                         bits: int = 8):
    """Comm-fused padded gather (`_sparse_fused_body`): each gathered
    row is its source row's payload, quantized with that row's own
    zp/scale; the self term stays exact.  EF as in
    `circulant_mix_fused_ref`."""
    pay = _payload(y, zp, scale, seed, hat, bits)
    acc = w_self.to(y.dtype)[:, None] * y
    for j in range(neighbors.shape[1]):
        acc = acc + weights[:, j:j + 1].to(y.dtype) \
            * pay.index_select(0, neighbors[:, j].long())
    out = y - acc if laplacian else acc
    return out if hat is None else (out, pay)


def neumann_step_fused_ref(h, hvp_h, p, d_scalar, zp, scale, seed, *,
                           w_self: float, offsets, weights, beta: float,
                           bits: int = 8) -> torch.Tensor:
    """Comm-fused Neumann step (`_neumann_fused_body`, no EF): the W·h
    neighbor terms mix the quantized h; the self, D̃, HVP and p terms
    never cross the wire and stay exact."""
    mix = circulant_mix_fused_ref(h, zp, scale, seed, w_self=w_self,
                                  offsets=offsets, weights=weights,
                                  bits=bits)
    return neumann_update(mix, h, hvp_h, p, d_scalar, beta)


# ---------------------------------------------------------------------------
# Row-tiled (halo) entry points
# ---------------------------------------------------------------------------

def signed_offsets(offsets, n: int) -> tuple[int, ...]:
    """Cyclic offsets 0 ≤ o < n remapped to the shorter direction (o ≤
    n//2 stays +o, else o − n), as `repro`'s: the halo extents follow."""
    return tuple(o if o <= n // 2 else o - n for o in (int(o) % n
                                                        for o in offsets))


def halo_extents(offsets, n: int) -> tuple[int, int]:
    """(h_lo, h_hi): the rows of low and high halo a row tile needs."""
    signed = signed_offsets(offsets, n)
    return (max((-s for s in signed if s < 0), default=0),
            max((s for s in signed if s > 0), default=0))


def check_halo_tile(n: int, bn, h_lo: int = 0, h_hi: int = 0) -> None:
    """`repro`'s row-tile rules: bn | n, and halo extents ≤ bn so that no
    staged range wraps more than once."""
    if isinstance(bn, bool) or not isinstance(bn, int) or bn < 1:
        raise ValueError(f"bn must be a positive int, got {bn!r}")
    if n % bn:
        raise ValueError(f"n={n} not a multiple of bn={bn}")
    if max(h_lo, h_hi) > bn:
        raise ValueError(f"halo extents ({h_lo}, {h_hi}) exceed bn={bn}; "
                         f"widen the row tile or use the full-operand "
                         f"kernel")


def circulant_mix_halo_ref(y, zp=None, scale=None, seed=None, hat=None, *,
                           w_self: float, offsets, weights,
                           laplacian: bool = False, bn: int,
                           bits: int | None = None):
    """Plain version of `circulant_mix_matvec_halo`: the checks on the
    row tile, then `circulant_mix_ref` (bits None) or
    `circulant_mix_fused_ref`."""
    n = y.shape[0]
    check_halo_tile(n, bn, *halo_extents(offsets, n))
    if bits is None:
        return circulant_mix_ref(y, w_self, offsets, weights, laplacian)
    return circulant_mix_fused_ref(y, zp, scale, seed, hat, w_self=w_self,
                                   offsets=offsets, weights=weights,
                                   laplacian=laplacian, bits=bits)


def sparse_mix_halo_ref(y, w_self, neighbors, weights, zp=None, scale=None,
                        seed=None, *, laplacian: bool = False, bn: int,
                        bits: int | None = None):
    """Plain version of `sparse_mix_matvec_halo` (no EF): the checks on
    the row tile, then `sparse_mix_padded_ref` (bits None) or
    `sparse_mix_fused_ref`."""
    check_halo_tile(y.shape[0], bn)
    if bits is None:
        return sparse_mix_padded_ref(y, w_self, neighbors, weights,
                                     laplacian)
    return sparse_mix_fused_ref(y, w_self, neighbors, weights, zp, scale,
                                seed, laplacian=laplacian, bits=bits)


# ---------------------------------------------------------------------------
# Attention and the RWKV6 WKV recurrence (`repro.kernels.ref`'s
# `attention_ref` / `rwkv6_ref` and the plain versions of the kernels in
# `csrc/flash_attention.cu` and `csrc/rwkv6_scan.cu`)
# ---------------------------------------------------------------------------

NEG_INF = -1e30
# f32 scores one q chunk may hold (1 GiB): at S = 32768 the whole
# (B, H, S, S) score tensor would be 137 GB per batch row
_SCORE_ELEMS = 1 << 28


def _attention_chunked(q, k, v, *, causal: bool, window: int,
                       kernel_masks: bool, q_chunk: int | None
                       ) -> torch.Tensor:
    """Softmax attention in f32 over chunks of q rows, each against the
    keys its mask can reach; output in q's dtype.

    kernel_masks: the causal and window masks apply independently (the
    kernel's semantics); else the window applies only under causal
    (`attention_ref`'s).  Masked scores are NEG_INF, so a key outside a
    chunk's range would add exp(NEG_INF − max) = 0 to every row that has
    an unmasked key, as every row here has (key = query)."""
    B, S, H, hd = q.shape
    win = window if (kernel_masks or causal) else 0
    scale = 1.0 / math.sqrt(hd)
    if q_chunk is None:          # a chunk of ≤ win rows reaches < 2·win keys
        reach = min(S, 2 * win) if win else S
        q_chunk = max(1, min(win or S, _SCORE_ELEMS // (B * H * reach)))
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    vf_all = v.float()
    for q0 in range(0, S, q_chunk):
        q1 = min(S, q0 + q_chunk)
        lo = max(0, q0 - win + 1) if win else 0
        hi = q1 if causal else S
        qf = q[:, q0:q1].float().permute(0, 2, 1, 3)          # (B,H,c,hd)
        kf = k[:, lo:hi].float().permute(0, 2, 3, 1)          # (B,H,hd,t)
        s = torch.matmul(qf, kf) * scale
        qi = torch.arange(q0, q1, device=q.device)[:, None]
        kj = torch.arange(lo, hi, device=q.device)[None, :]
        keep = torch.ones((q1 - q0, hi - lo), dtype=torch.bool,
                          device=q.device)
        if causal:
            keep &= kj <= qi
        if win:
            keep &= (qi - kj) < win
        s = s.masked_fill(~keep, NEG_INF)
        w = torch.softmax(s, dim=-1)
        o = torch.matmul(w, vf_all[:, lo:hi].permute(0, 2, 1, 3))
        out[:, q0:q1] = o.permute(0, 2, 1, 3).to(q.dtype)
    return out


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  q_chunk: int | None = None) -> torch.Tensor:
    """Plain softmax attention (`repro.kernels.ref.attention_ref`); q, k,
    v: (B, S, H, hd), the same H.  The window applies only under causal;
    masked scores NEG_INF, softmax in f32, output in q's dtype.  Runs in
    chunks of q rows (`q_chunk`, by default sized to 1 GiB of scores),
    which changes no result."""
    return _attention_chunked(q, k, v, causal=causal, window=window,
                              kernel_masks=False, q_chunk=q_chunk)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        q_chunk: int | None = None) -> torch.Tensor:
    """Plain version of the flash-attention kernel (`repro`'s
    `flash_attention`): the causal mask and the window mask
    (q − k) < window apply independently, so the window holds with
    causal=False too; masked scores NEG_INF, f32 online-softmax
    arithmetic (here one softmax per chunk), output in q's dtype.  Every
    row keeps its own key, so the kernel's acc / max(l, 1e-30) is the
    softmax here.  q-chunked as `attention_ref`."""
    return _attention_chunked(q, k, v, causal=causal, window=window,
                              kernel_masks=True, q_chunk=q_chunk)


def rwkv6_ref(r, k, v, logw, u, S0=None):
    """The WKV recurrence step by step (`repro.kernels.ref.rwkv6_ref`):

        out_t = r_t (S + diag(u) k_tᵀ v_t),  S ← diag(e^{logw_t}) S + k_tᵀ v_t

    r, k, v, logw: (B, T, H, hd); u: (H, hd); S0: (B, H, hd, hd) or None
    (zeros).  Returns (out (B, T, H, hd) f32, S_T)."""
    B, T, H, hd = r.shape
    S = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device) \
        if S0 is None else S0.float()
    rf, kf, vf, wf = (a.float() for a in (r, k, v, logw))
    uf = u.float()
    out = torch.empty((B, T, H, hd), dtype=torch.float32, device=r.device)
    for t in range(T):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        out[:, t] = torch.einsum("bhk,bhkv->bhv", rf[:, t],
                                 S + uf[:, :, None] * kv)
        S = torch.exp(wf[:, t])[..., None] * S + kv
    return out, S


def rwkv6_scan_ref(r, k, v, logw, u, *, chunk: int = 64) -> torch.Tensor:
    """Plain version of the RWKV6 scan kernel: `rwkv6_ref(...)[0]` in f32
    from a zero state.  The recurrence does not depend on `chunk`, which
    only `repro`'s TPU grid used; the wrapper checks T % chunk."""
    return rwkv6_ref(r, k, v, logw, u)[0]
