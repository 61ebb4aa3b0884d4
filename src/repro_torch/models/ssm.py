"""Sequence mixers without attention: RWKV6 ("Finch") and Mamba2 (SSD).

Counterpart of `repro.models.ssm`.  Both are linear recurrences with
data-dependent decay.

RWKV6 time-mix (per head, state S ∈ R^{hd×hd}):
    S_t = diag(w_t) S_{t-1} + k_tᵀ v_t
    o_t = r_t (S_{t-1} + diag(u) k_tᵀ v_t)
with per-channel data-dependent decay w_t = exp(-exp(w̃_t)) ∈ (0,1).
From a zero state — a forward with no cache, or a prefill — the WKV mix
goes through `repro_torch.kernels.ops.wkv` (the chunked-scan kernel
where the switch is on and T % 64 == 0), which at prefill also returns
the final state; from a given state (decode) it runs the plain
recurrence `kernels.ref.rwkv6_ref(..., S0)`.  r, k, v and log w enter
the mix in f32.

Mamba2 SSD (per head, state S ∈ R^{hd×N}):
    S_t = a_t S_{t-1} + (Δ_t x_t) ⊗ B_t ,   a_t = exp(-Δ_t e^{A_log})
    y_t = S_t C_t + D x_t
`repro` has no kernel for it, so its scan is a plain loop over time here
as there.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.sharding import shard
from ..kernels import ops as kops
from ..kernels import ref as kref
from .layers import Maker, Params, rmsnorm

WKV_CHUNK = 64      # ops.wkv's time block: the kernel route needs T % 64


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def token_shift(x, prev=None):
    """x_{t-1} along seq; position 0 sees `prev` (decode carry) or zeros."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    else:
        prev = prev[:, None, :]
    return torch.cat([prev, x[:, :-1]], dim=1)


def _ddlerp(x, xprev, mu, w1, w2):
    """RWKV6 data-dependent lerp: mix = mu + tanh((x+(xp-x)mu_x) W1) W2."""
    dyn = torch.tanh((x + (xprev - x) * mu["base"]) @ w1) @ w2
    m = mu["mix"] + dyn
    return x + (xprev - x) * m


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------

RWKV_LORA = 32


def init_rwkv_time_mix(mk: Maker, cfg) -> dict:
    d = cfg.d_model
    hd = cfg.rwkv_head_size
    H = d // hd
    lo = RWKV_LORA

    def mix():
        return {"base": mk((d,), (None,), scale=0.5),
                "mix": mk((d,), (None,), scale=0.5)}

    return {
        "mu_r": mix(), "mu_k": mix(), "mu_v": mix(), "mu_w": mix(),
        "mu_g": mix(),
        "lora_w1": mk((d, lo), (None, None)),
        "lora_w2": mk((lo, d), (None, None)),
        "wr": mk((d, d), ("fsdp", "rwkv_heads")),
        "wk": mk((d, d), ("fsdp", "rwkv_heads")),
        "wv": mk((d, d), ("fsdp", "rwkv_heads")),
        "wg": mk((d, d), ("fsdp", "rwkv_heads")),
        "wo": mk((d, d), ("rwkv_heads", "fsdp")),
        "w_base": mk((d,), (None,), scale=0.5),
        "decay_w1": mk((d, lo * 2), (None, None)),
        "decay_w2": mk((lo * 2, d), (None, None)),
        "u": mk((H, hd), ("rwkv_heads", None), scale=0.5),
        "ln_x": mk((d,), (None,), init="ones"),
    }


def _rwkv_proj(p, x, xprev):
    """Shared r/k/v/g/decay projections for train and decode paths."""
    lw1, lw2 = p["lora_w1"], p["lora_w2"]
    r = _ddlerp(x, xprev, p["mu_r"], lw1, lw2) @ p["wr"]
    k = _ddlerp(x, xprev, p["mu_k"], lw1, lw2) @ p["wk"]
    v = _ddlerp(x, xprev, p["mu_v"], lw1, lw2) @ p["wv"]
    g = F.silu(_ddlerp(x, xprev, p["mu_g"], lw1, lw2) @ p["wg"])
    xw = _ddlerp(x, xprev, p["mu_w"], lw1, lw2)
    dyn = torch.tanh(xw @ p["decay_w1"]) @ p["decay_w2"]
    # log-decay in [-exp(4), -exp(-8)] ⊂ (-55, 0)
    logw = -torch.exp(torch.clamp(p["w_base"] + dyn, -8.0, 4.0))
    return r, k, v, g, logw


def rwkv_wkv_scan(r, k, v, logw, u, S0=None, *, final_state: bool = True):
    """The WKV recurrence.  r/k/v/logw: (B,T,H,hd) f32; u: (H,hd); S0:
    (B,H,hd,hd) f32, or None for a zero state → (out (B,T,H,hd), S_T),
    S_T None where not `final_state` (a forward with no cache).

    From a zero state `ops.wkv` (the kernel where its route applies);
    from S0 the step-by-step plain recurrence."""
    if S0 is not None:
        return kref.rwkv6_ref(r, k, v, logw, u, S0)
    if final_state:
        return kops.wkv(r, k, v, logw, u, chunk=WKV_CHUNK, return_state=True)
    return kops.wkv(r, k, v, logw, u, chunk=WKV_CHUNK), None


def rwkv_time_mix(p: Params, x, cfg, state=None, *, fresh: bool = False):
    """x: (B,T,D). state: None (train) or {"x": (B,D), "S": (B,H,hd,hd)}.
    `fresh`: the state is the empty one (a prefill from pos 0), so the
    scan starts from zero.  Returns (out, new_state)."""
    B, T, D = x.shape
    hd = cfg.rwkv_head_size
    H = D // hd
    prev_x = None if state is None or fresh else state["x"]
    xprev = token_shift(x, prev_x)
    r, k, v, g, logw = _rwkv_proj(p, x, xprev)
    heads = lambda z: z.reshape(B, T, H, hd).float()
    r, k, v, logw = heads(r), heads(k), heads(v), heads(logw)
    r = shard(r, "batch", None, "rwkv_heads", None)
    S0 = None if state is None or fresh else state["S"]
    u = p["u"].float()
    if not torch.is_grad_enabled():   # no graph is built: a plain operand
        u = u.detach()
    out, S = rwkv_wkv_scan(r, k, v, logw, u, S0,
                           final_state=state is not None)
    out = out.reshape(B, T, D).to(x.dtype)
    out = rmsnorm({"scale": p["ln_x"]}, out)        # per-channel group norm
    out = (out * g) @ p["wo"]
    new_state = {"x": x[:, -1], "S": S}
    return shard(out, "batch", None, None), new_state


def init_rwkv_channel_mix(mk: Maker, cfg) -> dict:
    d, Fd = cfg.d_model, cfg.d_ff
    return {
        "mu_k": mk((d,), (None,), scale=0.5),
        "mu_r": mk((d,), (None,), scale=0.5),
        "wk": mk((d, Fd), ("fsdp", "ffn")),
        "wv": mk((Fd, d), ("ffn", "fsdp")),
        "wr": mk((d, d), ("fsdp", None)),
    }


def rwkv_channel_mix(p: Params, x, state=None):
    prev_x = None if state is None else state["x"]
    xprev = token_shift(x, prev_x)
    xk = x + (xprev - x) * p["mu_k"]
    xr = x + (xprev - x) * p["mu_r"]
    k = torch.square(torch.relu(xk @ p["wk"]))
    k = shard(k, "batch", None, "ffn")
    out = torch.sigmoid(xr @ p["wr"]) * (k @ p["wv"])
    return shard(out, "batch", None, None), {"x": x[:, -1]}


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------

def mamba_dims(cfg):
    d_inner = 2 * cfg.d_model
    H = d_inner // cfg.mamba_head_dim
    return d_inner, H, cfg.ssm_state


def init_mamba2(mk: Maker, cfg) -> dict:
    d = cfg.d_model
    d_inner, H, N = mamba_dims(cfg)
    K = cfg.conv_kernel
    return {
        "in_z": mk((d, d_inner), ("fsdp", "ffn")),
        "in_x": mk((d, d_inner), ("fsdp", "ffn")),
        "in_B": mk((d, N), (None, None)),
        "in_C": mk((d, N), (None, None)),
        "in_dt": mk((d, H), (None, "ffn")),
        "dt_bias": mk((H,), ("ffn",), init="zeros"),
        "A_log": mk((H,), ("ffn",), scale=0.5),
        "D": mk((H,), ("ffn",), init="ones"),
        "conv": mk((K, d_inner), (None, "ffn"), scale=0.5),
        "out": mk((d_inner, d), ("ffn", "fsdp")),
    }


def causal_conv1d(x, w, prev=None):
    """Depthwise causal conv: x (B,T,C), w (K,C); prev (B,K-1,C) carry."""
    K = w.shape[0]
    if prev is None:
        prev = torch.zeros_like(x[:, :1]).repeat(1, K - 1, 1)
    xp = torch.cat([prev, x], dim=1)                  # (B, T+K-1, C)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(K))
    return out, xp[:, xp.shape[1] - (K - 1):]         # (out, new carry)


def mamba_ssd_scan(xh, Bm, Cm, dt, a_log, S0):
    """xh: (B,T,H,hd); Bm/Cm: (B,T,N); dt: (B,T,H); S0: (B,H,hd,N)."""
    S = S0
    ys = []
    for t in range(xh.shape[1]):
        xt, bt, ct, dtt = xh[:, t], Bm[:, t], Cm[:, t], dt[:, t]
        at = torch.exp(-dtt * torch.exp(a_log))       # (B,H)
        upd = (dtt[..., None] * xt)[..., None] * bt[:, None, None, :]
        S = at[..., None, None] * S + upd             # (B,H,hd,N)
        ys.append(torch.einsum("bhkn,bn->bhk", S, ct))
    return torch.stack(ys, dim=1), S


def mamba2(p: Params, x, cfg, state=None):
    """x: (B,T,D). state: None or {"conv": (B,K-1,d_inner),
    "S": (B,H,hd,N)}.  Returns (out, new_state)."""
    B, T, D = x.shape
    d_inner, H, N = mamba_dims(cfg)
    hd = cfg.mamba_head_dim
    z = F.silu(x @ p["in_z"])
    xin = x @ p["in_x"]
    conv_prev = None if state is None else state["conv"]
    xin, conv_carry = causal_conv1d(xin, p["conv"], conv_prev)
    xin = F.silu(xin)
    xin = shard(xin, "batch", None, "ffn")
    Bm = x @ p["in_B"]                               # (B,T,N)
    Cm = x @ p["in_C"]
    dt = F.softplus(x @ p["in_dt"] + p["dt_bias"])   # (B,T,H)
    xh = xin.reshape(B, T, H, hd)
    S0 = torch.zeros((B, H, hd, N), dtype=torch.float32, device=x.device) \
        if state is None else state["S"]
    y, S = mamba_ssd_scan(xh.float(), Bm.float(), Cm.float(), dt.float(),
                          p["A_log"].float(), S0)
    y = y + p["D"][None, None, :, None] * xh.float()
    y = (y.reshape(B, T, d_inner).to(x.dtype)) * z
    out = y @ p["out"]
    return shard(out, "batch", None, None), {"conv": conv_carry, "S": S}
