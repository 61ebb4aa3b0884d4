"""The model zoo's kernel routes on the CPU: at S % 128 == 0 every
self-attention whose query and key lengths match goes through
`repro_torch.kernels.ops.attention`, and at T % 64 == 0 the RWKV6 mix
from a zero state through `ops.wkv` (at prefill with its final state),
where on CPU tensors they run the kernels' plain versions.  Held
against `repro.models` (whose attention and WKV scan are plain) at a
GQA width, an MQA width, a sliding window (the prefill longer than the
window's cache), rwkv's state handed from prefill to decode, zamba2's
shared attention and whisper's decoder; and against the same port
model with the kernel switch off, which takes neither kernel route.

Tolerance: as test_torch_models.py (logits atol 2e-5 / rtol 1e-5): the
plain flash-attention and WKV versions compute in f32 as `repro`'s
`_sdpa` and `lax.scan` do, in other orders.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import kernel_mode
from repro_torch.kernels import ops as kops
from repro_torch.models import transformer as tf

from test_torch_models import _batch, _close, carried

S = 128
DECODE_STEPS = 2


@pytest.fixture
def calls(monkeypatch):
    """Record every call `ops.attention` / `ops.wkv` make on their kernel
    route (the wrappers `flash_attention` / `rwkv6_scan`), then run it."""
    seen = []
    attention, wkv = kops.flash_attention, kops.rwkv6_scan

    def spy_attention(q, k, v, **kw):
        seen.append(("attention", tuple(q.shape), tuple(k.shape), kw))
        return attention(q, k, v, **kw)

    def spy_wkv(r, k, v, logw, u, **kw):
        seen.append(("wkv", tuple(r.shape), kw.get("return_state", False)))
        return wkv(r, k, v, logw, u, **kw)

    monkeypatch.setattr(kops, "flash_attention", spy_attention)
    monkeypatch.setattr(kops, "rwkv6_scan", spy_wkv)
    return seen


CASES = {
    # name: (arch, config changes, calls of a forward, of a prefill)
    "gqa": ("qwen3-4b", {"num_kv_heads": 2}, 2, 2),
    "mqa": ("granite-34b", {}, 2, 2),
    "window": ("mixtral-8x7b", {"capacity_factor": 8.0}, 2, 2),
    "rwkv": ("rwkv6-7b", {}, 2, 2),
    "zamba2_shared": ("zamba2-1.2b", {}, 1, 1),
    "whisper_decoder": ("whisper-large-v3", {}, 2, 2),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    arch, changes, n_fwd, n_pre = CASES[request.param]
    return (request.param, n_fwd, n_pre, *carried(arch, **changes))


def _expected(name, seen, n, prefill):
    kind = "wkv" if name == "rwkv" else "attention"
    assert [c[0] for c in seen] == [kind] * n, seen
    for c in seen:
        if kind == "wkv":
            assert c[1][1] == S and c[2] == prefill
        else:
            q, k, kw = c[1], c[2], c[3]
            assert q[1] == k[1] == S and q[2] == k[2]    # kv heads expanded
            assert kw["causal"] is True


def test_forward_takes_the_kernel_route(case, calls):
    name, n_fwd, _, jm, jparams, tm, tparams = case
    cfg = tm.cfg
    jb, tb = _batch(cfg, 1, S, seed=3)
    with torch.no_grad():
        if cfg.encoder_decoder:
            from repro.models import whisper as jwp
            from repro_torch.models import whisper as wp
            want = jax.jit(lambda p, b: jwp.decode_tokens(
                p, cfg, b["tokens"], enc_out=jwp.encode(p, cfg, b["frames"])
            ))(jparams, jb)
            run = lambda: wp.decode_tokens(
                tparams, cfg, tb["tokens"],
                enc_out=wp.encode(tparams, cfg, tb["frames"]))
        else:
            from repro.models import transformer as jtf
            want = jax.jit(lambda p, t: jtf.forward(p, cfg, t)[0])(
                jparams, jb["tokens"])
            run = lambda: tf.forward(tparams, cfg, tb["tokens"])[0]
        got = run()
        _close(got, want)
        _expected(name, calls, n_fwd, prefill=False)
        if name == "window":
            assert all(c[3]["window"] == cfg.sliding_window for c in calls)
        calls.clear()
        with kernel_mode(False):
            plain = run()
        assert calls == []
    _close(got, np.asarray(plain))


def test_prefill_and_decode_take_the_kernel_route(case, calls):
    """Prefill of S tokens on the kernel route (a window's cache of 64
    slots is shorter than the prompt), then greedy decode on the plain
    rolling-cache route, against `repro` and the switch off."""
    name, _, n_pre, jm, jparams, tm, tparams = case
    jb, tb = _batch(tm.cfg, 1, S, seed=4)
    del jb["labels"], tb["labels"]
    C = S + DECODE_STEPS
    want, jcache = jax.jit(lambda p, b: jm.prefill(p, b, cache_len=C))(
        jparams, jb)
    j_decode = jax.jit(jm.decode_step)
    got, cache = tm.prefill(tparams, tb, cache_len=C)
    _expected(name, calls, n_pre, prefill=True)
    calls.clear()
    with kernel_mode(False):
        plain, plain_cache = tm.prefill(tparams, tb, cache_len=C)
    for _ in range(DECODE_STEPS):
        _close(got, want)
        _close(got, np.asarray(plain))
        tok = np.array(jnp.argmax(want, -1))[:, None]
        want, jcache = j_decode(jparams, jnp.asarray(tok, jnp.int32), jcache)
        got, cache = tm.decode_step(tparams, torch.as_tensor(tok), cache)
        with kernel_mode(False):
            plain, plain_cache = tm.decode_step(tparams, torch.as_tensor(tok),
                                                plain_cache)
    _close(got, want)
    assert calls == []      # decode: the plain routes only
    if name == "rwkv":      # the state the prefill handed over
        _close(cache["blocks"][0]["S"],
               np.asarray(jcache["blocks"]["S"][0]), atol=1e-4, rtol=1e-4)


def test_a_gradient_through_the_kernel_route_raises():
    """The kernels have no backward: a loss asked for a gradient on the
    kernel route refuses (no fallback), and with the switch off the same
    loss backpropagates."""
    jm, jparams, tm, tparams = carried("qwen3-4b")
    _, tb = _batch(tm.cfg, 1, S, seed=5)
    with pytest.raises(ValueError, match="requires grad"):
        tm.loss(tparams, tb)
    with kernel_mode(False):
        loss, _ = tm.loss(tparams, tb)
    loss.backward()
    assert all(p.grad is not None for p in tparams.parameters())


@pytest.mark.parametrize("impl", ["batched", "shard_map"])
def test_grouped_moe_routing_matches_repro(impl):
    """`moe_route_groups` = 2: each half of the batch routes on its own;
    `repro`'s shard_map implementation takes the batched route where no
    mesh rules are installed, as the port does on one device."""
    jm, jparams, tm, tparams = carried(
        "mixtral-8x7b", moe_route_groups=2, moe_group_impl=impl)
    jb, tb = _batch(tm.cfg, 2, 16, seed=6)
    from repro.models import transformer as jtf
    want, jaux = jax.jit(lambda p, t: jtf.forward(p, tm.cfg, t))(
        jparams, jb["tokens"])
    with torch.no_grad():
        got, aux = tf.forward(tparams, tm.cfg, tb["tokens"])
    _close(got, want)
    _close(aux, jaux, atol=1e-6, rtol=1e-5)


def test_load_lm_params_keeps_bf16_and_checks_names():
    from repro.configs import ARCHS as JARCHS
    from repro.models import build_model as j_build_model
    from repro_torch.configs import ARCHS
    from repro_torch.interop import load_lm_params

    jcfg = JARCHS["qwen3-4b"].reduced()
    jparams = jax.jit(lambda k: j_build_model(jcfg).init(k, jnp.bfloat16))(
        jax.random.PRNGKey(1))
    host = jax.tree.map(np.asarray, jparams)
    state = load_lm_params(ARCHS["qwen3-4b"].reduced(), host, device="cpu")
    assert {t.dtype for t in state.values()} == {torch.bfloat16}
    table = np.asarray(jparams["embed"]["table"].astype(jnp.float32))
    np.testing.assert_array_equal(state["embed.table"].float().numpy(), table)
    with pytest.raises(ValueError, match="names differ"):
        load_lm_params(ARCHS["yi-9b"].reduced(), host, device="cpu")
    wide = dict(host, final_norm={"scale": np.ones(7, np.float32)})
    with pytest.raises(ValueError, match="final_norm.scale: shape"):
        load_lm_params(ARCHS["qwen3-4b"].reduced(), wide, device="cpu")


@pytest.mark.parametrize("window", [0, 300])
def test_long_plain_attention_goes_in_query_chunks(window):
    """Past ATTN_CHUNK_THRESHOLD the plain route takes the queries in
    chunks of ATTN_Q_CHUNK: the same result as one masked softmax."""
    from repro_torch.models import layers
    S = layers.ATTN_CHUNK_THRESHOLD + layers.ATTN_Q_CHUNK
    gen = torch.Generator().manual_seed(9)
    q = torch.randn((1, S, 2, 8), generator=gen)
    k, v = (torch.randn((1, S, 1, 8), generator=gen) for _ in range(2))
    got = layers.sdpa_with_spec(q, k, v, torch.float32, causal=True,
                                window=window)
    i = torch.arange(S)
    mask = i[None, :] <= i[:, None]
    if window:
        mask &= (i[:, None] - i[None, :]) < window
    want = layers._sdpa(q, k, v, mask, torch.float32)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)
