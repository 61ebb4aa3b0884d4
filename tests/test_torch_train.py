"""The port's training step (`repro_torch.models.steps.make_train_step`)
against `repro`'s on the CPU, outside any mesh or sharding rules (as
`jax.jit(make_train_step(...))` runs there), on `repro`'s parameters
carried across by `repro_torch.interop.load_lm_params`.

Both take two AdamW steps under the launcher's schedule
(`cosine_schedule(3e-4, 1, 4)`, its default rate) on the same synthetic
token batches (whisper: the same numpy frames); the losses, the aux
metrics, and the parameters and AdamW moments after the second step are
held to rtol 1e-4 / atol 1e-5.  The parameters go through AdamW's
normalised update, which maps a gradient element of order eps to an
update of order the rate whatever its last digits, so their agreement
scales with the rate: at the launcher's 3e-4 the largest difference is
a few 1e-6.

Also: the step with the kernel switch on at a kernel-route shape (S %
128 == 0) reaches neither kernel wrapper and leaves the switch as it
found it; clipping active; the microbatch split's validation.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.models.steps import make_train_step as j_make_train_step
from repro.optim import adamw as j_adamw
from repro.optim import cosine_schedule as j_cosine_schedule

from repro_torch.configs import get_config
from repro_torch.data import TokenDataConfig, make_token_batch
from repro_torch.interop import load_lm_params, stack_layers
from repro_torch.kernels import kernel_mode, kernels_enabled
from repro_torch.kernels import ops as kops
from repro_torch.models import build_model
from repro_torch.models.layers import param_tree
from repro_torch.models.steps import make_train_step
from repro_torch.optim import adamw, cosine_schedule, global_norm

TOL = dict(rtol=1e-4, atol=1e-5)
LR, WARMUP, TOTAL = 3e-4, 1, 4
B, S, STEPS = 4, 16, 2


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """Torch's CPU ops on one thread for the module.  The suite runs its
    files in parallel workers, and torch's default of one thread per core
    in each worker oversubscribes the cores several times over: a step
    that takes 0.3 s alone took a minute under the whole suite.  Left at
    one after the module: setting it back above one makes MKL's LU hang
    in a later `torch.linalg.solve`."""
    torch.set_num_threads(1)


# (arch, microbatches, clip_norm): each architecture once, microbatches
# 1 and 2 both taken, one case with clipping active; granite-moe-3b-a800m
# (the aux loss) and whisper-large-v3 (frames) are in
# test_torch_train_archs.py
CASES = [("qwen3-4b", 2, 0.05), ("rwkv6-7b", 1, 1.0)]


def carried(arch, seed=0):
    """(repro model, its params, port model, port parameter tree) on the
    same weights at `reduced()`."""
    cfg = get_config(arch).reduced()
    jm = j_build_model(j_get_config(arch).reduced())
    jparams = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    tm = build_model(cfg)
    mod = tm.init(device="meta")
    mod.load_state_dict(load_lm_params(cfg, jax.tree.map(np.asarray, jparams),
                                       device="cpu"), assign=True)
    return jm, jparams, tm, param_tree(mod)


def batches(cfg, steps=STEPS, batch=B, seq=S):
    """[(repro batch, port batch)] of synthetic tokens (and frames)."""
    data = TokenDataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                           global_batch=batch, seed=0)
    out = []
    for step in range(steps):
        tb = make_token_batch(data, step, device="cpu")
        jb = {k: jnp.asarray(v.numpy().astype(np.int32))
              for k, v in tb.items()}
        if cfg.encoder_decoder:
            fr = (0.02 * np.random.default_rng(step).standard_normal(
                (batch, cfg.encoder_frames, cfg.d_model))).astype(np.float32)
            jb["frames"], tb["frames"] = jnp.asarray(fr), torch.tensor(fr)
        out.append((jb, tb))
    return out


def tree_close(port_tree, repro_tree, what):
    want = jax.tree_util.tree_flatten_with_path(repro_tree)[0]
    got = jax.tree.map(lambda t: t.detach().numpy(), stack_layers(port_tree))
    got = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=f"{what} {path}",
                                   **TOL)


def run_port(tm, params, data, microbatches, clip_norm):
    opt = adamw(cosine_schedule(LR, WARMUP, TOTAL))
    step = make_train_step(tm, opt, microbatches=microbatches,
                           clip_norm=clip_norm)
    state, metrics = opt.init(params), []
    for _, tb in data:
        params, state, m = step(params, state, tb)
        metrics.append(m)
    return params, state, metrics


def run_both(arch, microbatches, clip_norm):
    jm, jparams, tm, params = carried(arch)
    data = batches(tm.cfg)
    jopt = j_adamw(j_cosine_schedule(LR, WARMUP, TOTAL))
    jstep = jax.jit(j_make_train_step(jm, jopt, microbatches=microbatches,
                                      clip_norm=clip_norm))
    jstate, jmetrics = jopt.init(jparams), []
    for jb, _ in data:
        jparams, jstate, m = jstep(jparams, jstate, jb)
        jmetrics.append(m)
    return (run_port(tm, params, data, microbatches, clip_norm),
            (jparams, jstate, jmetrics))


def check_against_repro(arch, microbatches, clip_norm):
    (params, state, metrics), (jparams, jstate, jmetrics) = run_both(
        arch, microbatches, clip_norm)
    for m, jm_ in zip(metrics, jmetrics):
        assert set(m) == set(jm_)
        assert set(m) >= {"loss"}
        for k in m:
            np.testing.assert_allclose(m[k].numpy(), np.asarray(jm_[k]),
                                       err_msg=k, **TOL)
    assert int(state.step) == int(jstate.step) == STEPS
    tree_close(params, jparams, "params")
    tree_close(state.mu, jstate.mu, "mu")
    tree_close(state.nu, jstate.nu, "nu")


@pytest.mark.parametrize("arch,microbatches,clip_norm", CASES)
def test_train_step_matches_repro(arch, microbatches, clip_norm):
    check_against_repro(arch, microbatches, clip_norm)


def test_clipping_is_active():
    """The clip case's first moments are the unclipped run's scaled down:
    the raw gradient's global norm is over clip_norm."""
    _, _, tm, params = carried("qwen3-4b")
    data = batches(tm.cfg)
    clipped = run_port(tm, params, data, 2, 0.05)[1]
    free = run_port(tm, params, data, 2, 1e9)[1]
    assert global_norm(clipped.mu) < 0.5 * global_norm(free.mu)


def test_step_runs_the_plain_routes_and_keeps_the_switch(monkeypatch):
    """At kernel-route shapes with the switch on, `Model.loss` would send
    attention and the WKV mix to the kernel wrappers, which refuse a
    gradient; the step takes the plain routes inside its own
    `kernel_mode(False)` and leaves the switch on."""
    calls = []
    for name in ("flash_attention", "rwkv6_scan"):
        real = getattr(kops, name)
        monkeypatch.setattr(kops, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    # the shortest kernel-route shapes: S % 128 == 0 for attention, T %
    # 64 == 0 for the WKV scan
    for arch, seq in (("qwen3-4b", 128), ("rwkv6-7b", 64)):
        _, _, tm, params = carried(arch)
        opt = adamw(1e-3)
        step = make_train_step(tm, opt)
        tb = batches(tm.cfg, steps=1, batch=2, seq=seq)[0][1]
        with kernel_mode(True):
            new, _, m = step(params, opt.init(params), tb)
            assert kernels_enabled()
        assert np.isfinite(float(m["loss"]))
        with torch.no_grad(), kernel_mode(True):      # the serving forward
            tm.loss(params, tb)
    assert calls.count("flash_attention") == 2
    assert calls.count("rwkv6_scan") == 2
    assert set(calls) == {"flash_attention", "rwkv6_scan"}


def test_microbatch_split_is_checked():
    _, _, tm, params = carried("qwen3-4b")
    opt = adamw(1e-3)
    tb = batches(tm.cfg, steps=1, batch=3)[0][1]
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(tm, opt, microbatches=2)(params, opt.init(params), tb)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(tm, opt, microbatches=0)
