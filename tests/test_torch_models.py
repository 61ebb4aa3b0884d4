"""The port's model zoo against `repro.models` on the CPU, for every
architecture at its `reduced()` size in f32, on `repro`'s parameters
carried across by `repro_torch.interop.load_lm_params`: the state dict's
names, shapes and dtypes, the logical axes, the parameter count, and the
forward logits and `loss`.  Prefill and greedy decode are in
test_torch_models_serve.py.

Tolerance: both run the same f32 arithmetic in other reduction orders
(matmuls, softmax sums, MoE scatter-adds); logits of size ~1 agree to
~2e-6 at these sizes, held at atol 2e-5 / rtol 1e-5, the loss at
atol 1e-5.

The kernel routes (`ops.attention` at S % 128 == 0, `ops.wkv` at T % 64
== 0) are in test_torch_models_routes.py.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.configs import ARCHS as JARCHS
from repro.models import build_model as j_build_model

from repro_torch.configs import ARCHS
from repro_torch.interop import load_lm_params
from repro_torch.models import build_model
from repro_torch.models import transformer as tf
from repro_torch.models import whisper as wp

ALL_ARCHS = sorted(ARCHS)
LOGIT_TOL = dict(atol=2e-5, rtol=1e-5)


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    labs = rng.integers(0, cfg.vocab_size, (B, S))
    labs[0, :2] = -1                       # ignored labels
    jb = {"tokens": jnp.asarray(toks, jnp.int32),
          "labels": jnp.asarray(labs, jnp.int32)}
    tb = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labs)}
    if cfg.encoder_decoder:
        fr = (0.02 * rng.standard_normal(
            (B, cfg.encoder_frames, cfg.d_model))).astype(np.float32)
        jb["frames"], tb["frames"] = jnp.asarray(fr), torch.as_tensor(fr)
    return jb, tb


def carried(arch, **replace):
    """(repro model, its params, port model, port params) on the same
    weights, at `reduced()` with `replace` applied to both configs."""
    jcfg = dataclasses.replace(JARCHS[arch].reduced(), **replace)
    tcfg = dataclasses.replace(ARCHS[arch].reduced(), **replace)
    jm = j_build_model(jcfg)
    jparams = jax.jit(jm.init)(jax.random.PRNGKey(7))
    tm = build_model(tcfg)
    tparams = tm.init(device="meta")
    tparams.load_state_dict(
        load_lm_params(tcfg, jax.tree.map(np.asarray, jparams),
                       device="cpu"),
        assign=True)
    return jm, jparams, tm, tparams


@pytest.fixture(scope="module", params=ALL_ARCHS)
def pair(request):
    arch = request.param
    # MoE: a capacity no token overflows, so prefill and decode route alike
    extra = {"capacity_factor": 8.0} if ARCHS[arch].num_experts else {}
    return (arch, *carried(arch, **extra))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               **(tol or LOGIT_TOL))


def test_state_dict_names_shapes_and_dtypes(pair):
    arch, jm, jparams, tm, tparams = pair
    jleaves = jax.tree_util.tree_leaves_with_path(jparams)
    n_stacked = sum(int(np.asarray(leaf).shape[0])
                    for path, leaf in jleaves
                    if path[0].key in ("blocks", "enc_layers", "dec_layers"))
    n_flat = sum(1 for path, _ in jleaves
                 if path[0].key not in ("blocks", "enc_layers", "dec_layers"))
    assert len(list(tparams.parameters())) == n_stacked + n_flat
    assert all(p.dtype == torch.float32 for p in tparams.parameters())
    assert tm.param_count() == jm.param_count()
    # layer i of the port is slice i of repro's stacked leaf
    key = "enc_layers" if tm.cfg.encoder_decoder else "blocks"
    name, leaf = next((".".join(str(k.key) for k in path), leaf)
                      for path, leaf in jleaves if path[0].key == key)
    rest = name.split(".", 1)[1]
    np.testing.assert_array_equal(
        tparams.get_parameter(f"{key}.1.{rest}").detach().numpy(),
        np.asarray(leaf)[1])


def test_param_axes_match_repro(pair):
    """Every parameter's logical axes are `repro`'s leaf's, less the
    stacked layer axis."""
    arch, jm, jparams, tm, tparams = pair
    jaxes = dict(
        (".".join(str(k.key) for k in path), axes) for path, axes in
        jax.tree_util.tree_leaves_with_path(
            jm.param_axes(), is_leaf=lambda t: isinstance(t, tuple)))
    got = tm.param_axes()
    assert len(got) == len(list(tparams.parameters()))
    for name, axes in got.items():
        parts = name.split(".")
        if parts[0] in ("blocks", "enc_layers", "dec_layers"):
            want = jaxes[".".join([parts[0]] + parts[2:])][1:]
        else:
            want = jaxes[name]
        assert axes == tuple(want), name
        assert len(axes) == tparams.get_parameter(name).dim()


def test_forward_logits_and_loss_match_repro(pair):
    arch, jm, jparams, tm, tparams = pair
    cfg = tm.cfg
    jb, tb = _batch(cfg, 2, 16, seed=1)
    with torch.no_grad():
        if cfg.encoder_decoder:
            from repro.models import whisper as jwp
            want = jax.jit(lambda p, b: jwp.decode_tokens(
                p, cfg, b["tokens"], enc_out=jwp.encode(p, cfg, b["frames"])
            ))(jparams, jb)
            got = wp.decode_tokens(tparams, cfg, tb["tokens"],
                                   enc_out=wp.encode(tparams, cfg,
                                                     tb["frames"]))
        else:
            from repro.models import transformer as jtf
            want, jaux = jax.jit(lambda p, t: jtf.forward(p, cfg, t))(
                jparams, jb["tokens"])
            got, aux = tf.forward(tparams, cfg, tb["tokens"])
            _close(aux, jaux, atol=1e-5, rtol=1e-5)
        _close(got, want)
        jloss, jmetrics = jax.jit(jm.loss)(jparams, jb)
        loss, metrics = tm.loss(tparams, tb)
    _close(loss, jloss, atol=1e-5, rtol=1e-6)
    assert set(metrics) == set(jmetrics)
