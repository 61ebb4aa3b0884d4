"""The port's cost model (`repro_torch.launch.costs`) against
`repro.launch.costs` on the CPU: every function on every architecture ×
input shape gives the same float (both are the same Python arithmetic on
the same configuration fields, so equality is exact).  `repro`'s module
imports nothing of XLA's device setup, so it runs in this process.
"""
from __future__ import annotations

import dataclasses

import pytest
from repro.configs import ARCHS as JARCHS
from repro.configs import INPUT_SHAPES as JSHAPES
from repro.launch import costs as jc

from repro_torch.configs import ARCHS, INPUT_SHAPES
from repro_torch.launch import costs as tc

PAIRS = [(a, s) for a in sorted(ARCHS) for s in INPUT_SHAPES]


def test_the_same_architectures_and_shapes():
    assert sorted(ARCHS) == sorted(JARCHS)
    assert list(INPUT_SHAPES) == list(JSHAPES)
    for name, shape in INPUT_SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(JSHAPES[name])


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_costs_equal_repros(arch, shape):
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    s, js = INPUT_SHAPES[shape], JSHAPES[shape]
    assert tc.flops_estimate(cfg, s) == jc.flops_estimate(jcfg, js)
    for kw in ({}, {"ctx": 333.0}, {"batch": 3}):
        assert tc.forward_flops(cfg, s.seq_len, **kw) == \
            jc.forward_flops(jcfg, js.seq_len, **kw)
    n = cfg.active_param_count()
    assert n == jcfg.active_param_count()
    assert tc.model_flops_convention(cfg, s, n) == \
        jc.model_flops_convention(jcfg, js, n)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_per_family_helpers_and_depth_equal_repros(arch):
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    for name in ("_ffn_flops_per_token", "_rwkv_flops_per_token",
                 "_mamba_flops_per_token"):
        if name == "_mamba_flops_per_token" and not cfg.mamba_head_dim:
            continue
        assert getattr(tc, name)(cfg) == getattr(jc, name)(jcfg), name
    if cfg.num_heads:
        for ctx in (1.0, 2048.0):
            assert tc._attn_flops_per_token(cfg, ctx) == \
                jc._attn_flops_per_token(jcfg, ctx)
    assert tc.depth_pair(cfg) == jc.depth_pair(jcfg)
    for layers in tc.depth_pair(cfg):
        got = dataclasses.asdict(tc.reduced_depth(cfg, layers))
        assert got == dataclasses.asdict(jc.reduced_depth(jcfg, layers))
        assert got["num_layers"] == layers


@pytest.mark.parametrize("small,large,l_small,l_large,full", [
    (10.0, 18.0, 2, 4, 36), (3.5, 7.25, 4, 8, 38), (1e12, 1.5e12, 2, 4, 2)])
def test_affine_correct_equals_repros(small, large, l_small, l_large, full):
    assert tc.affine_correct(small, large, l_small, l_large, full) == \
        jc.affine_correct(small, large, l_small, l_large, full)
