"""The LM workload's configs, synthetic data, sharding rules and meshes in
the port against `repro` on the CPU: every `ARCHS` entry and its
`reduced()` equal field for field, with the derived properties; the
synthetic tokens equal bit for bit; `shard` a no-op on one device; the
logical-to-mesh table and the per-leaf placements of
`tree_param_sharding` the same as `repro`'s on a 1×1 host mesh.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh
from repro import configs as jconfigs
from repro.data import synthetic as jsyn
from repro.distributed import sharding as jsh
from repro.models import build_model as j_build_model

from repro_torch import configs as tconfigs
from repro_torch.data import synthetic as tsyn
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import mesh as tmesh

ALL_ARCHS = sorted(jconfigs.ARCHS)
DERIVED = ("resolved_head_dim", "padded_vocab", "q_dim", "kv_dim")
METHODS = ("block_kinds", "shared_attn_positions", "param_count",
           "active_param_count")


def test_registry_matches_repro():
    assert list(tconfigs.ARCHS) == list(jconfigs.ARCHS)
    assert {k: dataclasses.asdict(v) for k, v in
            tconfigs.INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.INPUT_SHAPES.items()}
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("gpt-2")
    from repro.configs import bilevel_mlp as jmlp
    from repro_torch.configs import bilevel_mlp as tmlp
    assert (tmlp.N_AGENTS, tmlp.INPUT_DIM, tmlp.HIDDEN, tmlp.N_CLASSES) == \
        (jmlp.N_AGENTS, jmlp.INPUT_DIM, jmlp.HIDDEN, jmlp.N_CLASSES)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_arch_config_matches_repro(arch, reduced):
    jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    assert type(tc).__module__.startswith("repro_torch.")
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for name in DERIVED:
        assert getattr(tc, name) == getattr(jc, name), name
    for name in METHODS:
        assert getattr(tc, name)() == getattr(jc, name)(), name


def _cfgs():
    return [jsyn.TokenDataConfig(vocab_size=512, seq_len=48, global_batch=3,
                                 seed=5),
            jsyn.TokenDataConfig(vocab_size=151_936, seq_len=64,
                                 global_batch=1, n_domains=4, zipf_a=1.1,
                                 markov_weight=0.7, seed=11)]


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("biased", [False, True])
def test_token_batches_equal_repro_bitwise(which, biased):
    jcfg = _cfgs()[which]
    tcfg = tsyn.TokenDataConfig(**dataclasses.asdict(jcfg))
    bias = jsyn.agent_domain_bias(5, jcfg.n_domains, 0.6)[3] if biased \
        else None
    jb = list(jsyn.token_batches(jcfg, 2, bias))
    tb = list(tsyn.token_batches(tcfg, 2, bias, device="cpu"))
    for j, t in zip(jb, tb):
        for key in ("tokens", "labels"):
            assert t[key].dtype == torch.int64
            assert t[key].device.type == "cpu"
            np.testing.assert_array_equal(t[key].numpy(),
                                          np.asarray(j[key]))
    assert not torch.equal(tb[0]["tokens"], tb[1]["tokens"])


def test_agent_domain_bias_and_batch_spec():
    np.testing.assert_array_equal(tsyn.agent_domain_bias(10, 4, 0.3),
                                  jsyn.agent_domain_bias(10, 4, 0.3))
    spec = tsyn.lm_batch_spec(4096, 8)
    jspec = jsyn.lm_batch_spec(4096, 8)
    assert set(spec) == set(jspec) == {"tokens", "labels"}
    for key, t in spec.items():
        assert t.device.type == "meta" and t.dtype == torch.int64
        assert tuple(t.shape) == jspec[key].shape
    assert set(tsyn.lm_batch_spec(16, 2, with_labels=False)) == {"tokens"}


def test_make_token_batch_runs_on_cuda_unless_told_cpu(monkeypatch):
    cfg = tsyn.TokenDataConfig(vocab_size=64, seq_len=8, global_batch=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsyn.make_token_batch(cfg, 0)
    assert tsyn.make_token_batch(cfg, 0, device="cpu")["tokens"].shape \
        == (1, 8)


@pytest.fixture(scope="module")
def host_mesh():
    """The port's 1×1 host mesh (a one-rank gloo group on this process,
    torn down after) and `repro`'s on one device."""
    created = not dist.is_initialized()
    mesh = tmesh.make_host_mesh(device_type="cpu")
    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                 ("data", "model"))
    yield mesh, jmesh
    if created:
        dist.destroy_process_group()


def _spec_of(placements, mesh_dims, ndim):
    """Placements back to a PartitionSpec-like tuple (entries normalised
    to tuples of mesh dims, None where replicated)."""
    per_dim = [[] for _ in range(ndim)]
    for name, pl in zip(mesh_dims, placements):
        if pl.is_shard():
            per_dim[pl.dim].append(name)
    return tuple(tuple(d) if d else None for d in per_dim)


def _norm(spec):
    return tuple(None if e is None else (e if isinstance(e, tuple) else (e,))
                 for e in spec)


@pytest.mark.parametrize("opts", [{}, {"expert_parallel": True,
                                       "seq_shard_cache": True},
                                  {"fsdp": False}])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_rules_and_param_placements_match_repro(host_mesh, arch, opts):
    mesh, jmesh = host_mesh
    cfg = tconfigs.get_config(arch)
    rules = tsh.make_rules(cfg, mesh, **opts)
    jrules = jsh.make_rules(jconfigs.get_config(arch), jmesh, **opts)
    assert rules.table == jrules.table
    axes = j_build_model(jconfigs.get_config(arch)).param_axes()
    try:
        jplaced = jsh.tree_param_sharding(axes, jrules)
    except Exception as e:          # repro's DuplicateSpecError
        assert "duplicate" in str(e)
        # expert-parallel MoE: experts and ffn both on `model`
        assert opts.get("expert_parallel") and cfg.num_experts
        with pytest.raises(ValueError, match="shards tensor dims"):
            tsh.tree_param_sharding(axes, rules)
        return
    placed = tsh.tree_param_sharding(axes, rules)
    leaves = jax.tree_util.tree_leaves_with_path(
        axes, is_leaf=lambda t: isinstance(t, tuple))
    got = jax.tree_util.tree_leaves(
        placed, is_leaf=lambda t: isinstance(t, tuple))
    want = jax.tree_util.tree_leaves(jplaced)
    assert len(got) == len(want) == len(leaves)
    for (path, ax), pl, named in zip(leaves, got, want):
        assert len(pl) == 2
        assert _spec_of(pl, mesh.mesh_dim_names, len(ax)) == \
            _norm(tuple(named.spec) + (None,) * (len(ax) - len(named.spec))), \
            path
        assert _norm(rules.resolve(*ax)) == _norm(jrules.resolve(*ax))


def test_shard_is_a_no_op_on_one_device(host_mesh):
    mesh, _ = host_mesh
    x = torch.arange(12.0).reshape(2, 3, 2)
    assert tsh.shard(x, "batch", None, None) is x        # no rules
    rules = tsh.make_rules(tconfigs.get_config("qwen3-4b"), mesh)
    with tsh.use_rules(rules):
        assert tsh.current_rules() is rules
        assert tsh.shard(x, "batch", None, "vocab") is x  # one device
        with pytest.raises(ValueError, match="logical axes"):
            tsh.shard(x, "batch", None)
        with tsh.use_rules(None):
            assert tsh.current_rules() is None
        assert tsh.current_rules() is rules
    assert tsh.current_rules() is None


def test_model_under_one_device_rules_is_unchanged(host_mesh):
    """A model's `shard` calls under installed rules on a one-device mesh
    leave every activation as it is: the same logits as with no rules."""
    from repro_torch.models import build_model
    mesh, _ = host_mesh
    cfg = tconfigs.get_config("mixtral-8x7b").reduced()
    model = build_model(cfg)
    params = model.init(seed=2, device="cpu")
    tokens = torch.arange(24).reshape(2, 12) % cfg.vocab_size
    with torch.no_grad():
        want, _ = model.prefill(params, {"tokens": tokens}, cache_len=16)
        with tsh.use_rules(tsh.make_rules(cfg, mesh)):
            got, _ = model.prefill(params, {"tokens": tokens}, cache_len=16)
    assert torch.equal(got, want)


class _Mesh:
    """Stand-in with a `DeviceMesh`'s dim names and shape (the rules read
    nothing else), for layouts one process cannot create."""
    def __init__(self, **axes):
        self.mesh_dim_names = tuple(axes)
        self.shape = tuple(axes.values())


def test_production_layout_table():
    """The multi-pod layout's table, as `repro`'s docstring gives it."""
    mesh = _Mesh(pod=2, data=16, model=16)
    t = tsh.make_rules(tconfigs.get_config("qwen3-4b"), mesh).table
    assert t["batch"] == ("pod", "data") and t["heads"] == "model"
    assert t["kv_heads"] is None and t["fsdp"] == "data"
    z = tsh.make_rules(tconfigs.get_config("zamba2-1.2b"), mesh,
                       seq_shard_cache=True).table
    assert z["kv_heads"] == "model" and z["cache_seq"] is None
    r = tsh.make_rules(tconfigs.get_config("rwkv6-7b"), mesh).table
    assert r["rwkv_heads"] == "model" and r["heads"] is None
    rules = tsh.ShardingRules(mesh, t)
    names = [str(p) for p in rules.placements("batch", None, "vocab")]
    assert names == ["S(0)", "S(0)", "S(2)"]
    with pytest.raises(ValueError, match="shards tensor dims"):
        rules.placements("vocab", "ffn")


def test_production_mesh_needs_its_ranks():
    with pytest.raises(RuntimeError, match="256 ranks"):
        tmesh.make_production_mesh()
    assert tmesh.H100_PEAK_FLOPS_BF16 == 989e12
    assert tmesh.H100_HBM_BYTES_PER_S == 3.35e12
