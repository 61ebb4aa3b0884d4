"""The port's dry runs (`repro_torch.launch.dryrun`, `.dagm_dryrun`) on the
CPU, traced on the meta device.

`repro`'s dry-run modules rewrite XLA_FLAGS to 512 host devices when
imported, so `repro`'s side runs in one module-scoped subprocess, which
writes JSON: its `SKIP`, `LONG_WINDOW`, `input_specs` for every
(architecture × shape) pair but the skipped one, and `microbatches_for`
on its production meshes (16×16 and 2×16×16).  The port's
`microbatches_for` takes the mesh as {axis: size}.

Against `repro`: the skip table; the inputs' shapes for all 39 pairs
(tokens, labels, frames; a decode cache by its leaves' total element
count and names, since `repro` stacks its layers and the port keeps a
list); the microbatch factors.  On the meta device: the traced FLOPs of
a reduced-depth training step of the attention family equal 3 ×
`costs.forward_flops` at full context (the plain route computes every
score; the flop counter counts the matmuls only) to 1e-12 relative;
`run_one` on a training and a decode step, a prefill step's trace, and
a skipped pair; the tracer's live
peak on a hand-counted case; the DAGM dry run's traced gossip bytes
equal to `sharded_comm_ledger`, on the identity wire and int8+ef.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.utils._pytree import tree_leaves

from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config
from repro_torch.launch import dagm_dryrun as dd
from repro_torch.launch import dryrun as dr
from repro_torch.launch.costs import forward_flops, reduced_depth

SRC = Path(__file__).resolve().parents[1] / "src"
PAIRS = [(a, s) for a in sorted(ARCHS) for s in INPUT_SHAPES
         if (a, s) not in dr.SKIP]

SCRIPT = r"""
import json, sys
sys.path.insert(0, {src!r})
import jax
from repro.configs import ARCHS, INPUT_SHAPES, get_config
from repro.launch import dryrun as dr
from repro.launch.mesh import make_production_mesh
out = {{"skip": [[a, s, r] for (a, s), r in dr.SKIP.items()],
       "long_window": dr.LONG_WINDOW, "specs": {{}}, "mb": {{}}}}
meshes = {{"1": make_production_mesh(), "2": make_production_mesh(
    multi_pod=True)}}
for arch in ARCHS:
    for shape in INPUT_SHAPES:
        key = arch + "|" + shape
        for pods, mesh in meshes.items():
            out["mb"][key + "|" + pods] = dr.microbatches_for(
                get_config(arch), INPUT_SHAPES[shape], mesh)
        if (arch, shape) in dr.SKIP:
            continue
        spec = dr.input_specs(arch, shape)
        flat = jax.tree_util.tree_flatten_with_path(spec)[0]
        out["specs"][key] = [[jax.tree_util.keystr(p), list(l.shape),
                             str(l.dtype)] for p, l in flat]
with open({path!r}, "w") as f:
    json.dump(out, f)
print("OK")
"""


@pytest.fixture(scope="module")
def jr(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dryrun") / "repro.json")
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(src=str(SRC), path=path)],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    with open(path) as f:
        return json.load(f)


def test_skip_and_long_window_equal_repros(jr):
    assert {(a, s): r for a, s, r in jr["skip"]} == dr.SKIP
    assert jr["long_window"] == dr.LONG_WINDOW
    assert len(PAIRS) == 39


@pytest.mark.parametrize("multi_pod", [False, True])
def test_microbatches_for_equals_repros(jr, multi_pod):
    axes = dr.production_axes(multi_pod)
    for arch in ARCHS:
        for shape in INPUT_SHAPES:
            got = dr.microbatches_for(get_config(arch), INPUT_SHAPES[shape],
                                      axes)
            assert got == jr["mb"][f"{arch}|{shape}|{1 + multi_pod}"], \
                (arch, shape)


def _leaf_name(path: str) -> str:
    return path.rsplit("[", 1)[-1].strip("]'\"")


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_input_specs_match_repros(jr, arch, shape):
    want = jr["specs"][f"{arch}|{shape}"]
    spec = dr.input_specs(arch, shape)
    leaves = [t for t in tree_leaves(spec) if isinstance(t, torch.Tensor)]
    assert all(t.device.type == "meta" for t in leaves)
    if INPUT_SHAPES[shape].kind != "decode":
        assert {k: list(v.shape) for k, v in spec.items()} == \
            {_leaf_name(p): s for p, s, _ in want}
        assert spec["tokens"].dtype == torch.int64
        return
    assert list(spec["tokens"].shape) == next(
        s for p, s, _ in want if _leaf_name(p) == "tokens")
    # `repro`'s cache position is an array leaf, the port's an int
    cache_want = [(p, s) for p, s, _ in want if "['cache']" in p
                  and _leaf_name(p) != "pos"]
    numel = lambda shapes: sum(int(torch.Size(s).numel()) for s in shapes)
    assert numel([t.shape for t in tree_leaves(spec["cache"])
                  if isinstance(t, torch.Tensor)]) == \
        numel([s for _, s in cache_want])
    names = {_leaf_name(p) for p, _ in cache_want}
    got_names = set()

    def walk(t, name=None):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, k)
        elif isinstance(t, list):
            for v in t:
                walk(v, name)
        elif isinstance(t, torch.Tensor):
            got_names.add(name)
    walk(spec["cache"])
    assert got_names == names


@pytest.mark.parametrize("arch", ["qwen3-4b", "yi-9b", "chameleon-34b"])
def test_traced_flops_equal_three_forward_passes(arch):
    cfg = reduced_depth(get_config(arch), 2)
    shape = dr.InputShape("t", 128, 2, "train")
    fn, args, _ = dr.build_step_and_args(cfg, shape, "t")
    cost = dr.trace_costs(fn, *args)
    want = 3 * forward_flops(cfg, 128, ctx=128.0, batch=2)
    assert abs(cost["flops"] / want - 1) < 1e-12
    assert cost["bytes"] > 0 and cost["peak_live"] > 0


def test_trace_peak_counts_live_storages():
    x = torch.empty(1000, device="meta")            # 4,000 bytes

    def fn(x):
        a = x * 2                                   # +4,000 (a)
        b = a + 1                                   # +4,000 (a, b)
        del a                                       # -4,000
        c = b.view(10, 100) * 3                     # +4,000 (b, c)
        return c.sum()                              # +4 (b, c, sum)
    cost = dr.trace_costs(fn, x)
    assert cost["peak_live"] == 8_004
    assert cost["bytes"] == (4_000 * 2) * 3 + 4_000 + 4


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_run_one_on_the_meta_device(shape):
    res = dr.run_one("yi-9b", shape, verbose=False)
    assert res.ok, res.error
    rf = res.roofline()
    assert set(rf) == {"compute_s", "memory_s", "collective_s",
                       "bottleneck"}
    assert res.flops > 0 and res.peak_memory_per_device > \
        res.argument_size_per_device > 0
    if shape == "train_4k":
        assert res.microbatches > 1 and res.collective_bytes
        assert 0 < res.useful_ratio < 1


def test_prefill_step_traces():
    """A prefill step on the meta device (the production prefill_32k
    traces 128 query chunks a layer; 256 tokens take one)."""
    cfg = reduced_depth(get_config("qwen3-4b"), 2)
    shape = dr.InputShape("p", 256, 2, "prefill")
    fn, args, _ = dr.build_step_and_args(cfg, shape, "p")
    cost = dr.trace_costs(fn, *args)
    # a forward at full context, the logits of the last position only
    want = forward_flops(cfg, 256, ctx=256.0, batch=2) \
        - 2 * 255 * 2 * cfg.d_model * cfg.padded_vocab
    assert abs(cost["flops"] / want - 1) < 1e-12
    assert cost["peak_live"] > 0


def test_run_one_skips_and_reports():
    res = dr.run_one("whisper-large-v3", "long_500k", verbose=False)
    assert not res.ok and res.skip_reason == dr.SKIP[
        ("whisper-large-v3", "long_500k")]
    assert dr.main(["--arch", "qwen3-4b", "--shape", "long_500k"]) == 0


@pytest.mark.parametrize("comm", ["identity", "int8+ef"])
def test_dagm_dryrun_wire_bytes_equal_the_ledger(comm):
    """The traced gossips' bytes, fitted from depths 2 and 4 to the full
    36, equal the ledger's at full depth (one inner step and one Neumann
    term keep the trace short)."""
    res = dd.run("qwen3-4b", n_agents=4, seq_len=16, batch_per_agent=1,
                 M=1, U=1, comm=comm, param_dtype="bf16", verbose=False)
    assert res["layers"] == 36 and res["traced_layers"] == [2, 4]
    assert res["traced_gossip_bytes"] == res["collective_bytes"] > 0
    per_send = 4 * res["params_per_agent"] if comm == "identity" else None
    if per_send:
        assert res["collective_bytes"] == (1 + 1) * per_send \
            + 4 * (dd.N_DOMAINS + 1)
    assert res["flops"] > 0 and res["peak_memory_per_device"] > 0
