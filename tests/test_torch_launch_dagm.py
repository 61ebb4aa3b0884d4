"""The decentralized bilevel LM round (`repro_torch.launch.dagm_dryrun`)
against `repro`'s on the CPU.

`repro`'s side runs in module-scoped subprocesses: its sharded tier
needs 8 host devices, which jax grants only through XLA_FLAGS at process
start, and importing `repro.launch.dagm_dryrun` rewrites XLA_FLAGS (to
512 devices), so the subprocess starts jax on 8 devices first and
imports it after.  It writes an .npz; the port runs here on the same
numpy inputs (`repro`'s parameters drawn with `jax.random`, the port's
token batches, an x of N(0, 0.3²)).

The model is qwen3-4b at `reduced()` widths and depth 1: one layer keeps
each of `repro`'s stacked leaves one wire row, as each of the port's is,
so the int8+ef case quantizes the same rows.  Its uniforms are
`repro`'s per-agent draws (`test_torch_sharded.Tokens`).

Tolerances: g, f and their gradients 1e-5 (relative and absolute: the
same f32 arithmetic summed in other orders); g on a bf16 tree as its
test states them; one round on LocalRing(4)
(also with one agent's autodiff at a time, `agent_chunk=1`) and
LocalRing(8), identity, x, y and every metric rtol = atol = 1e-5, as
`tests/test_torch_sharded.py`'s solves.  The int8+ef round's first y
gossip quantizes the same y0 with the same uniforms, so its payload and
its mixed y agree to the identity round's 1e-5; the round's other sends
quantize iterates that carry the two packages' f32 differences, so a
stochastic-rounding level can flip between them (one level of the row:
its span / 255), and the round is held by the norm-relative error of x,
y and the metrics, 1e-3, as `chip_smoke.py` holds its compressed runs
against the CPU.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten, tree_map

from test_torch_sharded import Tokens, _agent_uniforms
from test_torch_train import one_cpu_thread  # noqa: F401  (autouse)

from repro_torch.configs import get_config
from repro_torch.distributed import (LocalRing, make_sharded_dagm,
                                     round_channels, sharded_comm_ledger)
from repro_torch.interop import load_lm_params, stack_layers
from repro_torch.launch import dagm_dryrun as dd
from repro_torch.launch.costs import reduced_depth
from repro_torch.models import build_model
from repro_torch.models.layers import param_tree
from repro_torch.solve import sharded_spec

SRC = Path(__file__).resolve().parents[1] / "src"
ARCH, SEQ, BPA = "qwen3-4b", 16, 2
TOL = dict(rtol=1e-5, atol=1e-5)
NORM_REL = 1e-3
SPEC = dict(alpha=0.3, beta=0.1, M=2, U=2, curvature=8.0)
RING_NS = (4, 8)
ROUND_KEY = 1000

SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, {src!r})
import jax
jax.devices()                      # 8 devices, before dagm_dryrun's flag
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
from repro.distributed.dagm_sharded import make_sharded_dagm
from repro.launch.costs import reduced_depth
from repro.launch.dagm_dryrun import build_dagm_bilevel
from repro.models import build_model
from repro.solve import sharded_spec

inp = dict(np.load({inp!r}))
cfg = reduced_depth(get_config({arch!r}).reduced(), 1)
model = build_model(cfg)
out = {{}}
n_max = max({ns!r})
keys = jax.random.split(jax.random.PRNGKey(0), n_max)
y0 = jax.jit(jax.vmap(model.init))(keys)
paths = [jax.tree_util.keystr(p) for p, _ in
         jax.tree_util.tree_flatten_with_path(y0)[0]]
for i, leaf in enumerate(jax.tree.leaves(y0)):
    out[f"y0_{{i}}"] = np.asarray(leaf)
out["paths"] = np.asarray(paths)
def batch(n):
    return {{s: {{k: jnp.asarray(inp[f"{{s}}_{{k}}"][:n]) for k in
                 ("tokens", "labels", "domain")}} for s in ("train", "val")}}
x0 = jnp.asarray(inp["x0"])
spec = sharded_spec(comm="identity", **{spec!r})
g_fn, f_fn = build_dagm_bilevel(cfg, seq_len={seq}, batch_per_agent={bpa},
                                dcfg=spec)
one = jax.tree.map(lambda t: t[0], batch(n_max))
y_one = jax.tree.map(lambda t: t[0], y0)
both = jax.jit(lambda *a: [jax.value_and_grad(fn, argnums=(0, 1))(*a)
                           for fn in (g_fn, f_fn)])
for name, (val, (gx, gy)) in zip(("g", "f"), both(x0[0], y_one, one)
                                 if {objectives!r} else ()):
    out[f"{{name}}_val"] = np.asarray(val)
    out[f"{{name}}_gx"] = np.asarray(gx)
    for i, leaf in enumerate(jax.tree.leaves(gy)):
        out[f"{{name}}_gy_{{i}}"] = np.asarray(leaf)
if {objectives!r}:
    y_bf = jax.tree.map(lambda t: t.astype(jnp.bfloat16), y_one)
    val, (gx, gy) = jax.jit(jax.value_and_grad(g_fn, argnums=(0, 1)))(
        x0[0], y_bf, one)
    out["gbf16_val"], out["gbf16_gx"] = np.asarray(val), np.asarray(gx)
    for i, leaf in enumerate(jax.tree.leaves(gy)):
        out[f"gbf16_gy_{{i}}"] = np.asarray(leaf.astype(jnp.float32))
for n, comm in {rounds!r}:
    spec = sharded_spec(comm=comm, **{spec!r})
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(n), ("data",))
    step, _ = make_sharded_dagm(g_fn, f_fn, spec, mesh)
    args = (x0[:n], jax.tree.map(lambda t: t[:n], y0), batch(n))
    if comm != "identity":
        args += (jax.random.PRNGKey({key}),)
    x1, y1, m = step(*args)
    tag = f"r{{n}}_{{comm}}"
    out[tag + "_x"] = np.asarray(x1)
    for i, leaf in enumerate(jax.tree.leaves(y1)):
        out[f"{{tag}}_y_{{i}}"] = np.asarray(leaf)
    for k, v in m.items():
        out[f"{{tag}}_m_{{k}}"] = np.asarray(v)
np.savez({path!r}, **out)
print("OK")
"""


def _cfg():
    return reduced_depth(get_config(ARCH).reduced(), 1)


@pytest.fixture(scope="module")
def inputs():
    cfg, n = _cfg(), max(RING_NS)
    b = dd.agent_batches(cfg, n, SEQ, BPA, 0, device="cpu")
    x0 = (0.3 * np.random.default_rng(0).standard_normal(
        (n, dd.N_DOMAINS + 1))).astype(np.float32)
    return b, x0


# `repro`'s side in three subprocesses started together, each compiling
# its own rounds: the objectives and the identity round at n = 4, the
# identity round at n = 8, the int8+ef round
PARTS = ((True, [(RING_NS[0], "identity")]),
         (False, [(RING_NS[1], "identity")]), (False, [(4, "int8+ef")]))


@pytest.fixture(scope="module")
def jr(inputs, tmp_path_factory):
    b, x0 = inputs
    d = tmp_path_factory.mktemp("dagm_lm")
    inp = str(d / "inputs.npz")
    np.savez(inp, x0=x0, **{f"{s}_{k}": v.numpy() for s in b
                            for k, v in b[s].items()})
    paths = [str(d / f"repro{i}.npz") for i in range(len(PARTS))]
    procs = [subprocess.Popen(
        [sys.executable, "-c", SCRIPT.format(
            src=str(SRC), inp=inp, arch=ARCH, ns=RING_NS, spec=SPEC,
            seq=SEQ, bpa=BPA, key=ROUND_KEY, path=path,
            objectives=objectives, rounds=rounds)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
        for (objectives, rounds), path in zip(PARTS, paths)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=600)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    out = {}
    for path in paths:
        out.update(np.load(path))
    return out


def build_model_j(cfg):
    from repro.configs import get_config as j_get_config
    from repro.launch.costs import reduced_depth as j_reduced_depth
    from repro.models import build_model as j_build_model
    jcfg = j_reduced_depth(j_get_config(ARCH).reduced(), 1)
    return jax.eval_shape(j_build_model(jcfg).init, jax.random.PRNGKey(0))


def port_tree_of(jr, prefix, n):
    """`repro`'s (n, ...) leaves under `prefix` as a port parameter tree
    with the agent axis: each agent's state dict via `load_lm_params`."""
    cfg = _cfg()
    shapes = build_model_j(cfg)
    leaves = [jr[f"{prefix}_{i}"][:n] for i in
              range(len(jax.tree.leaves(shapes)))]
    agents = []
    for a in range(n):
        tree = jax.tree.unflatten(jax.tree.structure(shapes),
                                  [leaf[a] for leaf in leaves])
        mod = build_model(cfg).init(device="meta")
        mod.load_state_dict(load_lm_params(cfg, tree, device="cpu"),
                            assign=True)
        agents.append(param_tree(mod))
    return tree_map(lambda *ts: torch.stack(ts), *agents)


def as_repro_leaves(port_tree):
    """A port tree's (n, ...) leaves in `repro`'s order and layout: the
    agent axis first, then the stacked layers."""
    n = tree_flatten(port_tree)[0][0].shape[0]
    agents = [jax.tree.leaves(jax.tree.map(
        lambda t: t.detach().numpy(),
        stack_layers(tree_map(lambda t: t[a], port_tree))))
        for a in range(n)]
    return [np.stack(leaves) for leaves in zip(*agents)]


def port_batch(inputs, n):
    b, _ = inputs
    return {s: {k: v[:n] for k, v in b[s].items()} for s in b}


@pytest.mark.parametrize("name", ["g", "f"])
def test_objectives_and_gradients_match_repro(jr, inputs, name):
    cfg = _cfg()
    _, x0 = inputs
    g_fn, f_fn = dd.build_dagm_bilevel(cfg, seq_len=SEQ,
                                       batch_per_agent=BPA)
    fn = g_fn if name == "g" else f_fn
    y = tree_map(lambda t: t[0].clone().requires_grad_(),
                 port_tree_of(jr, "y0", 1))
    x = torch.tensor(x0[0], requires_grad=True)
    one = {s: {k: v[0] for k, v in d.items()}
           for s, d in port_batch(inputs, 1).items()}
    val = fn(x, y, one)
    gx, *gy = torch.autograd.grad(val, [x] + tree_flatten(y)[0],
                                  materialize_grads=True)
    np.testing.assert_allclose(val.item(), jr[f"{name}_val"], **TOL)
    np.testing.assert_allclose(gx.numpy(), jr[f"{name}_gx"], **TOL)
    gtree = tree_map(lambda t: t[None], tree_flatten(y)[1].unflatten(gy))
    for i, leaf in enumerate(as_repro_leaves(gtree)):
        np.testing.assert_allclose(leaf[0], jr[f"{name}_gy_{i}"], **TOL)


def test_g_on_a_bf16_tree_matches_repro(jr, inputs):
    """g and its gradients on a bf16 tree against `repro`'s, which squares
    an f32 copy of each leaf.  dg/dx_D is the regulariser alone (x_D is
    inside the clip): held to 2e-5, since f32 sums of the same bf16
    squares in other orders differ by ~5e-6 and squares rounded to bf16
    move it by ~1e-4 on this tree.  The CE runs the model in bf16 in both
    packages with other summation orders: g and dg/dx[:D] are held to
    1e-4, each leaf of dg/dy by its norm-relative error to 2^-6 (a few
    bf16 roundings of 2^-9)."""
    cfg = _cfg()
    _, x0 = inputs
    g_fn, _ = dd.build_dagm_bilevel(cfg, seq_len=SEQ, batch_per_agent=BPA)
    y = tree_map(lambda t: t[0].to(torch.bfloat16).requires_grad_(),
                 port_tree_of(jr, "y0", 1))
    x = torch.tensor(x0[0], requires_grad=True)
    one = {s: {k: v[0] for k, v in d.items()}
           for s, d in port_batch(inputs, 1).items()}
    val = g_fn(x, y, one)
    gx, *gy = torch.autograd.grad(val, [x] + tree_flatten(y)[0],
                                  materialize_grads=True)
    D = dd.N_DOMAINS
    assert abs(x0[0][D]) < 3.0
    np.testing.assert_allclose(gx[D].item(), jr["gbf16_gx"][D], rtol=2e-5)
    np.testing.assert_allclose(val.item(), jr["gbf16_val"], rtol=1e-4)
    np.testing.assert_allclose(gx[:D].numpy(), jr["gbf16_gx"][:D],
                               rtol=1e-4)
    gtree = tree_map(lambda t: t[None].float(),
                     tree_flatten(y)[1].unflatten(gy))
    for i, leaf in enumerate(as_repro_leaves(gtree)):
        want = jr[f"gbf16_gy_{i}"]
        assert np.linalg.norm(leaf[0] - want) <= \
            2.0 ** -6 * np.linalg.norm(want), i


def _round(jr, inputs, n, comm, monkeypatch=None, agent_chunk=None):
    cfg = _cfg()
    spec = sharded_spec(comm=comm, **SPEC)
    g_fn, f_fn = dd.build_dagm_bilevel(cfg, seq_len=SEQ,
                                       batch_per_agent=BPA, dcfg=spec)
    ring = LocalRing(n, device="cpu", agent_chunk=agent_chunk)
    step, _ = make_sharded_dagm(g_fn, f_fn, spec, ring)
    y = port_tree_of(jr, "y0", n)
    x = torch.as_tensor(inputs[1][:n])
    channels = round_channels(spec, x, y, 0, 0)
    if monkeypatch is not None:
        repro_uniforms(jr, spec, channels, y, n).patch(monkeypatch)
    return spec, y, step(x, y, port_batch(inputs, n), channels)


def repro_uniforms(jr, spec, channels, y, n):
    """`repro`'s per-agent uniforms of one stochastic round, keyed by the
    port's (stream, send, leaf): agent a's key is fold_in(key, a), split
    into the three channels' keys, each send split into one subkey per
    leaf in `repro`'s leaf order."""
    paths = [str(p) for p in jr["paths"]]
    port_order = _port_leaf_paths(y)
    assert sorted(port_order) == sorted(paths)
    # port leaf i (torch pytree order) -> its repro leaf index
    to_repro = [paths.index(p) for p in port_order]
    widths = [int(np.prod(jr[f"y0_{i}"].shape[1:])) for i in range(len(paths))]
    key = jax.random.PRNGKey(ROUND_KEY)
    keys = jax.vmap(lambda a: jax.random.split(
        jax.random.fold_in(key, a), 3))(jnp.arange(n))
    tokens = Tokens()
    sends = {"inner_y": spec.M, "dihgp_h": spec.U, "outer_x": 1}
    for c, name in enumerate(("inner_y", "dihgp_h", "outer_x")):
        w = [dd.N_DOMAINS + 1] if name == "outer_x" else widths
        for s, us in enumerate(_agent_uniforms(keys[:, c], w, sends[name])):
            if name == "outer_x":
                tokens.add(channels[name].seed, s, 0, us[0])
            else:
                for leaf, j in enumerate(to_repro):
                    tokens.add(channels[name].seed, s, leaf, us[j])
    return tokens


def _port_leaf_paths(y):
    """`repro`'s key path of each port leaf, in the port's leaf order
    (depth 1: blocks.0.<...> is repro's ['blocks'][...])."""
    out = []

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, prefix + f"['{k}']")
        elif isinstance(t, list):
            assert len(t) == 1
            walk(t[0], prefix)
        else:
            out.append(prefix)
    walk(y, "")
    return out


def _close(res, jr, tag, rel=False):
    x1, y1, m, _ = res
    want_y = [jr[f"{tag}_y_{i}"] for i in range(len(jr["paths"]))]
    got = [("x", x1.numpy(), jr[f"{tag}_x"])] + [
        (f"y{i}", g, w) for i, (g, w) in
        enumerate(zip(as_repro_leaves(y1), want_y))]
    got += [(k, v.numpy(), jr[f"{tag}_m_{k}"]) for k, v in m.items()
            if f"{tag}_m_{k}" in jr]
    assert {k for k in jr if k.startswith(f"{tag}_m_")} == \
        {f"{tag}_m_{k}" for k in m}
    for name, g, w in got:
        if rel:
            err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
            assert err <= NORM_REL, (name, err)
        else:
            np.testing.assert_allclose(g, w, err_msg=name, **TOL)


@pytest.mark.parametrize("n,agent_chunk", [(4, None), (8, None), (4, 1)])
def test_identity_round_matches_repro(jr, inputs, n, agent_chunk):
    """agent_chunk=1: one agent's autodiff at a time (chip_smoke's LM
    round), the same round."""
    spec, y0, res = _round(jr, inputs, n, "identity",
                           agent_chunk=agent_chunk)
    _close(res, jr, f"r{n}_identity")
    one = tree_map(lambda t: t[0], y0)
    led = sharded_comm_ledger(spec, torch.zeros(dd.N_DOMAINS + 1), one)
    assert res[2]["comm_sends"].item() == led.total_sends() == 5


def test_int8_ef_round_on_repros_uniforms(jr, inputs, monkeypatch):
    spec, _, res = _round(jr, inputs, 4, "int8+ef", monkeypatch)
    _close(res, jr, "r4_int8+ef", rel=True)


def _cross_term_inputs():
    cfg = _cfg()
    g_fn, _ = dd.build_dagm_bilevel(cfg, seq_len=SEQ, batch_per_agent=BPA)
    leaves, spec = tree_flatten(param_tree(build_model(cfg).init(
        seed=0, device="cpu")))
    gen = torch.Generator().manual_seed(1)
    h = [torch.randn(t.shape, generator=gen) for t in leaves]
    b = dd.agent_batches(cfg, 1, SEQ, BPA, 0, device="cpu")
    one = {s: {k: v[0] for k, v in d.items()} for s, d in b.items()}
    x = 0.3 * torch.randn(dd.N_DOMAINS + 1, generator=gen)
    return g_fn, leaves, spec, h, one, x


def test_x_d_terms_meet_in_one_stack():
    """The cross term's x-gradient (the second derivative of g, as
    `dagm_local_round`'s `cross_one` takes it) sums no pair of scalars in
    autograd's engine: x_D's terms from the leaves meet in g's stack of
    the leaves' squared norms, in leaf order.  A sum of the leaves'
    scalars would leave their order to the engine, which runs the
    leaves' branches in an order that varied from run to run on the card
    (one ulp of x_D in one agent)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_unflatten

    class ScalarAdds(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.count = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.__name__ == "add.Tensor" and all(
                    isinstance(a, torch.Tensor) and a.numel() == 1
                    for a in args[:2]):
                self.count += 1
            return func(*args, **(kwargs or {}))

    g_fn, leaves, spec, h, one, x = _cross_term_inputs()
    xx = x.clone().requires_grad_()
    live = [t.detach().requires_grad_() for t in leaves]
    gy = torch.autograd.grad(g_fn(xx, tree_unflatten(live, spec), one),
                             live, create_graph=True)
    inner = sum(torch.sum(a * b) for a, b in zip(gy, h))
    adds = ScalarAdds()
    with adds:
        (gx,) = torch.autograd.grad(inner, xx)
    assert adds.count == 0
    assert torch.isfinite(gx).all() and gx[dd.N_DOMAINS] != 0


def test_round_bitwise_across_runs_with_allocator_churn():
    """Two runs of the round from the same draw, a large allocation freed
    between them: x, y and the metrics bitwise."""
    cfg = _cfg()
    spec = sharded_spec(comm="identity", **SPEC)
    g_fn, f_fn = dd.build_dagm_bilevel(cfg, seq_len=SEQ,
                                       batch_per_agent=BPA, dcfg=spec)
    ring = LocalRing(4, device="cpu", agent_chunk=1)
    step, _ = make_sharded_dagm(g_fn, f_fn, spec, ring)
    batch = dd.agent_batches(cfg, 4, SEQ, BPA, 0, device="cpu")
    runs = []
    for churn in (0, 1 << 26):
        del_me = torch.empty(churn, dtype=torch.uint8)
        del del_me
        y = dd.init_agents(build_model(cfg), 4, seed=0, device="cpu")
        x = torch.zeros((4, dd.N_DOMAINS + 1))
        x, y, m, _ = step(x, y, batch, round_channels(spec, x, y, 0, 0))
        runs.append([x] + tree_flatten(y)[0] + list(m.values()))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
