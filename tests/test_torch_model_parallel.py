"""Model parallelism on the CPU: the port's training step and launcher on
DTensor parameters laid out by `tree_param_sharding`'s placements, over
gloo processes, against one process on the same global batch.

(a) `make_train_step(rules=)` on a (data 1, model 2) mesh, each of the
    ten architectures at `reduced()` and qwen3-4b with a tied, padded
    table: two subprocesses run all the cases in turn (one start-up),
    and each case is its own test against
    the one-process step here.  Besides, on a (data 1, model 3) mesh,
    qwen3-4b with its table and with the tied, padded one (512 rows
    shard 171 / 171 / 170: uneven shards), and on (b)'s 2 × 2 mesh
    rwkv6-7b and zamba2-1.2b (the WKV and SSD scans' gradients partial
    over rows and heads).  2 AdamW steps (the launcher's schedule,
    `cosine_schedule(3e-4, 1, 4)`), 2 microbatches, losses and
    parameters to rtol 1e-4 / atol 1e-5, the tolerance of the
    data-parallel launcher test, and AdamW's moments within 1e-4 of
    each leaf's largest element: the update m̂ / (√v̂ + eps) does not
    move where a leaf's whole gradient is scaled, but the moments do.
    The two sum each product's terms in
    other orders (a shard's partial sums, then the all-reduce), and
    AdamW's update m̂ / (√v̂ + eps) turns a gradient element of order eps
    into a step whose size hangs on its last digits: an element whose
    second moment in the one-process run is that small but not zero (0 <
    √v̂ < 1e-6, 100 eps: a gradient at the f32 noise of its leaf's sums)
    is held to the most one step at the rate can move it, 2·3e-4, and
    such elements must be rare (a zero gradient, a token absent from the
    batch, is exact in both).
(b) `launch.train.main --smoke --device cpu --model-parallel 2` on four
    gloo processes (a 2 × 2 mesh: "fsdp" shards over "data"), 2
    microbatches, checkpoints at steps 2 and 3, then resumed from
    `latest_step` to step 4: the losses and the checkpoint files against
    one process on the global batch, `repro.checkpoint` reading the
    files into `repro`'s template.
(c) The layout: on each of the four ranks every leaf's placements are
    `tree_param_sharding`'s and its local shape the one that
    `launch.dryrun`'s per-device bytes assume.

And the one-process route: the functions that model parallelism changed
(the embedding, the cross-entropy, the MoE dispatch, the RWKV mix's
scan, the step) give the same bits as their code before it, with no
rules installed and under a 1 × 1 mesh's rules.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F
from repro.checkpoint import restore_checkpoint as j_restore_checkpoint
from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from torch.utils._pytree import tree_flatten

from repro_torch.checkpoint import checkpoint_steps, load_arrays
from repro_torch.configs import ARCHS, get_config
from repro_torch.distributed.sharding import (distribute_params, make_rules,
                                              tree_param_sharding,
                                              use_rules)
from repro_torch.kernels import kernel_mode
from repro_torch.kernels import ref as kref
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train
from repro_torch.launch.dryrun import MeshShape, _shard_factor
from repro_torch.models import build_model, moe, model_zoo
from repro_torch.models import ssm
from repro_torch.models.layers import embed, param_tree
from repro_torch.models.steps import make_train_step
from repro_torch.optim import adamw, cosine_schedule

from test_torch_train import one_cpu_thread  # noqa: F401  (autouse)

SRC = Path(__file__).resolve().parents[1] / "src"
TOL = dict(rtol=1e-4, atol=1e-5)
LR, WARMUP, TOTAL = 3e-4, 1, 4
B, S, MICRO, STEPS = 4, 16, 2, 2
EPS_SCALE, EPS_MOVE = 1e-6, 2 * LR
MOMENT_TOL = 1e-4
INIT_TIMEOUT_S, JOIN_TIMEOUT_S = 60, 600
SMOKE = ["--arch", "qwen3-4b", "--smoke", "--device", "cpu",
         "--seq-len", "32", "--global-batch", "4", "--warmup", "1",
         "--log-every", "1", "--microbatches", "2", "--ckpt-every", "2"]

# (a)'s cases: the ten architectures, and qwen3-4b with its table tied
# and its vocabulary 500 of the 512 padded columns (no shipped
# configuration ties the table, and at reduced() none pads): the
# embedding's and the unembedding's gradients meet in one table, and the
# cross-entropy masks pad columns on one rank's shard
CASES = list(ARCHS) + ["qwen3-4b+tied-padded"]
# (mesh, case): two pairs of processes run CASES on (1, 2), half each,
# three run the uneven vocabulary shards on (1, 3), and the launcher's
# four run the scans' partial gradients on (2, 2)
MESH_CASES = {"1x2": CASES, "1x3": ["qwen3-4b", "qwen3-4b+tied-padded"],
              "2x2": ["rwkv6-7b", "zamba2-1.2b"]}
STEP_CASES = [f"{m}-{c}" for m, cases in MESH_CASES.items() for c in cases]

# the cases' configurations and the STEPS global batches (synthetic
# tokens, whisper's frames from the launcher's seeded generator), defined
# once for this module and the step workers
BATCHES = r"""
def config_of(case):
    import dataclasses
    from repro_torch.configs import get_config
    arch, _, variant = case.partition("+")
    cfg = get_config(arch).reduced()
    if variant == "tied-padded":
        cfg = dataclasses.replace(cfg, tie_embeddings=True, vocab_size=500)
    return cfg


def batches(cfg):
    from repro_torch.data import TokenDataConfig, make_token_batch
    from repro_torch.launch.train import frames_for
    data = TokenDataConfig(vocab_size=cfg.vocab_size, seq_len={seq},
                           global_batch={batch}, seed=0)
    out = []
    for step in range({steps}):
        batch = make_token_batch(data, step, device="cpu")
        if cfg.encoder_decoder:
            batch["frames"] = frames_for(cfg, step, {batch}, "cpu")
        out.append(batch)
    return out
""".format(seq=S, batch=B, steps=STEPS)
exec(BATCHES)

PRELUDE = r"""
import sys, json, traceback
from datetime import timedelta
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
dist.init_process_group("gloo", init_method="file://" + store,
                        world_size=world, rank=rank,
                        timeout=timedelta(seconds={init_timeout}))
"""

# each case's step on a mesh, rank 0 writing {mesh}-{case}.npz: the losses,
# the parameters (p<i>) and AdamW's moments (m<i>, n<i>) gathered whole
RUN_CASES = r"""
import time, traceback
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_flatten
from repro_torch.distributed.sharding import (distribute_params,
                                              gather_params, make_rules)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model
from repro_torch.models.layers import param_tree
from repro_torch.models.steps import make_train_step
from repro_torch.optim import adamw, cosine_schedule


def run_cases(model, cases):
    mesh = make_host_mesh(model=model, device_type="cpu")
    for case in cases:
        name = f"{{out}}/{{world // model}}x{{model}}-{{case}}"
        t0 = time.perf_counter()
        try:
            cfg = config_of(case)
            net = build_model(cfg)
            rules = make_rules(cfg, mesh)
            params = distribute_params(param_tree(net.init(seed=0,
                                                           device="cpu")),
                                       net.param_axes(), rules)
            opt = adamw(cosine_schedule({lr}, {warmup}, {total}))
            state = opt.init(params)
            step = make_train_step(net, opt, microbatches={micro},
                                   rules=rules)
            losses = []
            for batch in batches(cfg):
                batch = {{k: DTensor.from_local(
                    v, mesh, rules.placements("batch",
                                              *[None] * (v.dim() - 1)))
                    for k, v in batch.items()}}
                params, state, metrics = step(params, state, batch)
                losses.append(float(metrics["loss"]))
            trees = {{key: tree_flatten(gather_params(t))[0] for key, t in
                      (("p", params), ("m", state.mu), ("n", state.nu))}}
            if rank == 0:
                np.savez(name + ".npz", losses=np.array(losses),
                         seconds=time.perf_counter() - t0,
                         **{{f"{{key}}{{i}}": t.numpy()
                             for key, leaves in trees.items()
                             for i, t in enumerate(leaves)}})
        except Exception:
            if rank == 0:
                with open(name + ".err", "w") as f:
                    f.write(traceback.format_exc())
"""

STEP_WORKER = PRELUDE + "{batches}" + RUN_CASES + r"""
run_cases(world, sys.argv[5].split(","))
dist.destroy_process_group()
"""

LAUNCH_WORKER = PRELUDE + "{batches}" + RUN_CASES + r"""
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import distribute_params, make_rules
from repro_torch.launch import train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model
from repro_torch.models.layers import param_tree
argv = sys.argv[5:]
codes = [train.main(argv + ["--steps", "3"]),
         train.main(argv + ["--steps", "4"])]
cfg = get_config("qwen3-4b").reduced()
model = build_model(cfg)
mesh = make_host_mesh(model=2, device_type="cpu")
laid = distribute_params(param_tree(model.init(seed=0, device="cpu")),
                         model.param_axes(), make_rules(cfg, mesh))
layout = {{}}
def walk(tree, prefix):
    if isinstance(tree, dict):
        for k, v in tree.items():
            walk(v, prefix + k + ".")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            walk(v, prefix + str(i) + ".")
    else:
        layout[prefix[:-1]] = dict(
            placements=[repr(p) for p in tree.placements],
            local=list(tree.to_local().shape), shape=list(tree.shape))
walk(laid, "")
with open(f"{{out}}/layout{{rank}}.json", "w") as f:
    json.dump(layout, f)
run_cases(2, {mesh_2x2})
dist.destroy_process_group()
sys.exit(max(codes))
"""


def losses_of(text: str) -> list[float]:
    return [float(m) for m in re.findall(r"step +\d+ loss ([-\d.]+)", text)]


def _spawn(script: str, world: int, workdir: Path, tail: list[str]):
    store = str(workdir / "store")
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, "-c", script, str(r), str(world), store,
         str(workdir), *tail], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]


def _join(procs) -> list[str]:
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=JOIN_TIMEOUT_S)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


@pytest.fixture(scope="module")
def runs():
    """The four process groups, started together: (a)'s two pairs, each
    over half the cases on (1, 2), its three on (1, 3), and (b)-(c)'s
    four launcher ranks, which then run (a)'s cases on (2, 2).  Yields
    the directory of (a)'s results, (b)'s directory and (b)'s rank
    outputs."""
    fmt = dict(init_timeout=INIT_TIMEOUT_S, batches=BATCHES, lr=LR,
               warmup=WARMUP, total=TOTAL, micro=MICRO,
               mesh_2x2=MESH_CASES["2x2"])
    groups = {"1x2a": MESH_CASES["1x2"][0::2],
              "1x2b": MESH_CASES["1x2"][1::2], "1x3": MESH_CASES["1x3"]}
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {k: Path(tmp) / k for k in [*groups, "launch"]}
        for d in dirs.values():
            d.mkdir()
        step_procs = [
            p for g, cases in groups.items()
            for p in _spawn(STEP_WORKER.format(**fmt), int(g[2]), dirs[g],
                            [",".join(cases)])]
        launch_procs = _spawn(
            LAUNCH_WORKER.format(**fmt), 4, dirs["launch"],
            SMOKE + ["--model-parallel", "2", "--ckpt-dir",
                     str(dirs["launch"] / "ck")])
        outs = _join(launch_procs + step_procs)
        results = Path(tmp) / "cases"
        results.mkdir()
        for d in dirs.values():
            for f in d.glob("[12]x[23]-*"):
                f.rename(results / f.name)
        yield results, dirs["launch"], outs[:len(launch_procs)]


def one_process(cfg):
    """The one-process step on the same batches: (losses, parameter
    leaves, AdamW first- and second-moment leaves, AdamW step count)."""
    model = build_model(cfg)
    params = param_tree(model.init(seed=0, device="cpu"))
    opt = adamw(cosine_schedule(LR, WARMUP, TOTAL))
    state = opt.init(params)
    step = make_train_step(model, opt, microbatches=MICRO)
    losses = []
    for batch in batches(cfg):
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
    return (losses, tree_flatten(params)[0], tree_flatten(state.mu)[0],
            tree_flatten(state.nu)[0], int(state.step))


@pytest.mark.parametrize("case", STEP_CASES)
def test_model_parallel_step_matches_one_process(runs, case):
    err = runs[0] / f"{case}.err"
    assert not err.exists(), err.read_text()[-3000:]
    got = np.load(runs[0] / f"{case}.npz")
    arch = case.split("-", 1)[1]
    losses, leaves, mu, nu, count = one_process(config_of(arch))
    np.testing.assert_allclose(got["losses"], losses, **TOL)
    assert len(got.files) == 3 * len(leaves) + 2
    for key, moments in (("m", mu), ("n", nu)):
        for i, want in enumerate(moments):
            want, have = want.numpy(), got[f"{key}{i}"]
            assert have.shape == want.shape
            assert np.abs(have - want).max() <= MOMENT_TOL * np.abs(
                want).max(), f"{case} moment {key} leaf {i}"
    b2 = 0.95
    apart = total = 0
    for i, (want, v) in enumerate(zip(leaves, nu)):
        want, have = want.numpy(), got[f"p{i}"]
        assert have.shape == want.shape and have.dtype == want.dtype
        vhat = v.numpy() / (1 - b2 ** count)
        small = (vhat > 0) & (np.sqrt(vhat) < EPS_SCALE)
        np.testing.assert_allclose(have[~small], want[~small],
                                   err_msg=f"{arch} leaf {i}", **TOL)
        assert np.abs(have[small] - want[small]).max(initial=0) <= EPS_MOVE
        apart += int((~np.isclose(have, want, **TOL)).sum())
        total += want.size
    assert apart <= 1e-4 * total, (apart, total)


def test_launcher_model_parallel_equals_one_process(runs, tmp_path, capsys):
    launch_dir, outs = runs[1], runs[2]
    ck = str(tmp_path / "one")
    assert train.main(SMOKE + ["--steps", "3", "--ckpt-dir", ck]) == 0
    want = losses_of(capsys.readouterr().out)
    assert train.main(SMOKE + ["--steps", "4", "--ckpt-dir", ck]) == 0
    want_resumed = losses_of(capsys.readouterr().out)
    mp = str(launch_dir / "ck")
    assert "mesh {'data': 2, 'model': 2}" in outs[0]
    assert "[train] restored step 3" in outs[0]
    assert checkpoint_steps(mp) == [2, 3, 4]
    for out in outs:                        # every rank logs the global loss
        got = losses_of(out)
        np.testing.assert_allclose(got[:3], want, **TOL)
        np.testing.assert_allclose(got[3:], want_resumed, **TOL)
    for step in (3, 4):
        a, b = load_arrays(mp, step), load_arrays(ck, step)
        assert set(a) == set(b)
        for key in b:
            np.testing.assert_allclose(a[key], b[key], err_msg=key, **TOL)


def test_repro_reads_the_model_parallel_checkpoint(runs):
    mp = str(runs[1] / "ck")
    template = j_build_model(j_get_config("qwen3-4b").reduced()).init(
        jax.random.PRNGKey(1))
    restored = j_restore_checkpoint(mp, 3, template)
    arrays = load_arrays(mp, 3)
    flat = jax.tree_util.tree_flatten_with_path(restored)[0]
    assert len(flat) == len(arrays)
    for (path, leaf), want in zip(flat, jax.tree.leaves(template)):
        key = "/".join(str(p) for p in path)
        assert leaf.shape == want.shape and leaf.dtype == want.dtype
        np.testing.assert_array_equal(np.asarray(leaf), arrays[key])


@pytest.mark.parametrize("rank", range(4))
def test_layout_is_tree_param_sharding_on_a_2x2_mesh(runs, rank):
    layout = json.loads((runs[1] / f"layout{rank}.json").read_text())
    cfg = get_config("qwen3-4b").reduced()
    axes = build_model(cfg).param_axes()
    rules = make_rules(cfg, MeshShape.of({"data": 2, "model": 2}))
    want = tree_param_sharding(axes, rules)
    assert set(layout) == set(axes)
    sharded_over_both = 0
    for name, leaf in layout.items():
        assert leaf["placements"] == [repr(p) for p in want[name]], name
        assert np.prod(leaf["local"]) * _shard_factor(rules, axes[name]) \
            == np.prod(leaf["shape"]), name
        sharded_over_both += all(p.startswith("Shard")
                                 for p in leaf["placements"])
    assert sharded_over_both                # "fsdp" → "data", as repro


# ---------------------------------------------------------------------------
# the one-process route, bit for bit its code before model parallelism
# ---------------------------------------------------------------------------

def old_cross_entropy(logits, labels, vocab_size: int):
    V = logits.shape[-1]
    if V > vocab_size:
        pad = torch.arange(V, device=logits.device) >= vocab_size
        logits = torch.where(pad[None, None], torch.full_like(logits, -1e30),
                             logits)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    true = torch.gather(logits, -1,
                        torch.clamp(labels, min=0)[..., None].long())[..., 0]
    mask = (labels >= 0).float()
    return torch.sum((lse - true) * mask) / torch.clamp(mask.sum(), min=1.0)


def old_moe_dispatch(p, xt, cfg):
    T, D = xt.shape
    E, k = cfg.num_experts, cfg.top_k
    C = moe.expert_capacity(T, E, k, cfg.capacity_factor)
    logits = (xt @ p["router"]).float()
    probs, gate, eidx = moe._route(logits, k)
    me = torch.mean(probs, dim=0)
    ce = torch.mean(F.one_hot(eidx[:, 0], E).float(), dim=0)
    aux = E * torch.sum(me * ce)
    flat_e = eidx.reshape(-1)
    flat_t = torch.arange(T, device=xt.device).repeat_interleave(k)
    flat_g = gate.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st, sg = flat_e[order], flat_t[order], flat_g[order]
    counts = torch.zeros(E, dtype=se.dtype, device=se.device).index_add_(
        0, se, torch.ones_like(se))
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(T * k, device=xt.device) - starts[se]
    keep = slot < C
    dest = torch.where(keep, se * C + slot, E * C)
    buf = torch.zeros((E * C + 1, D), dtype=xt.dtype, device=xt.device)
    buf[dest] = xt[st]
    buf = buf[:E * C].reshape(E, C, D)
    out_flat = moe._expert_ffn(p, buf).reshape(E * C, D)
    contrib = torch.where(
        keep[:, None],
        out_flat[torch.clamp(dest, max=E * C - 1)] * sg[:, None].to(xt.dtype),
        torch.zeros((), dtype=xt.dtype, device=xt.device))
    out = torch.zeros((T, D), dtype=xt.dtype,
                      device=xt.device).index_add_(0, st, contrib)
    return out, aux


@pytest.fixture(scope="module")
def mesh1x1():
    """A 1 × 1 host mesh (a one-rank gloo group here, torn down after)."""
    created = not dist.is_initialized()
    mesh = tmesh.make_host_mesh(device_type="cpu")
    yield mesh
    if created:
        dist.destroy_process_group()


def _grads(fn, inputs: list):
    """fn's outputs and the gradient of their sum of squares with respect
    to `inputs` (float tensors)."""
    live = [t.detach().requires_grad_() for t in inputs]
    outs = fn(*live)
    outs = outs if isinstance(outs, tuple) else (outs,)
    total = sum((o.float() ** 2).sum() for o in outs)
    return [o.detach() for o in outs] + list(torch.autograd.grad(total, live))


def _cases(cfg_of):
    """{name: (new, old)} pairs of functions of float inputs, and the
    inputs, from a seeded numpy generator."""
    rng = np.random.default_rng(0)
    t = lambda *shape: torch.tensor(rng.standard_normal(shape),
                                    dtype=torch.float32)
    tokens = torch.tensor(rng.integers(0, 500, (2, 8)))
    labels = torch.tensor(rng.integers(-1, 500, (2, 8)))
    mix = cfg_of("mixtral-8x7b")
    mix_p = param_tree(build_model(mix).init(seed=0, device="cpu"))
    ffn = mix_p["blocks"][0]["ffn"]
    names = sorted(ffn)
    rw = cfg_of("rwkv6-7b")
    H = rw.d_model // rw.rwkv_head_size
    hd = rw.rwkv_head_size

    def moe_fn(impl):
        return lambda x, *w: impl(dict(zip(names, w)), x, mix)

    def wkv_new(r, k, v, w, u):
        return ssm.rwkv_wkv_scan(r, k, v, -torch.exp(w), u,
                                 final_state=False)[0]

    def wkv_old(r, k, v, w, u):
        return kref.rwkv6_ref(r, k, v, -torch.exp(w), u)[0]

    return {
        "embed": (lambda tbl: embed({"table": tbl}, tokens),
                  lambda tbl: tbl[tokens], [t(512, 16)]),
        # 500 of 512 columns real: the pad mask; labels < 0 ignored
        "cross_entropy": (
            lambda lg: model_zoo.cross_entropy(lg, labels, 500),
            lambda lg: old_cross_entropy(lg, labels, 500), [t(2, 8, 512)]),
        "moe_dispatch": (moe_fn(moe._moe_dispatch), moe_fn(old_moe_dispatch),
                         [t(12, mix.d_model)] + [ffn[n] for n in names]),
        "wkv_scan": (wkv_new, wkv_old,
                     [t(2, 8, H, hd), t(2, 8, H, hd), t(2, 8, H, hd),
                      t(2, 8, H, hd), t(H, hd)]),
    }


@pytest.mark.parametrize("where", ["no rules", "1x1 mesh"])
@pytest.mark.parametrize("fn", ["embed", "cross_entropy", "moe_dispatch",
                                "wkv_scan"])
def test_one_process_functions_are_bitwise_their_old_selves(mesh1x1, where,
                                                            fn):
    cfg_of = lambda a: get_config(a).reduced()
    new, old, inputs = _cases(cfg_of)[fn]
    rules = make_rules(cfg_of("qwen3-4b"), mesh1x1) if where == "1x1 mesh" \
        else None
    with use_rules(rules), kernel_mode(False):
        got = _grads(new, inputs)
    with kernel_mode(False):
        want = _grads(old, inputs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("arch", ["qwen3-4b", "mixtral-8x7b", "rwkv6-7b"])
def test_one_process_step_is_bitwise_under_1x1_rules(mesh1x1, arch):
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    rules = make_rules(cfg, mesh1x1)
    runs = []
    for how in ("old signature", "rules None", "1x1 rules"):
        params = param_tree(model.init(seed=0, device="cpu"))
        if how == "1x1 rules":
            params = distribute_params(params, model.param_axes(), rules)
        opt = adamw(cosine_schedule(LR, WARMUP, TOTAL))
        state = opt.init(params)
        kw = {} if how == "old signature" else {
            "rules": rules if how == "1x1 rules" else None}
        step = make_train_step(model, opt, microbatches=MICRO, **kw)
        out = []
        for batch in batches(cfg):
            params, state, metrics = step(params, state, batch)
            out += list(metrics.values())
        runs.append(out + tree_flatten((params, state))[0])
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))
