"""Dry run of every (architecture × input shape) step on the production
layout, allocating nothing — the counterpart of `repro.launch.dryrun`.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
        --shape train_4k [--multi-pod] [--accounting]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dry.json

`repro` compiles each step on a 512-device host mesh and reads its
costs from XLA.  The port has no HLO and no fake device count: it traces
the step on the meta device (`Model.init(device="meta")`, batches and
caches of meta tensors), where every op computes shapes only, and reads
the costs from the trace:

* FLOPs — `torch.utils.flop_counter.FlopCounterMode` (the matmuls and
  attention products; element-wise work is not counted);
* bytes — the operands and results of every traced op that makes new
  storage (a view moves nothing), with no fusion: an upper count;
* peak — the bytes of the arguments (parameters, optimizer state, batch)
  plus the most that the trace's own tensors held alive at once (each
  storage counted from its creation until it is freed);
* per-device values — the arguments by the sharding rules' placements
  (each leaf divided by the mesh dims that shard it), everything else by
  the device count (the step's work split evenly), the training step's
  activations also by its microbatches;
* collective bytes — from the placements (`train_collective_bytes`).
  `repro`'s `collective_bytes_from_hlo` has no counterpart (no HLO).

The mesh is the production layout as {axis: size} (`production_axes`),
so no 256-rank process group is needed; the rules take it through
`MeshShape`.  Roofline terms are the H100's (`launch.mesh`).  The gossips
and attention run as plain ops on meta tensors (kernel switch off): a
dry run launches nothing.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_leaves

from ..configs import ARCHS, INPUT_SHAPES, get_config
from ..configs.base import ArchConfig, InputShape
from ..distributed.sharding import make_rules
from ..kernels import ops as kops
from .costs import (affine_correct, depth_pair, flops_estimate,
                    model_flops_convention, reduced_depth)
from .mesh import (H100_HBM_BYTES_PER_S, H100_NVLINK_BYTES_PER_S,
                   H100_PEAK_FLOPS_BF16)

# long_500k policy: whisper skipped; SSM/hybrid native; attention archs
# use a sliding-window cache of this size
LONG_WINDOW = 8192
SKIP = {("whisper-large-v3", "long_500k"):
        "encoder-decoder: 500k self-cache is semantically undefined "
        "(30s audio source); see DESIGN.md §5"}

COMPUTE_DTYPE = torch.bfloat16
META = torch.device("meta")


def production_axes(multi_pod: bool = False) -> dict[str, int]:
    """The production mesh as {axis: size}: (data=16, model=16), or
    (pod=2, data=16, model=16) across two pods."""
    return {"pod": 2, "data": 16, "model": 16} if multi_pod \
        else {"data": 16, "model": 16}


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's named dims and sizes without devices or a process group —
    what `distributed.sharding.make_rules` reads of a `DeviceMesh`."""
    axes: tuple

    @classmethod
    def of(cls, axes: dict) -> "MeshShape":
        return cls(tuple(axes.items()))

    @property
    def mesh_dim_names(self) -> tuple:
        return tuple(a for a, _ in self.axes)

    @property
    def shape(self) -> tuple:
        return tuple(s for _, s in self.axes)

    def size(self) -> int:
        return math.prod(self.shape)


def microbatches_for(cfg: ArchConfig, shape: InputShape, mesh: dict) -> int:
    """Grad-accumulation factor so the rematerialised activations fit
    HBM: saved bytes ≈ L × B_shard/mb × S × d × 2; target ≤ 2 GB.
    `mesh` is {axis: size}."""
    dp = mesh.get("data", 1) * mesh.get("pod", 1)
    b_shard = max(shape.global_batch // dp, 1)
    layers = cfg.num_layers + cfg.encoder_layers
    bytes_act = layers * b_shard * shape.seq_len * cfg.d_model * 2
    mb = 1
    while bytes_act / mb > 2e9 and mb < b_shard:
        mb *= 2
    return mb


def batch_specs(cfg: ArchConfig, shape: InputShape, *, with_labels: bool):
    """({name: meta tensor}, {name: logical axes}) of one step's batch."""
    B, S = shape.global_batch, shape.seq_len
    spec = {"tokens": torch.empty((B, S), dtype=torch.int64, device=META)}
    sh = {"tokens": ("batch", None)}
    if with_labels:
        spec["labels"] = torch.empty((B, S), dtype=torch.int64, device=META)
        sh["labels"] = ("batch", None)
    if cfg.encoder_decoder:
        spec["frames"] = torch.empty((B, cfg.encoder_frames, cfg.d_model),
                                     dtype=COMPUTE_DTYPE, device=META)
        sh["frames"] = ("batch", None, None)
    return spec, sh


def _window(cfg: ArchConfig, shape_name: str) -> int:
    return LONG_WINDOW if (shape_name == "long_500k"
                           and not cfg.sliding_window
                           and not cfg.attn_free
                           and not cfg.shared_attn_every) else 0


def input_specs(arch: str, shape_name: str):
    """Meta-device stand-ins for every model input of the (arch × shape)
    pair: the batch of a train or prefill step; a decode step's new
    token and its cache of seq_len (a sliding window of LONG_WINDOW for
    full-attention archs at long_500k)."""
    from ..models import build_model
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    if shape.kind == "train":
        return batch_specs(cfg, shape, with_labels=True)[0]
    if shape.kind == "prefill":
        return batch_specs(cfg, shape, with_labels=False)[0]
    cache = build_model(cfg).init_cache(
        shape.global_batch, shape.seq_len, COMPUTE_DTYPE,
        window_override=_window(cfg, shape_name), device=META)
    tokens = torch.empty((shape.global_batch, 1), dtype=torch.int64,
                         device=META)
    return {"tokens": tokens, "cache": cache}


@dataclasses.dataclass
class DryRunResult:
    arch: str
    shape: str
    mesh: str
    ok: bool
    error: str = ""
    skip_reason: str = ""
    compile_s: float = 0.0          # the trace's seconds
    flops: float = 0.0              # per device
    hbm_bytes_accessed: float = 0.0
    peak_memory_per_device: float = 0.0
    argument_size_per_device: float = 0.0
    collective_bytes: dict = dataclasses.field(default_factory=dict)
    params_b: float = 0.0
    microbatches: int = 1
    # depth-pair accounting (traces at two reduced depths, fitted affine)
    flops_corrected: float = 0.0
    bytes_corrected: float = 0.0
    collective_bytes_corrected: float = 0.0
    analytic_flops_per_chip: float = 0.0
    model_flops_per_chip: float = 0.0
    useful_ratio: float = 0.0

    def roofline(self) -> dict:
        """Roofline terms in seconds, per device, on the H100's dense bf16
        peak, HBM rate and NVLink rate (one direction); the depth-pair
        values where the accounting ran."""
        coll = self.collective_bytes_corrected or \
            sum(self.collective_bytes.values())
        flops = self.flops_corrected or self.flops
        byts = self.bytes_corrected or self.hbm_bytes_accessed
        terms = {"compute_s": flops / H100_PEAK_FLOPS_BF16,
                 "memory_s": byts / H100_HBM_BYTES_PER_S,
                 "collective_s": coll / H100_NVLINK_BYTES_PER_S}
        terms["bottleneck"] = max(terms, key=terms.get)
        return terms


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class TraceCost(TorchDispatchMode):
    """Bytes and live-memory peak of the ops traced inside it: `bytes`
    sums every op's tensor operands and results (a view of storage the
    trace holds moves none); `peak` is the largest total of the storages
    that traced ops created and that were alive together (a storage is
    counted once, from its creation until it is freed)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._alive: set = set()

    def _freed(self, key, nbytes: int) -> None:
        self._alive.discard(key)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        fresh = []
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                if st._cdata not in self._alive:
                    fresh.append(st)
        if not fresh:               # a view of live storage moves nothing
            return out
        self.bytes += sum(_nbytes(t) for t in
                          tree_leaves((args, kwargs or {}, out))
                          if isinstance(t, torch.Tensor))
        for st in fresh:
            key = st._cdata
            if key in self._alive:
                continue
            self._alive.add(key)
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._freed, key, st.nbytes())
        return out


def trace_costs(fn, *args) -> dict:
    """fn(*args) traced on the meta device, the kernel switch off:
    {"flops", "bytes", "peak_live", "seconds"}."""
    from torch.utils.flop_counter import FlopCounterMode
    t0 = time.perf_counter()
    flops = FlopCounterMode(display=False)
    cost = TraceCost()
    with kops.kernel_mode(False), flops, cost:
        fn(*args)
    return {"flops": float(flops.get_total_flops()),
            "bytes": float(cost.bytes), "peak_live": float(cost.peak),
            "seconds": time.perf_counter() - t0}


def _shard_factor(rules, axes: tuple) -> int:
    """How many pieces the placements cut a tensor with these logical
    axes into."""
    sizes = dict(zip(rules.mesh.mesh_dim_names, rules.mesh.shape))
    factor = 1
    for entry in rules.resolve(*axes):
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            factor *= sizes.get(name, 1) if name is not None else 1
    return factor


def sharded_bytes(tree_axes: dict, shapes: dict, rules, itemsize) -> float:
    """Per-device bytes of a parameter-shaped tree: each leaf's bytes over
    its placement's shard count."""
    return float(sum(math.prod(shapes[k]) * itemsize(k)
                     / _shard_factor(rules, ax)
                     for k, ax in tree_axes.items()))


def train_collective_bytes(cfg: ArchConfig, shape: InputShape, rules,
                           param_axes: dict, param_shapes: dict,
                           microbatches: int) -> dict:
    """Per-device collective bytes of one training step from the
    placements, as ring collectives move them:

    * a parameter sharded over "data" (fsdp) is all-gathered for the
      forward and again for the backward of every microbatch, and its
      gradient reduce-scattered once a step: (dp − 1) shards each;
    * a parameter replicated over "data" has its gradient all-reduced
      once a step: 2(dp − 1)/dp of its per-device bytes;
    * tensor parallelism: where heads (attention) or ffn shard over
      "model", each layer all-reduces its (B/dp, S, d) block output twice
      in the forward and twice in the backward, 2(m − 1)/m of it each.
    Parameters and gradients move in bf16."""
    sizes = dict(zip(rules.mesh.mesh_dim_names, rules.mesh.shape))
    dp = sizes.get("data", 1) * sizes.get("pod", 1)
    m = sizes.get("model", 1)
    item = COMPUTE_DTYPE.itemsize
    gather = scatter = reduce = 0.0
    for name, ax in param_axes.items():
        local = math.prod(param_shapes[name]) * item \
            / _shard_factor(rules, ax)
        data_sharded = any("data" in (e if isinstance(e, tuple) else (e,))
                           for e in rules.resolve(*ax) if e is not None)
        if dp > 1 and data_sharded:
            gather += 2 * microbatches * (dp - 1) * local
            scatter += (dp - 1) * local
        elif dp > 1:
            reduce += 2 * (dp - 1) / dp * local
    tp = 0.0
    if m > 1 and (rules.table.get("heads") or rules.table.get("ffn")):
        act = (shape.global_batch // dp) * shape.seq_len * cfg.d_model * item
        layers = cfg.num_layers + cfg.encoder_layers
        tp = layers * 4 * 2 * (m - 1) / m * act
    out = {"all-gather": gather, "reduce-scatter": scatter,
           "all-reduce": reduce + tp}
    return {k: v for k, v in out.items() if v}


def build_step_and_args(cfg: ArchConfig, shape: InputShape,
                        shape_name: str, *, microbatches: int = 1):
    """(fn, args, extra) of the step on meta stand-ins; the parameters in
    bf16 (AdamW's moments f32), as `repro`'s dry run."""
    from ..models import build_model
    from ..models.layers import param_tree
    from ..models.steps import (make_decode_step, make_prefill_step,
                                make_train_step)
    from ..optim import adamw
    model = build_model(cfg)
    params = param_tree(model.init(dtype=COMPUTE_DTYPE, device=META))
    if shape.kind == "train":
        opt = adamw(1e-4)
        step = make_train_step(model, opt, microbatches=microbatches)
        batch = batch_specs(cfg, shape, with_labels=True)[0]
        return step, (params, opt.init(params), batch), {
            "optimizer_bytes_per_param": 8}
    if shape.kind == "prefill":
        fn = make_prefill_step(model, cache_dtype=COMPUTE_DTYPE)
        return fn, (params, batch_specs(cfg, shape,
                                        with_labels=False)[0]), {}
    cache = model.init_cache(shape.global_batch, shape.seq_len,
                             COMPUTE_DTYPE,
                             window_override=_window(cfg, shape_name),
                             device=META)
    tokens = torch.empty((shape.global_batch, 1), dtype=torch.int64,
                         device=META)
    return make_decode_step(model), (params, tokens, cache), {}


def _arg_bytes(args) -> float:
    return float(sum(_nbytes(t) for t in tree_flatten(args)[0]
                     if isinstance(t, torch.Tensor)))


def accounting_pass(cfg, shape, shape_name, rules, res: DryRunResult,
                    n_dev: int) -> None:
    """Two traces at reduced depths (`costs.depth_pair`), microbatches 1,
    fitted affine in the depth to the full one (`costs.affine_correct`):
    flops, bytes and collective bytes per device (the latter at the
    step's microbatches)."""
    from ..models import build_model
    l1, l2 = depth_pair(cfg)
    vals = {}
    for L in (l1, l2):
        sub = reduced_depth(cfg, L)
        fn, args, _ = build_step_and_args(sub, shape, shape_name)
        cost = trace_costs(fn, *args)
        coll = 0.0
        if shape.kind == "train":
            mod = build_model(sub).init(dtype=COMPUTE_DTYPE, device=META)
            coll = sum(train_collective_bytes(
                sub, shape, rules, build_model(sub).param_axes(),
                {k: tuple(p.shape) for k, p in mod.named_parameters()},
                res.microbatches).values())
        vals[L] = (cost["flops"] / n_dev, cost["bytes"] / n_dev, coll)
    L = cfg.num_layers
    res.flops_corrected = affine_correct(vals[l1][0], vals[l2][0], l1, l2, L)
    res.bytes_corrected = affine_correct(vals[l1][1], vals[l2][1], l1, l2, L)
    res.collective_bytes_corrected = affine_correct(
        vals[l1][2], vals[l2][2], l1, l2, L)


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            verbose: bool = True, accounting: bool = False,
            expert_parallel: bool = False, microbatches: int = 0
            ) -> DryRunResult:
    """One (arch × shape) dry run on the production layout."""
    from ..models import build_model
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    axes = production_axes(multi_pod)
    mesh = MeshShape.of(axes)
    n_dev = mesh.size()
    mesh_name = "x".join(str(s) for s in mesh.shape)
    res = DryRunResult(arch=arch, shape=shape_name, mesh=mesh_name,
                       ok=False)
    if (arch, shape_name) in SKIP:
        res.skip_reason = SKIP[(arch, shape_name)]
        if verbose:
            print(f"[dryrun] SKIP {arch} × {shape_name}: {res.skip_reason}")
        return res
    rules = make_rules(cfg, mesh, seq_shard_cache=shape.kind == "decode",
                       fsdp=shape.kind == "train",
                       expert_parallel=expert_parallel)
    if shape.global_batch == 1:
        cs = "data" if rules.table.get("kv_heads") else ("data", "model")
        rules = dataclasses.replace(
            rules, table={**rules.table, "batch": None, "cache_seq": cs})
    try:
        model = build_model(cfg)
        mod = model.init(dtype=COMPUTE_DTYPE, device=META)
        p_shapes = {k: tuple(p.shape) for k, p in mod.named_parameters()}
        p_axes = model.param_axes()
        mb = 1
        if shape.kind == "train":
            mb = microbatches or microbatches_for(cfg, shape, axes)
        # one trace of the global step with microbatches 1: the same ops
        # as mb microbatches of B / mb rows, up to the accumulation adds
        fn, args, extra = build_step_and_args(cfg, shape, shape_name)
        cost = trace_costs(fn, *args)
        res.compile_s = cost["seconds"]
        res.flops = cost["flops"] / n_dev
        res.hbm_bytes_accessed = cost["bytes"] / n_dev
        param_dev = sharded_bytes(p_axes, p_shapes, rules,
                                  lambda _: COMPUTE_DTYPE.itemsize)
        opt_dev = param_dev / COMPUTE_DTYPE.itemsize \
            * extra.get("optimizer_bytes_per_param", 0)
        # the batch (and a decode step's cache) split over the devices
        rest = _arg_bytes(args[2:] if shape.kind == "train" else args[1:])
        res.argument_size_per_device = param_dev + opt_dev + rest / n_dev
        res.peak_memory_per_device = res.argument_size_per_device + \
            cost["peak_live"] / n_dev / mb
        if shape.kind == "train":
            res.collective_bytes = train_collective_bytes(
                cfg, shape, rules, p_axes, p_shapes, mb)
        res.params_b = model.param_count() / 1e9
        res.microbatches = mb
        res.analytic_flops_per_chip = flops_estimate(cfg, shape) / n_dev
        n_active = int(model.param_count() * (cfg.active_param_count()
                                              / max(cfg.param_count(), 1)))
        res.model_flops_per_chip = model_flops_convention(
            cfg, shape, n_active) / n_dev
        if accounting:
            accounting_pass(cfg, shape, shape_name, rules, res, n_dev)
        useful = res.flops_corrected or res.flops
        res.useful_ratio = res.model_flops_per_chip / useful if useful else 0
        res.ok = True
        if verbose:
            rf = res.roofline()
            terms = {k: f"{v * 1e3:.2f}ms" for k, v in rf.items()
                     if k != "bottleneck"}
            print(f"[dryrun] OK {arch} × {shape_name} ({mesh_name}) "
                  f"trace={res.compile_s:.1f}s flops={res.flops:.3g} "
                  f"corr={res.flops_corrected:.3g} "
                  f"mem/dev={res.peak_memory_per_device / 1e9:.2f}GB "
                  f"coll={sum(res.collective_bytes.values()) / 1e9:.3f}GB "
                  f"roofline={terms} bound={rf['bottleneck']}")
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        res.error = f"{type(e).__name__}: {e}"
        if verbose:
            print(f"[dryrun] FAIL {arch} × {shape_name}: {res.error[:500]}")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--accounting", action="store_true",
                    help="also trace the depth pair and fit the full depth")
    ap.add_argument("--expert-parallel", action="store_true",
                    help="experts over the model axis")
    ap.add_argument("--microbatches", type=int, default=0,
                    help="override the grad-accumulation heuristic")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    kw = dict(multi_pod=args.multi_pod, accounting=args.accounting,
              expert_parallel=args.expert_parallel,
              microbatches=args.microbatches)
    if args.all:
        results = [run_one(a, s, **kw) for a in ARCHS for s in INPUT_SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        results = [run_one(args.arch, args.shape, **kw)]
    if args.out:
        with open(args.out, "w") as f:
            json.dump([dataclasses.asdict(r) for r in results], f, indent=1)
    n_fail = sum(1 for r in results if not r.ok and not r.skip_reason)
    print(f"[dryrun] {sum(r.ok for r in results)} ok, {n_fail} failed, "
          f"{sum(1 for r in results if r.skip_reason)} skipped")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
