"""Logical-axis sharding rules → `DeviceMesh` placements.

Model code annotates parameters and activations with *logical* axis
names ("batch", "vocab", "ffn", "heads", ...).  A `ShardingRules` object
maps those to mesh dims for a given (ArchConfig, mesh) pair, with the
table `repro.distributed.sharding` derives:

  batch   → ("pod", "data")      (or ("data",) single-pod)
  vocab   → "model"              (vocab padded to /256 so it divides)
  ffn     → "model"              (d_ff, mamba d_inner, rwkv dims)
  heads   → "model" iff num_heads % model_size == 0 else replicated
  kv_heads→ "model" iff num_kv_heads % model_size == 0 else replicated
  experts → None (TP-inside-expert default) or "model" (expert-parallel)
  seq     → None by default; "model" for the sequence-sharded long-decode
            cache where the kv heads do not shard

The mesh is a `torch.distributed` `DeviceMesh` (`repro_torch.launch.mesh`)
whose dim names are the mesh axes.  `resolve(*logical)` gives the
PartitionSpec-like entry per tensor dim (a mesh dim name, a tuple of
them, or None) and `placements(*logical)` the same as one `Shard` or
`Replicate` per mesh dim, which `DTensor` takes.

Rules are installed in a thread-local context (`use_rules`); `shard(x,
*logical_axes)` returns x itself when no rules are installed or the mesh
has one device — one card — so single-device code runs unchanged.

Model parallelism (`repro_torch.launch.train --model-parallel k`):
`distribute_params` lays a parameter tree out as `DTensor`s on
`tree_param_sharding`'s placements (the tree itself where the mesh has
one rank) and `gather_params` takes each leaf whole again.  The model's
functions then run on DTensors, whose sharding propagation inserts the
collectives.  Where an op has no such rule and is independent across
rows and heads (attention, the WKV and SSD scans), `on_local_shards`
runs it on each rank's shards; where it reduces over a sharded axis (a
masked vocabulary lookup, the cross-entropy's sums over the vocabulary)
the function works on each rank's shard, whose place in the whole
`shard_start` gives, and joins the shards with `reduce_local`, an
all-reduce whose gradient comes back replicated.  Plain tensors that
the model makes itself (positions, masks) count as replicated under
`replicate_plain_tensors`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any

import torch

from ..configs.base import ArchConfig

_state = threading.local()


def _mesh_axes(mesh) -> dict[str, int]:
    """{mesh dim name: size} of a `DeviceMesh`."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mesh: Any    # torch.distributed DeviceMesh with named dims
    table: dict  # logical name -> mesh dim name | tuple | None

    def resolve(self, *logical: str | None) -> tuple:
        """One entry per tensor dim: the mesh dim(s) it shards over."""
        return tuple(self.table.get(a) if a is not None else None
                     for a in logical)

    def placements(self, *logical: str | None) -> tuple:
        """One `Shard(tensor dim)` or `Replicate()` per mesh dim."""
        from torch.distributed.tensor import Replicate, Shard
        by_mesh_dim = {}
        for dim, entry in enumerate(self.resolve(*logical)):
            names = entry if isinstance(entry, tuple) else (entry,)
            for name in names:
                if name is None:
                    continue
                if name in by_mesh_dim:
                    raise ValueError(f"mesh dim {name!r} shards tensor dims "
                                     f"{by_mesh_dim[name]} and {dim}")
                by_mesh_dim[name] = dim
        return tuple(Shard(by_mesh_dim[n]) if n in by_mesh_dim
                     else Replicate() for n in self.mesh.mesh_dim_names)


def make_rules(cfg: ArchConfig, mesh, *, expert_parallel: bool = False,
               seq_shard_cache: bool = False,
               fsdp: bool = True) -> ShardingRules:
    axes = _mesh_axes(mesh)
    model = "model" if "model" in axes else None
    msize = axes.get("model", 1)
    batch = tuple(a for a in ("pod", "data") if a in axes) or None

    def if_div(k: int):
        return model if (model and k and k % msize == 0) else None

    kv = if_div(cfg.num_kv_heads)
    # Each mesh dim may shard one tensor dim: when KV heads already shard
    # over `model` (e.g. zamba2 kv=32), the cache sequence axis stays
    # replicated; seq-sharding is the fallback for GQA/MQA archs whose
    # kv count does not divide the model axis.
    table = {
        "batch": batch,
        "vocab": model,
        "ffn": model,
        "embed": None,
        "heads": if_div(cfg.num_heads),
        "kv_heads": kv,
        "rwkv_heads": if_div(cfg.d_model // max(cfg.rwkv_head_size, 1))
        if cfg.attn_free else None,
        "experts": (model if expert_parallel else None),
        "cache_seq": (model if seq_shard_cache and kv is None else None),
        "fsdp": ("data" if fsdp and "data" in axes else None),
        "frames": None,
    }
    return ShardingRules(mesh=mesh, table=table)


@contextlib.contextmanager
def use_rules(rules: ShardingRules | None):
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def current_rules() -> ShardingRules | None:
    return getattr(_state, "rules", None)


def shard(x, *logical: str | None):
    """Lay x out over the installed rules' mesh (x itself when no rules
    are installed or the mesh has one device).

    Pass one logical axis name (or None) per tensor dim.  A `DTensor` is
    redistributed; a plain tensor, the same full value on every rank, is
    distributed."""
    rules = current_rules()
    if rules is None:
        return x
    if x.dim() != len(logical):
        raise ValueError(f"rank {x.dim()} vs {len(logical)} logical axes")
    if rules.mesh.size() == 1:
        return x
    from torch.distributed.tensor import DTensor, distribute_tensor
    placements = rules.placements(*logical)
    if isinstance(x, DTensor):
        return x.redistribute(rules.mesh, placements)
    return distribute_tensor(x, rules.mesh, placements)


def tree_param_sharding(param_axes, rules: ShardingRules):
    """Map a tree (dicts and lists) of logical-axis tuples to placement
    tuples, one per leaf."""
    if isinstance(param_axes, tuple):
        return rules.placements(*param_axes)
    if isinstance(param_axes, dict):
        return {k: tree_param_sharding(v, rules)
                for k, v in param_axes.items()}
    if isinstance(param_axes, list):
        return [tree_param_sharding(v, rules) for v in param_axes]
    raise TypeError(f"expected a tuple of logical axes, a dict or a list, "
                    f"got {type(param_axes).__name__}")


def is_sharded(x) -> bool:
    """Whether x is a `DTensor` (a leaf or activation on a mesh)."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _map_named(tree, fn, prefix: str = ""):
    """tree with each leaf t replaced by fn(state-dict name, t)."""
    if isinstance(tree, dict):
        return {k: _map_named(v, fn, f"{prefix}{k}.") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_named(v, fn, f"{prefix}{i}.") for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


def distribute_params(params, param_axes: dict, rules: ShardingRules):
    """The parameter tree (`models.layers.param_tree`: dicts and lists)
    laid out on the rules' mesh: each leaf a `DTensor` on
    `tree_param_sharding(param_axes, rules)`'s placements, param_axes
    keyed by state-dict name (`blocks.0.attn.wq`), as `Model.param_axes`
    gives it.  Every rank holds the same whole tree (drawn from one seed,
    or read from one checkpoint) and keeps its own shard of each leaf: no
    collective runs.  Where the mesh has one rank, the tree itself."""
    if rules.mesh.size() == 1:
        return params
    from torch.distributed.tensor import distribute_tensor
    placements = tree_param_sharding(param_axes, rules)
    return _map_named(params, lambda name, t: distribute_tensor(
        t, rules.mesh, placements[name], src_data_rank=None))


def gather_params(tree):
    """Each `DTensor` leaf of a tree whole (`full_tensor()`, a collective
    every rank joins), plain leaves as they are: a checkpoint's tree."""
    return _map_named(tree, lambda _, t: t.full_tensor() if is_sharded(t)
                      else t)


def as_dtensor(x, mesh):
    """x on `mesh`: a `DTensor` as it is, a plain tensor (the same on every
    rank) replicated."""
    from torch.distributed.tensor import DTensor, Replicate
    if is_sharded(x):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def shard_start(size: int, mesh, dim: int) -> int:
    """Where this rank's shard begins along a tensor dim of `size` that
    `Shard` splits over mesh dim `dim`: DTensor splits as `torch.chunk`
    does, ceil(size / n) a shard, the last ones shorter or empty."""
    n = mesh.size(dim)
    return min(mesh.get_coordinate()[dim] * -(-size // n), size)


def on_local_shards(fn, args, in_axes, out_axes):
    """fn(*args) on each rank's own shards under the installed rules, for
    a function that no collective joins: each arg (a `DTensor`, a plain
    tensor the same on every rank, or None) is laid out on the rules'
    placements of its logical axes `in_axes[i]` and taken local, fn runs
    on the local tensors, and its outputs (a tuple where out_axes is a
    list; None passes through) become DTensors on `out_axes`'
    placements.  fn must be independent across every sharded axis.  A
    mesh dim that shards any input splits the work, so an input that it
    does not shard gets back a gradient partial over it (a head's u
    summed over the ranks' rows, a kv head over the query heads that
    read it)."""
    from torch.distributed.tensor import DTensor, Partial, Shard
    rules = current_rules()
    mesh = rules.mesh
    places = [rules.placements(*ax) for ax in in_axes]
    split = {d for p in places for d, q in enumerate(p)
             if isinstance(q, Shard)}
    local = [None if a is None else as_dtensor(a, mesh).redistribute(
        mesh, p).to_local(grad_placements=tuple(
            Partial() if d in split and not isinstance(q, Shard) else q
            for d, q in enumerate(p)))
        for a, p in zip(args, places)]
    outs = fn(*local)
    wrap = lambda t, ax: None if t is None else DTensor.from_local(
        t, mesh, rules.placements(*ax), run_check=False)
    if isinstance(out_axes, list):
        return tuple(wrap(t, ax) for t, ax in zip(outs, out_axes))
    return wrap(outs, out_axes)


def reduce_local(local: torch.Tensor, mesh, placements, dims, op="sum"):
    """`local`, one rank's term of a reduction over the mesh dims `dims`,
    reduced over them (an all-reduce `op`, "sum" or "max") as a plain
    tensor.  placements: the layout of `local` on every mesh dim (those
    in `dims` are ignored).  The gradient of the result comes back to
    every rank's term whole, as the result was replicated."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    part = tuple(Partial(op) if i in dims else p
                 for i, p in enumerate(placements))
    full = tuple(Replicate() if i in dims else p
                 for i, p in enumerate(placements))
    return DTensor.from_local(local, mesh, part, run_check=False
                              ).redistribute(mesh, full).to_local()


_implicit_lock = threading.Lock()
_implicit_depth = 0
_implicit_ctx = None


@contextlib.contextmanager
def replicate_plain_tensors():
    """DTensor's `implicit_replication()` for a block: plain tensors meeting
    DTensors count as replicated.  Threads may enter it at once (two ranks
    of one process): where torch keeps the flag per thread each thread
    sets its own; where it keeps one flag for the process, the first
    thread in sets it and the last one out clears it."""
    from torch.distributed.tensor.experimental import implicit_replication
    global _implicit_depth, _implicit_ctx
    if hasattr(torch._C, "_set_dtensor_allow_implicit_replication"):
        with implicit_replication():
            yield
        return
    with _implicit_lock:
        _implicit_depth += 1
        if _implicit_depth == 1:
            _implicit_ctx = implicit_replication()
            _implicit_ctx.__enter__()
    try:
        yield
    finally:
        with _implicit_lock:
            _implicit_depth -= 1
            if _implicit_depth == 0:
                _implicit_ctx.__exit__(None, None, None)
