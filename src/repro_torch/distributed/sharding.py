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
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any

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
