"""Minimal tensor-tree checkpointing: nested state ⇄ compressed .npz.

Counterpart of `repro.checkpoint`, with the same on-disk layout:
<dir>/step_<N>.npz holds one array per leaf under its flattened key
path, and restore rebuilds into a provided template tree (shape checked,
leaves put on the template's device and dtype).  Writes are atomic (tmp
+ `os.replace`), `sweep_stale` clears the `*.tmp.npz` debris a crash
mid-save leaves behind, and `keep_last` bounds the directory.

Trees are nested dicts, tuples, lists and NamedTuples of tensors (numpy
arrays and Python numbers are leaves too; None is an empty subtree).
The key strings are `repro`'s — `jax.tree_util` key paths joined by
"/": ``['carry']`` for a dict key (dicts walked in sorted key order),
``[0]`` for a sequence index, ``.rows`` for a NamedTuple field — so an
.npz written by either package restores into the other's template of
the same structure.  bfloat16 leaves are stored as numpy ``V2`` records,
which is how ml_dtypes' bfloat16 lands in an .npz, and read back by
viewing their 16 bits as `torch.bfloat16`.
"""
from __future__ import annotations

import os
import re
from typing import Any

import numpy as np
import torch


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def _walk(tree: Any, prefix: tuple = ()):
    """(key path, leaf) pairs in `jax.tree_util`'s order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (f"[{k!r}]",))
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield from _walk(getattr(tree, name), prefix + (f".{name}",))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _walk(v, prefix + (f"[{i}]",))
    else:
        yield prefix, tree


def _key(path: tuple) -> str:
    return "/".join(path)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {_key(path): _to_numpy(leaf) for path, leaf in _walk(tree)}


def _step_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}.npz")


def save_checkpoint(directory: str, step: int, tree: Any, *,
                    keep_last: int | None = None) -> str:
    """Atomically write `tree` as step `step`; a crash mid-save leaves
    only a `*.tmp.npz` (swept here on the next save, and invisible to
    `latest_step`).  `keep_last=N` prunes all but the newest N steps
    after a successful write."""
    os.makedirs(directory, exist_ok=True)
    sweep_stale(directory)
    path = _step_path(directory, step)
    tmp = path + ".tmp.npz"          # savez keeps names ending in .npz
    np.savez_compressed(tmp, **_flatten(tree))
    os.replace(tmp, path)
    if keep_last is not None:
        prune_checkpoints(directory, keep_last)
    return path


def sweep_stale(directory: str) -> list[str]:
    """Remove `*.tmp.npz` files a crashed `save_checkpoint` left next
    to the real checkpoints; returns the removed paths."""
    if not os.path.isdir(directory):
        return []
    removed = []
    for f in sorted(os.listdir(directory)):
        if f.endswith(".tmp.npz"):
            p = os.path.join(directory, f)
            os.remove(p)
            removed.append(p)
    return removed


def checkpoint_steps(directory: str) -> list[int]:
    """Ascending step numbers of the completed (non-tmp) checkpoints."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(directory)
                  if (m := re.fullmatch(r"step_(\d+)\.npz", f)))


def latest_step(directory: str) -> int | None:
    steps = checkpoint_steps(directory)
    return steps[-1] if steps else None


def prune_checkpoints(directory: str, keep_last: int) -> list[int]:
    """Delete all but the newest `keep_last` checkpoint steps; returns
    the pruned step numbers."""
    if keep_last < 1:
        raise ValueError(f"keep_last must be >= 1 (got {keep_last}); "
                         f"pruning every checkpoint defeats the point")
    steps = checkpoint_steps(directory)
    pruned = steps[:-keep_last] if keep_last < len(steps) else []
    for s in pruned:
        os.remove(_step_path(directory, s))
    return pruned


def load_arrays(directory: str, step: int) -> dict[str, np.ndarray]:
    """The raw flattened-keypath arrays of one checkpoint — for callers
    (the serve engine's resume path) that rebuild their template before
    knowing which keys it will have."""
    with np.load(_step_path(directory, step)) as data:
        return {k: data[k] for k in data.files}


def _restore_leaf(key: str, arr: np.ndarray, leaf):
    shape = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
    if tuple(arr.shape) != shape:
        raise ValueError(f"shape mismatch for {key}: {arr.shape} vs "
                         f"{shape}")
    if isinstance(leaf, torch.Tensor):
        if arr.dtype.kind == "V":
            # 16-bit records (bfloat16 from either package): the bits
            t = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        return t.to(device=leaf.device, dtype=leaf.dtype)
    if isinstance(leaf, np.ndarray):
        return arr.view(leaf.dtype) if arr.dtype.kind == "V" \
            else arr.astype(leaf.dtype)
    return type(leaf)(arr.item()) if np.ndim(arr) == 0 else arr


def _rebuild(tree, prefix: tuple, arrays: dict):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, prefix + (f"[{k!r}]",), arrays)
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(getattr(tree, name),
                                     prefix + (f".{name}",), arrays)
                            for name in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, prefix + (f"[{i}]",), arrays)
                          for i, v in enumerate(tree))
    key = _key(prefix)
    if key not in arrays:
        raise KeyError(f"checkpoint has no array {key!r}")
    return _restore_leaf(key, arrays[key], tree)


def restore_into(arrays: dict[str, np.ndarray], template: Any) -> Any:
    """Rebuild `template`'s tree from flattened-keypath arrays (shape
    checked; each tensor leaf lands on its template leaf's device and
    dtype, bfloat16 records through their raw bits)."""
    return _rebuild(template, (), arrays)


def restore_checkpoint(directory: str, step: int, template: Any) -> Any:
    return restore_into(load_arrays(directory, step), template)
