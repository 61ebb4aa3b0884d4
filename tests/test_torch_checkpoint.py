"""`repro_torch.checkpoint` against `repro.checkpoint` on the CPU.

Files written by either package restore into the other's template of
the same structure (nested dict / tuple / list / NamedTuple, f32, int32
and bf16 leaves), bit for bit; the step directory's protocol (atomic
writes, sweep of tmp debris, pruning) is the reference's.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro import checkpoint as jckpt

from repro_torch import checkpoint as tckpt


class Buf(NamedTuple):
    rows: object
    count: object


def _arrays(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((4, 6)).astype(np.float32),
            "y": rng.standard_normal((4, 3)).astype(np.float32),
            "rows": rng.standard_normal((5, 5)).astype(np.float32),
            "count": np.int32(7),
            "idx": rng.integers(0, 9, (3,)).astype(np.int32),
            "h": rng.standard_normal((2, 8)).astype(np.float32)}


def _tree(a: dict, leaf, bf16):
    """One nested structure over `a`'s arrays, leaves built by `leaf`
    (and `bf16` for the bfloat16 one)."""
    return {"carry": ((leaf(a["x"]), leaf(a["y"])),
                      Buf(rows=leaf(a["rows"]), count=leaf(a["count"]))),
            "data": {"idx": leaf(a["idx"]), "half": bf16(a["h"])},
            "list": [leaf(a["y"]), None]}


def _torch_tree(a):
    return _tree(a, lambda v: torch.as_tensor(np.array(v)),
                 lambda v: torch.as_tensor(v).to(torch.bfloat16))


def _jax_tree(a):
    return _tree(a, jnp.asarray, lambda v: jnp.asarray(v, jnp.bfloat16))


def _flat_np(tree) -> list[np.ndarray]:
    out = []

    def walk(t):
        if t is None:
            return
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, tuple) and hasattr(t, "_fields"):
            for v in t:
                walk(v)
        elif isinstance(t, (tuple, list)):
            for v in t:
                walk(v)
        elif isinstance(t, torch.Tensor):
            out.append(t.view(torch.int16).numpy() if t.dtype
                       == torch.bfloat16 else t.numpy())
        else:
            arr = np.asarray(t)
            out.append(arr.view(np.int16) if arr.dtype.itemsize == 2
                       and arr.dtype.kind == "V" or str(arr.dtype)
                       == "bfloat16" else arr)
    walk(tree)
    return out


def test_key_strings_are_repros(tmp_path):
    a = _arrays()
    jckpt.save_checkpoint(str(tmp_path / "j"), 1, _jax_tree(a))
    tckpt.save_checkpoint(str(tmp_path / "t"), 1, _torch_tree(a))
    jk = tckpt.load_arrays(str(tmp_path / "j"), 1)
    tk = tckpt.load_arrays(str(tmp_path / "t"), 1)
    assert sorted(jk) == sorted(tk)
    assert "['carry']/[1]/.rows" in tk and "['data']/['half']" in tk
    for k in jk:
        assert jk[k].dtype == tk[k].dtype, k
        assert jk[k].tobytes() == tk[k].tobytes(), k
    assert tk["['data']/['half']"].dtype.kind == "V"


@pytest.mark.parametrize("seed", [0, 1])
def test_repro_files_restore_into_the_port(tmp_path, seed):
    a = _arrays(seed)
    jckpt.save_checkpoint(str(tmp_path), 3, _jax_tree(a))
    template = _torch_tree(_arrays(99))
    got = tckpt.restore_checkpoint(str(tmp_path), 3, template)
    assert got["data"]["half"].dtype == torch.bfloat16
    assert isinstance(got["carry"][1], Buf)
    assert got["list"][1] is None
    for g, w in zip(_flat_np(got), _flat_np(_torch_tree(a))):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


@pytest.mark.parametrize("seed", [0, 1])
def test_port_files_restore_into_repro(tmp_path, seed):
    a = _arrays(seed)
    tckpt.save_checkpoint(str(tmp_path), 3, _torch_tree(a))
    got = jckpt.restore_checkpoint(str(tmp_path), 3,
                                   _jax_tree(_arrays(99)))
    assert got["data"]["half"].dtype == jnp.bfloat16
    for g, w in zip(_flat_np(got), _flat_np(_jax_tree(a))):
        assert g.tobytes() == w.tobytes()


def test_restore_checks_shapes_and_keeps_device_and_dtype(tmp_path):
    a = _arrays()
    tckpt.save_checkpoint(str(tmp_path), 0, _torch_tree(a))
    bad = _torch_tree(a)
    bad["carry"] = ((torch.zeros(5, 6), bad["carry"][0][1]),
                    bad["carry"][1])
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.restore_checkpoint(str(tmp_path), 0, bad)
    tmpl = {"carry": ((torch.zeros(4, 6, dtype=torch.float64),
                       torch.zeros(4, 3)), Buf(torch.zeros(5, 5),
                                               torch.zeros((), dtype=torch.int64)))}
    got = tckpt.restore_checkpoint(str(tmp_path), 0, tmpl)
    assert got["carry"][0][0].dtype == torch.float64
    assert got["carry"][1].count.dtype == torch.int64
    assert int(got["carry"][1].count) == 7
    with pytest.raises(KeyError):
        tckpt.restore_checkpoint(str(tmp_path), 0, {"absent": torch.zeros(1)})


def test_atomic_write_sweep_and_prune(tmp_path):
    d = str(tmp_path)
    tree = {"v": torch.arange(3.0)}
    for step in (1, 2, 3):
        tckpt.save_checkpoint(d, step, tree)
    # debris of a crash mid-save: invisible to the steps, swept next save
    open(os.path.join(d, "step_00000009.npz.tmp.npz"), "wb").close()
    assert tckpt.checkpoint_steps(d) == [1, 2, 3]
    assert tckpt.latest_step(d) == 3
    tckpt.save_checkpoint(d, 4, tree, keep_last=2)
    assert tckpt.checkpoint_steps(d) == [3, 4]
    assert not any(f.endswith(".tmp.npz") for f in os.listdir(d))
    assert tckpt.prune_checkpoints(d, 1) == [3]
    with pytest.raises(ValueError, match="keep_last"):
        tckpt.prune_checkpoints(d, 0)
    assert tckpt.sweep_stale(str(tmp_path / "missing")) == []
    assert tckpt.checkpoint_steps(str(tmp_path / "missing")) == []
    assert tckpt.latest_step(str(tmp_path / "missing")) is None
    # the two packages list and prune the same directory alike
    assert jckpt.checkpoint_steps(d) == tckpt.checkpoint_steps(d) == [4]
