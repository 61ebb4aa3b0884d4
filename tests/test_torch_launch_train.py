"""The port's training launcher (`repro_torch.launch.train.main`) on the
CPU: a `--smoke --device cpu` run, its checkpoints, a resume from
`latest_step`, `repro.checkpoint` restoring the port's files into
`repro`'s own parameter template, and data parallelism over two gloo
processes against one process on the global batch (model parallelism:
tests/test_torch_model_parallel.py).

`repro`'s launcher itself is not run: outside a mesh its step is what
tests/test_torch_train.py compares, and inside one
(`tests/test_system.py::test_train_launcher_end_to_end`) it fails on
this JAX build's explicit-axis sharding (ROADMAP queue 3).

Data parallelism: two ranks each take half of the global batch, and the
step averages the gradients (all-reduce SUM / 2); one process takes the
whole batch.  The two sum the batch's terms in other orders, so the
parameters after the run and the logged losses are held to rtol 1e-4 /
atol 1e-5, the tolerance of the step against `repro`
(test_torch_train.py).
"""
from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
from repro.checkpoint import restore_checkpoint as j_restore_checkpoint
from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model

from repro_torch.checkpoint import (checkpoint_steps, latest_step,
                                    load_arrays)
from repro_torch.launch import train

from test_torch_train import one_cpu_thread  # noqa: F401  (autouse)

SRC = Path(__file__).resolve().parents[1] / "src"
SMOKE = ["--arch", "qwen3-4b", "--smoke", "--device", "cpu",
         "--seq-len", "32", "--global-batch", "4", "--warmup", "1",
         "--log-every", "1"]
TOL = dict(rtol=1e-4, atol=1e-5)
INIT_TIMEOUT_S, JOIN_TIMEOUT_S = 60, 240

WORKER = r"""
import sys
from datetime import timedelta
import torch
torch.set_num_threads(1)
import torch.distributed as dist
rank, world, store, argv = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                            sys.argv[4:])
dist.init_process_group("gloo", init_method="file://" + store,
                        world_size=world, rank=rank,
                        timeout=timedelta(seconds={init_timeout}))
from repro_torch.launch import train
code = train.main(argv)
dist.destroy_process_group()
sys.exit(code)
"""


def losses(text: str) -> list[float]:
    return [float(m) for m in re.findall(r"step +\d+ loss ([-\d.]+)", text)]


def test_smoke_run_resume_and_latest_step(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    assert train.main(SMOKE + ["--steps", "3", "--ckpt-dir", ck,
                               "--ckpt-every", "2"]) == 0
    first = capsys.readouterr().out
    assert len(losses(first)) == 3 and np.all(np.isfinite(losses(first)))
    assert checkpoint_steps(ck) == [2, 3] and latest_step(ck) == 3
    saved = load_arrays(ck, 3)
    assert train.main(SMOKE + ["--steps", "5", "--ckpt-dir", ck,
                               "--ckpt-every", "100"]) == 0
    resumed = capsys.readouterr().out
    assert "[train] restored step 3" in resumed
    assert len(losses(resumed)) == 2                  # steps 3 and 4
    assert latest_step(ck) == 5
    after = load_arrays(ck, 5)
    assert set(after) == set(saved)
    assert any(not np.array_equal(after[k], saved[k]) for k in saved)
    # a run with nothing left to do restores and returns 0
    assert train.main(SMOKE + ["--steps", "5", "--ckpt-dir", ck]) == 0
    assert "nothing to run" in capsys.readouterr().out


def test_repro_checkpoint_reads_the_port_files(tmp_path):
    ck = str(tmp_path / "ck")
    assert train.main(SMOKE + ["--steps", "2", "--ckpt-dir", ck]) == 0
    jm = j_build_model(j_get_config("qwen3-4b").reduced())
    template = jm.init(jax.random.PRNGKey(1))
    restored = j_restore_checkpoint(ck, 2, template)
    arrays = load_arrays(ck, 2)
    flat = jax.tree_util.tree_flatten_with_path(restored)[0]
    assert len(flat) == len(arrays)
    for (path, leaf), want in zip(flat, jax.tree.leaves(template)):
        key = "/".join(str(p) for p in path)
        assert leaf.shape == want.shape and leaf.dtype == want.dtype
        np.testing.assert_array_equal(np.asarray(leaf), arrays[key])


def test_whisper_frames_from_a_seeded_generator(capsys):
    argv = ["--arch", "whisper-large-v3", "--smoke", "--device", "cpu",
            "--seq-len", "16", "--global-batch", "2", "--steps", "2",
            "--log-every", "1"]
    assert train.main(argv) == 0
    one = losses(capsys.readouterr().out)
    assert train.main(argv) == 0
    assert losses(capsys.readouterr().out) == one
    cfg = j_get_config("whisper-large-v3").reduced()
    a, b = (train.frames_for(cfg, 3, 2, "cpu") for _ in range(2))
    assert a.shape == (2, cfg.encoder_frames, cfg.d_model)
    assert bool((a == b).all())
    assert not bool((a == train.frames_for(cfg, 4, 2, "cpu")).all())


def test_two_gloo_ranks_equal_one_process(tmp_path, capsys):
    argv = SMOKE + ["--steps", "2", "--microbatches", "1"]
    one_dir, two_dir = str(tmp_path / "one"), str(tmp_path / "two")
    assert train.main(argv + ["--ckpt-dir", one_dir]) == 0
    one_losses = losses(capsys.readouterr().out)
    store = str(tmp_path / "store")
    script = WORKER.format(init_timeout=INIT_TIMEOUT_S)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), "2", store, *argv,
         "--ckpt-dir", two_dir], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=JOIN_TIMEOUT_S)
            outs.append(out)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert "mesh {'data': 2, 'model': 1}" in outs[0]
    for out in outs:                    # both ranks log the averaged loss
        np.testing.assert_allclose(losses(out), one_losses, **TOL)
    assert checkpoint_steps(two_dir) == [2]
    want, got = load_arrays(one_dir, 2), load_arrays(two_dir, 2)
    assert set(want) == set(got)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)
