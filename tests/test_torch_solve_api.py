"""The port's `solve` front-end on the CPU: device selection, seeded
initialisation, schedules, that every tier runs (the baselines and
faults are in test_torch_baselines.py and test_torch_faults.py, the
sharded tier in test_torch_sharded.py), the matrix-free curvature
estimate, and the import isolation of the package.  End-to-end parity with `repro.solve` is in
test_torch_solve.py.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.core import problems as jp
from repro.solve import ScheduleSpec as JSchedule
from repro.solve import SolverSpec as JSpec
from repro.solve import solve as jsolve
from repro.topology import make_network as j_make_network

from repro_torch.core import problems as tp
from repro_torch.solve import CommSpec, ScheduleSpec, SolverSpec, solve
from repro_torch.topology import make_network

SRC = Path(__file__).resolve().parents[1] / "src"


def test_matrix_free_without_curvature_estimates_it():
    """curvature=None runs power iteration every round from one fixed
    start vector (`dihgp.power_start`); `repro` draws its start vector
    from another generator, so the bounds, and the runs, agree only to
    the power iteration's convergence (12 steps: ~1e-2)."""
    jprob = jp.quadratic_bilevel(8, 6, 6, seed=1)
    tprob = tp.quadratic_bilevel(8, 6, 6, seed=1, device="cpu")
    spec = dict(K=5, M=5, U=3, dihgp="matrix_free")
    y0 = np.zeros((8, 6), np.float32)
    jres = jsolve(jprob, j_make_network("ring", 8), JSpec(**spec),
                  y0=jnp.asarray(y0))
    tres = solve(tprob, make_network("ring", 8), SolverSpec(**spec),
                 y0=y0, device="cpu")
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x),
                               rtol=5e-2, atol=1e-3)
    assert tres.ledger.total_bytes == jres.ledger.total_bytes


def test_solve_needs_a_card_unless_told_cpu(monkeypatch):
    tprob = tp.quadratic_bilevel(4, 2, 3, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve(tprob, make_network("ring", 4), SolverSpec(K=1))
    res = solve(tprob, make_network("ring", 4), SolverSpec(K=1, M=1),
                device="cpu")
    assert res.x.device.type == "cpu"


def test_default_init_draws_y0_from_the_seed():
    """x0 = 0 and y0 = 0.01·N(0, I) from torch.Generator(device) seeded
    with `seed`: the same seed repeats the run, another seed does not."""
    tprob = tp.quadratic_bilevel(4, 2, 3, device="cpu")
    net = make_network("ring", 4)
    spec = SolverSpec(K=2, M=2, U=1)
    a, b, c = (solve(tprob, net, spec, seed=s, device="cpu")
               for s in (3, 3, 4))
    assert torch.equal(a.y, b.y) and torch.equal(a.x, b.x)
    assert not torch.equal(a.y, c.y)


def test_queued_paths_raise_naming_their_roadmap_item():
    """No path is queued any more: the sharded tier (item 11) runs since
    its slice, on a ring of agents (`mesh=`), and the module keeps no
    stub.  The serve tier and obs (items 9 and 10) run — the flight
    recorder with dagm, the obs hooks of the fault trace and the ledger
    — and so do the baselines and faults (items 6 and 7)."""
    from repro_torch import obs
    from repro_torch.distributed import LocalRing
    from repro_torch.faults import FaultSpec, lower_faults
    from repro_torch.solve import api, sharded_spec
    tprob = tp.quadratic_bilevel(4, 2, 3, device="cpu")
    net = make_network("ring", 4)
    assert not hasattr(api, "_QUEUED_TIERS")
    with pytest.raises(ValueError, match="curvature"):
        solve(tprob, net, SolverSpec(K=1, tier="sharded"), device="cpu")
    sh = solve(tprob, net, sharded_spec(K=2, curvature=6.0),
               mesh=LocalRing(4, device="cpu"))
    assert sh.tier == "sharded" and sh.metrics["outer_loss"].shape == (2,)
    with pytest.raises(TypeError, match="RecorderSpec"):
        solve(tprob, net, SolverSpec(K=1), device="cpu",
              recorder=object())
    ref = solve(tprob, net, SolverSpec(K=2), device="cpu",
                recorder=obs.RecorderSpec())
    assert ref.extras["flight"].shape == (2, len(obs.FIELDS))
    srv = solve(tprob, net, SolverSpec(K=2, tier="serve"), device="cpu")
    assert srv.tier == "serve" and torch.equal(srv.x, ref.x)
    res = solve(tprob, net, SolverSpec(K=1, faults=FaultSpec(
        drop_prob=0.5)), device="cpu")
    for obj in (res.extras["fault_trace"], res.ledger,
                lower_faults(FaultSpec(), net, 2)):
        obj.observe(case="queued")
    assert obs.counter_value("comm_sends_total", case="queued",
                             ledger=res.ledger.name, channel="outer_x",
                             spec="identity") == 1
    for method in ("dgbo", "dgtbo", "fednest", "ma_dbo"):
        assert solve(tprob, net, SolverSpec(K=1, M=1, method=method),
                     device="cpu").method == method
    with pytest.raises(ValueError, match="positive iteration count"):
        solve(tprob, net, SolverSpec(K=0), device="cpu")


def test_spec_carries_only_what_the_port_reads():
    """The port's SolverSpec is a subset of repro's: the sharded tier's
    options came with the code that reads them (`ShardedSpec.axis`,
    `mix_every`, `CommSpec.persist_ef`), and `repro`'s `unroll_loops`,
    which only its traced loops read, has no counterpart, so a caller
    cannot set one that would be silently ignored; the baselines'
    momentum, b and N are back with the baselines, at repro's
    defaults."""
    from repro.solve import CommSpec as JComm
    from repro.solve import ShardedSpec as JSharded

    from repro_torch.solve import ShardedSpec
    names = {f.name for f in dataclasses.fields(SolverSpec)}
    assert names <= {f.name for f in dataclasses.fields(JSpec)}
    assert "sharded" in names
    for name in ("momentum", "b", "N"):
        assert getattr(SolverSpec(), name) == getattr(JSpec(), name)
    sharded = {f.name for f in dataclasses.fields(ShardedSpec)}
    assert sharded == {f.name for f in dataclasses.fields(JSharded)} \
        - {"unroll_loops"}
    for name in sharded:
        assert getattr(ShardedSpec(), name) == getattr(JSharded(), name)
    assert CommSpec(persist_ef=True).persist_ef
    assert CommSpec().persist_ef == JComm().persist_ef is False
    with pytest.raises(TypeError):
        ShardedSpec(unroll_loops=True)


def test_schedules_materialize_like_repro():
    K = 6
    for sched in (dict(alpha=0.05, beta=0.1),
                  dict(alpha=tuple(np.linspace(0.1, 0.01, K)), beta=0.2,
                       gamma=3.0)):
        jm = JSchedule(**sched).materialize(K)
        tm = ScheduleSpec(**sched).materialize(K)
        for f in ("alpha", "beta", "gamma"):
            np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f))
    tm = ScheduleSpec(alpha=lambda k: 0.1 / (1.0 + k)).materialize(K)
    np.testing.assert_allclose(tm.alpha, 0.1 / (1.0 + np.arange(K)),
                               rtol=1e-6)


def test_port_imports_neither_jax_nor_repro():
    """Importing every module of the port pulls in no jax and nothing of
    the JAX package (checked in a fresh interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' "
        "or k.startswith(('jax.', 'jaxlib')) or k == 'repro' "
        "or k.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "new = ('repro_torch.checkpoint.checkpoint', 'repro_torch.obs.spans', "
        "'repro_torch.obs.metrics', 'repro_torch.obs.export', "
        "'repro_torch.obs.recorder', 'repro_torch.serve.jobs', "
        "'repro_torch.serve.batching', 'repro_torch.serve.engine', "
        "'repro_torch.serve.slo', 'repro_torch.core.jobs', "
        "'repro_torch.serve.admission.loop', "
        "'repro_torch.serve.admission.classes', "
        "'repro_torch.serve.admission.packing', "
        "'repro_torch.serve.admission.quotas', "
        "'repro_torch.distributed.collectives', "
        "'repro_torch.distributed.dagm_sharded', "
        "'repro_torch.optim.optimizers', 'repro_torch.configs', "
        "'repro_torch.configs.base', 'repro_torch.configs.qwen3_4b', "
        "'repro_torch.data', 'repro_torch.data.synthetic', "
        "'repro_torch.models', 'repro_torch.models.layers', "
        "'repro_torch.models.ssm', 'repro_torch.models.moe', "
        "'repro_torch.models.transformer', 'repro_torch.models.whisper', "
        "'repro_torch.models.model_zoo', 'repro_torch.models.steps', "
        "'repro_torch.launch', 'repro_torch.launch.mesh', "
        "'repro_torch.distributed.sharding', 'repro_torch.launch.costs', "
        "'repro_torch.launch.train', 'repro_torch.launch.dryrun', "
        "'repro_torch.launch.dagm_dryrun', 'repro_torch.interop')\n"
        "assert all(m in sys.modules for m in new), new\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30
