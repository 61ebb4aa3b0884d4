"""The sharded tier on a `ProcessRing`: 8 gloo processes on the CPU, one
agent each, against the same ring run as a `LocalRing` in this process.

The 8 processes are spawned once (module scope), each with one thread,
a `file://` store in the test's temporary directory and timeouts on the
process group's set-up and on the join; each writes its agent's results
to an .npz.  On the CPU one gossip equals `LocalRing`'s plain version
bit for bit for identity and int8/int4 ± EF (the process ring adds its
neighbours in `MixingOp`'s order and quantizes its row with that row's
draws); bf16, top-k and rand-k take `MixingOp`'s composed path on the
local ring (W·ŷ + w_self·(y − ŷ)), so those hold to 1e-6.  Solves run
`torch.func` per agent on a process and under `vmap` on the local ring,
whose products may round apart: K = 4 rounds within 1e-6
norm-relative.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.comm import channel_init, parse_comm_spec
from repro_torch.core import problems as tp
from repro_torch.distributed import (LocalRing, ring_laplacian,
                                     ring_laplacian_c, ring_mix, ring_mix_c,
                                     ring_shift, sharded_comm_ledger)
from repro_torch.solve import sharded_spec, solve

SRC = Path(__file__).resolve().parents[1] / "src"
WORLD, D1, D2, K = 8, 3, 4, 4
EXACT = ("identity", "int8", "int8+ef", "int4", "int4+ef")
CLOSE = ("bf16", "top_k:0.5+ef", "rand_k:0.5")
SOLVES = {"identity": dict(), "int8ef": dict(comm="int8+ef"),
          "int8ef_persist": dict(comm="int8+ef", persist_ef=True),
          "mix_every2": dict(mix_every=2), "bf16": dict(comm="bf16")}
REL_TOL = 1e-6
INIT_TIMEOUT_S, JOIN_TIMEOUT_S = 60, 240

WORKER = r"""
import sys
from datetime import timedelta
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
rank, world, store, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
dist.init_process_group("gloo", init_method="file://" + store,
                        world_size=world, rank=rank,
                        timeout=timedelta(seconds={init_timeout}))
from repro_torch.comm import channel_init, parse_comm_spec
from repro_torch.core import problems as tp
from repro_torch.distributed import (ProcessRing, ring_laplacian,
                                     ring_laplacian_c, ring_mix, ring_mix_c,
                                     ring_shift)
from repro_torch.solve import sharded_spec, solve

out = {{}}
mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
ring = ProcessRing(mesh, "data")
assert ring.rank == rank and ring.n == world
rng = np.random.default_rng(0)
tree = {{"a": rng.standard_normal((world, 5)).astype(np.float32),
        "b": rng.standard_normal((world, 2, 3)).astype(np.float32)}}
local = {{k: torch.as_tensor(v[rank]) for k, v in tree.items()}}
for o in (1, -2):
    out[f"shift_{{o}}"] = ring_shift(local["a"], ring, o).numpy()
for k, v in ring_mix(local, ring).items():
    out["mix_" + k] = v.numpy()
for k, v in ring_laplacian(local, ring).items():
    out["lap_" + k] = v.numpy()
for k, v in ring_mix(local, ring, torch.bfloat16).items():
    out["mixbf16_" + k] = v.numpy()
for comm in {comms!r}:
    pol = parse_comm_spec(comm)
    st = channel_init(pol, "ch", local, 1234)
    m1, st = ring_mix_c(local, ring, pol, st)
    l2, st = ring_laplacian_c(local, ring, pol, st)
    for k in local:
        out[f"{{comm}}_mixc_{{k}}"] = m1[k].numpy()
        out[f"{{comm}}_lapc_{{k}}"] = l2[k].numpy()
        if pol.ef:
            out[f"{{comm}}_hat_{{k}}"] = st.hat[k].numpy()
    out[f"{{comm}}_sends"] = np.int64(st.sends)

prob = tp.quadratic_bilevel(world, {d1}, {d2}, seed=0, device="cpu")
y0 = (0.01 * np.random.default_rng(1).standard_normal(
    (world, {d2}))).astype(np.float32)
for case, kw in {solves!r}.items():
    spec = sharded_spec(alpha=0.05, beta=0.1, M=4, U=3, K={K},
                        curvature=6.0, **kw)
    res = solve(prob, None, spec, mesh=mesh, y0=y0, seed=0)
    out[case + "_x"] = res.x.numpy()
    out[case + "_y"] = res.y.numpy()
    for key, val in res.metrics.items():
        out[case + "_m_" + key] = val.numpy()
    out[case + "_bytes"] = np.int64(res.ledger.total_bytes)

mesh2 = init_device_mesh("cpu", (2, world // 2),
                         mesh_dim_names=("pod", "data"))
ring2 = ProcessRing(mesh2, ("pod", "data"))
row = torch.as_tensor(tree["a"][ring2.rank])
out["pod_rank"] = np.int64(ring2.rank)
out["pod_mix"] = ring_mix(row, ring2).numpy()
np.savez(out_dir + f"/rank{{rank}}.npz", **out)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results, from one spawn of WORLD gloo processes."""
    tmp = tmp_path_factory.mktemp("gloo")
    script = WORKER.format(init_timeout=INIT_TIMEOUT_S,
                           comms=EXACT + CLOSE, d1=D1, d2=D2, K=K,
                           solves=SOLVES)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    logs = [open(tmp / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), str(WORLD),
         str(tmp / "store"), str(tmp)], env=env, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(WORLD)]
    try:
        for p in procs:
            p.wait(timeout=JOIN_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (tmp / f"rank{r}.log").read_text()[-3000:]
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]


def _inputs():
    rng = np.random.default_rng(0)
    return {"a": torch.as_tensor(rng.standard_normal((WORLD, 5)).astype(
        np.float32)), "b": torch.as_tensor(rng.standard_normal(
            (WORLD, 2, 3)).astype(np.float32))}


def _assert_rows(ranks, key_of, full: dict, exact: bool):
    for r, out in enumerate(ranks):
        for k, v in full.items():
            got, want = out[key_of(k)], v[r].numpy()
            if exact:
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("offset", [1, -2])
def test_ring_shift_receives_agent_i_minus_offset(ranks, offset):
    full = _inputs()["a"]
    want = ring_shift(full, LocalRing(WORLD, device="cpu"), offset)
    assert torch.equal(want, torch.roll(full, offset, dims=0))
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out[f"shift_{offset}"],
                                      full[(r - offset) % WORLD].numpy())


def test_plain_gossips_bitwise_local_ring(ranks):
    ring = LocalRing(WORLD, device="cpu")
    val = _inputs()
    _assert_rows(ranks, lambda k: "mix_" + k, ring_mix(val, ring), True)
    _assert_rows(ranks, lambda k: "lap_" + k, ring_laplacian(val, ring),
                 True)
    _assert_rows(ranks, lambda k: "mixbf16_" + k,
                 ring_mix(val, ring, torch.bfloat16), False)


@pytest.mark.parametrize("comm", EXACT + CLOSE)
def test_channel_gossips_across_transports(ranks, comm):
    """Two sends on one channel (the second reads the first's replica):
    bitwise for identity and int8/int4 ± EF, EF replicas included."""
    ring = LocalRing(WORLD, device="cpu")
    val = _inputs()
    pol = parse_comm_spec(comm)
    st = channel_init(pol, "ch", val, 1234)
    m1, st = ring_mix_c(val, ring, pol, st)
    l2, st = ring_laplacian_c(val, ring, pol, st)
    exact = comm in EXACT
    _assert_rows(ranks, lambda k: f"{comm}_mixc_{k}", m1, exact)
    _assert_rows(ranks, lambda k: f"{comm}_lapc_{k}", l2, exact)
    if pol.ef:
        _assert_rows(ranks, lambda k: f"{comm}_hat_{k}", st.hat, exact)
    assert all(int(out[f"{comm}_sends"]) == st.sends == 2 for out in ranks)


@pytest.mark.parametrize("case", list(SOLVES))
def test_solves_match_the_local_ring(ranks, case):
    prob = tp.quadratic_bilevel(WORLD, D1, D2, seed=0, device="cpu")
    y0 = (0.01 * np.random.default_rng(1).standard_normal(
        (WORLD, D2))).astype(np.float32)
    spec = sharded_spec(alpha=0.05, beta=0.1, M=4, U=3, K=K, curvature=6.0,
                        **SOLVES[case])
    res = solve(prob, None, spec, mesh=LocalRing(WORLD, device="cpu"),
                y0=y0, seed=0)
    for name in ("x", "y"):
        got = np.concatenate([out[f"{case}_{name}"] for out in ranks])
        want = getattr(res, name).numpy()
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= REL_TOL, (name, rel)
    for key, val in res.metrics.items():
        np.testing.assert_allclose(ranks[0][f"{case}_m_{key}"], val.numpy(),
                                   rtol=REL_TOL, atol=0)
    assert all(int(out[f"{case}_bytes"]) == res.ledger.total_bytes
               for out in ranks)


@pytest.mark.parametrize("case", list(SOLVES))
def test_metrics_equal_on_every_rank_and_sends_the_ledger(ranks, case):
    keys = [k for k in ranks[0] if k.startswith(case + "_m_")]
    assert len(keys) == 5
    for out in ranks[1:]:
        for key in keys:
            np.testing.assert_array_equal(out[key], ranks[0][key])
    spec = sharded_spec(M=4, U=3, K=K, curvature=6.0, **SOLVES[case])
    led = sharded_comm_ledger(spec, torch.zeros(D1), torch.zeros(D2),
                              rounds=1)
    sends = ranks[0][case + "_m_comm_sends"]
    want = led.total_sends() * (np.arange(K) + 1) \
        if spec.comm.persist_ef else np.full(K, led.total_sends())
    np.testing.assert_array_equal(sends, want.astype(np.float32))


def test_two_dim_mesh_rings_the_flattened_axes(ranks):
    """A ("pod", "data") ring over a 2 × 4 mesh: agent a is flattened
    rank a, and its gossip is `LocalRing(8)`'s row a."""
    full = ring_mix(_inputs()["a"], LocalRing(WORLD, device="cpu"))
    seen = sorted(int(out["pod_rank"]) for out in ranks)
    assert seen == list(range(WORLD))
    for out in ranks:
        np.testing.assert_array_equal(out["pod_mix"],
                                      full[int(out["pod_rank"])].numpy())
