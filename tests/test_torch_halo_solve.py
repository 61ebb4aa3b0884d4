"""The large-network path end to end on the CPU: `repro_torch.solve` at
n = 4096 agents, where every gossip takes the row-tiled halo tier,
against `repro.solve` under `pallas_mode(True)` (its halo Pallas
kernels in interpret mode).

As in test_torch_comm_solve.py the port runs with `repro`'s per-send
seeds injected through `MixingOp._next_seed`, so both quantize with
bitwise-equal metadata and uniforms.  Sparse + EF on the halo tier
composes the compressor with the plain halo mix on both sides (the
sparse halo kernel has no payload write-back), and `repro`'s compose
path draws `jax.random.uniform` from the send's key: the port's
quantizer is handed those same uniforms.  What is left is f32 rounding
in the autodiff terms over K = 2 rounds: rtol 1e-4 / atol 1e-5 for
every per-round metric, and for x and y on the identity wire.

Compressed runs, x and y: stochastic rounding is discontinuous, and at
n = 4096 each gossip quantizes 524,288 elements, some of them next to a
code boundary, where a ~1e-7 difference in the autodiff terms flips the
code and moves one neighbor term by w·scale (~4e-5 here, carried on by
the later rounds).  Measured: 15-1,133 of 524,288 elements outside
rtol 1e-4 / atol 1e-5, at most 8.5e-4 apart, norm-relative error
≤ 3.7e-5.  So x and y are held by norm-relative error (`NORM_REL`) and
by the share of elements outside the elementwise band (`FLIP_SHARE`).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.comm.feedback import channel_keys
from repro.core import problems as jp
from repro.kernels import mixing_matvec as jmm
from repro.kernels.ops import pallas_mode
from repro.solve import CommSpec as JCommSpec
from repro.solve import ScheduleSpec as JSchedule
from repro.solve import SolverSpec as JSpec
from repro.solve import solve as jsolve
from repro.topology import make_mixing_op as j_make_mixing_op
from repro.topology import ops as jops

from repro_torch.comm import compressors
from repro_torch.core import problems as tp
from repro_torch.solve import CommSpec, ScheduleSpec, SolverSpec, solve
from repro_torch.topology import MixingOp, make_network
from repro_torch.topology import ops as tops

SOLVE_RTOL, SOLVE_ATOL = 1e-4, 1e-5
NORM_REL, FLIP_SHARE = 1e-4, 1e-2
N, D = 4096, 128
K, M, U = 2, 2, 2


@pytest.fixture(scope="module")
def networks():
    """The port's ring and Erdős–Rényi (r = 0.004) networks at n = 4096,
    and `repro`'s from the same arrays."""
    nets = {"ring": make_network("ring", N),
            "erdos_renyi": make_network("erdos_renyi", N, r=0.004,
                                        seed=0)}
    return {kind: (net, jops.Network(adj=net.adj, W=net.W, name=net.name))
            for kind, net in nets.items()}


def _repro_sends(seed: int, sends: dict) -> dict:
    """{channel: [(kernel seed, send key), ...]}: each channel's key
    split once per send, as `repro`'s `_next_seed` and
    `compressed_payload` do."""
    out = {}
    for name, key in channel_keys(seed, list(sends)).items():
        seq = []
        for _ in range(sends[name]):
            key, sub = jax.random.split(key)
            seq.append((int(jax.random.randint(
                sub, (1,), 0, jnp.iinfo(jnp.int32).max, jnp.int32)[0]),
                sub))
        out[name] = seq
    return out


def _spy(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def spy(*args, **kw):
        calls.append(kw.get("bn"))
        return fn(*args, **kw)
    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("kind,comm", [("ring", "identity"),
                                       ("ring", "int8+ef"),
                                       ("erdos_renyi", "identity"),
                                       ("erdos_renyi", "int8"),
                                       ("erdos_renyi", "int8+ef")])
def test_solve_at_4096_matches_repro_on_the_halo_tier(networks, kind, comm,
                                                      monkeypatch):
    net, jnet = networks[kind]
    jprob = jp.ho_regression(N, D, seed=1)
    tprob = tp.ho_regression(N, D, seed=1, device="cpu")
    rng = np.random.default_rng(0)
    x0 = (0.1 * rng.standard_normal((N, D))).astype(np.float32)
    y0 = (0.1 * rng.standard_normal((N, D))).astype(np.float32)
    kw = dict(K=K, M=M, U=U, dihgp="matrix_free", curvature=10.0)
    sched = dict(alpha=0.05, beta=0.05)
    gather = kind == "erdos_renyi"
    base = "sparse_mix_matvec_halo" if gather \
        else "circulant_mix_matvec_halo"
    # both sides plan the halo tier for every variant this run takes
    y = jnp.zeros((N, D), jnp.float32)
    blocks = 3 if comm == "identity" else 6 if comm.endswith("+ef") else 4
    with pallas_mode(True, interpret=True):
        jop = j_make_mixing_op(jnet, comm=comm)
        assert jop._stripe_plan(y, blocks=blocks, circulant=not gather)[0] \
            == "halo"
        j_halo = _spy(monkeypatch, jmm, base)
        jres = jsolve(jprob, jnet, JSpec(schedule=JSchedule(**sched),
                                         comm=JCommSpec(comm), **kw),
                      x0=jnp.asarray(x0), y0=jnp.asarray(y0), seed=0)
    assert j_halo and all(bn is not None for bn in j_halo)
    top = MixingOp(net.W, comm=comm, device="cpu")
    assert top._stripe_plan(torch.zeros(N, D), blocks=blocks,
                            circulant=not gather)[0] == "halo"
    sends = _repro_sends(0, {"inner_y": K * M, "dihgp_h": K * U,
                             "outer_x": K})
    seeds = {name: [s for s, _ in seq] for name, seq in sends.items()}
    keys = {s: sub for seq in sends.values() for s, sub in seq}
    monkeypatch.setattr(MixingOp, "_next_seed",
                        lambda self, st: seeds[st.name][st.sends])

    def repro_uniforms(seed, rows, cols):
        return torch.as_tensor(np.asarray(jax.random.uniform(
            keys[seed], (rows.shape[0], cols.shape[-1]), jnp.float32)))
    monkeypatch.setattr(compressors, "hash_uniform", repro_uniforms)
    t_halo = _spy(monkeypatch, tops, base)
    tres = solve(tprob, net, SolverSpec(schedule=ScheduleSpec(**sched),
                                        comm=CommSpec(comm), **kw),
                 x0=x0, y0=y0, device="cpu")
    gossips = K * (M + U + 1)
    halo_mixes = K * (M + 1) if kind == "ring" and comm == "identity" \
        else gossips
    assert len(t_halo) == halo_mixes and set(t_halo) == {
        128 if comm == "identity" or (gather and comm.endswith("+ef"))
        else 64}
    for got, want in ((tres.x, jres.x), (tres.y, jres.y)):
        got, want = got.numpy(), np.asarray(want)
        if comm == "identity":
            np.testing.assert_allclose(got, want, rtol=SOLVE_RTOL,
                                       atol=SOLVE_ATOL)
            continue
        outside = np.abs(got - want) > SOLVE_ATOL + SOLVE_RTOL * np.abs(want)
        assert outside.mean() <= FLIP_SHARE, outside.sum()
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= NORM_REL, rel
    for key, val in jres.metrics.items():
        np.testing.assert_allclose(tres.metrics[key].numpy(),
                                   np.asarray(val), rtol=SOLVE_RTOL,
                                   atol=SOLVE_ATOL, err_msg=key)
    assert tres.ledger.summary() == jres.ledger.summary()
    assert {k: st.sends for k, st in tres.channels.items()} \
        == {k: len(v) for k, v in seeds.items()}
