"""Compressed gossip end to end on the CPU: `MixingOp`'s dispatch
between the comm-fused kernels and the compose path, and
`repro_torch.solve` against `repro.solve` under `pallas_mode(True)`.

The end-to-end runs hand the port `repro`'s per-send seeds (its channel
keys, split once per send) through `MixingOp._next_seed`.  Every width
is a multiple of 128 and n of 8, so `repro` fuses every gossip and both
sides quantize with bitwise-equal metadata and uniforms; had `repro`
fallen back to its compose path (jax.random uniforms) the runs would
differ at the quantization step (~1e-2).  What is left is f32 rounding
in the autodiff terms, compounded over K = 3 rounds: rtol 1e-4 /
atol 1e-5, as for the uncompressed runs (test_torch_solve.py).  A
rounding difference that flipped a stochastic-rounding code would move
one neighbor term by w·scale and fail the test; none does here.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.comm.feedback import channel_keys
from repro.core import problems as jp
from repro.kernels.ops import pallas_mode
from repro.solve import CommSpec as JCommSpec
from repro.solve import ScheduleSpec as JSchedule
from repro.solve import SolverSpec as JSpec
from repro.solve import solve as jsolve
from repro.topology import make_network as j_make_network

from repro_torch.comm import compressed_payload
from repro_torch.core import problems as tp
from repro_torch.solve import CommSpec, ScheduleSpec, SolverSpec, solve
from repro_torch.topology import MixingOp, make_mixing_op, make_network

OUT_ATOL = 1e-6
SOLVE_RTOL, SOLVE_ATOL = 1e-4, 1e-5
COMMS = ["int8", "int4", "int8+ef", "int4+ef"]


def _data(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


@pytest.mark.parametrize("comm", COMMS)
@pytest.mark.parametrize("kind", ["ring", "erdos_renyi"])
def test_compose_path_equals_fused_path(comm, kind):
    """`compressed_payload` + plain mix + exact self term (the compose
    path) and the fused plain version draw the same seed and the same
    uniforms: the EF payloads are bitwise equal and the outputs agree to
    f32 rounding (the self term is summed in another order)."""
    op = make_mixing_op(make_network(kind, 16, r=0.5, seed=0),
                        comm=comm, device="cpu")
    y = torch.as_tensor(_data((16, 300), seed=6))
    st = op.comm_channel("c", y, seed=12)
    if op.comm.ef:
        st.hat = torch.as_tensor(_data((16, 300), seed=7, scale=0.3))
    for lap in (False, True):
        assert op._fused_plan(y)
        fused, st_f = op._apply_fused(y, y, st, lap)
        pay, st_c = compressed_payload(op.comm, y, st, op._next_seed(st))
        mixed = op._apply(pay, False) + op._diag[:, None] * (y - pay)
        composed = y - mixed if lap else mixed
        np.testing.assert_allclose(fused.numpy(), composed.numpy(),
                                   atol=OUT_ATOL, rtol=0)
        assert st_f.sends == st_c.sends == 1
        if op.comm.ef:
            assert torch.equal(st_f.hat, st_c.hat)


def test_fused_plan_keeps_repro_dispatch():
    """Fused: int8/int4 (± EF), f32, no bf16 storage, circulant or padded
    gather.  Everything else composes."""
    def plan(kind, comm, dtype="f32", operand=torch.float32):
        op = make_mixing_op(make_network(kind, 16, r=0.5, seed=0),
                            comm=comm, dtype=dtype, device="cpu")
        return op._fused_plan(torch.zeros(16, 8, dtype=operand))
    assert plan("ring", "int8") and plan("ring", "int4+ef")
    assert plan("erdos_renyi", "int8+ef")
    assert not plan("star", "int8")              # CSR path
    assert not plan("complete", "int8")          # dense W
    assert not plan("ring", "int8", dtype="bf16")
    assert not plan("ring", "int8", operand=torch.bfloat16)
    for comm in ("identity", "bf16", "top_k:0.1+ef", "rand_k:0.25"):
        assert not plan("ring", comm)


def _repro_send_seeds(seed: int, sends: dict) -> dict:
    """`repro`'s per-send kernel seeds: each channel's key
    (`channel_keys`) split once per send, `randint` on the second half
    (`MixingOp._next_seed`)."""
    out = {}
    for name, key in channel_keys(seed, list(sends)).items():
        seq = []
        for _ in range(sends[name]):
            key, sub = jax.random.split(key)
            seq.append(int(jax.random.randint(
                sub, (1,), 0, jnp.iinfo(jnp.int32).max, jnp.int32)[0]))
        out[name] = seq
    return out


@pytest.mark.parametrize("comm", ["int8+ef", "int4"])
@pytest.mark.parametrize("kind,n", [("ring", 8), ("erdos_renyi", 16)])
def test_solve_matches_repro_fused_with_its_seeds(comm, kind, n,
                                                  monkeypatch):
    K, M, U = 3, 5, 3
    jprob = jp.quadratic_bilevel(n, 128, 256, seed=1)
    tprob = tp.quadratic_bilevel(n, 128, 256, seed=1, device="cpu")
    rng = np.random.default_rng(0)
    x0 = (0.1 * rng.standard_normal((n, 128))).astype(np.float32)
    y0 = (0.1 * rng.standard_normal((n, 256))).astype(np.float32)
    kw = dict(K=K, M=M, U=U, dihgp="matrix_free", curvature=10.0)
    sched = dict(alpha=0.05, beta=0.05)
    net_kw = {"r": 0.5, "seed": 0} if kind == "erdos_renyi" else {}
    with pallas_mode(True, interpret=True):
        jres = jsolve(jprob, j_make_network(kind, n, **net_kw),
                      JSpec(schedule=JSchedule(**sched),
                            comm=JCommSpec(comm), **kw),
                      x0=jnp.asarray(x0), y0=jnp.asarray(y0), seed=0)
    seeds = _repro_send_seeds(0, {"inner_y": K * M, "dihgp_h": K * U,
                                  "outer_x": K})
    monkeypatch.setattr(MixingOp, "_next_seed",
                        lambda self, st: seeds[st.name][st.sends])
    tres = solve(tprob, make_network(kind, n, **net_kw),
                 SolverSpec(schedule=ScheduleSpec(**sched),
                            comm=CommSpec(comm), **kw),
                 x0=x0, y0=y0, device="cpu")
    for got, want in ((tres.x, jres.x), (tres.y, jres.y)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=SOLVE_RTOL, atol=SOLVE_ATOL)
    for key, val in jres.metrics.items():
        np.testing.assert_allclose(tres.metrics[key].numpy(),
                                   np.asarray(val), rtol=SOLVE_RTOL,
                                   atol=SOLVE_ATOL, err_msg=key)
    assert tres.ledger.summary() == jres.ledger.summary()
    assert {k: st.sends for k, st in tres.channels.items()} \
        == {k: len(v) for k, v in seeds.items()}
