"""`repro_torch.serve` on the CPU: the engine against the port's own solo
solves, against `repro`'s solo `solve(tier="reference")`, and the
kernels' job axis through their plain versions.

* Serve vs the port's solo solves: every job of a bucket ends bitwise
  at its solo `solve(tier="reference")` (on the CPU the batched autodiff
  sums as the solo run does; the card is held to a tolerance by
  chip_smoke), with exact per-job wire bytes that add up to the ledger.
  Also signatures, widths, chunking, inert padding, backfill, `tol`
  retirement, the runner cache, quarantine and checkpoint resume.
* Serve vs `repro`: each job against `repro.solve(tier="reference")`
  on the same data and y0 (the port's draw for the job's seed, handed
  to `repro`), identity and bf16 wires, rtol 1e-4 / atol 1e-5 (the
  solve parity tests' band) and exact ledger bytes.  `repro`'s own
  serve tier is not the reference: its bit-exact tests fail there.
* The job axis: each job's columns of a job-axis call (Neumann step,
  comm-fused gossips, the compressed halo gossips) bitwise its solo
  call, at B = 1 today's call, and the planner's routes all take the
  axis; compressed buckets at n = 128 (the halo kernels' row tile) are
  accepted and each job is its solo solve.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.core import problems as jp
from repro.solve import ScheduleSpec as JSchedule
from repro.solve import SolverSpec as JSpec
from repro.solve import solve as jsolve
from repro.topology import make_network as j_make_network

from repro_torch import obs
from repro_torch.comm import row_quant_params
from repro_torch.kernels import mixing_matvec as mm
from repro_torch.serve import (JobSpec, ServeEngine, SimulatedCrash,
                               bucketize, build_network, build_problem,
                               chunk_rounds_for, compile_signature,
                               pack_signature, pad_schedule, pad_width)
from repro_torch.solve import CommSpec, ScheduleSpec, SolverSpec, solve
from repro_torch.topology import make_network
from repro_torch.topology.ops import make_mixing_op

RTOL, ATOL = 1e-4, 1e-5


def cfg(alpha=0.02, beta=0.02, K=6, comm="identity", dihgp="matrix_free",
        curvature=30.0, **kw):
    return SolverSpec(K=K, M=3, U=2, dihgp=dihgp, curvature=curvature,
                      schedule=ScheduleSpec(alpha=alpha, beta=beta),
                      comm=CommSpec(comm), **kw)


def ho_spec(data_seed, seed=3, graph="ring", graph_kwargs=None, **kw):
    tol = kw.pop("tol", None)
    return JobSpec("ho_regression",
                   {"n": 8, "d": 16, "m_per": 10, "seed": data_seed},
                   cfg(**kw), graph=graph, graph_kwargs=graph_kwargs or {},
                   seed=seed, tol=tol)


def quad_spec(data_seed, K=8, tol=None, alpha=0.05, **kw):
    kw.setdefault("curvature", 6.0)
    return JobSpec("quadratic", {"n": 6, "d1": 4, "d2": 8,
                                 "seed": data_seed},
                   cfg(alpha=alpha, beta=0.1, K=K, **kw),
                   seed=data_seed, tol=tol)


def solo(spec):
    return solve(build_problem(spec, "cpu"), build_network(spec),
                 spec.config, seed=spec.seed, device="cpu")


def engine(**kw):
    kw.setdefault("chunk_rounds", 2)
    return ServeEngine(device="cpu", **kw)


def _same(res, ref):
    assert torch.equal(res.x, ref.x.cpu()) and torch.equal(res.y,
                                                           ref.y.cpu())
    assert res.wire_bytes == ref.ledger.total_bytes


# ---------------------------------------------------------------------------
# bucketing, widths, chunking
# ---------------------------------------------------------------------------

def test_signatures_group_by_shape_not_values():
    a, b = ho_spec(0, alpha=0.01), ho_spec(1, alpha=0.05, beta=0.03)
    c = JobSpec("ho_regression", {"n": 8, "d": 12, "seed": 0}, cfg())
    sig = [compile_signature(s, build_problem(s, "cpu")) for s in (a, b, c)]
    assert sig[0] == sig[1] != sig[2]
    d = ho_spec(0, K=8)
    pa = pack_signature(a, build_problem(a, "cpu"))
    assert pa == pack_signature(d, build_problem(d, "cpu"))
    assert compile_signature(d, build_problem(d, "cpu")) != sig[0]
    # prebuilt networks are content-addressed
    n1, n2 = make_network("ring", 8), make_network("erdos_renyi", 8, r=0.6)
    n2 = dataclasses.replace(n2, name=n1.name)
    s1, s2 = (dataclasses.replace(a, graph=n) for n in (n1, n2))
    assert compile_signature(s1, build_problem(s1, "cpu")) \
        != compile_signature(s2, build_problem(s2, "cpu"))


def test_bucketize_groups_and_orders():
    specs = [ho_spec(0), quad_spec(0), ho_spec(1), quad_spec(1)]
    buckets = list(bucketize(specs, "cpu").values())
    assert [[s.problem["seed"] for s, _ in b] for b in buckets] \
        == [[0, 1], [0, 1]]
    assert buckets[0][0][1].device == torch.device("cpu")


@pytest.mark.parametrize("n,cap,want", [(1, 64, 2), (2, 64, 2), (3, 64, 4),
                                        (5, 64, 8), (9, 64, 16),
                                        (40, 64, 64), (100, 64, 64),
                                        (3, 1, 2), (9, 4, 4)])
def test_pad_width_powers_of_two_floor_two(n, cap, want):
    assert pad_width(n, cap) == want


@pytest.mark.parametrize("K,req,want", [(20, 5, 5), (20, 6, 5), (7, 3, 7),
                                        (1, 10, 1), (12, 1, 2), (9, 20, 9)])
def test_chunk_rounds_divides_k(K, req, want):
    assert chunk_rounds_for(K, req) == want


def test_pad_schedule():
    rows = np.arange(6, dtype=np.float32).reshape(2, 3)
    padded = pad_schedule(rows, 4)
    assert padded.shape == (4, 3) and (padded[2:] == rows[-1]).all()
    with pytest.raises(ValueError):
        pad_schedule(rows, 1)


# ---------------------------------------------------------------------------
# the engine against the port's solo solves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["ring", "erdos_renyi"])
@pytest.mark.parametrize("comm", ["identity", "int8+ef", "int4", "int8",
                                  "bf16", "top_k:0.5+ef"])
def test_bucket_matches_solo(kind, comm):
    gk = {"r": 0.6, "seed": 1} if kind == "erdos_renyi" else {}
    specs = [ho_spec(s, seed=s, graph=kind, graph_kwargs=gk, comm=comm,
                     alpha=a, beta=b)
             for s, (a, b) in enumerate([(0.02, 0.02), (0.05, 0.01),
                                         (0.01, 0.04)])]
    eng = engine(max_width=4)
    eng.submit(specs)
    res = eng.run()
    for s, r in zip(specs, res):
        _same(r, solo(s))
    led = eng.ledgers[res[0].signature]
    assert int(led.per_job_bytes().sum()) == led.total_bytes \
        == sum(r.wire_bytes for r in res)


@pytest.mark.parametrize("dihgp,curvature", [("dense", None),
                                             ("exact", None),
                                             ("matrix_free", None)])
def test_bucket_matches_solo_every_dihgp(dihgp, curvature):
    specs = [quad_spec(s, dihgp=dihgp, curvature=curvature)
             for s in range(3)]
    eng = engine()
    eng.submit(specs)
    for s, r in zip(specs, eng.run()):
        _same(r, solo(s))


def test_hp_modes_give_the_same_bits_and_static_keys_on_hp():
    # decaying step sizes: every chunk scans other values
    specs = [ho_spec(s, seed=s,
                     alpha=tuple(0.01 * (s + 1) / (1 + k) for k in range(6)))
             for s in range(3)]
    out = {}
    for mode in ("traced", "static"):
        eng = engine(hp_mode=mode)
        eng.submit(specs)
        out[mode] = (eng.run(), eng.stats)
    for a, b in zip(out["traced"][0], out["static"][0]):
        assert torch.equal(a.x, b.x) and torch.equal(a.y, b.y)
    assert out["traced"][1].traces == 1
    assert out["static"][1].traces > 1


def test_padded_slots_are_inert():
    spec = ho_spec(0, comm="int8+ef")
    eng = engine(max_width=8)
    eng.submit([spec])
    (res,) = eng.run()
    _same(res, solo(spec))
    led = eng.ledgers[res.signature]
    assert led.per_job_sends()["inner_y"].tolist() == [spec.config.K * 3]
    assert led.total_bytes == res.wire_bytes


def test_retire_and_backfill_preserves_trajectories():
    specs = [ho_spec(s, seed=s, K=4 if s % 2 else 6) for s in range(5)]
    eng = engine(max_width=2)
    eng.submit(specs)
    res = eng.run()
    assert [r.rounds for r in res] == [6, 4, 6, 4, 6]
    for s, r in zip(specs, res):
        _same(r, solo(s))
    assert eng.stats.jobs_completed == 5


def test_early_retirement_on_tol():
    loose, tight = quad_spec(0, K=12, tol=1e9), quad_spec(1, K=12)
    eng = engine()
    eng.submit([loose, tight])
    res = eng.run()
    assert res[0].converged and res[0].rounds == 2
    assert not res[1].converged and res[1].rounds == 12
    # the retired job's state is its solo run's after its rounds
    ref = solo(dataclasses.replace(
        loose, config=dataclasses.replace(loose.config, K=2)))
    _same(res[0], ref)


def test_runner_cache_second_wave_builds_nothing():
    eng = engine()
    eng.submit([ho_spec(s, seed=s) for s in range(2)])
    eng.run()
    assert eng.stats.traces == 1 and eng._trace_counter.retraces == 0
    eng.submit([ho_spec(s + 5, seed=s, alpha=0.03) for s in range(2)])
    eng.run()
    assert eng.stats.traces == 1 and eng.stats.cache_hits > 0
    assert obs.counter_value("jit_traces_total", name="serve_chunk") >= 1


def test_quarantine_rolls_back_the_poisoned_slot():
    good = quad_spec(0)
    bad = quad_spec(1, alpha=1e6)           # diverges to inf/nan
    eng = engine()
    eng.submit([good, bad])
    res = eng.run()
    assert res[1].quarantined and np.isnan(res[1].final_gap)
    assert torch.isfinite(res[1].x).all() and torch.isfinite(res[1].y).all()
    _same(res[0], solo(good))
    assert eng.stats.quarantined == 1


def test_checkpoint_resume_is_bitwise(tmp_path):
    specs = [ho_spec(s, seed=s, comm="int8+ef", alpha=0.01 * (s + 1))
             for s in range(5)]
    full = engine(max_width=4)
    full.submit(specs)
    want = full.run()
    crash = engine(max_width=4, checkpoint_dir=str(tmp_path),
                   crash_after_chunks=2,
                   flight_recorder=obs.RecorderSpec(capacity=8))
    crash.submit(specs)
    with pytest.raises(SimulatedCrash):
        crash.run()
    with pytest.raises(ValueError, match="chunk_rounds"):
        engine(max_width=4, checkpoint_dir=str(tmp_path),
               chunk_rounds=3).run()
    fresh = engine(max_width=4, checkpoint_dir=str(tmp_path),
                   flight_recorder=obs.RecorderSpec(capacity=8))
    got = fresh.run()
    assert fresh.stats.restarts == 1
    for a, b in zip(want, got):
        assert torch.equal(a.x, b.x) and torch.equal(a.y, b.y)
        assert a.wire_bytes == b.wire_bytes and a.rounds == b.rounds
        assert b.flight[:, 0].tolist() == list(range(6))
    assert not list(tmp_path.iterdir())          # swept on completion


def test_preempt_and_resume_a_slot_is_bitwise():
    from repro_torch.serve import BucketState
    from repro_torch.topology import make_mixing_op
    spec = ho_spec(0, comm="int8+ef")
    prob = build_problem(spec, "cpu")
    sspec = spec.config
    op = make_mixing_op(build_network(spec), comm=sspec.comm.spec,
                        device="cpu")
    bkt = BucketState(compile_signature(spec, prob), 2, prob,
                      build_network(spec), op, sspec)
    bkt.admit(0, spec, prob)
    before = [t.clone() for t in bkt.carry[0]]
    state = bkt.preempt(0)
    bkt.admit(1, spec, prob, resume=state)
    assert torch.equal(bkt.carry[0][0][:, 1], before[0][:, 0])
    assert torch.equal(bkt.carry[0][1][:, 1], before[1][:, 0])


def test_submit_validation():
    eng = engine()
    with pytest.raises(ValueError, match="max_width"):
        engine(max_width=1)
    with pytest.raises(ValueError, match="hp_mode"):
        engine(hp_mode="eager")
    with pytest.raises(TypeError, match="RecorderSpec"):
        engine(flight_recorder=16)
    with pytest.raises(ValueError, match="duplicate"):
        eng.submit([dataclasses.replace(ho_spec(0), job_id="a")] * 2)
    with pytest.raises(TypeError, match="SolverSpec"):
        eng.submit(JobSpec("quadratic", {"n": 6}, config={"K": 3}))
    from repro_torch.faults import FaultSpec
    with pytest.raises(ValueError, match="fault masks"):
        eng.submit(dataclasses.replace(
            ho_spec(0), config=cfg(faults=FaultSpec(drop_prob=0.1))))
    with pytest.raises(ValueError, match="chunk boundary"):
        engine(chunk_rounds=4).submit(quad_spec(0, K=7, tol=1e-3))
    with pytest.raises(ValueError, match="pickle"):
        engine(checkpoint_dir="unused").submit(dataclasses.replace(
            quad_spec(0), family=lambda **kw: None))


@pytest.mark.parametrize("graph,gkw,comm", [
    ("ring", {}, "int8"), ("ring", {}, "int4+ef"),
    ("erdos_renyi", {"r": 0.5}, "int8")])
def test_compressed_halo_bucket_is_each_jobs_solo_solve(graph, gkw, comm):
    """At n = 128 the compressed gossips plan the halo kernels' row tile
    (ER int8+ef composes with the plain mix, as in `repro`): a bucket is
    accepted and each job ends bitwise at its solo solve, wire bytes
    exact (on the CPU through the plain versions, the card in chip_smoke
    and the gpu tests)."""
    specs = [JobSpec("quadratic", {"n": 128, "d1": 2, "d2": 3, "seed": s},
                     cfg(alpha=0.05, beta=0.1, K=4, comm=comm,
                         curvature=6.0),
                     graph=graph, graph_kwargs=gkw, seed=s)
             for s in range(3)]
    op = make_mixing_op(build_network(specs[0]), comm=comm, device="cpu")
    assert op._fused_plan(torch.empty(128, 3 * 3))[1] == 64
    eng = engine()
    eng.submit(specs)
    for spec, res in zip(specs, eng.run()):
        _same(res, solo(spec))


# ---------------------------------------------------------------------------
# solve(tier="serve")
# ---------------------------------------------------------------------------

def test_serve_tier_is_the_reference_run():
    prob = build_problem(quad_spec(0), "cpu")
    net = make_network("ring", 6)
    spec = cfg(alpha=0.05, beta=0.1, curvature=6.0, comm="int8+ef")
    ref = solve(prob, net, spec, seed=2, device="cpu")
    srv = solve(prob, net, dataclasses.replace(spec, tier="serve"), seed=2,
                device="cpu", recorder=obs.RecorderSpec())
    assert srv.tier == "serve"
    assert torch.equal(srv.x, ref.x) and torch.equal(srv.y, ref.y)
    # the metrics' reductions run batched over the job axis
    for k in ref.metrics:
        torch.testing.assert_close(srv.metrics[k], ref.metrics[k],
                                   rtol=1e-5, atol=1e-7)
    assert srv.extras["wire_bytes"] == ref.ledger.total_bytes \
        == srv.ledger.total_bytes
    assert srv.extras["flight"].shape == (6, len(obs.FIELDS))


def test_serve_tier_refusals_and_shared_engine():
    prob = build_problem(quad_spec(0), "cpu")
    net = make_network("ring", 6)
    spec = cfg(tier="serve", curvature=6.0)
    with pytest.raises(ValueError, match="x0/y0"):
        solve(prob, net, spec, y0=np.zeros((6, 8), np.float32),
              device="cpu")
    with pytest.raises(ValueError, match="record_metrics"):
        solve(prob, net, spec, device="cpu", serve_engine=engine())
    with pytest.raises(ValueError, match="flight_recorder"):
        solve(prob, net, spec, device="cpu", recorder=obs.RecorderSpec(),
              serve_engine=engine(record_metrics=True))
    shared = engine(record_metrics=True)
    a = solve(prob, net, spec, device="cpu", serve_engine=shared)
    b = solve(prob, net, spec, device="cpu", serve_engine=shared)
    assert torch.equal(a.x, b.x) and shared.stats.traces == 1
    # the sharded tier runs on a ring of agents, not on a serve engine
    with pytest.raises(ValueError, match="mesh=LocalRing"):
        solve(prob, net, cfg(tier="sharded"), device="cpu")
    from repro_torch.distributed import LocalRing
    sh = solve(prob, net, cfg(tier="sharded", K=2), device="cpu",
               mesh=LocalRing(6, device="cpu"))
    assert sh.tier == "sharded" and sh.ledger.total_sends() == 2 * 6


# ---------------------------------------------------------------------------
# the engine against repro's solo reference solves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["ring", "erdos_renyi"])
@pytest.mark.parametrize("family", ["quadratic", "ho_regression"])
@pytest.mark.parametrize("comm,dihgp", [("identity", "matrix_free"),
                                        ("identity", "dense"),
                                        ("bf16", "matrix_free")])
def test_bucket_jobs_match_repro_reference(kind, family, comm, dihgp):
    gk = {"r": 0.6, "seed": 1} if kind == "erdos_renyi" else {}
    n, K = 8, 6
    sched = [(0.03, 0.05), (0.05, 0.02), (0.02, 0.08)]
    problem = ({"n": n, "d1": 4, "d2": 6} if family == "quadratic"
               else {"n": n, "d": 12, "m_per": 10})
    specs = [JobSpec(family, dict(problem, seed=s),
                     cfg(alpha=a, beta=b, K=K, comm=comm, dihgp=dihgp,
                         curvature=10.0),
                     graph=kind, graph_kwargs=gk, seed=s)
             for s, (a, b) in enumerate(sched)]
    eng = engine(max_width=2)
    eng.submit(specs)
    res = eng.run()
    jnet = j_make_network(kind, n, **gk)
    for s, r in zip(specs, res):
        maker = jp.quadratic_bilevel if family == "quadratic" \
            else jp.ho_regression
        kw = dict(s.problem)
        jprob = maker(kw.pop("n"), *(kw.pop(k) for k in (
            ("d1", "d2") if family == "quadratic" else ("d",))), **kw)
        gen = torch.Generator("cpu").manual_seed(s.seed)
        y0 = 0.01 * torch.randn((n, jprob.d2), generator=gen)
        a, b = sched[s.seed]
        jres = jsolve(jprob, jnet,
                      JSpec(K=K, M=3, U=2, dihgp=dihgp, curvature=10.0,
                            schedule=JSchedule(alpha=a, beta=b),
                            comm=__import__("repro.solve", fromlist=[
                                "CommSpec"]).CommSpec(comm)),
                      y0=jnp.asarray(y0.numpy()), seed=s.seed)
        np.testing.assert_allclose(r.x.numpy(), np.asarray(jres.x),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(r.y.numpy(), np.asarray(jres.y),
                                   rtol=RTOL, atol=ATOL)
        assert r.wire_bytes == jres.ledger.total_bytes


# ---------------------------------------------------------------------------
# the kernels' job axis (plain versions; the card's in the gpu tests)
# ---------------------------------------------------------------------------

def _ring(n):
    from repro_torch.topology.structure import circulant_structure
    return circulant_structure(make_network("ring", n).W)


def _job_operands(n, B, d, seed=0):
    g = torch.Generator().manual_seed(seed)
    h, hv, p = (torch.randn((n, B * d), generator=g) for _ in range(3))
    beta = torch.rand((B,), generator=g) * 0.2 + 0.01
    dsc = torch.rand((n, B), generator=g) + 1.5
    return h, hv, p, beta, dsc


def _wire(y, B, bits, hat=None):
    n = y.shape[0]
    q = y if hat is None else y - hat
    zp, sc = row_quant_params(q.reshape(n * B, -1), bits)
    return zp.reshape(n, B).contiguous(), sc.reshape(n, B).contiguous()


@pytest.mark.parametrize("B,d", [(1, 7), (3, 5), (8, 3), (4, 16)])
def test_neumann_step_job_axis_is_each_jobs_solo_step(B, d):
    s = _ring(8)
    kw = dict(w_self=s.w_self, offsets=s.offsets, weights=s.weights)
    h, hv, p, beta, dsc = _job_operands(8, B, d)
    out = mm.circulant_neumann_step(h, hv, p, dsc, beta=beta, **kw)
    for j in range(B):
        c = slice(j * d, (j + 1) * d)
        solo_out = mm.circulant_neumann_step(
            h[:, c].contiguous(), hv[:, c].contiguous(),
            p[:, c].contiguous(), dsc[:, j:j + 1].contiguous(),
            beta=float(beta[j]), **kw)
        assert torch.equal(out[:, c], solo_out)


@pytest.mark.parametrize("B,d", [(1, 7), (3, 5), (8, 3)])
@pytest.mark.parametrize("comm", ["int8", "int4", "int8+ef", "int4+ef"])
@pytest.mark.parametrize("graph", ["ring", "erdos_renyi"])
def test_comm_gossip_job_axis_is_each_jobs_solo_send(B, d, comm, graph):
    from repro_torch.topology.structure import sparse_structure
    bits, ef = int(comm[3]), comm.endswith("+ef")
    n = 8
    y, hat, _, _, _ = _job_operands(n, B, d, seed=B)
    hat = hat * 0.1 if ef else None
    zp, sc = _wire(y, B, bits, hat)
    seeds = [1000 + 17 * j for j in range(B)]
    if graph == "ring":
        s = _ring(n)
        kw = dict(w_self=s.w_self, offsets=s.offsets, weights=s.weights)

        def call(yy, z, c, sd, hh):
            return mm.circulant_mix_matvec(yy, z, c, sd, hh, comm=comm,
                                           laplacian=True, **kw)
    else:
        sp = sparse_structure(make_network("erdos_renyi", n, r=0.6,
                                           seed=1).W)
        tabs = [torch.as_tensor(a) for a in (sp.w_self, sp.neighbors,
                                            sp.weights)]

        def call(yy, z, c, sd, hh):
            return mm.sparse_mix_matvec(yy, *tabs, z, c, sd, hh, comm=comm)
    out = call(y, zp, sc, seeds, hat)
    for j in range(B):
        c = slice(j * d, (j + 1) * d)
        got = call(y[:, c].contiguous(), zp[:, j:j + 1].contiguous(),
                   sc[:, j:j + 1].contiguous(), seeds[j],
                   None if hat is None else hat[:, c].contiguous())
        if ef:
            assert torch.equal(out[0][:, c], got[0])
            assert torch.equal(out[1][:, c], got[1])
        else:
            assert torch.equal(out[:, c], got)


@pytest.mark.parametrize("B,d", [(1, 7), (3, 5), (8, 3), (4, 6)])
@pytest.mark.parametrize("comm", ["int8", "int4+ef"])
@pytest.mark.parametrize("graph", ["ring", "erdos_renyi"])
def test_halo_comm_job_axis_is_each_jobs_solo_send(B, d, comm, graph):
    """Rows 2f and 4f on a job axis (odd in-job widths included): each
    job's columns of the halo call, output and EF payload, bitwise its
    solo halo call and the full-operand call.  The sparse halo gossip
    takes no EF, as `repro`'s."""
    from repro_torch.topology.structure import sparse_structure
    if graph == "erdos_renyi" and comm.endswith("+ef"):
        comm = "int4"
    bits, ef = int(comm[3]), comm.endswith("+ef")
    n = 16
    y, hat, _, _, _ = _job_operands(n, B, d, seed=2 * B + 1)
    hat = hat * 0.1 if ef else None
    zp, sc = _wire(y, B, bits, hat)
    seeds = [77 + 31 * j for j in range(B)]
    if graph == "ring":
        s = _ring(n)
        kw = dict(w_self=s.w_self, offsets=s.offsets, weights=s.weights)

        def call(yy, z, c, sd, hh, bn):
            if bn is None:
                return mm.circulant_mix_matvec(yy, z, c, sd, hh, comm=comm,
                                               laplacian=True, **kw)
            return mm.circulant_mix_matvec_halo(yy, z, c, sd, hh, comm=comm,
                                                laplacian=True, bn=bn, **kw)
    else:
        sp = sparse_structure(make_network("erdos_renyi", n, r=0.5,
                                           seed=3).W)
        tabs = [torch.as_tensor(a) for a in (sp.w_self, sp.neighbors,
                                            sp.weights)]

        def call(yy, z, c, sd, hh, bn):
            if bn is None:
                return mm.sparse_mix_matvec(yy, *tabs, z, c, sd, comm=comm)
            return mm.sparse_mix_matvec_halo(yy, *tabs, z, c, sd, comm=comm,
                                             bn=bn)
    out = call(y, zp, sc, seeds, hat, 4)
    full = call(y, zp, sc, seeds, hat, None)
    outs = out if ef else (out,)
    for a, b in zip(outs, full if ef else (full,)):
        assert torch.equal(a, b)
    for j in range(B):
        c = slice(j * d, (j + 1) * d)
        got = call(y[:, c].contiguous(), zp[:, j:j + 1].contiguous(),
                   sc[:, j:j + 1].contiguous(), seeds[j],
                   None if hat is None else hat[:, c].contiguous(), 8)
        for a, b in zip(outs, got if ef else (got,)):
            assert torch.equal(a[:, c], b)


@pytest.mark.parametrize("B,d", [(1, 9), (3, 5), (8, 2)])
@pytest.mark.parametrize("bits", [4, 8])
def test_comm_neumann_job_axis_is_each_jobs_solo_step(B, d, bits):
    s = _ring(8)
    kw = dict(w_self=s.w_self, offsets=s.offsets, weights=s.weights)
    h, hv, p, beta, dsc = _job_operands(8, B, d, seed=7)
    zp, sc = _wire(h, B, bits)
    seeds = [5 + j for j in range(B)]
    out = mm.circulant_neumann_step(h, hv, p, dsc, zp, sc, seeds, beta=beta,
                                    comm=f"int{bits}", **kw)
    for j in range(B):
        c = slice(j * d, (j + 1) * d)
        solo_out = mm.circulant_neumann_step(
            h[:, c].contiguous(), hv[:, c].contiguous(),
            p[:, c].contiguous(), dsc[:, j:j + 1].contiguous(),
            zp[:, j:j + 1].contiguous(), sc[:, j:j + 1].contiguous(),
            seeds[j], beta=float(beta[j]), comm=f"int{bits}", **kw)
        assert torch.equal(out[:, c], solo_out)


def test_job_axis_at_one_job_is_todays_call():
    s = _ring(8)
    kw = dict(w_self=s.w_self, offsets=s.offsets, weights=s.weights)
    h, hv, p, beta, dsc = _job_operands(8, 1, 11, seed=3)
    assert torch.equal(
        mm.circulant_neumann_step(h, hv, p, dsc, beta=beta, **kw),
        mm.circulant_neumann_step(h, hv, p, dsc, beta=float(beta[0]), **kw))
    zp, sc = _wire(h, 1, 8)
    assert torch.equal(
        mm.circulant_mix_matvec(h, zp, sc, [99], comm="int8", **kw),
        mm.circulant_mix_matvec(h, zp, sc, 99, comm="int8", **kw))


def test_job_axis_argument_checks():
    s = _ring(8)
    kw = dict(w_self=s.w_self, offsets=s.offsets, weights=s.weights)
    h, hv, p, beta, dsc = _job_operands(8, 3, 4)
    with pytest.raises(ValueError, match="d_scalar"):
        mm.circulant_neumann_step(h, hv, p, dsc[:, :1].contiguous(),
                                  beta=beta, **kw)
    with pytest.raises(ValueError, match="equal"):
        mm.circulant_neumann_step(h[:, :11].contiguous(),
                                  hv[:, :11].contiguous(),
                                  p[:, :11].contiguous(), dsc, beta=beta,
                                  **kw)
    zp, sc = _wire(h, 3, 8)
    with pytest.raises(ValueError, match="zp"):
        mm.circulant_mix_matvec(h, zp, sc, [1, 2], comm="int8", **kw)
    with pytest.raises(ValueError, match="zp"):
        mm.circulant_neumann_step(h, hv, p, dsc, zp, sc, 5, beta=beta,
                                  comm="int8", **kw)
    with pytest.raises(ValueError, match="solo one"):
        mm.circulant_neumann_step(h, hv, p, dsc[:, :1].contiguous(),
                                  zp, sc, [1, 2, 3], beta=0.1, comm="int8",
                                  **kw)
    big = 65
    with pytest.raises(ValueError, match="1 to 64"):
        mm.circulant_mix_matvec(torch.zeros(8, big), torch.zeros(8, big),
                                torch.ones(8, big), list(range(big)),
                                comm="int8", **kw)
    with pytest.raises(ValueError, match="zp"):
        mm.circulant_mix_matvec_halo(h, zp[:, :1].contiguous(),
                                     sc[:, :1].contiguous(), [1, 2, 3],
                                     comm="int8", bn=4, **kw)
    with pytest.raises(ValueError, match="equal"):
        mm.circulant_mix_matvec_halo(h[:, :11].contiguous(), zp, sc,
                                     [1, 2, 3], comm="int8", bn=4, **kw)


def test_every_route_takes_the_job_axis():
    """The planners' route rule on a job axis: every route of rows 5,
    1f, 2f, 3f, 4f and 5f has a job-axis launch (counted apart), so the
    planner sends a job-axis launch wherever it sends the solo one — the
    stripes and the unstaged kernels of the comm-fused gossips and the
    comm-fused Neumann step, the fused circulant halo, the compressed
    sparse halo's slab and row tiles, the ring and the unstaged kernel
    of the plain Neumann step."""
    assert set(mm.JOB_COUNTERS) == {
        f"{name}_jobs" for name in (
            "circulant_neumann_step", "circulant_neumann_step_unstaged",
            "circulant_mix_matvec_comm",
            "circulant_mix_matvec_comm_unstaged", "sparse_mix_matvec_comm",
            "sparse_mix_matvec_comm_unstaged",
            "circulant_neumann_step_comm",
            "circulant_neumann_step_comm_unstaged",
            "circulant_mix_matvec_halo_comm", "sparse_mix_matvec_halo_comm",
            "sparse_mix_matvec_halo_comm_rows")}
    for name in ("circulant_neumann_jobs", "circulant_neumann_ring_jobs",
                 "circulant_mix_comm_jobs", "sparse_mix_comm_jobs",
                 "circulant_neumann_comm_jobs",
                 "circulant_mix_halo_comm_jobs",
                 "sparse_mix_halo_comm_jobs"):
        assert name in mm._LIB.signatures
    # both routes of the comm-fused Neumann step and of the plain one
    # take a job-axis call (here through their plain versions)
    sr = _ring(8)
    kw = dict(w_self=sr.w_self, offsets=sr.offsets, weights=sr.weights)
    h, hv, p, beta, dsc = _job_operands(8, 4, 32)
    zp, sc = _wire(h, 4, 8)
    outs = [mm._neumann_comm_launch(h, hv, p, dsc, zp, sc, [1, 2, 3, 4],
                                    beta=beta, comm="int8", cols=cols, **kw)
            for cols in (0, 32, None)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    plain = [mm.circulant_neumann_step(h, hv, p, dsc, beta=beta, ring=ring,
                                       **kw) for ring in ((8, 2), None)]
    assert torch.equal(plain[0], plain[1])


def test_engine_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine()
    prob = build_problem(quad_spec(0), "cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve(prob, make_network("ring", 6), cfg(tier="serve"))
    assert ServeEngine(device="cpu").device.type == "cpu"
