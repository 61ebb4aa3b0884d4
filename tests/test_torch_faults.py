"""Fault injection in the port (`repro_torch.faults`, `MixingOp.masked`,
faulted DAGM through `solve`) against `repro` on the CPU.

The port lowers a `FaultSpec` with numpy generators where `repro` folds
jax keys, so link drops and straggler skips realize differently; churn
is a pure schedule and lowers identically.  Everything downstream of the
lowering is held against `repro` on `repro`'s own edge masks, carried
across as numpy arrays.

Compressed gossip under a mask composes the compressor with the masked
mix in both packages, where `repro` draws `jax.random.uniform` per send.
The compressed cases hand the port those uniforms: each send's seed
(`MixingOp._next_seed`) becomes a token for its (channel, send), and the
port's quantizer looks the token's uniforms up in place of
`hash_uniform`.  Tolerances: single gossips 1e-6 absolute (f32 rounding
of a few terms); solves rtol 1e-4 / atol 1e-5, as the unfaulted solves
(test_torch_solve.py).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.comm.feedback import channel_keys
from repro.core import problems as jp
from repro.faults import FaultSpec as JFaultSpec
from repro.faults import lower_faults as j_lower_faults
from repro.solve import CommSpec as JCommSpec
from repro.solve import ScheduleSpec as JSchedule
from repro.solve import SolverSpec as JSpec
from repro.solve import solve as jsolve
from repro.topology import make_mixing_op as j_make_mixing_op
from repro.topology import make_network as j_make_network

import repro_torch.faults as tfaults
from repro_torch.comm import compressors
from repro_torch.core import problems as tp
from repro_torch.faults import FaultSpec, FaultTrace, lower_faults
from repro_torch.faults import realized_W
from repro_torch.kernels.mixing_matvec import sparse_row_plan
from repro_torch.solve import CommSpec, ScheduleSpec, SolverSpec, solve
from repro_torch.topology import (MaskedMixingOp, make_mixing_op,
                                  make_network)
from repro_torch.topology.ops import MixingOp

OUT_ATOL = 1e-6
SOLVE_RTOL, SOLVE_ATOL = 1e-4, 1e-5
GRAPHS = {"ring": ("ring", 8, {}),
          "erdos_renyi": ("erdos_renyi", 16, {"r": 0.5, "seed": 0}),
          "star": ("star", 8, {}),
          "complete": ("complete", 6, {})}
SPEC = dict(drop_prob=0.3, stragglers=(1,), churn=((2, 1, 3),), seed=0)


def _nets(kind):
    name, n, kw = GRAPHS[kind]
    return make_network(name, n, **kw), j_make_network(name, n, **kw)


def _data(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _carry(jtrace):
    """`repro`'s lowered trace as the port's FaultTrace."""
    return FaultTrace(spec=FaultSpec(**SPEC), adj=np.asarray(jtrace.adj),
                      edge_masks=np.asarray(jtrace.edge_masks))


class ReproUniforms:
    """`repro`'s compose-path uniforms for the port: `MixingOp
    ._next_seed` hands each send a token for its (channel, send), and
    the port's quantizer returns `repro`'s `jax.random.uniform` draw of
    that send (its channel key split once per send)."""

    def __init__(self, seed, sends: dict, widths: dict, n: int):
        self.token, self.table = {}, {}
        for name, key in channel_keys(seed, list(sends)).items():
            for s in range(sends[name]):
                key, sub = jax.random.split(key)
                tok = len(self.table)
                self.token[(name, s)] = tok
                self.table[tok] = np.array(jax.random.uniform(
                    sub, (n, widths[name]), jnp.float32))

    def patch(self, monkeypatch):
        monkeypatch.setattr(MixingOp, "_next_seed",
                            lambda op, st: self.token[(st.name, st.sends)])
        monkeypatch.setattr(compressors, "hash_uniform",
                            lambda seed, rows, cols:
                            torch.as_tensor(self.table[seed]))


# ---------------------------------------------------------------------------
# FaultSpec and the lowering
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,match", [
    (dict(drop_prob=1.0), "drop_prob"),
    (dict(drop_prob=-0.1), "drop_prob"),
    (dict(straggle_prob=0.0), "straggle_prob"),
    (dict(churn=((1, 2),)), "triples"),
    (dict(churn=((1, 3, 3),)), "leave_round < rejoin_round"),
    (dict(churn=((1, -1, 3),)), "leave_round < rejoin_round")])
def test_faultspec_validation_matches_repro(kw, match):
    for cls in (FaultSpec, JFaultSpec):
        with pytest.raises(ValueError, match=match):
            cls(**kw)


def test_faultspec_normalizes_and_reports_trivial():
    spec = FaultSpec(stragglers=[np.int64(2)], churn=[[1, 0, 2]])
    assert spec.stragglers == (2,) and spec.churn == ((1, 0, 2),)
    assert hash(spec) == hash(FaultSpec(stragglers=(2,),
                                        churn=((1, 0, 2),)))
    assert FaultSpec().is_trivial and not spec.is_trivial
    assert not FaultSpec(drop_prob=0.1).is_trivial


@pytest.mark.parametrize("kw,match", [
    (dict(stragglers=(8,)), "out of range"),
    (dict(churn=((9, 0, 2),)), "out of range"),
    (dict(churn=((1, 5, 7),)), "round budget")])
def test_lowering_validation_matches_repro(kw, match):
    net, jnet = _nets("ring")
    with pytest.raises(ValueError, match=match):
        lower_faults(FaultSpec(**kw), net, 5)
    with pytest.raises(ValueError, match=match):
        j_lower_faults(JFaultSpec(**kw), jnet, 5)
    with pytest.raises(ValueError, match="K >= 1"):
        lower_faults(FaultSpec(), net, 0)


@pytest.mark.parametrize("kind", list(GRAPHS))
def test_trace_views_match_repro_on_its_masks(kind):
    """realized_W, table_masks and alive_fraction on `repro`'s own edge
    masks equal `repro`'s."""
    net, jnet = _nets(kind)
    jtrace = j_lower_faults(JFaultSpec(**SPEC), jnet, 6)
    trace = _carry(jtrace)
    op = make_mixing_op(net, device="cpu")
    jop = j_make_mixing_op(jnet)
    np.testing.assert_array_equal(trace.table_masks(op.sparse),
                                  jtrace.table_masks(jop.sparse))
    for rounds in (None, 1, 3):
        assert trace.alive_fraction(rounds) == jtrace.alive_fraction(rounds)
    for k in range(trace.rounds):
        np.testing.assert_array_equal(trace.realized_W(net.W, k),
                                      jtrace.realized_W(jnet.W, k))
    with pytest.raises(ValueError, match="symmetric"):
        realized_W(net.W, np.triu(np.ones((net.n, net.n), bool)))


def test_churn_alone_lowers_as_repro():
    """Churn is a pure schedule: the same trace in both packages."""
    net, jnet = _nets("erdos_renyi")
    churn = ((3, 0, 2), (7, 1, 9), (11, 4, 5))
    trace = lower_faults(FaultSpec(churn=churn), net, 6)
    jtrace = j_lower_faults(JFaultSpec(churn=churn), jnet, 6)
    np.testing.assert_array_equal(trace.edge_masks, jtrace.edge_masks)
    np.testing.assert_array_equal(trace.adj, jtrace.adj)
    assert not trace.edge_masks[1:, 7][:, net.neighbors(7)].any()
    # round 0: only agent 3 is out
    alive = [j for j in net.neighbors(7) if j != 3]
    assert trace.edge_masks[0, 7][alive].all()


def test_drops_and_stragglers_lower_to_symmetric_seeded_masks():
    """The port's numpy draws: every mask symmetric with its diagonal
    set, the same trace for the same seed, another for another seed,
    and the realized drop and skip rates within 5 binomial standard
    deviations of the spec's."""
    net = make_network("erdos_renyi", 32, r=0.4, seed=1)
    K, p, q = 60, 0.3, 0.4
    spec = FaultSpec(drop_prob=p, stragglers=(0, 5), straggle_prob=q,
                     seed=3)
    trace = lower_faults(spec, net, K)
    m = trace.edge_masks
    assert m.shape == (K, 32, 32) and m.dtype == bool
    assert np.array_equal(m, m.transpose(0, 2, 1))
    assert m[:, np.arange(32), np.arange(32)].all()
    assert np.array_equal(m, lower_faults(spec, net, K).edge_masks)
    other = lower_faults(FaultSpec(drop_prob=p, stragglers=(0, 5),
                                   straggle_prob=q, seed=4), net, K)
    assert not np.array_equal(m, other.edge_masks)
    # drop rate on the links no straggler touches
    iu, ju = np.nonzero(np.triu(net.adj, 1))
    free = ~np.isin(iu, (0, 5)) & ~np.isin(ju, (0, 5))
    trials = K * int(free.sum())
    dropped = int((~m[:, iu[free], ju[free]]).sum())
    assert abs(dropped / trials - p) <= 5 * np.sqrt(p * (1 - p) / trials)
    # a skipping straggler loses every incident link that round
    for a in (0, 5):
        skipped = ~m[:, a][:, net.neighbors(a)].any(axis=1)
        assert abs(skipped.mean() - q) <= 5 * np.sqrt(q * (1 - q) / K) \
            + (1 - q) * p ** len(net.neighbors(a))


# ---------------------------------------------------------------------------
# MaskedMixingOp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("comm", ["identity", "bf16", "int8+ef"])
@pytest.mark.parametrize("kind", list(GRAPHS))
def test_masked_gossips_match_repro(kind, comm, monkeypatch):
    """mix, laplacian, mix_c, laplacian_c and neumann_step(_c) of one
    round's view against `repro`'s, on `repro`'s masks."""
    net, jnet = _nets(kind)
    n, d = net.n, 12
    jtrace = j_lower_faults(JFaultSpec(**SPEC), jnet, 3)
    op = make_mixing_op(net, comm=comm, device="cpu")
    jop = j_make_mixing_op(jnet, comm=comm)
    masks = jtrace.table_masks(jop.sparse)
    y, hvp, p = (_data((n, d), seed=s) for s in range(3))
    dsc = np.random.default_rng(5).uniform(1.5, 3.0, (n, 1)).astype(
        np.float32)
    uniforms = ReproUniforms(7, {"c": 3 * masks.shape[0]}, {"c": d}, n)
    uniforms.patch(monkeypatch)
    st = op.comm_channel("c", torch.as_tensor(y), 0)
    jst = jop.comm_channel("c", jnp.asarray(y), channel_keys(7, ["c"])["c"])
    for k in range(masks.shape[0]):
        view = op.masked(torch.as_tensor(masks[k]))
        jview = jop.masked(jnp.asarray(masks[k]))
        assert isinstance(view, MaskedMixingOp)
        assert view._fused_plan(torch.as_tensor(y)) is None
        pairs = [(view.mix(torch.as_tensor(y)), jview.mix(jnp.asarray(y))),
                 (view.laplacian(torch.as_tensor(y)),
                  jview.laplacian(jnp.asarray(y))),
                 (view.neumann_step(*(torch.as_tensor(a) for a in
                                      (y, hvp, p, dsc)), 0.1),
                  jview.neumann_step(*(jnp.asarray(a) for a in
                                       (y, hvp, p, dsc)), 0.1))]
        for fn, jfn in ((view.mix_c, jview.mix_c),
                        (view.laplacian_c, jview.laplacian_c)):
            out, st = fn(torch.as_tensor(y), st)
            jout, jst = jfn(jnp.asarray(y), jst)
            pairs.append((out, jout))
        out, st = view.neumann_step_c(*(torch.as_tensor(a) for a in
                                        (y, hvp, p, dsc)), 0.1, st)
        jout, jst = jview.neumann_step_c(*(jnp.asarray(a) for a in
                                           (y, hvp, p, dsc)), 0.1, jst)
        pairs.append((out, jout))
        for got, want in pairs:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=OUT_ATOL, rtol=0)
    assert st.sends == int(jst.sends) == 3 * masks.shape[0]
    assert op.ledger.summary() == jop.ledger.summary()


@pytest.mark.parametrize("kind", ["ring", "erdos_renyi", "star"])
def test_all_ones_mask_is_the_padded_gather_bitwise(kind):
    """An all-ones mask leaves the tables, and the gossips, bit for bit
    those of the unmasked padded gather (`sparse_gather_pallas`), on any
    base backend; the row plan of masked tables is the nominal one."""
    net, _ = _nets(kind)
    base = make_mixing_op(net, device="cpu")
    padded = make_mixing_op(net, "sparse_gather_pallas", device="cpu")
    y = torch.as_tensor(_data((net.n, 33), seed=4))
    ones = base.masked(np.ones(base.sparse.neighbors.shape, np.float32))
    assert torch.equal(ones._sp_wts, padded._sp_wts)
    assert torch.equal(ones._sp_wself, padded._sp_wself)
    for lap in (False, True):
        got = ones.laplacian(y) if lap else ones.mix(y)
        want = padded.laplacian(y) if lap else padded.mix(y)
        assert torch.equal(got, want)
    masks = lower_faults(FaultSpec(drop_prob=0.5, seed=2), net, 4) \
        .table_masks(base.sparse)
    sp = base.sparse
    nominal = sparse_row_plan(sp.neighbors, sp.weights)
    for k in range(masks.shape[0]):
        view = base.masked(masks[k])
        plan = sparse_row_plan(sp.neighbors, view._sp_wts.numpy())
        for a, b in zip(plan, nominal):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("backend,switch,kernel", [
    ("auto", True, True), ("auto", False, False),
    ("sparse_gather_pallas", False, True), ("dense", True, False)])
@pytest.mark.parametrize("kind", list(GRAPHS))
def test_masked_view_routes_like_the_padded_gather(kind, backend, switch,
                                                   kernel, monkeypatch):
    """A masked gossip takes the padded sparse-gather kernel whenever an
    unmasked padded gather with the same requested backend would — on a
    circulant, CSR (star) or dense base op too — and its plain version
    otherwise: the view dispatches through the base `_apply`."""
    from repro_torch.kernels.ops import kernel_mode
    from repro_torch.topology import ops as tops
    net, _ = _nets(kind)
    if backend == "sparse_gather_pallas" and kind == "ring":
        backend = "circulant_pallas"
    op = make_mixing_op(net, backend, device="cpu")
    calls = []

    def spy(*args, **kw):
        calls.append(kw["laplacian"])
        return tops.sparse_mix_padded_ref(*args, kw["laplacian"])
    monkeypatch.setattr(tops, "sparse_mix_matvec", spy)
    mask = lower_faults(FaultSpec(drop_prob=0.5, seed=1), net, 1) \
        .table_masks(op.sparse)[0]
    view = op.masked(mask)
    y = torch.as_tensor(_data((net.n, 9), seed=2))
    with kernel_mode(switch):
        got = view.mix(y), view.laplacian(y)
    assert calls == ([False, True] if kernel else [])
    Wk = torch.as_tensor(lower_faults(FaultSpec(drop_prob=0.5, seed=1),
                                      net, 1).realized_W(net.W, 0),
                         dtype=torch.float32)
    np.testing.assert_allclose(got[0].numpy(), (Wk @ y).numpy(),
                               atol=OUT_ATOL)
    np.testing.assert_allclose(got[1].numpy(), (y - Wk @ y).numpy(),
                               atol=OUT_ATOL)


def test_masked_view_matches_realized_W_and_shares_the_ledger():
    net = make_network("erdos_renyi", 12, r=0.5, seed=3)
    op = make_mixing_op(net, comm="int8", device="cpu")
    trace = lower_faults(FaultSpec(drop_prob=0.4, stragglers=(2,),
                                   straggle_prob=1.0, seed=1), net, 2)
    y = torch.as_tensor(_data((12, 7), seed=1))
    view = op.masked(trace.table_masks(op.sparse)[1])
    Wk = torch.as_tensor(trace.realized_W(net.W, 1), dtype=torch.float32)
    np.testing.assert_allclose(view.mix(y).numpy(), (Wk @ y).numpy(),
                               atol=OUT_ATOL)
    np.testing.assert_allclose(view.laplacian(y).numpy(),
                               (y - Wk @ y).numpy(), atol=OUT_ATOL)
    # the straggler holds its value: every incident link is down
    assert torch.equal(view.mix(y)[2], y[2])
    assert view.ledger is op.ledger and view.comm is op.comm
    assert "masked" in repr(view)
    with pytest.raises(ValueError, match="table_masks"):
        op.masked(np.ones((12, 2)))


# ---------------------------------------------------------------------------
# Faulted DAGM through solve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("comm", ["identity", "int8+ef"])
@pytest.mark.parametrize("kind", ["ring", "erdos_renyi"])
def test_faulted_solve_matches_repro_on_its_trace(kind, comm,
                                                  monkeypatch):
    net, jnet = _nets(kind)
    n, d1, d2 = net.n, 6, 5
    K, M, U = 5, 3, 2
    jprob = jp.quadratic_bilevel(n, d1, d2, seed=1)
    tprob = tp.quadratic_bilevel(n, d1, d2, seed=1, device="cpu")
    x0, y0 = _data((n, d1), 0, 0.1), _data((n, d2), 1, 0.1)
    kw = dict(K=K, M=M, U=U, dihgp="matrix_free", curvature=10.0)
    sched = dict(alpha=0.05, beta=0.1)
    jres = jsolve(jprob, jnet, JSpec(schedule=JSchedule(**sched),
                                     comm=JCommSpec(comm),
                                     faults=JFaultSpec(**SPEC), **kw),
                  x0=jnp.asarray(x0), y0=jnp.asarray(y0), seed=0)
    carried = _carry(jres.extras["fault_trace"])
    monkeypatch.setattr(tfaults, "lower_faults",
                        lambda spec, net, K: carried)
    ReproUniforms(0, {"inner_y": K * M, "dihgp_h": K * U, "outer_x": K},
                  {"inner_y": d2, "dihgp_h": d2, "outer_x": d1},
                  n).patch(monkeypatch)
    tres = solve(tprob, net, SolverSpec(schedule=ScheduleSpec(**sched),
                                        comm=CommSpec(comm),
                                        faults=FaultSpec(**SPEC), **kw),
                 x0=x0, y0=y0, seed=0, device="cpu")
    assert tres.extras["fault_trace"] is carried
    assert tres.extras["fault_alive_fraction"] \
        == jres.extras["fault_alive_fraction"] < 1.0
    for got, want in ((tres.x, jres.x), (tres.y, jres.y)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=SOLVE_RTOL, atol=SOLVE_ATOL)
    for key, val in jres.metrics.items():
        np.testing.assert_allclose(tres.metrics[key].numpy(),
                                   np.asarray(val), rtol=SOLVE_RTOL,
                                   atol=SOLVE_ATOL, err_msg=key)
    assert tres.ledger.summary() == jres.ledger.summary()


def test_all_alive_faults_reproduce_the_padded_solve_bitwise():
    """FaultSpec() lowers to all-ones masks: the faulted ring solve
    equals the unfaulted solve on "sparse_gather_pallas" bit for bit."""
    net = make_network("ring", 8)
    prob = tp.quadratic_bilevel(8, 4, 3, seed=2, device="cpu")
    kw = dict(K=3, M=2, U=2, dihgp="matrix_free", curvature=10.0)
    from repro_torch.solve import MixingSpec
    ones = solve(prob, net, SolverSpec(faults=FaultSpec(), **kw),
                 device="cpu")
    bare = solve(prob, net, SolverSpec(
        mixing=MixingSpec(backend="sparse_gather_pallas"), **kw),
        device="cpu")
    assert ones.extras["fault_alive_fraction"] == 1.0
    assert torch.equal(ones.x, bare.x) and torch.equal(ones.y, bare.y)
    for key, val in bare.metrics.items():
        assert torch.equal(ones.metrics[key], val), key


def test_fault_spec_is_validated_by_solve():
    net = make_network("ring", 4)
    prob = tp.quadratic_bilevel(4, 2, 3, device="cpu")
    with pytest.raises(ValueError, match="repro_torch.faults.FaultSpec"):
        solve(prob, net, SolverSpec(K=1, faults=JFaultSpec()),
              device="cpu")
    with pytest.raises(ValueError, match="baseline methods"):
        solve(prob, net, SolverSpec(K=1, method="dgbo",
                                    faults=FaultSpec()), device="cpu")
    with pytest.raises(ValueError, match="reference-tier"):
        solve(prob, net, SolverSpec(K=1, tier="serve",
                                    faults=FaultSpec()), device="cpu")
