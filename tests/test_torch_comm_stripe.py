"""The comm-fused full-operand gossips' decoded column stripe, on the CPU.

* `plan_comm_stripe_cols`: the widest f32 stripe of the comm-fused
  full-operand kernels (`sparse_mix_stripe_comm_kernel`,
  `circulant_mix_stripe_comm_kernel`) that fits the shared-memory budget,
  up to n = 14,528, where the unstaged kernels take over; the narrowing
  of an operand too narrow to give every SM a stripe; `smem_budget`
  reaches every width and the unstaged route at n = 16.
* The kernels' walk, emulated in plain PyTorch: each stripe of the
  operand decoded once, one uniform per element (hat + the round trip of
  y − hat under EF: the payload), then every row gathers its neighbors'
  decoded values in table or offset order from the stripe, w_self·y_i
  first with the exact y_i, y_i − acc for the Laplacian.  With the
  port's `term` (product and sum rounded apart) it is held bitwise,
  output and payload, against `sparse_mix_fused_ref` and
  `circulant_mix_fused_ref`; with an exact f32 FMA per term
  (`test_torch_plain_halo._term_fma`: XLA's CPU code contracts each
  neighbor term) against `repro`'s interpret-mode `sparse_mix_matvec`
  and `circulant_mix_matvec` with ``comm=``.  Rows hold NaN, ±inf and
  −0; graphs are a ring (k = 2), a circulant of k = 18 offsets, an
  Erdős–Rényi graph (r = 0.5) and a star.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.kernels import mixing_matvec as jmm
from test_torch_plain_halo import _operand, _same_bits, _term_fma, \
    _term_separate

from repro_torch.comm import row_quant_params
from repro_torch.kernels import mixing_matvec as tmm
from repro_torch.kernels import ref as tref
from repro_torch.topology import make_network
from repro_torch.topology.structure import sparse_structure

COMMS = ["int8", "int4", "int8+ef", "int4+ef"]
GRAPHS = ["ring", "circulant18", "erdos_renyi", "star"]
# the largest n each stripe width fits (232,448 bytes of shared memory,
# one decoded f32 stripe and nothing else)
LARGEST_N = {128: 454, 64: 908, 32: 1816, 16: 3632, 8: 7264, 4: 14528}
D1, D2 = 157_000, 2_010


# -- the planner --------------------------------------------------------------

@pytest.mark.parametrize("n", [3, 16, 75, 100, 128, 454, 455, 4121, 14528,
                               14529])
def test_comm_stripe_planner(n):
    cols = tmm.plan_comm_stripe_cols(n)
    # one decoded stripe is all the kernels stage: the plain f32 widths
    assert cols == tmm.plan_stripe_cols(n, 4)
    if n > LARGEST_N[4]:
        assert cols is None             # the unstaged kernels
        assert tmm.plan_comm_stripe_cols(n, D2) is None
        return
    assert cols == max(c for c, top in LARGEST_N.items() if n <= top)
    assert tmm.stripe_bytes(n, cols) <= tmm.SMEM_BUDGET_BYTES
    assert all(tmm.stripe_bytes(n, c) > tmm.SMEM_BUDGET_BYTES
               for c in tmm.stripe_cols_for(4) if c > cols)
    # the main path's d1 operand keeps the widest stripe (1,227 stripes
    # of 128 columns at n ≤ 454); its d2 operand is narrowed until its
    # stripes cover the card's 132 SMs: 8 columns, 252 stripes
    assert tmm.plan_comm_stripe_cols(n, D1) == cols
    narrow = tmm.plan_comm_stripe_cols(n, D2)
    assert narrow == min(cols, 8)
    assert -(-D2 // narrow) >= tmm.CARD_SMS or narrow == 4


def test_comm_stripe_planner_edges():
    """The unstaged edge, and the narrowing: bc halves while the stripes
    leave an SM idle and stops at 4 columns (d = 1 has one stripe at any
    width)."""
    assert tmm.plan_comm_stripe_cols(LARGEST_N[4]) == 4
    assert tmm.plan_comm_stripe_cols(LARGEST_N[4] + 1) is None
    assert tmm.plan_comm_stripe_cols(16, 1) == 4
    assert tmm.plan_comm_stripe_cols(16, 128 * 132) == 128
    assert tmm.plan_comm_stripe_cols(16, 128 * 131) == 64
    assert tmm.plan_comm_stripe_cols(16, 2010, sms=16) == 128
    assert tmm.plan_comm_stripe_cols(16, 2010, sms=17) == 64
    assert tmm.plan_comm_stripe_cols(4121, D2) == 8


def test_smem_budget_reaches_every_comm_stripe_route():
    """At n = 16 a budget of exactly a width's stripe gives that width,
    one byte under the narrowest gives None (the unstaged kernels); the
    budget comes back on exit, and the CPU wrappers' output and payload
    do not depend on the route and launch nothing."""
    n, saved = 16, tmm.SMEM_BUDGET_BYTES
    y = torch.as_tensor(_operand(n, d=40))
    hat = torch.as_tensor(_operand(n, d=40, seed=1)) * 0.5
    zp, sc = row_quant_params(y - hat, 8)
    sp = sparse_structure(make_network("erdos_renyi", n, r=0.5, seed=0).W)
    tabs = [torch.as_tensor(a) for a in (sp.w_self, sp.neighbors,
                                         sp.weights)]
    offsets, weights = tmm.ring_offsets(n, 0.25)
    off, w = tmm.circulant_tables(n, offsets, weights, "cpu")
    want_s = tref.sparse_mix_fused_ref(y, *tabs, zp, sc, 5, hat,
                                       laplacian=True)
    want_c = tref.circulant_mix_fused_ref(y, zp, sc, 5, hat, w_self=0.5,
                                          offsets=offsets, weights=weights,
                                          laplacian=True)
    widths = tmm.stripe_cols_for(4)
    budgets = [tmm.stripe_bytes(n, c) for c in widths]
    tmm.reset_launch_counts()
    for cols, budget in zip([*widths, None], [*budgets, budgets[-1] - 1]):
        with tmm.smem_budget(budget):
            assert tmm.plan_comm_stripe_cols(n) == cols
            assert tmm.plan_comm_stripe_cols(n, D1) == cols
            got_s = tmm.sparse_mix_matvec(y, *tabs, zp, sc, 5, hat,
                                          laplacian=True, comm="int8+ef")
            got_c = tmm.circulant_mix_matvec(y, zp, sc, 5, hat, w_self=0.5,
                                             offsets=off, weights=w,
                                             laplacian=True, comm="int8+ef")
        for got, want in ((got_s, want_s), (got_c, want_c)):
            for g, ww in zip(got, want):
                _same_bits(g, ww)
    assert tmm.SMEM_BUDGET_BYTES == saved
    assert sum(tmm.launch_counts().values()) == 0


# -- the walk, emulated -------------------------------------------------------

def _slots(graph: str, n: int):
    """(w_self (n, 1), [(source rows (n,), weights (n, 1)) per slot in the
    kernel's order], sparse tables or circulant tables)."""
    rows = torch.arange(n)
    if graph in ("ring", "circulant18"):
        if graph == "ring":
            offsets, weights = tmm.ring_offsets(n, 0.25)
            w_self = 0.5
        else:
            # 18 offsets in [1, n): repeats where n ≤ 18 (the kernel and
            # both plain versions add each table entry on its own)
            rng = np.random.default_rng(n)
            offsets = tuple(1 + t % (n - 1) for t in range(18))
            weights = tuple(float(x) for x in
                            rng.uniform(0.01, 0.05, 18).astype(np.float32))
            w_self = float(np.float32(1 - sum(weights)))
        slots = [((rows + o) % n, torch.full((n, 1), c))
                 for o, c in zip(offsets, weights)]
        return torch.full((n, 1), w_self), slots, ("circulant", w_self,
                                                   offsets, weights)
    net = make_network(graph, n, r=0.5, seed=0)
    sp = sparse_structure(net.W)
    tabs = [torch.as_tensor(a) for a in (sp.w_self, sp.neighbors,
                                         sp.weights)]
    slots = [(tabs[1][:, t].long(), tabs[2][:, t:t + 1])
             for t in range(sp.k)]
    return tabs[0][:, None], slots, ("sparse", *tabs)


def _stripe_emulation(y, zp, sc, seed, hat, *, bits, w_self, slots,
                      laplacian, term, cols):
    """The decoded-stripe kernels in plain PyTorch: stripe by stripe of
    `cols` columns, (2) every staged element decoded once with its own
    row's metadata and the uniform of its (row, column), hat + the round
    trip of y − hat under EF, which is also the payload; (3) each row
    w_self·y_i with the exact y_i, then every slot's decoded row in
    order through `term`, then y_i − acc for the Laplacian."""
    n, d = y.shape
    levels = float(2 ** bits - 1)
    out, pay = torch.empty_like(y), torch.empty_like(y)
    for c0 in range(0, d, cols):
        j = torch.arange(c0, min(d, c0 + cols))
        ys = y[:, j]
        x = ys - hat[:, j] if hat is not None else ys
        u = tref.hash_uniform(seed, torch.arange(n)[:, None], j[None, :])
        q = torch.clamp(torch.floor((x - zp) / sc + u), 0.0, levels)
        dec = zp + sc * q
        if hat is not None:
            dec = hat[:, j] + dec
        acc = w_self * ys
        for src, w in slots:
            acc = term(acc, w, dec[src])
        out[:, j] = ys - acc if laplacian else acc
        pay[:, j] = dec
    return out, pay


def _case(graph, n, comm, d, seed=0):
    bits, ef = int(comm[3]), comm.endswith("+ef")
    y = torch.as_tensor(_operand(n, d=d, seed=seed))
    hat = 0.5 * torch.as_tensor(_operand(n, d=d, seed=seed + 1)) \
        if ef else None
    if ef:
        hat[:, 5] = 0.0                 # −0 − 0 and 0 − 0 on the wire
    zp, sc = row_quant_params(y - hat if ef else y, bits)
    return bits, ef, y, hat, zp, sc


@pytest.mark.parametrize("n", [7, 16, 100])
@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("comm", COMMS)
@pytest.mark.parametrize("laplacian", [False, True])
def test_stripe_walk_matches_the_plain_versions(n, graph, comm, laplacian):
    """d = 300: two 128-column stripes and a ragged third at the
    planner's width; the walk with separate roundings is bitwise the
    port's plain versions (the CPU wrappers), output and payload."""
    bits, ef, y, hat, zp, sc = _case(graph, n, comm, d=300)
    w_self, slots, tables = _slots(graph, n)
    cols = tmm.plan_comm_stripe_cols(n)
    assert cols == 128
    out, pay = _stripe_emulation(y, zp, sc, 13, hat, bits=bits,
                                 w_self=w_self, slots=slots,
                                 laplacian=laplacian, term=_term_separate,
                                 cols=cols)
    if tables[0] == "sparse":
        want = tmm.sparse_mix_matvec(y, *tables[1:], zp, sc, 13, hat,
                                     laplacian=laplacian, comm=comm)
    else:
        _, ws, offsets, weights = tables
        off, w = tmm.circulant_tables(n, offsets, weights, "cpu")
        want = tmm.circulant_mix_matvec(y, zp, sc, 13, hat, w_self=ws,
                                        offsets=off, weights=w,
                                        laplacian=laplacian, comm=comm)
    if ef:
        want, want_pay = want
        _same_bits(pay, want_pay)
    _same_bits(out, want)
    assert torch.isnan(out).any()       # the NaN row reached the output


@pytest.mark.parametrize("n", [7, 16, 100])
@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("comm", COMMS)
def test_stripe_walk_with_fma_matches_repro(n, graph, comm):
    """The same walk with one f32 FMA per neighbor term against `repro`'s
    fused Pallas kernel in interpret mode (d = 256, its bd | d), (I−W)·Y:
    output and payload bitwise."""
    bits, ef, y, hat, zp, sc = _case(graph, n, comm, d=256, seed=2)
    w_self, slots, tables = _slots(graph, n)
    out, pay = _stripe_emulation(y, zp, sc, 21, hat, bits=bits,
                                 w_self=w_self, slots=slots, laplacian=True,
                                 term=_term_fma,
                                 cols=tmm.plan_comm_stripe_cols(n))
    args = (jnp.asarray(zp.numpy()), jnp.asarray(sc.numpy()),
            jnp.asarray([21], jnp.int32),
            jnp.asarray(hat.numpy()) if ef else None)
    if tables[0] == "sparse":
        want = jmm.sparse_mix_matvec(
            jnp.asarray(y.numpy()),
            *(jnp.asarray(t.numpy()) for t in tables[1:]), *args,
            laplacian=True, comm=comm, interpret=True)
    else:
        _, ws, offsets, weights = tables
        want = jmm.circulant_mix_matvec(
            jnp.asarray(y.numpy()), *args, w_self=ws, offsets=offsets,
            weights=weights, laplacian=True, comm=comm, interpret=True)
    if ef:
        want, want_pay = want
        _same_bits(pay, np.array(want_pay))
    _same_bits(out, np.array(want))
