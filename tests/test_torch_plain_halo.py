"""The plain halo gossips' kernel-side arithmetic and plans, on the CPU.

* The plain sparse gather's column slab (`sparse_mix_slab_kernel`) walks
  rows in the row plan's order, gathers a row's real slots and applies
  the padded slots (index i, weight +0.0) left after them as
  term(acc, +0.0, y_i) from registers.  A plain-PyTorch emulation of that
  per-row arithmetic — each row's own deg[i] slots gathered, or, as the
  kernel's warps walk, the pass's most real slots for every row of the
  pass — is held bitwise (NaN at the same places, payloads
  aside) against `sparse_mix_padded_ref` and against `repro`'s
  `sparse_mix_matvec_halo` in interpret mode, on Erdős–Rényi tables with
  NaN, ±inf and −0 in the operand.  The two references round
  differently: the port's kernels and `sparse_mix_padded_ref` round each
  product and sum on its own, while XLA's CPU lowering of `repro`'s
  kernel contracts each neighbor term into one fused multiply-add.  So
  the emulation runs each reference's own `term` (separate roundings,
  or an exact f32 FMA); the padded-slot identity holds under both.
* `sparse_row_plan`: the real degrees and the degree order.
* The column-slab planner for f32 and bf16: widths, bytes, the table
  stage's alignment and every route under `smem_budget`.
* The staged circulant kernel's ring: `halo_stages` and the launch's
  shared memory against the planner's 3-buffer plan.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.kernels import mixing_matvec as jmm

from repro_torch.kernels import mixing_matvec as tmm
from repro_torch.kernels import ref as tref
from repro_torch.topology import MixingOp
from repro_torch.topology.graphs import erdos_renyi_graph, star_graph
from repro_torch.topology.structure import (circulant_structure,
                                            sparse_structure)
from repro_torch.topology.weights import metropolis_weights

# n, r, the port's bn, repro's bn (one grid step of the interpreter at
# n = 4121 = 13·317; the port's wrapper keeps its tile within shared
# memory)
ER_CASES = [(16, 0.5, 8, 8), (64, 0.15, 8, 8), (4121, 0.004, 1, 4121)]
D = 128              # repro's halo kernels take d % 128 == 0
RPW = 16             # rows a warp walks per pass at the planner's slab


def _er_structure(n: int, r: float):
    return sparse_structure(metropolis_weights(erdos_renyi_graph(n, r, 0)))


def _operand(n: int, d: int = D, seed: int = 0) -> np.ndarray:
    """N(0, 1) with NaN, ±inf and −0 entries, a column of −0 (every
    accumulator −0 before the Laplacian) and one of −0 and +0 mixed."""
    y = np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)
    y[3 % n, :4] = [np.nan, np.inf, -np.inf, -0.0]
    y[7 % n] = -0.0
    y[11 % n, 1::3] = np.inf
    y[:, 5] = -0.0
    y[:, 6] = np.where(np.arange(n) % 3 == 0, 0.0, -0.0)
    return y


def _term_separate(acc, w, v):
    """The kernels' `term`: the product and the sum rounded on their
    own."""
    return acc + w * v


def _term_fma(acc, w, v):
    """acc + w·v rounded once (an f32 fused multiply-add), exactly: the
    f64 product of two f32 values is exact, the f64 sum is made
    round-to-odd from its TwoSum error, and rounding that to f32 is the
    single rounding of the exact value (53 ≥ 24 + 2 bits)."""
    a, b, c = (torch.as_tensor(t).double() for t in (w, v, acc))
    a, b, c = torch.broadcast_tensors(a, b, c)
    p = a * b
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    even = (s.view(torch.int64) & 1) == 0
    nudge = torch.isfinite(s) & (err != 0) & even
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, -float("inf")))
    s = torch.where(nudge, torch.nextafter(s, toward), s)
    return s.float()


def _slab_emulation(y, w_self, nbr, wts, order, deg, *, laplacian, term,
                    walk="row"):
    """The slab kernel's per-row arithmetic in plain PyTorch: passes of
    RPW rows along `order`; acc = w_self·y_i, then the row's first slots
    gathered in table order, then term(acc, +0.0, y_i) for each slot
    left, with y_i from the row itself (no gather), then y_i − acc for
    the Laplacian.  walk="row" gathers each row's own deg[i] real slots;
    walk="warp" the kernel's extent, the pass's most real slots rounded
    up to a group of four and capped at k, for every row of the pass
    (a row with fewer real slots gathers some of its padded ones)."""
    n, k = nbr.shape
    out = torch.empty_like(y)
    zero = torch.zeros((1, 1))
    for p0 in range(0, n, RPW):
        rows = order[p0:p0 + RPW].long()
        g = deg[rows].long()[:, None]
        if walk == "warp":
            g = torch.full_like(g, min(k, -(-int(g.max()) // 4) * 4))
        yi = y[rows]
        acc = w_self[rows, None] * yi
        for q in range(int(g.max())):
            gathered = term(acc, wts[rows, q:q + 1], y[nbr[rows, q].long()])
            acc = torch.where(q < g, gathered, acc)
        for t in range(int((k - g).max())):
            acc = torch.where(t < k - g, term(acc, zero, yi), acc)
        out[rows] = yi - acc if laplacian else acc
    return out


def _same_bits(got, want):
    """Bitwise, with NaN at the same places (a NaN's payload aside)."""
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    assert got.dtype == want.dtype == torch.float32
    nan = got.isnan()
    assert torch.equal(nan, want.isnan())
    assert torch.equal(got.view(torch.int32)[~nan],
                       want.view(torch.int32)[~nan])


@pytest.mark.parametrize("n,r,bn,repro_bn", ER_CASES)
@pytest.mark.parametrize("laplacian", [False, True])
@pytest.mark.parametrize("walk", ["row", "warp"])
def test_padded_slots_from_registers_bitwise(n, r, bn, repro_bn, laplacian,
                                             walk):
    sp = _er_structure(n, r)
    order, deg = (torch.as_tensor(a) for a in
                  tmm.sparse_row_plan(sp.neighbors, sp.weights))
    assert int(deg.min()) < sp.k        # some rows carry padded slots
    y = torch.as_tensor(_operand(n))
    tabs = [torch.as_tensor(a) for a in (sp.w_self, sp.neighbors,
                                         sp.weights)]
    emu = _slab_emulation(y, *tabs, order, deg, laplacian=laplacian,
                          term=_term_separate, walk=walk)
    _same_bits(emu, tref.sparse_mix_padded_ref(y, *tabs, laplacian))
    _same_bits(emu, tmm.sparse_mix_matvec_halo(
        y, *tabs, laplacian=laplacian, bn=bn, row_plan=(order, deg)))
    emu_fma = _slab_emulation(y, *tabs, order, deg, laplacian=laplacian,
                              term=_term_fma, walk=walk)
    want = jmm.sparse_mix_matvec_halo(
        jnp.asarray(y.numpy()), *(jnp.asarray(t.numpy()) for t in tabs),
        laplacian=laplacian, bn=repro_bn)
    _same_bits(emu_fma, np.array(want))


def test_fma_emulation_is_one_rounding():
    """`_term_fma` against exactly rounded sums of a few hand-picked
    cases: 2³⁰ + 2⁷ + 2⁶·(1 − 2⁻⁴⁶), which lies just below an f32 tie
    that the f64 sum alone rounds onto (and then to the even neighbor,
    2³⁰ + 2⁸), an exact cancellation, −0 + (+0)·(−0), inf·0."""
    one = np.float32(1.0)
    cases = [
        # acc, w, v, exact f32 result
        (np.float32(2 ** 30 + 2 ** 7), np.float32(2 ** 6 * (1 + 2 ** -23)),
         np.float32(1 - 2 ** -23), np.float32(2 ** 30 + 2 ** 7)),
        (one, np.float32(-1.0), one, np.float32(0.0)),
        (np.float32(-0.0), np.float32(0.0), np.float32(-0.0),
         np.float32(-0.0)),
    ]
    for acc, w, v, want in cases:
        got = _term_fma(torch.tensor([acc]), torch.tensor([w]),
                        torch.tensor([v]))
        _same_bits(got, torch.tensor([want]))
    assert torch.isnan(_term_fma(torch.tensor([1.0]), torch.tensor([0.0]),
                                 torch.tensor([float("inf")]))).all()


# -- the row plan -----------------------------------------------------------

@pytest.mark.parametrize("n,r", [(16, 0.5), (64, 0.15), (4121, 0.004)])
def test_row_plan_counts_real_slots_in_degree_order(n, r):
    sp = _er_structure(n, r)
    order, deg = tmm.sparse_row_plan(sp.neighbors, sp.weights)
    assert order.dtype == deg.dtype == np.int32
    np.testing.assert_array_equal(np.sort(order), np.arange(n))
    assert np.all(np.diff(deg[order]) >= 0)
    np.testing.assert_array_equal(deg, np.diff(sp.rowptr))


def test_row_plan_on_a_skewed_graph():
    """The star: the hub's n − 1 slots all real, each leaf one."""
    sp = sparse_structure(metropolis_weights(star_graph(9)))
    order, deg = tmm.sparse_row_plan(sp.neighbors, sp.weights)
    np.testing.assert_array_equal(deg, np.diff(sp.rowptr))
    assert deg[order[-1]] == sp.k == 8


def test_row_plan_pads_only_a_trailing_run_of_self_and_plus_zero():
    """A trailing slot counts as padding only with the row's own index
    and weight bits exactly +0.0: weight −0.0, another row's index, or a
    real slot after a (self, +0) slot keep deg = k; and the emulation on
    such a table still equals the padded reference bit for bit."""
    nbr = np.array([[1, 2, 0],      # weight −0.0 on a self slot
                    [0, 2, 3],      # weight +0.0 on another row
                    [0, 2, 2],      # two trailing pads
                    [3, 3, 3],      # isolated: every slot a pad
                    [1, 4, 2]],     # a (self, +0) slot before a real one
                   dtype=np.int32)
    wts = np.array([[0.2, 0.3, -0.0],
                    [0.1, 0.0, 0.0],
                    [0.5, 0.0, 0.0],
                    [0.0, 0.0, 0.0],
                    [0.1, 0.0, 0.2]], dtype=np.float32)
    order, deg = tmm.sparse_row_plan(nbr, wts)
    np.testing.assert_array_equal(deg, [3, 3, 1, 0, 3])
    np.testing.assert_array_equal(order, [3, 2, 0, 1, 4])
    y = torch.as_tensor(_operand(5, d=8, seed=2))
    w_self = torch.tensor([0.5, 0.4, 0.5, 1.0, 0.7])
    for lap in (False, True):
        emu = _slab_emulation(y, w_self, torch.as_tensor(nbr),
                              torch.as_tensor(wts), torch.as_tensor(order),
                              torch.as_tensor(deg), laplacian=lap,
                              term=_term_separate)
        _same_bits(emu, tref.sparse_mix_padded_ref(
            y, w_self, torch.as_tensor(nbr), torch.as_tensor(wts), lap))


def test_row_plan_refuses_mismatched_tables():
    with pytest.raises(ValueError, match=r"\(n, k\)"):
        tmm.sparse_row_plan(np.zeros((4, 3), np.int32),
                            np.zeros((4, 2), np.float32))


def test_halo_wrapper_checks_the_row_plan():
    sp = _er_structure(64, 0.15)
    tabs = [torch.as_tensor(a) for a in (sp.w_self, sp.neighbors,
                                         sp.weights)]
    order, deg = (torch.as_tensor(a) for a in
                  tmm.sparse_row_plan(sp.neighbors, sp.weights))
    y = torch.as_tensor(_operand(64))
    with pytest.raises(ValueError, match="row_plan deg"):
        tmm.sparse_mix_matvec_halo(y, *tabs, bn=8,
                                   row_plan=(order, deg.long()))
    with pytest.raises(ValueError, match="row_plan order"):
        tmm.sparse_mix_matvec_halo(y, *tabs, bn=8,
                                   row_plan=(order[:-1], deg))
    zp, sc = torch.zeros(64, 1), torch.ones(64, 1)
    with pytest.raises(ValueError, match="plain gather"):
        tmm.sparse_mix_matvec_halo(y, *tabs, zp, sc, 1, bn=8, comm="int8",
                                   row_plan=(order, deg))


def test_mixing_op_builds_the_row_plan_once():
    w = metropolis_weights(erdos_renyi_graph(64, 0.15, 0))
    op = MixingOp(w, device="cpu")
    order, deg = op._sp_plan
    want = tmm.sparse_row_plan(op.sparse.neighbors, op.sparse.weights)
    np.testing.assert_array_equal(order.numpy(), want[0])
    np.testing.assert_array_equal(deg.numpy(), want[1])
    assert order.dtype == deg.dtype == torch.int32


# -- the column-slab planner, f32 and bf16 ----------------------------------

# the largest n each slab row width fits beside its table stage (232,448
# bytes): 32-byte rows beside 81,920 bytes of stage, narrower ones beside
# 98,304
LARGEST_N = {32: 4704, 16: 8384, 8: 16768, 4: 33536}


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("n", [16, 4096, 4121, *LARGEST_N.values()])
def test_slab_planner_by_itemsize(itemsize, n):
    widths = tmm.slab_cols_for(itemsize)
    assert widths == ((16, 8, 4, 2) if itemsize == 2 else (8, 4, 2, 1))
    cols = tmm.plan_slab_cols(n, itemsize)
    row_bytes = max(b for b, top in LARGEST_N.items() if n <= top)
    assert cols == row_bytes // itemsize
    smem = tmm.slab_smem_bytes(n, cols, itemsize)
    assert smem <= tmm.SMEM_BUDGET_BYTES
    # a bf16 slab of c columns is the f32 slab of c/2, byte for byte
    assert smem == tmm.slab_smem_bytes(n, cols * itemsize // 4)
    stage = tmm.slab_smem_bytes(0, cols, itemsize)
    assert stage == (81_920 if row_bytes == 32 else 98_304)
    slab = smem - stage
    assert slab % 16 == 0 and n * row_bytes <= slab < n * row_bytes + 16
    if n == LARGEST_N[row_bytes]:
        assert smem == tmm.SMEM_BUDGET_BYTES
        narrower = [c for c in widths if c < cols]
        assert tmm.plan_slab_cols(n + 1, itemsize) \
            == (narrower[0] if narrower else None)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("n", [4096, 4121])
def test_smem_budget_reaches_every_slab_route_by_itemsize(itemsize, n):
    """A budget of exactly a width's slab gives that width; one byte
    under the narrowest gives None (the row-tiled kernel, whose (64, 128)
    tile still fits); the planner's budget comes back on exit."""
    saved = tmm.SMEM_BUDGET_BYTES
    widths = tmm.slab_cols_for(itemsize)
    assert tmm.plan_slab_cols(n, itemsize) == widths[0]
    for cols in widths:
        with tmm.smem_budget(tmm.slab_smem_bytes(n, cols, itemsize)):
            assert tmm.plan_slab_cols(n, itemsize) == cols
    with tmm.smem_budget(tmm.slab_smem_bytes(n, widths[-1], itemsize) - 1):
        assert tmm.plan_slab_cols(n, itemsize) is None
        assert tmm.halo_smem_bytes(64, itemsize=itemsize) \
            <= tmm.SMEM_BUDGET_BYTES
    assert tmm.SMEM_BUDGET_BYTES == saved


# -- the staged circulant kernel's ring -------------------------------------

@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("offsets", [(1,), tuple(range(1, 10))])
def test_circulant_ring_fills_the_planners_three_buffers(itemsize,
                                                         offsets):
    """At the planner's bn the ring holds 3 stages, the plan's 3 live
    buffers (`plan_blocks(False)`), within the budget; at bn/2 still 3;
    at 2·bn the one buffer that fits.  The wrapper's size is stages ×
    one tile, which the C entry point recomputes."""
    n = 4096
    s = circulant_structure(_circulant_w(n, offsets))
    h_lo, h_hi = tmm.halo_extents(s.offsets, n)
    assert len(s.offsets) == 2 * len(offsets)
    bn = tmm.pick_halo_bn(n, h_lo=h_lo, h_hi=h_hi, itemsize=itemsize)
    assert bn == (256 if itemsize == 2 else 128)
    for tile, stages in ((bn, 3), (bn // 2, 3), (2 * bn, 1)):
        rows = h_lo + tile + h_hi
        assert tmm.halo_stages(rows, itemsize=itemsize) == stages
        got = tmm._halo_smem(n, tile, h_lo, h_hi, itemsize,
                             tmm.plan_blocks(False), rows, ring=True)
        one = tmm.halo_smem_bytes(rows, itemsize=itemsize)
        assert got == (stages, stages * one)
        assert stages * one <= tmm.SMEM_BUDGET_BYTES
    assert tmm.halo_stages(h_lo + bn + h_hi, itemsize=itemsize) \
        == tmm.plan_blocks(False) == tmm.HALO_STAGES
    assert tmm.halo_smem_bytes(h_lo + bn + h_hi, itemsize=itemsize,
                               blocks=3) <= tmm.SMEM_BUDGET_BYTES
    # a launch without a ring (the sparse row tiles) keeps one tile
    assert tmm._halo_smem(n, bn, h_lo, h_hi, itemsize, 4,
                          h_lo + bn + h_hi)[0] == 1


def test_circulant_ring_follows_a_lower_budget():
    one = tmm.halo_smem_bytes(130)
    with tmm.smem_budget(2 * one):
        assert tmm.halo_stages(130) == 2
    with tmm.smem_budget(one - 1):
        assert tmm.halo_stages(130) == 0
    assert tmm.halo_stages(130) == 3


def _circulant_w(n: int, offsets) -> np.ndarray:
    """A circulant W with neighbors at ±o for o in offsets, uniform
    weights, built directly (no spectral checks at n = 4096)."""
    w = np.eye(n) / (2 * len(offsets) + 1)
    for o in offsets:
        w += (np.roll(np.eye(n), o, axis=1) + np.roll(np.eye(n), -o, axis=1)
              ) / (2 * len(offsets) + 1)
    return w
