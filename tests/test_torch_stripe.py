"""The full-operand sparse gather's column stripe and the fused circulant
halo kernel's ring, on the CPU.

* `plan_stripe_cols`: the widest (n, bc) column stripe of the plain
  full-operand sparse gather (`sparse_mix_stripe_kernel`) that fits the
  shared-memory budget, for f32 and bf16, up to n = 14,528, where the
  unstaged kernel takes over; `smem_budget` reaches every width and the
  unstaged route at n = 16.
* The port's `sparse_mix_matvec` at odd row counts (n = 7, 100), which
  the stripe's warps must cover, against `repro`'s interpret-mode
  `sparse_mix_matvec`.  The stripe kernel's arithmetic is the plain
  version's: w_self·y_i, every table slot in order, y_i − acc for the
  Laplacian.  The emulation of `test_torch_plain_halo` with every slot
  gathered runs that order with the port's `term` (product and sum
  rounded apart) and with an exact f32 FMA, which is what XLA's CPU
  lowering of `repro`'s kernel makes of each neighbor term: the first is
  bitwise the port's output, the second bitwise `repro`'s.
* `halo_comm_stages`: the fused circulant halo kernel's ring of raw
  stages and its decoded tile within the planner's `plan_blocks(True,
  ef)` buffers at the planner's bn.
"""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.kernels import mixing_matvec as jmm
from test_torch_plain_halo import (_operand, _same_bits, _slab_emulation,
                                   _term_fma, _term_separate)

from repro_torch.comm import row_quant_params
from repro_torch.kernels import mixing_matvec as tmm
from repro_torch.kernels import ref as tref
from repro_torch.topology import MixingOp, make_network
from repro_torch.topology.structure import sparse_structure

D1, D2 = 157_000, 2_010
# the largest n each stripe row width fits (232,448 bytes of shared
# memory, nothing else staged)
LARGEST_N = {512: 454, 256: 908, 128: 1816, 64: 3632, 32: 7264,
             16: 14528}


# -- the stripe planner -----------------------------------------------------

@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("n", [3, 16, 100, 128, 151, 4121, 14528, 14529])
def test_stripe_planner_by_itemsize(itemsize, n):
    widths = tmm.stripe_cols_for(itemsize)
    assert widths == ((256, 128, 64, 32, 16, 8) if itemsize == 2
                      else (128, 64, 32, 16, 8, 4))
    cols = tmm.plan_stripe_cols(n, itemsize)
    if n > LARGEST_N[16]:
        assert cols is None             # the unstaged kernel
        return
    row_bytes = max(b for b, top in LARGEST_N.items() if n <= top)
    assert cols == row_bytes // itemsize
    smem = tmm.stripe_bytes(n, cols, itemsize)
    assert smem == n * row_bytes <= tmm.SMEM_BUDGET_BYTES
    wider = [c for c in widths if c > cols]
    assert all(tmm.stripe_bytes(n, c, itemsize) > tmm.SMEM_BUDGET_BYTES
               for c in wider)
    # the main path's sizes: the whole 128-column stripe of repro's
    # full tier up to n = 151, eight f32 columns at n = 4121
    if n <= 151:
        assert cols * itemsize == 512
    if n == 4121:
        assert cols * itemsize == 32
    if n == LARGEST_N[16]:
        assert smem == tmm.SMEM_BUDGET_BYTES


@pytest.mark.parametrize("itemsize", [2, 4])
def test_smem_budget_reaches_every_stripe_route(itemsize):
    """At n = 16 a budget of exactly a width's stripe gives that width,
    one byte under the narrowest gives None (the unstaged kernel); the
    budget comes back on exit, and the CPU wrapper's output does not
    depend on the route."""
    n = 16
    saved = tmm.SMEM_BUDGET_BYTES
    sp = sparse_structure(make_network("erdos_renyi", n, r=0.5, seed=0).W)
    tabs = [torch.as_tensor(a) for a in (sp.w_self, sp.neighbors,
                                         sp.weights)]
    y = torch.as_tensor(_operand(n, d=40)).to(
        torch.float32 if itemsize == 4 else torch.bfloat16)
    want = tref.sparse_mix_padded_ref(y.float(), *tabs, True).to(y.dtype)
    widths = tmm.stripe_cols_for(itemsize)
    budgets = [tmm.stripe_bytes(n, c, itemsize) for c in widths]
    for cols, budget in zip([*widths, None], [*budgets, budgets[-1] - 1]):
        with tmm.smem_budget(budget):
            assert tmm.plan_stripe_cols(n, itemsize) == cols
            got = tmm.sparse_mix_matvec(y, *tabs, laplacian=True)
        assert torch.equal(got.float().isnan(), want.float().isnan())
        assert torch.equal(got.view(torch.int16 if itemsize == 2
                                    else torch.int32),
                           want.view(torch.int16 if itemsize == 2
                                     else torch.int32))
    assert tmm.SMEM_BUDGET_BYTES == saved
    assert sum(tmm.launch_counts().values()) == 0


# -- the port's sparse_mix_matvec against repro's, at odd row counts --------

@pytest.mark.parametrize("n", [100, 7])
@pytest.mark.parametrize("laplacian", [False, True])
def test_sparse_mix_at_odd_row_counts_matches_repro(n, laplacian):
    sp = sparse_structure(make_network("erdos_renyi", n, r=0.5, seed=0).W)
    assert tmm.plan_stripe_cols(n) == 128
    y = torch.as_tensor(_operand(n, d=256))
    tabs = [torch.as_tensor(a) for a in (sp.w_self, sp.neighbors,
                                         sp.weights)]
    # natural order, every slot gathered: the stripe kernel's walk
    order = torch.arange(n, dtype=torch.int32)
    every = torch.full((n,), sp.k, dtype=torch.int32)
    got = tmm.sparse_mix_matvec(y, *tabs, laplacian=laplacian)
    _same_bits(got, _slab_emulation(y, *tabs, order, every,
                                    laplacian=laplacian,
                                    term=_term_separate))
    _same_bits(got, tref.sparse_mix_padded_ref(y, *tabs, laplacian))
    want = jmm.sparse_mix_matvec(
        jnp.asarray(y.numpy()), *(jnp.asarray(t.numpy()) for t in tabs),
        laplacian=laplacian, interpret=True)
    _same_bits(_slab_emulation(y, *tabs, order, every, laplacian=laplacian,
                               term=_term_fma), np.array(want))


# -- the fused circulant halo kernel's ring ---------------------------------

@functools.lru_cache(maxsize=None)
def _ring_op(n: int) -> MixingOp:
    return MixingOp(make_network("ring", n).W, device="cpu")


@pytest.mark.parametrize("ef", [False, True])
@pytest.mark.parametrize("n", [4096, 4121])
@pytest.mark.parametrize("d", [D1, D2])
def test_fused_ring_fits_the_planners_buffers(ef, n, d):
    """`MixingOp`'s plan for a fused ring gossip of the main path's d1
    and d2 operands (64 at n = 4096; 4121 = 13·317 has no power-of-two
    tile, so the full-operand kernel runs there): at that bn the ring
    holds 3 raw stages, or 2 of y and hat under EF, beside the decoded
    tile, 4 or 5 tiles within `plan_blocks(True, ef)` = 4 or 6."""
    blocks = tmm.plan_blocks(True, ef)
    plan = _ring_op(n)._stripe_plan(torch.empty((n, d), device="meta"),
                                    blocks=blocks, circulant=True)
    h_lo, h_hi = tmm.halo_extents(_ring_op(n).structure.offsets, n)
    if n == 4121:
        assert plan == ("xla", None)
        return
    assert plan == ("halo", 64)
    rows = h_lo + 64 + h_hi
    one = tmm.halo_smem_bytes(rows)
    stages = tmm.halo_comm_stages(rows, ef=ef)
    buffers = tmm.halo_comm_buffers(stages, ef=ef)
    assert (stages, buffers) == ((2, 5) if ef else (3, 4))
    assert buffers <= blocks
    assert buffers * one <= tmm.halo_smem_bytes(rows, blocks=blocks) \
        <= tmm.SMEM_BUDGET_BYTES
    assert tmm._halo_smem(n, 64, h_lo, h_hi, 4, blocks, rows,
                          comm_ef=ef) == (stages, buffers * one)


@pytest.mark.parametrize("ef", [False, True])
def test_fused_ring_follows_a_lower_budget(ef):
    """Every stage count a budget can give, and the refusal where not
    even one stage fits beside the decoded tile; the budget comes back
    on exit."""
    one = tmm.halo_smem_bytes(66)
    per = 2 if ef else 1
    for stages in range(1, (2 if ef else 3) + 1):
        with tmm.smem_budget((stages * per + 1) * one):
            assert tmm.halo_comm_stages(66, ef=ef) == stages
    with tmm.smem_budget((per + 1) * one - 1):
        assert tmm.halo_comm_stages(66, ef=ef) == 0
        with pytest.raises(ValueError, match="shared memory"):
            tmm._halo_smem(4096, 64, 1, 1, 4, tmm.plan_blocks(True, ef), 66,
                           comm_ef=ef)
    assert tmm.halo_comm_stages(66, ef=ef) == (2 if ef else 3)


@pytest.mark.parametrize("comm", ["int8", "int8+ef"])
def test_fused_halo_wrapper_at_the_planners_tile(comm):
    """The fused circulant halo wrapper at n = 4096, d2, the planner's
    bn: its sizing accepts the tile and its plain version equals the
    full-operand plain version bit for bit, payload included."""
    n, ef = 4096, comm.endswith("+ef")
    offsets, weights = tmm.ring_offsets(n, 0.25)
    rng = np.random.default_rng(3)
    y = torch.as_tensor(rng.standard_normal((n, D2)).astype(np.float32))
    hat = torch.as_tensor(0.5 * rng.standard_normal((n, D2)).astype(
        np.float32)) if ef else None
    zp, sc = row_quant_params(y - hat if ef else y, 8)
    kw = dict(w_self=0.5, offsets=offsets, weights=weights, laplacian=True)
    got = tmm.circulant_mix_matvec_halo(y, zp, sc, 11, hat, bn=64,
                                        comm=comm, **kw)
    want = tref.circulant_mix_fused_ref(y, zp, sc, 11, hat, bits=8, **kw)
    for g, w in zip(got if ef else (got,), want if ef else (want,)):
        _same_bits(g, w)
