"""The circulant ring's Neumann step and plain full-operand mix, on the
CPU.

* The planners: `neumann_ring_plan` (the Neumann step's row tile and
  stages), `circulant_ring_stages` (the plain mix's ring at bn = n) and
  `neumann_stage_bytes`, for f32 and bf16 at n = 7, 16, 100 and 4096,
  their rule for operands as narrow as d2, and every route through
  `smem_budget`, a prime n with no tile among them; the wrappers' checks
  on a (bn, stages) they are handed.
* The ring's walk (`circulant_ring_body` in csrc/mixing_matvec.cu) in
  plain PyTorch, tile by tile: each block's rows [row0, row0 + bn) and
  each 128-column tile staged as the kernel's copies stage it (the low
  halo, the body and the high halo as three runs of contiguous rows,
  each wrapping mod n as a whole; hvp_h and p as two (bn, 128) tiles),
  then w_self·h_i, the neighbor terms in offset order and the epilogue
  (y_i − acc for the Laplacian, `neumann_update` for the step).  Held
  bitwise (NaN at the same places) against `neumann_step_ref` and
  `circulant_mix_ref`, at every bn from 2 to n, and against `repro`'s
  interpret-mode `circulant_neumann_step` / `circulant_mix_matvec`.
  XLA's CPU code contracts each neighbor term into one FMA, and the
  update's D̃·h − (h − mix) and − β·hvp_h each into one more, so against
  `repro` the walk runs those with an exact f32 FMA
  (`test_torch_plain_halo._term_fma`); no tolerance is used anywhere.
* Inputs: a ring and a k = 4 circulant with asymmetric offsets
  (+1, +2, −3, +5); NaN, ±inf and −0 in every operand; D̃ of 1 and of
  tiny values (subnormal ones too against the port's plain version; XLA's
  CPU code flushes subnormals to zero, so not against `repro`).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.kernels import mixing_matvec as jmm

from repro_torch.kernels import mixing_matvec as tmm
from repro_torch.kernels import ref as tref
from test_torch_plain_halo import _operand, _same_bits, _term_fma

BD = tmm.HALO_BD
BETA = 0.1


def _asym(n: int):
    """A k = 4 circulant with offsets +1, +2, −3, +5 and unequal
    weights (the kernels take any table)."""
    return 0.3, tuple(o % n for o in (1, 2, -3, 5)), (0.25, 0.125, 0.2,
                                                      0.125)


def _ring(n: int):
    return 0.5, (1, n - 1), (0.25, 0.25)


GRAPHS = {"ring": _ring, "asym": _asym}


def _term(acc, w, v):
    """The kernels' `term`: the product and the sum rounded on their
    own."""
    return acc + w * v


def _update(h, mix, hvp, p, dsc, beta):
    """`neumann_update` in the kernels' order, each operation rounded on
    its own."""
    return (dsc * h - (h - mix) - beta * hvp - p) / dsc


def _update_fma(h, mix, hvp, p, dsc, beta):
    """The same with XLA's contractions: D̃·h − (h − mix) and the
    − β·hvp_h term each one f32 FMA."""
    x = _term_fma(-(h - mix), dsc, h)
    x = _term_fma(x, -beta, hvp)
    return (x - p) / dsc


def _ring_walk(y, *, w_self, offsets, weights, bn, term=_term,
               laplacian=False, neumann=None, update=_update):
    """The ring's arithmetic, tile by tile; neumann: (hvp, p, dsc, beta)
    for the Neumann step's epilogue."""
    n, d = y.shape
    soff = tref.signed_offsets(offsets, n)
    h_lo, h_hi = tref.halo_extents(offsets, n)
    tref.check_halo_tile(n, bn, h_lo, h_hi)
    w = [torch.tensor(c, dtype=torch.float32) for c in weights]
    out = torch.empty_like(y)
    for row0 in range(0, n, bn):
        lo_src = row0 - h_lo if row0 >= h_lo else row0 - h_lo + n
        hi_src = row0 + bn if row0 + bn < n else row0 + bn - n
        # each staged run is contiguous: it wraps mod n as a whole
        assert lo_src + h_lo <= n and hi_src + h_hi <= n
        body = slice(row0, row0 + bn)
        for col0 in range(0, d, BD):
            cs = slice(col0, col0 + BD)
            tile = torch.cat([y[lo_src:lo_src + h_lo, cs], y[body, cs],
                              y[hi_src:hi_src + h_hi, cs]])
            yi = tile[h_lo:h_lo + bn]
            acc = w_self * yi
            for s, c in zip(soff, w):
                acc = term(acc, c, tile[h_lo + s:h_lo + s + bn])
            if neumann is not None:
                hvp, p, dsc, beta = neumann
                acc = update(yi, acc, hvp[body, cs], p[body, cs],
                             dsc[body], beta)
            elif laplacian:
                acc = yi - acc
            out[body, cs] = acc
    return out


def _tiles(n: int, offsets) -> list[int]:
    """Every row tile the kernel takes: bn | n, halo extents ≤ bn."""
    h = max(tref.halo_extents(offsets, n))
    return [bn for bn in range(1, n + 1) if n % bn == 0 and bn >= h]


def _neumann_operands(n: int, d: int, dsc_kind: str):
    h, hvp, p = (torch.as_tensor(_operand(n, d, seed=s)) for s in range(3))
    if dsc_kind == "one":
        dsc = torch.ones((n, 1))
    else:   # tiny normal values (or subnormal ones too), and one of 1
        low = 1e-45 if dsc_kind == "subnormal" else 1e-37
        dsc = torch.as_tensor(np.geomspace(1e-30, low, n).astype(
            np.float32)[:, None])
        dsc[0] = 1.0
    return h, hvp, p, dsc


# -- the walk against the plain versions ------------------------------------

@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("n", [7, 16])
@pytest.mark.parametrize("dsc_kind", ["one", "tiny", "subnormal"])
def test_neumann_walk_equals_neumann_step_ref(graph, n, dsc_kind):
    w_self, offsets, weights = GRAPHS[graph](n)
    h, hvp, p, dsc = _neumann_operands(n, 300, dsc_kind)
    want = tref.neumann_step_ref(h, hvp, p, dsc, w_self=w_self,
                                 offsets=offsets, weights=weights,
                                 beta=BETA)
    for bn in _tiles(n, offsets):
        got = _ring_walk(h, w_self=w_self, offsets=offsets,
                         weights=weights, bn=bn,
                         neumann=(hvp, p, dsc, BETA))
        _same_bits(got, want)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("n", [7, 16])
@pytest.mark.parametrize("laplacian", [False, True])
def test_mix_walk_equals_circulant_mix_ref(graph, n, laplacian):
    w_self, offsets, weights = GRAPHS[graph](n)
    y = torch.as_tensor(_operand(n, 300))
    want = tref.circulant_mix_ref(y, w_self, offsets, weights, laplacian)
    for bn in _tiles(n, offsets):
        _same_bits(_ring_walk(y, w_self=w_self, offsets=offsets,
                              weights=weights, bn=bn, laplacian=laplacian),
                   want)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_bf16_walk_equals_the_plain_version(graph):
    """bf16 operands widen exactly to f32 and the output rounds once, as
    the wrappers' plain versions do (`.float()`, then `.to(bf16)`)."""
    n = 16
    w_self, offsets, weights = GRAPHS[graph](n)
    h, hvp, p, dsc = (t.bfloat16().float() if t.shape[1] > 1 else t
                      for t in _neumann_operands(n, 300, "one"))
    want = tmm.circulant_neumann_step(
        *(t.bfloat16() for t in (h, hvp, p)), dsc, w_self=w_self,
        offsets=offsets, weights=weights, beta=BETA)
    got = _ring_walk(h, w_self=w_self, offsets=offsets, weights=weights,
                     bn=n, neumann=(hvp, p, dsc, BETA)).bfloat16()
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    want = tmm.circulant_mix_matvec(h.bfloat16(), w_self=w_self,
                                    offsets=offsets, weights=weights,
                                    laplacian=True)
    got = _ring_walk(h, w_self=w_self, offsets=offsets, weights=weights,
                     bn=n, laplacian=True).bfloat16()
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


# -- the walk against repro's interpret-mode kernels -----------------------

@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("dsc_kind", ["one", "tiny"])
def test_neumann_walk_equals_repro_interpret(graph, dsc_kind):
    n, d = 16, 256              # repro's kernels take d % 128 == 0
    w_self, offsets, weights = GRAPHS[graph](n)
    h, hvp, p, dsc = _neumann_operands(n, d, dsc_kind)
    want = jmm.circulant_neumann_step(
        *(jnp.asarray(t.numpy()) for t in (h, hvp, p, dsc)),
        w_self=w_self, offsets=offsets, weights=weights, beta=BETA,
        interpret=True)
    want = torch.as_tensor(np.array(want))
    for bn in (n, _tiles(n, offsets)[0]):
        got = _ring_walk(h, w_self=w_self, offsets=offsets,
                         weights=weights, bn=bn, term=_term_fma,
                         neumann=(hvp, p, dsc,
                                  torch.tensor(BETA, dtype=torch.float32)),
                         update=_update_fma)
        _same_bits(got, want)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("laplacian", [False, True])
def test_mix_walk_equals_repro_interpret(graph, laplacian):
    n, d = 16, 256
    w_self, offsets, weights = GRAPHS[graph](n)
    y = torch.as_tensor(_operand(n, d))
    want = torch.as_tensor(np.array(jmm.circulant_mix_matvec(
        jnp.asarray(y.numpy()), w_self=w_self, offsets=offsets,
        weights=weights, laplacian=laplacian, interpret=True)))
    for bn in (n, _tiles(n, offsets)[0]):
        _same_bits(_ring_walk(y, w_self=w_self, offsets=offsets,
                              weights=weights, bn=bn, term=_term_fma,
                              laplacian=laplacian), want)


# -- the wrappers on the CPU --------------------------------------------------

@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_wrappers_take_host_sequences_and_device_tables_alike(graph):
    n = 16
    w_self, offsets, weights = GRAPHS[graph](n)
    h, hvp, p, dsc = _neumann_operands(n, 40, "one")
    off, w = tmm.circulant_tables(n, offsets, weights, "cpu")
    for kw in (dict(offsets=offsets, weights=weights),
               dict(offsets=off, weights=w)):
        _same_bits(tmm.circulant_neumann_step(h, hvp, p, dsc, beta=BETA,
                                              w_self=w_self, **kw),
                   tref.neumann_step_ref(h, hvp, p, dsc, w_self=w_self,
                                         offsets=offsets, weights=weights,
                                         beta=BETA))
        _same_bits(tmm.circulant_mix_matvec(h, w_self=w_self, **kw),
                   tref.circulant_mix_ref(h, w_self, offsets, weights))
    with pytest.raises(TypeError, match="offsets must be a torch.Tensor"):
        tmm.circulant_mix_matvec(h, w_self=w_self, offsets=offsets,
                                 weights=w)
    with pytest.raises(ValueError, match="2 offsets but 1 weights"):
        tmm.circulant_neumann_step(h, hvp, p, dsc, beta=BETA, w_self=0.5,
                                   offsets=(1, 15), weights=(0.25,))


def test_wrappers_refuse_a_ring_the_kernels_do_not_take():
    n = 16
    w_self, offsets, weights = _asym(n)          # extents (3, 5)
    h, hvp, p, dsc = _neumann_operands(n, 40, "one")
    kw = dict(w_self=w_self, offsets=offsets, weights=weights, beta=BETA)
    step = tmm.circulant_neumann_step
    with pytest.raises(ValueError, match="exceed bn=4"):
        step(h, hvp, p, dsc, ring=(4, 2), **kw)
    with pytest.raises(ValueError, match="not a multiple of bn=6"):
        step(h, hvp, p, dsc, ring=(6, 2), **kw)
    with pytest.raises(ValueError, match="1 to 3"):
        step(h, hvp, p, dsc, ring=(8, 4), **kw)
    with pytest.raises(ValueError, match="1 to 3"):
        step(h, hvp, p, dsc, ring=(8, 0), **kw)
    with tmm.smem_budget(tmm.neumann_stage_bytes(8, 3, 5) - 1):
        with pytest.raises(ValueError, match="within"):
            step(h, hvp, p, dsc, ring=(8, 1), **kw)
    with pytest.raises(ValueError, match="comm-fused step has none"):
        zp, sc = torch.zeros((n, 1)), torch.ones((n, 1))
        step(h, hvp, p, dsc, zp, sc, 1, ring=(8, 1), comm="int8", **kw)
    mix = tmm.circulant_mix_matvec
    kw = dict(w_self=w_self, offsets=offsets, weights=weights)
    with pytest.raises(ValueError, match="bn = n = 16"):
        mix(h, ring=(8, 1), **kw)
    with pytest.raises(ValueError, match="1 to 3 stages"):
        mix(h, ring=(16, 4), **kw)
    with pytest.raises(ValueError, match="comm-fused mix"):
        mix(h, torch.zeros((n, 1)), torch.ones((n, 1)), 1, ring=(16, 1),
            comm="int8", **kw)
    # a ring the kernels take runs (the plain version on the CPU)
    _same_bits(step(h, hvp, p, dsc, ring=(8, 3), beta=BETA, **kw),
               tref.neumann_step_ref(h, hvp, p, dsc, beta=BETA, **kw))
    _same_bits(mix(h, ring=(16, 3), **kw),
               tref.circulant_mix_ref(h, w_self, offsets, weights))


# -- the planners -------------------------------------------------------------

SMEM = tmm.SMEM_BUDGET_BYTES
# (n, itemsize): the Neumann ring's (bn, stages) on the ring (extents 1)
PLANS = {(7, 4): (7, 1), (7, 2): (7, 2), (16, 4): (16, 1),
         (16, 2): (16, 2), (100, 4): (4, 1), (100, 2): (4, 2),
         (4096, 4): (16, 1), (4096, 2): (32, 2)}


@pytest.mark.parametrize("n,itemsize", sorted(PLANS))
def test_neumann_ring_plan(n, itemsize):
    bn, stages = PLANS[n, itemsize]
    assert tmm.neumann_ring_plan(n, 1, 1, itemsize=itemsize) == (bn, stages)
    one = tmm.neumann_stage_bytes(bn, 1, 1, itemsize=itemsize)
    assert one == (1 + 3 * bn + 1) * BD * itemsize
    assert stages * one <= SMEM
    # the rule for narrow operands: a launch with fewer tiles than SMs
    # keeps the unstaged kernel
    for d in (1, 2010, 16768, 16769, 157000):
        tiles = n // bn * -(-d // BD)
        want = None if tiles < tmm.CARD_SMS else (bn, stages)
        assert tmm.neumann_ring_plan(n, 1, 1, itemsize=itemsize,
                                     d=d) == want
    assert tmm.neumann_ring_plan(16, 1, 1, itemsize=itemsize,
                                 d=2010) is None
    assert tmm.neumann_ring_plan(4096, 1, 1, itemsize=itemsize,
                                 d=2010) is not None


def test_neumann_stage_bytes_of_the_sweep():
    """The stages chip_smoke's sweep printed: h's tile and two (bn, 128)
    operand tiles."""
    assert tmm.neumann_stage_bytes(8, 1, 1) == 13312
    assert tmm.neumann_stage_bytes(16, 1, 1) == 25600
    assert tmm.neumann_stage_bytes(32, 1, 1) == 50176
    assert tmm.neumann_stage_bytes(64, 1, 1) == 99328
    assert tmm.neumann_stage_bytes(32, 1, 1, itemsize=2) == 25088


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("n", [7, 16, 100, 4096])
def test_circulant_ring_stages(n, itemsize):
    one = tmm.halo_smem_bytes(n + 2, itemsize=itemsize)
    want = min(tmm.HALO_STAGES, SMEM // one)
    assert tmm.circulant_ring_stages(n, 1, 1, itemsize=itemsize) == want
    assert want == (0 if n == 4096 else 3)
    for d, ring in ((1, False), (2010, False), (16768, False),
                    (16769, True), (157000, True)):
        assert tmm.circulant_ring_stages(n, 1, 1, itemsize=itemsize,
                                         d=d) == (want if ring else 0)


@pytest.mark.parametrize("itemsize", [2, 4])
def test_every_route_through_smem_budget(itemsize):
    """A lower budget walks both planners down their routes to the
    unstaged kernels; the budget comes back on exit."""
    n = 16
    one = tmm.halo_smem_bytes(n + 2, itemsize=itemsize)
    for stages in (3, 2, 1):
        with tmm.smem_budget(stages * one):
            assert tmm.circulant_ring_stages(n, 1, 1,
                                             itemsize=itemsize) == stages
    with tmm.smem_budget(one - 1):
        assert tmm.circulant_ring_stages(n, 1, 1, itemsize=itemsize) == 0
    bn, stages = PLANS[n, itemsize]
    stage = tmm.neumann_stage_bytes(bn, 1, 1, itemsize=itemsize)
    for budget, want in ((stages * stage, (bn, stages)), (stage, (bn, 1))):
        with tmm.smem_budget(budget):
            assert tmm.neumann_ring_plan(n, 1, 1, itemsize=itemsize) == want
    # below the planner's tile the next shorter one serves, down to 2 rows
    with tmm.smem_budget(stage - 1):
        shorter = tmm.neumann_ring_plan(n, 1, 1, itemsize=itemsize)
        assert shorter is not None and shorter[0] < bn
    with tmm.smem_budget(tmm.neumann_stage_bytes(2, 1, 1,
                                                 itemsize=itemsize) - 1):
        assert tmm.neumann_ring_plan(n, 1, 1, itemsize=itemsize) is None
    with tmm.smem_budget(0):
        assert tmm.neumann_ring_plan(4096, 1, 1, itemsize=itemsize) is None
        assert tmm.circulant_ring_stages(4096, 1, 1,
                                         itemsize=itemsize) == 0
    assert tmm.SMEM_BUDGET_BYTES == SMEM


@pytest.mark.parametrize("n", [151, 4099])
def test_a_prime_n_without_a_tile_takes_the_unstaged_route(n):
    """n prime: the only tile is n itself, which overflows shared memory
    past n = 150 (f32) for the Neumann step and n = 452 for the mix."""
    assert tmm.neumann_ring_plan(n, 1, 1) is None
    assert tmm.neumann_ring_plan(7, 1, 1) == (7, 1)
    assert tmm.circulant_ring_stages(4099, 1, 1) == 0
    assert tmm.circulant_ring_stages(151, 1, 1) == 2


def test_wide_halos_take_the_shortest_tile_that_holds_them():
    """Offsets ±17 at n = 4096: no tile of at most 16 rows holds the
    halo, so the planner takes the shortest that does (32 rows)."""
    assert tmm.neumann_ring_plan(4096, 17, 17) == (32, 1)
    assert tmm.neumann_ring_plan(4096, 3, 5) == (16, 1)
    assert tmm.neumann_ring_plan(16, 3, 5) == (16, 1)
    assert tmm.neumann_ring_plan(16, 3, 5, itemsize=2) == (16, 2)


def test_mixing_op_hands_the_wrappers_host_tables(monkeypatch):
    """The plain full-operand mix and the Neumann step get the graph's
    offsets and weights as host tuples, so planning their tiles reads
    nothing back from the card."""
    from repro_torch.topology import MixingOp, make_network
    from repro_torch.topology import ops as tops
    seen = []
    for name in ("circulant_mix_matvec", "circulant_neumann_step"):
        fn = getattr(tops, name)

        def spy(*args, _fn=fn, _name=name, **kw):
            seen.append((_name, type(kw["offsets"]), type(kw["weights"])))
            return _fn(*args, **kw)
        monkeypatch.setattr(tops, name, spy)
    op = MixingOp(make_network("ring", 16).W, device="cpu")
    h, hvp, p = (torch.as_tensor(_operand(16, 30, seed=s))
                 for s in range(3))
    op.mix(h)
    op.neumann_step(h, hvp, p, torch.full((16, 1), 2.0), BETA)
    assert seen == [("circulant_mix_matvec", tuple, tuple),
                    ("circulant_neumann_step", tuple, tuple)]
