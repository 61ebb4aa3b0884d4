"""The comm-fused DIHGP Neumann step on the decoded column stripe, on the
CPU.

* `plan_neumann_comm_stripe_cols`: the comm-fused gossips' decoded stripe
  (`plan_comm_stripe_cols`) wherever the operand has at least one
  128-column tile per SM; the unstaged kernel at the n = 16 path's
  (16, 2,010) operands and past n = 14,528; `smem_budget` reaches every
  width and the unstaged route; a forced width (`_neumann_comm_launch`'s
  `cols=`) is held to the same checks.
* The kernel's walk (`circulant_neumann_stripe_comm_kernel`), emulated in
  plain PyTorch: each stripe of h decoded once, one uniform per element,
  then every row w_self·h_i with the exact h_i, its neighbors' decoded
  values in offset order, and `neumann_update(h_i, mix, hvp, p, D̃_i, β)`.
  With the port's `term` (product and sum rounded apart) it is held
  bitwise against `neumann_step_fused_ref`; with an exact f32 FMA per
  neighbor term and XLA's two contractions in the update
  (`test_torch_neumann_ring._update_fma`) against `repro`'s interpret-mode
  `circulant_neumann_step(comm="int8" | "int4")`.  Rows hold NaN, ±inf
  and −0; graphs are the ring and a circulant of k = 18 offsets; D̃ is
  1, tiny, or subnormal.
"""
from __future__ import annotations

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.kernels import mixing_matvec as jmm
from test_torch_comm_stripe import _slots
from test_torch_neumann_ring import _update, _update_fma
from test_torch_plain_halo import (_operand, _same_bits, _term_fma,
                                   _term_separate)

from repro_torch.comm import row_quant_params
from repro_torch.kernels import mixing_matvec as tmm
from repro_torch.kernels import ref as tref

COMMS = ["int8", "int4"]
GRAPHS = ["ring", "circulant18"]
BETA = 0.1
D1, D2 = 157_000, 2_010


# -- the planner --------------------------------------------------------------

@pytest.mark.parametrize("n,d,cols", [
    (16, D2, None),       # the n = 16 ring int4 solve's 15 launches
    (16, 2 * D2, None),
    (16, 128 * 131, None),
    (16, 128 * 132, 128),  # 132 tiles: one per SM
    (16, D1, 128),
    (128, D1, 128),
    (454, D1, 128),       # the widest stripe at its largest n
    (455, D1, 64),
    (4121, D1, 8),
    (14528, D1, 4),
    (14529, D1, None),    # past every stripe: the unstaged kernel
])
def test_neumann_stripe_planner(n, d, cols):
    assert tmm.plan_neumann_comm_stripe_cols(n, d) == cols
    if cols is not None:
        assert cols == tmm.plan_comm_stripe_cols(n, d)
        assert tmm.stripe_bytes(n, cols) <= tmm.SMEM_BUDGET_BYTES


def test_neumann_stripe_planner_follows_the_card():
    """The tile rule reads the card's SMs; without d the stripe is the
    comm-fused gossips'."""
    assert tmm.plan_neumann_comm_stripe_cols(16, D2, sms=16) == 128
    assert tmm.plan_neumann_comm_stripe_cols(16, D2, sms=17) is None
    assert tmm.plan_neumann_comm_stripe_cols(16) == 128
    assert tmm.plan_neumann_comm_stripe_cols(16000) is None


def test_smem_budget_reaches_every_neumann_stripe_route():
    """At n = 16 and d1 a budget of exactly each width's stripe gives that
    width, one byte under the narrowest the unstaged kernel; the CPU
    wrapper's output does not depend on the route and launches
    nothing; `_neumann_comm_launch`'s `cols=` takes a width that fits,
    or 0, and refuses the rest."""
    n, saved = 16, tmm.SMEM_BUDGET_BYTES
    h, hvp, p = (torch.as_tensor(_operand(n, d=40, seed=s))
                 for s in range(3))
    dsc = torch.full((n, 1), 2.0)
    zp, sc = row_quant_params(h, 8)
    offsets, weights = tmm.ring_offsets(n, 0.25)
    kw = dict(w_self=0.5, offsets=offsets, weights=weights, beta=BETA)
    want = tref.neumann_step_fused_ref(h, hvp, p, dsc, zp, sc, 5, bits=8,
                                       **kw)
    widths = tmm.stripe_cols_for(4)
    budgets = [tmm.stripe_bytes(n, c) for c in widths]
    tmm.reset_launch_counts()
    for cols, budget in zip([*widths, None], [*budgets, budgets[-1] - 1]):
        with tmm.smem_budget(budget):
            assert tmm.plan_neumann_comm_stripe_cols(n, D1) == cols
            got = tmm.circulant_neumann_step(h, hvp, p, dsc, zp, sc, 5,
                                             comm="int8", **kw)
        _same_bits(got, want)
    for cols in (0, *widths):
        _same_bits(tmm._neumann_comm_launch(h, hvp, p, dsc, zp, sc, 5,
                                            comm="int8", cols=cols, **kw),
                   want)
    assert tmm.SMEM_BUDGET_BYTES == saved
    assert sum(tmm.launch_counts().values()) == 0
    for bad in (3, 96, 256):
        with pytest.raises(ValueError, match="cols="):
            tmm._neumann_comm_launch(h, hvp, p, dsc, zp, sc, 5,
                                     comm="int8", cols=bad, **kw)
    with tmm.smem_budget(budgets[0] - 1), \
            pytest.raises(ValueError, match="cols=128"):
        tmm._neumann_comm_launch(h, hvp, p, dsc, zp, sc, 5, comm="int8",
                                 cols=128, **kw)
    # the public entry takes the planner's route alone
    assert "cols" not in inspect.signature(
        tmm.circulant_neumann_step).parameters


# -- the walk, emulated -------------------------------------------------------

def _neumann_stripe_emulation(h, hvp, p, dsc, zp, sc, seed, *, bits,
                              w_self, slots, beta, term, update, cols):
    """The decoded-stripe Neumann kernel in plain PyTorch: stripe by
    stripe of `cols` columns, every staged element of h decoded once with
    its row's metadata and the uniform of its (row, column); each row
    w_self·h_i with the exact h_i, then each neighbor's decoded value in
    offset order through `term`, then `update`."""
    n, d = h.shape
    levels = float(2 ** bits - 1)
    out = torch.empty_like(h)
    for c0 in range(0, d, cols):
        j = torch.arange(c0, min(d, c0 + cols))
        hs = h[:, j]
        u = tref.hash_uniform(seed, torch.arange(n)[:, None], j[None, :])
        dec = zp + sc * torch.clamp(torch.floor((hs - zp) / sc + u), 0.0,
                                    levels)
        acc = w_self * hs
        for src, w in slots:
            acc = term(acc, w, dec[src])
        out[:, j] = update(hs, acc, hvp[:, j], p[:, j], dsc, beta)
    return out


def _operands(n, d, dsc_kind, seed=0):
    h, hvp, p = (torch.as_tensor(_operand(n, d, seed=seed + s))
                 for s in range(3))
    if dsc_kind == "one":
        dsc = torch.ones((n, 1))
    else:   # tiny normal values (or subnormal ones too), and one of 1
        low = 1e-45 if dsc_kind == "subnormal" else 1e-37
        dsc = torch.as_tensor(np.geomspace(1e-30, low, n).astype(
            np.float32)[:, None])
        dsc[0] = 1.0
    return h, hvp, p, dsc


@pytest.mark.parametrize("n", [7, 16, 100])
@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("comm", COMMS)
@pytest.mark.parametrize("dsc_kind", ["one", "tiny", "subnormal"])
def test_stripe_walk_matches_neumann_step_fused_ref(n, graph, comm,
                                                    dsc_kind):
    """d = 300: two 128-column stripes and a ragged third; the walk with
    separate roundings is bitwise the port's plain version."""
    bits = int(comm[3])
    h, hvp, p, dsc = _operands(n, 300, dsc_kind)
    zp, sc = row_quant_params(h, bits)
    w_self, slots, tables = _slots(graph, n)
    _, ws, offsets, weights = tables
    got = _neumann_stripe_emulation(
        h, hvp, p, dsc, zp, sc, 13, bits=bits, w_self=w_self, slots=slots,
        beta=torch.tensor(BETA, dtype=torch.float32), term=_term_separate,
        update=_update, cols=tmm.plan_comm_stripe_cols(n))
    want = tref.neumann_step_fused_ref(h, hvp, p, dsc, zp, sc, 13,
                                       w_self=ws, offsets=offsets,
                                       weights=weights, beta=BETA,
                                       bits=bits)
    _same_bits(got, want)
    assert torch.isnan(got).any()       # the NaN row reached the output
    # and the wrapper's CPU route is that plain version
    off, w = tmm.circulant_tables(n, offsets, weights, "cpu")
    _same_bits(tmm.circulant_neumann_step(h, hvp, p, dsc, zp, sc, 13,
                                          w_self=ws, offsets=off,
                                          weights=w, beta=BETA, comm=comm),
               want)


@pytest.mark.parametrize("cols", [128, 8, 4])
def test_stripe_walk_does_not_depend_on_the_width(cols):
    """Each element is decoded once whatever the stripe: every width
    gives the same bits (d = 300 at 8 and 4 columns is 38 and 75
    stripes)."""
    h, hvp, p, dsc = _operands(16, 300, "one", seed=4)
    zp, sc = row_quant_params(h, 4)
    w_self, slots, tables = _slots("circulant18", 16)
    _, ws, offsets, weights = tables
    got = _neumann_stripe_emulation(
        h, hvp, p, dsc, zp, sc, 3, bits=4, w_self=w_self, slots=slots,
        beta=torch.tensor(BETA, dtype=torch.float32), term=_term_separate,
        update=_update, cols=cols)
    _same_bits(got, tref.neumann_step_fused_ref(
        h, hvp, p, dsc, zp, sc, 3, w_self=ws, offsets=offsets,
        weights=weights, beta=BETA, bits=4))


@pytest.mark.parametrize("n", [7, 16, 100])
@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("comm", COMMS)
@pytest.mark.parametrize("dsc_kind", ["one", "tiny"])
def test_stripe_walk_with_fma_matches_repro(n, graph, comm, dsc_kind):
    """The same walk with one f32 FMA per neighbor term and the update's
    two contractions against `repro`'s fused Pallas kernel in interpret
    mode (d = 256, its bd | d): bitwise."""
    bits = int(comm[3])
    h, hvp, p, dsc = _operands(n, 256, dsc_kind, seed=2)
    zp, sc = row_quant_params(h, bits)
    w_self, slots, tables = _slots(graph, n)
    _, ws, offsets, weights = tables
    got = _neumann_stripe_emulation(
        h, hvp, p, dsc, zp, sc, 21, bits=bits, w_self=w_self, slots=slots,
        beta=torch.tensor(BETA, dtype=torch.float32), term=_term_fma,
        update=_update_fma, cols=tmm.plan_comm_stripe_cols(n))
    want = jmm.circulant_neumann_step(
        *(jnp.asarray(t.numpy()) for t in (h, hvp, p, dsc, zp, sc)),
        jnp.asarray([21], jnp.int32), w_self=ws, offsets=offsets,
        weights=weights, beta=BETA, comm=comm, interpret=True)
    _same_bits(got, np.array(want))
