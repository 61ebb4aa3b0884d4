"""The row-tiled halo entry points and the shared-memory tile planner on
the CPU: the port's halo wrappers (their plain versions on a CPU tensor)
against `repro`'s halo Pallas kernels in interpret mode on the same
inputs, and `MixingOp`'s tiers (the end-to-end runs are in
test_torch_halo_solve.py).

Tolerances: the plain mixes differ only by the order of the f32
accumulation (rtol 1e-6 / atol 1e-6 at outputs of size ≤ ~10); the
fused payloads are bitwise equal (same wire metadata, same counter-hash
uniforms for the same seed); the fused outputs within 1e-5 absolute.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.comm import row_quant_params as j_row_quant_params
from repro.kernels import mixing_matvec as jmm

from repro_torch.comm import row_quant_params
from repro_torch.kernels import mixing_matvec as tmm
from repro_torch.topology import MixingOp, make_network
from repro_torch.topology import ops as tops
from repro_torch.topology.graphs import erdos_renyi_graph
from repro_torch.topology.structure import sparse_structure
from repro_torch.topology.weights import metropolis_weights

PLAIN_RTOL = PLAIN_ATOL = 1e-6
FUSED_ATOL = 1e-5
N, D = 64, 256
BNS = [8, 16, 32]
COMMS = ["int8", "int4", "int8+ef", "int4+ef"]
SEED = 17


def _data(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _ring_w(n: int) -> np.ndarray:
    """The ring's Metropolis W (1/3 on the diagonal and both sides),
    built directly so that large-n planner tests skip the spectral
    checks of `make_network`."""
    eye = np.eye(n)
    return (eye + np.roll(eye, 1, axis=1) + np.roll(eye, -1, axis=1)) / 3.0


def _er_w(n: int, r: float) -> np.ndarray:
    return metropolis_weights(erdos_renyi_graph(n, r, 0))


def _wire(y, hat, bits):
    src = y - hat if hat is not None else y
    zj, sj = j_row_quant_params(jnp.asarray(src), bits)
    zt, st = row_quant_params(torch.as_tensor(src), bits)
    np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    return (zj, sj), (zt, st)


@pytest.mark.parametrize("bn", BNS)
@pytest.mark.parametrize("offsets", [(1, N - 1), (1, 2, 5, N - 3, N - 1)])
def test_circulant_halo_plain_matches_repro(bn, offsets):
    y = _data((N, D), seed=1)
    weights = tuple(0.4 / len(offsets) * (1 + 0.1 * i)
                    for i in range(len(offsets)))
    kw = dict(w_self=0.55, offsets=offsets, weights=weights, bn=bn)
    for lap in (False, True):
        want = jmm.circulant_mix_matvec_halo(jnp.asarray(y), laplacian=lap,
                                             **kw)
        got = tmm.circulant_mix_matvec_halo(torch.as_tensor(y),
                                            laplacian=lap, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=PLAIN_RTOL, atol=PLAIN_ATOL)


@pytest.mark.parametrize("bn", BNS)
@pytest.mark.parametrize("comm", COMMS)
def test_circulant_halo_fused_matches_repro(bn, comm):
    bits, ef = int(comm[3]), comm.endswith("+ef")
    y = _data((N, D), seed=2)
    hat = _data((N, D), seed=3, scale=0.4) if ef else None
    (zj, sj), (zt, st) = _wire(y, hat, bits)
    kw = dict(w_self=1 / 3, offsets=(1, N - 1), weights=(1 / 3, 1 / 3),
              bn=bn, comm=comm)
    lap = bn == 16              # one interpret-mode build per case
    want = jmm.circulant_mix_matvec_halo(
        jnp.asarray(y), zj, sj, jnp.asarray([SEED], jnp.int32),
        None if hat is None else jnp.asarray(hat), laplacian=lap, **kw)
    got = tmm.circulant_mix_matvec_halo(
        torch.as_tensor(y), zt, st, SEED,
        None if hat is None else torch.as_tensor(hat), laplacian=lap, **kw)
    if ef:
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        got, want = got[0], want[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=FUSED_ATOL, rtol=0)


def _er_tables(n=N, r=0.15):
    sp = sparse_structure(_er_w(n, r))
    return sp, [torch.as_tensor(a) for a in (sp.w_self, sp.neighbors,
                                             sp.weights)]


@pytest.mark.parametrize("bn", BNS)
def test_sparse_halo_plain_matches_repro(bn):
    sp, tabs = _er_tables()
    assert sp.k > 1
    y = _data((N, D), seed=4)
    for lap in (False, True):
        want = jmm.sparse_mix_matvec_halo(
            jnp.asarray(y), *(jnp.asarray(t.numpy()) for t in tabs),
            laplacian=lap, bn=bn)
        got = tmm.sparse_mix_matvec_halo(torch.as_tensor(y), *tabs,
                                         laplacian=lap, bn=bn)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=PLAIN_RTOL, atol=PLAIN_ATOL)


@pytest.mark.parametrize("bn", BNS)
@pytest.mark.parametrize("comm", ["int8", "int4"])
def test_sparse_halo_fused_matches_repro(bn, comm):
    _, tabs = _er_tables()
    y = _data((N, D), seed=5)
    (zj, sj), (zt, st) = _wire(y, None, int(comm[3]))
    for lap in (False, True):
        want = jmm.sparse_mix_matvec_halo(
            jnp.asarray(y), *(jnp.asarray(t.numpy()) for t in tabs), zj, sj,
            jnp.asarray([SEED], jnp.int32), laplacian=lap, bn=bn, comm=comm)
        got = tmm.sparse_mix_matvec_halo(torch.as_tensor(y), *tabs, zt, st,
                                         SEED, laplacian=lap, bn=bn,
                                         comm=comm)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=FUSED_ATOL, rtol=0)


def test_sparse_halo_refuses_ef():
    _, tabs = _er_tables()
    y = torch.as_tensor(_data((N, D)))
    zp, sc = row_quant_params(y, 8)
    with pytest.raises(ValueError, match="ef"):
        tmm.sparse_mix_matvec_halo(y, *tabs, zp, sc, 1, bn=8,
                                   comm="int8+ef")
    with pytest.raises(ValueError, match="ef"):
        jmm.sparse_mix_matvec_halo(
            jnp.asarray(y.numpy()), *(jnp.asarray(t.numpy()) for t in tabs),
            jnp.asarray(zp.numpy()), jnp.asarray(sc.numpy()),
            jnp.asarray([1], jnp.int32), bn=8, comm="int8+ef")


def test_halo_wrappers_check_the_tile():
    """`repro`'s checks (bn | n, halo ≤ bn) and the card's (the staged
    tile within the shared memory a block may use)."""
    y = torch.as_tensor(_data((N, D)))
    _, tabs = _er_tables()
    kw = dict(w_self=0.5, offsets=(1, 2, N - 1), weights=(0.2, 0.1, 0.2))
    with pytest.raises(ValueError, match="not a multiple of bn"):
        tmm.circulant_mix_matvec_halo(y, bn=24, **kw)
    with pytest.raises(ValueError, match="not a multiple of bn"):
        tmm.sparse_mix_matvec_halo(y, *tabs, bn=48)
    with pytest.raises(ValueError, match=r"halo extents \(1, 9\) exceed"):
        tmm.circulant_mix_matvec_halo(y, w_self=0.5, offsets=(9, N - 1),
                                      weights=(0.25, 0.25), bn=8)
    with pytest.raises(ValueError, match="positive int"):
        tmm.circulant_mix_matvec_halo(y, bn=True, **kw)
    big = torch.zeros(4096, 8)
    with pytest.raises(ValueError, match="shared memory"):
        tmm.circulant_mix_matvec_halo(big, bn=512, **kw)
    assert tmm.circulant_mix_matvec_halo(big, bn=256, **kw).shape \
        == big.shape
    with pytest.raises(ValueError, match="1 offsets but 2"):
        tmm.circulant_mix_matvec_halo(y, w_self=0.5, offsets=(1,),
                                      weights=(0.2, 0.2), bn=8)


@pytest.mark.parametrize("n", [16, 24, 151, 152, 1000, 1024, 4096, 6144,
                               2 ** 15])
@pytest.mark.parametrize("h", [(0, 0), (1, 1), (3, 2), (40, 40),
                               (100, 1)])
@pytest.mark.parametrize("itemsize,blocks", [(4, 3), (4, 4), (4, 6),
                                             (2, 3)])
def test_pick_halo_bn_rules(n, h, itemsize, blocks):
    """bn | n, halo extents ≤ bn, the extended tile's buffers within the
    budget, and the largest such power of two from 2048 down to 8."""
    h_lo, h_hi = h
    bn = tmm.pick_halo_bn(n, h_lo=h_lo, h_hi=h_hi, itemsize=itemsize,
                          blocks=blocks)

    def ok(b):
        return n % b == 0 and b >= max(h) and (h_lo + b + h_hi) * 128 \
            * itemsize * blocks <= tmm.SMEM_BUDGET_BYTES
    fits = [b for b in tmm.HALO_BNS if ok(b)]
    assert bn == (fits[0] if fits else None)
    assert tmm.HALO_BNS == tuple(sorted(tmm.HALO_BNS, reverse=True))
    if bn is not None:
        assert tmm.halo_smem_bytes(h_lo + bn + h_hi, itemsize=itemsize,
                                   blocks=blocks) <= tmm.SMEM_BUDGET_BYTES


def test_pick_halo_bn_reads_the_budget_at_the_call(monkeypatch):
    assert tmm.pick_halo_bn(4096) == 128
    monkeypatch.setattr(tmm, "SMEM_BUDGET_BYTES", 2 * 2 ** 20)
    assert tmm.pick_halo_bn(4096) == 1024


def test_full_stripe_holds_up_to_151_agents():
    assert tmm.stripe_smem_bytes(151) <= tmm.SMEM_BUDGET_BYTES \
        < tmm.stripe_smem_bytes(152)
    assert [tmm.plan_blocks(False), tmm.plan_blocks(True),
            tmm.plan_blocks(True, True)] == [3, 4, 6]


@pytest.fixture(scope="module")
def big_ops():
    """n = 4096 ring and Erdős–Rényi (r = 0.004) executors, int8+ef."""
    return {kind: MixingOp(w, comm="int8+ef", device="cpu")
            for kind, w in (("ring", _ring_w(4096)),
                            ("erdos_renyi", _er_w(4096, 0.004)))}


def test_stripe_plan_full_at_16_halo_at_4096(big_ops):
    y16 = torch.zeros(16, 8)
    for kind in ("ring", "erdos_renyi"):
        small = MixingOp(make_network(kind, 16, r=0.5, seed=0).W,
                         comm="int8+ef", device="cpu")
        for blocks in (3, 4, 6):
            assert small._stripe_plan(
                y16, blocks=blocks, circulant=kind == "ring") \
                == ("full", None)
        assert small._fused_plan(y16) == (small.backend, None)
    y = torch.zeros(4096, 8)
    ring, er = big_ops["ring"], big_ops["erdos_renyi"]
    assert ring.backend == "circulant" and er.backend == "sparse_gather"
    assert er._sp_use_padded and er.sparse.k == 36
    for op, circ in ((ring, True), (er, False)):
        assert [op._stripe_plan(y, blocks=b, circulant=circ)
                for b in (3, 4, 6)] \
            == [("halo", 128), ("halo", 64), ("halo", 64)]
    assert ring._fused_plan(y) == ("circulant", 64)
    # sparse + EF on the halo tier: no payload write-back, so compose
    assert er._fused_plan(y) is None
    assert MixingOp(er.W, comm="int8", device="cpu")._fused_plan(y) \
        == ("sparse_gather", 64)
    # bf16 operands: half the bytes per tile row
    assert ring._stripe_plan(y.bfloat16(), blocks=3, circulant=True) \
        == ("halo", 256)


def test_stripe_plan_xla_when_no_tile_holds_the_halo():
    """Offsets ±100 need bn ≥ 100 and then 328 staged rows: no row tile
    fits, and the full-operand kernels run (`repro` runs XLA)."""
    op = MixingOp(make_network("circulant", 1024, offsets=(1, 100)).W,
                  comm="int8", device="cpu")
    y = torch.as_tensor(_data((1024, 40), seed=9))
    assert op._stripe_plan(y, blocks=3, circulant=True) == ("xla", None)
    assert op._fused_plan(y) == ("circulant", None)
    want = op.W @ y
    torch.testing.assert_close(op.mix(y), want, rtol=1e-5, atol=1e-5)


def _spy(monkeypatch, name):
    calls = []
    fn = getattr(tops, name)

    def spy(*args, **kw):
        calls.append(kw.get("bn"))
        return fn(*args, **kw)
    monkeypatch.setattr(tops, name, spy)
    return calls


@pytest.mark.parametrize("kind", ["ring", "erdos_renyi"])
def test_mixing_op_dispatches_the_halo_wrappers(big_ops, kind,
                                                monkeypatch):
    """At n = 4096 every gossip goes through a halo wrapper with the
    planner's bn, and agrees with the dense W·Y; the Neumann step keeps
    the full-operand wrapper on the identity wire (as `repro`) and
    composes a fused halo mix on the quantized one."""
    n = 4096
    base = "circulant" if kind == "ring" else "sparse"
    halo = _spy(monkeypatch, f"{base}_mix_matvec_halo")
    full = _spy(monkeypatch, f"{base}_mix_matvec")
    neumann = _spy(monkeypatch, "circulant_neumann_step")
    W = big_ops[kind].W
    y, h, hvp, p = (torch.as_tensor(_data((n, 20), seed=s))
                    for s in range(4))
    dsc = torch.full((n, 1), 2.0)
    plain = MixingOp(W, device="cpu")
    torch.testing.assert_close(plain.mix(y), W @ y, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(plain.laplacian(y), y - W @ y, rtol=1e-5,
                               atol=1e-5)
    plain.neumann_step(h, hvp, p, dsc, 0.1)
    assert halo == [128, 128] + ([] if kind == "ring" else [128])
    assert neumann == ([None] if kind == "ring" else [])
    op = MixingOp(W, comm="int8", device="cpu")
    st = op.comm_channel("c", y, seed=3)
    out, st = op.mix_c(y, st)
    op.neumann_step_c(h, hvp, p, dsc, 0.1, st)
    assert halo[-2:] == [64, 64] and full == []
    assert len(neumann) == (1 if kind == "ring" else 0)
    # the fused halo mix quantizes the neighbors only: each moves by at
    # most its row's scale, and their weights sum to less than 1
    assert (out - W @ y).abs().max() <= row_quant_params(y, 8)[1].max()


@pytest.mark.parametrize("bits", [4, 8])
def test_tiny_rows_take_the_constant_rows_scale(bits):
    """A row of tiny values (the n = 4096 ring's DIHGP iterates had
    some): its span/levels below the smallest normal f32 gives scale 1,
    as for a constant row.  Row 0 has a subnormal span, which `repro`'s
    XLA code flushes to 0, so its scale is 1 there too (torch keeps
    subnormals, and the bf16 scale rounded to 0 before).  Row 1 has a
    normal span whose quotient is subnormal: `repro` flushes it to a
    zero scale and decodes 0/0 = NaN at the row's small entries; the
    port decodes every entry to zp.  Other rows stay bitwise `repro`'s."""
    from repro.comm.compressors import make_compressor as j_make
    import jax

    from repro_torch.comm.compressors import make_compressor
    from repro_torch.kernels import ref as tref
    x = _data((4, 64), seed=8)
    x[0] = np.linspace(0, 3e-40, 64)
    x[1] = np.linspace(0, 2e-38, 64)
    zj, sj = j_row_quant_params(jnp.asarray(x), bits)
    zt, st = row_quant_params(torch.as_tensor(x), bits)
    np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))
    np.testing.assert_array_equal(st.numpy()[[0, 2, 3]],
                                  np.asarray(sj)[[0, 2, 3]])
    assert float(sj[1, 0]) == 0.0 and float(st[1, 0]) == 1 + 2 ** -7
    j_pay = np.asarray(j_make(f"int{bits}").roundtrip(
        jnp.asarray(x), jax.random.PRNGKey(0)))
    assert np.isnan(j_pay[1]).any() and not np.isnan(j_pay[[0, 2, 3]]).any()
    t_pay = make_compressor(f"int{bits}").roundtrip(torch.as_tensor(x), 5)
    assert torch.isfinite(t_pay).all()
    assert torch.equal(t_pay[:2], torch.zeros(2, 64))
    fused = tref._payload(torch.as_tensor(x), zt, st, 5, None, bits)
    assert torch.equal(fused[:2], torch.zeros(2, 64))
