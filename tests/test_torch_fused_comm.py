"""The comm-fused kernels' plain versions on the CPU against `repro`'s
Pallas kernels in interpret mode, on the same inputs (the end-to-end
runs are in test_torch_comm_solve.py).

Both sides quantize with the same wire metadata (`row_quant_params`,
bitwise) and the same counter-hash uniforms, given the same seed, so
payloads are bitwise equal: XLA's CPU code does not contract
zp + scale·q here (checked by the EF cases, which return the payload).
The mixed outputs differ only by the order of the f32 accumulation:
≤ 1e-6 absolute at these sizes (outputs of size ≤ ~10).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.comm import row_quant_params as j_row_quant_params
from repro.kernels import mixing_matvec as jmm
from repro.kernels import ref as jref
from repro.topology import make_network as j_make_network

from repro_torch.comm import row_quant_params
from repro_torch.kernels import mixing_matvec as tmm
from repro_torch.kernels import ref as tref
from repro_torch.topology.structure import (circulant_structure,
                                            sparse_structure)

OUT_ATOL = 1e-6
COMMS = ["int8", "int4", "int8+ef", "int4+ef"]


def _data(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _wire(y, hat, comm):
    """(bits, ef, zp/scale as jax and torch arrays) for one gossip."""
    bits, ef = int(comm[3]), comm.endswith("+ef")
    src = y - hat if ef else y
    zj, sj = j_row_quant_params(jnp.asarray(src), bits)
    zt, st = row_quant_params(torch.as_tensor(src), bits)
    np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))
    return bits, ef, (zj, sj), (zt, st)


def _compare(got, want, ef):
    if ef:
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        got, want = got[0], want[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=OUT_ATOL, rtol=0)


@pytest.mark.parametrize("laplacian", [False, True])
@pytest.mark.parametrize("kind,n,offsets,comm", [
    *(("ring", 16, (1,), c) for c in COMMS),
    ("circulant", 16, (1, 2), "int8"), ("circulant", 16, (1, 2), "int4+ef"),
    # k = 18 neighbors
    ("circulant", 64, tuple(range(1, 10)), "int8+ef"),
    ("circulant", 64, tuple(range(1, 10)), "int4")])
def test_circulant_fused_matches_pallas(laplacian, kind, n, offsets, comm):
    d = 256
    s = circulant_structure(j_make_network(kind, n, offsets=offsets).W)
    y, hat = _data((n, d), seed=1), _data((n, d), seed=2, scale=0.5)
    bits, ef, (zj, sj), (zt, st) = _wire(y, hat, comm)
    want = jmm.circulant_mix_matvec(
        jnp.asarray(y), zj, sj, jnp.asarray([77], jnp.int32),
        jnp.asarray(hat) if ef else None, w_self=s.w_self,
        offsets=s.offsets, weights=s.weights, laplacian=laplacian,
        comm=comm, interpret=True)
    off, w = tmm.circulant_tables(n, s.offsets, s.weights, "cpu")
    got = tmm.circulant_mix_matvec(
        torch.as_tensor(y), zt, st, 77, torch.as_tensor(hat) if ef else None,
        w_self=s.w_self, offsets=off, weights=w, laplacian=laplacian,
        comm=comm)
    _compare(got, want, ef)


@pytest.mark.parametrize("laplacian", [False, True])
@pytest.mark.parametrize("kind,comm", [
    *(("erdos_renyi", c) for c in COMMS),
    ("star", "int8"), ("star", "int4+ef")])
def test_sparse_fused_matches_pallas(laplacian, kind, comm):
    n, d = 16, 256
    sp = sparse_structure(j_make_network(kind, n, r=0.5, seed=0).W)
    y, hat = _data((n, d), seed=3), _data((n, d), seed=4, scale=0.5)
    bits, ef, (zj, sj), (zt, st) = _wire(y, hat, comm)
    want = jmm.sparse_mix_matvec(
        jnp.asarray(y), *(jnp.asarray(a) for a in
                          (sp.w_self, sp.neighbors, sp.weights)),
        zj, sj, jnp.asarray([5], jnp.int32),
        jnp.asarray(hat) if ef else None, laplacian=laplacian, comm=comm,
        interpret=True)
    got = tmm.sparse_mix_matvec(
        torch.as_tensor(y), *(torch.as_tensor(a) for a in
                              (sp.w_self, sp.neighbors, sp.weights)),
        zt, st, 5, torch.as_tensor(hat) if ef else None,
        laplacian=laplacian, comm=comm)
    _compare(got, want, ef)


@pytest.mark.parametrize("comm", ["int8", "int4"])
@pytest.mark.parametrize("beta", [0.1, 0.7])
def test_neumann_fused_matches_pallas(comm, beta):
    n, d = 8, 256
    s = circulant_structure(j_make_network("ring", n).W)
    h, hvp, p = (_data((n, d), seed=i) for i in range(3))
    dsc = np.random.default_rng(3).uniform(1.5, 3.0, (n, 1)).astype(
        np.float32)
    bits, _, (zj, sj), (zt, st) = _wire(h, None, comm)
    want = jmm.circulant_neumann_step(
        *(jnp.asarray(a) for a in (h, hvp, p, dsc)), zj, sj,
        jnp.asarray([11], jnp.int32), w_self=s.w_self, offsets=s.offsets,
        weights=s.weights, beta=beta, comm=comm, interpret=True)
    off, w = tmm.circulant_tables(n, s.offsets, s.weights, "cpu")
    got = tmm.circulant_neumann_step(
        *(torch.as_tensor(a) for a in (h, hvp, p, dsc)), zt, st, 11,
        w_self=s.w_self, offsets=off, weights=w, beta=beta, comm=comm)
    _compare(got, want, False)


@pytest.mark.parametrize("n", [2, 3, 8])
def test_ring_laplacian_matches_pallas(n):
    """`ring_laplacian_matvec` over the circulant kernel (one offset at
    n = 2) and `ring_laplacian_ref`, against `repro`'s."""
    d = 256
    y = _data((n, d), seed=n)
    W = j_make_network("ring", n).W if n > 2 else np.array(
        [[0.5, 0.5], [0.5, 0.5]])
    w_self, w_edge = float(W[0, 0]), float(W[0, 1])
    want = jmm.ring_laplacian_matvec(jnp.asarray(y), w_self=w_self,
                                     w_edge=w_edge, interpret=True)
    tmm.reset_launch_counts()
    got = tmm.ring_laplacian_matvec(torch.as_tensor(y), w_self=w_self,
                                    w_edge=w_edge)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=OUT_ATOL, rtol=0)
    ref = tref.ring_laplacian_ref(torch.as_tensor(y), w_self, w_edge)
    np.testing.assert_allclose(
        ref.numpy(), np.asarray(jref.ring_laplacian_ref(jnp.asarray(y),
                                                        w_self, w_edge)),
        atol=OUT_ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=OUT_ATOL,
                               rtol=0)
    assert set(tmm.launch_counts().values()) == {0}


def test_wrappers_refuse_what_the_fused_kernels_do_not_take():
    s = circulant_structure(j_make_network("ring", 8).W)
    off, w = tmm.circulant_tables(8, s.offsets, s.weights, "cpu")
    kw = dict(w_self=s.w_self, offsets=off, weights=w)
    y = torch.zeros(8, 4)
    zp, sc = row_quant_params(y, 8)
    with pytest.raises(ValueError, match="not kernel-fusable"):
        tmm.circulant_mix_matvec(y, zp, sc, 1, comm="top_k:0.1", **kw)
    with pytest.raises(ValueError, match="float32 operand"):
        tmm.circulant_mix_matvec(y.bfloat16(), zp, sc, 1, comm="int8", **kw)
    with pytest.raises(ValueError, match=r"hat has shape|must be a torch"):
        tmm.circulant_mix_matvec(y, zp, sc, 1, torch.zeros(8, 5),
                                 comm="int8+ef", **kw)
    with pytest.raises(ValueError, match="error-feedback replica"):
        tmm.circulant_mix_matvec(y, zp, sc, 1, y, comm="int8", **kw)
    with pytest.raises(ValueError, match=r"zp must be .* \(8, 1\)"):
        tmm.circulant_mix_matvec(y, zp[:4], sc, 1, comm="int8", **kw)
    with pytest.raises(TypeError, match="seed must be a Python int"):
        tmm.circulant_mix_matvec(y, zp, sc, torch.tensor([1]), comm="int8",
                                 **kw)
    with pytest.raises(ValueError, match="does not lower '\\+ef'"):
        tmm.circulant_neumann_step(y, y, y, torch.ones(8, 1), zp, sc, 1,
                                   beta=0.1, comm="int8+ef", **kw)
