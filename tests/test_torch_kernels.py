"""The port's kernel wrappers on the CPU (their plain PyTorch versions)
against `repro`'s Pallas kernels run in interpret mode, on the same
numpy inputs.

Tolerance: both sides compute in f32 with other operation orders
(fused multiply-adds, XLA fusion), so outputs of size ≤ ~10 agree to
1e-6 absolute; bf16 outputs may differ by one bf16 ulp (2⁻⁷ relative).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.kernels import mixing_matvec as jmm
from repro.topology import make_network as j_make_network

from repro_torch.kernels import _build
from repro_torch.kernels import mixing_matvec as tmm
from repro_torch.kernels import ref as tref
from repro_torch.topology.structure import (circulant_structure,
                                            sparse_structure)

F32_ATOL = 1e-6


def _data(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _assert_close(got: torch.Tensor, want, dtype):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    else:
        tol = 2.0 ** -7 * np.abs(want).max()
        assert np.abs(got - want).max() <= tol


def _pair(y: np.ndarray, dtype: str):
    """The same values as a jax and a torch array of `dtype`."""
    j = jnp.asarray(y).astype(jnp.bfloat16 if dtype == "bfloat16"
                              else jnp.float32)
    t = torch.as_tensor(y).to(torch.bfloat16 if dtype == "bfloat16"
                              else torch.float32)
    return j, t


def _tables(s):
    """The port's circulant offset/weight tables of structure `s`."""
    off, w = tmm.circulant_tables(s.n, s.offsets, s.weights, "cpu")
    return dict(w_self=s.w_self, offsets=off, weights=w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("laplacian", [False, True])
@pytest.mark.parametrize("kind,n,offsets", [
    ("ring", 16, (1,)), ("circulant", 16, (1, 2)),
    ("circulant", 64, tuple(range(1, 10)))])     # k = 18 neighbors
def test_circulant_mix_matches_pallas(dtype, laplacian, kind, n, offsets):
    d = 256
    s = circulant_structure(j_make_network(kind, n, offsets=offsets).W)
    assert len(s.offsets) == 2 * len(offsets) or kind == "ring"
    jy, ty = _pair(_data((n, d)), dtype)
    want = jmm.circulant_mix_matvec(jy, w_self=s.w_self, offsets=s.offsets,
                                    weights=s.weights, laplacian=laplacian,
                                    interpret=True)
    got = tmm.circulant_mix_matvec(ty, laplacian=laplacian, **_tables(s))
    assert got.dtype == ty.dtype
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("laplacian", [False, True])
@pytest.mark.parametrize("kind", ["erdos_renyi", "star"])
def test_sparse_mix_matches_pallas(dtype, laplacian, kind):
    n, d = 16, 256
    sp = sparse_structure(j_make_network(kind, n, r=0.5, seed=0).W)
    jy, ty = _pair(_data((n, d), seed=1), dtype)
    want = jmm.sparse_mix_matvec(jy, jnp.asarray(sp.w_self),
                                 jnp.asarray(sp.neighbors),
                                 jnp.asarray(sp.weights),
                                 laplacian=laplacian, interpret=True)
    got = tmm.sparse_mix_matvec(ty, torch.as_tensor(sp.w_self),
                                torch.as_tensor(sp.neighbors),
                                torch.as_tensor(sp.weights),
                                laplacian=laplacian)
    _assert_close(got, want, dtype)


def test_sparse_csr_ref_matches_padded():
    """The star graph's CSR path and the padded tables compute one W·Y."""
    sp = sparse_structure(j_make_network("star", 12).W)
    y = torch.as_tensor(_data((12, 33), seed=2))
    args = [torch.as_tensor(a) for a in (sp.w_self,)]
    for lap in (False, True):
        csr = tref.sparse_mix_ref(y, *args, torch.as_tensor(sp.row).long(),
                                  torch.as_tensor(sp.col).long(),
                                  torch.as_tensor(sp.val), laplacian=lap)
        padded = tref.sparse_mix_padded_ref(
            y, *args, torch.as_tensor(sp.neighbors),
            torch.as_tensor(sp.weights), laplacian=lap)
        np.testing.assert_allclose(csr.numpy(), padded.numpy(),
                                   atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("beta", [0.1, 0.7])
def test_neumann_step_matches_pallas(beta):
    n, d = 8, 256
    s = circulant_structure(j_make_network("ring", n).W)
    h, hvp, p = (_data((n, d), seed=i) for i in range(3))
    dsc = np.random.default_rng(3).uniform(1.5, 3.0, (n, 1)).astype(
        np.float32)
    kw = dict(w_self=s.w_self, offsets=s.offsets, weights=s.weights,
              beta=beta)
    want = jmm.circulant_neumann_step(*(jnp.asarray(a) for a in
                                        (h, hvp, p, dsc)), interpret=True,
                                      **kw)
    got = tmm.circulant_neumann_step(*(torch.as_tensor(a) for a in
                                       (h, hvp, p, dsc)), beta=beta,
                                     **_tables(s))
    _assert_close(got, want, "float32")


def test_cpu_wrappers_run_the_plain_versions_without_launching():
    tmm.reset_launch_counts()
    s = circulant_structure(j_make_network("ring", 5).W)
    y = torch.as_tensor(_data((5, 7)))
    out = tmm.circulant_mix_matvec(y, **_tables(s))
    want = tref.circulant_mix_ref(y, s.w_self, s.offsets, s.weights)
    assert torch.equal(out, want)
    counts = tmm.launch_counts()
    assert set(counts.values()) == {0}
    assert {"circulant_mix_matvec", "circulant_mix_matvec_unstaged",
            "sparse_mix_matvec", "sparse_mix_matvec_unstaged",
            "circulant_neumann_step", "circulant_neumann_step_unstaged",
            "circulant_mix_matvec_comm",
            "circulant_mix_matvec_comm_unstaged", "sparse_mix_matvec_comm",
            "sparse_mix_matvec_comm_unstaged", "circulant_neumann_step_comm",
            "circulant_neumann_step_comm_unstaged", "ring_laplacian_matvec", "circulant_mix_matvec_halo",
            "circulant_mix_matvec_halo_comm", "sparse_mix_matvec_halo",
            "sparse_mix_matvec_halo_rows", "sparse_mix_matvec_halo_comm",
            "sparse_mix_matvec_halo_comm_rows",
            # a serve bucket's job-axis launches (rows 5, 1f, 3f, 5f)
            "circulant_neumann_step_jobs",
            "circulant_neumann_step_unstaged_jobs",
            "circulant_mix_matvec_comm_jobs",
            "circulant_mix_matvec_comm_unstaged_jobs",
            "sparse_mix_matvec_comm_jobs",
            "sparse_mix_matvec_comm_unstaged_jobs",
            "circulant_neumann_step_comm_jobs",
            "circulant_neumann_step_comm_unstaged_jobs",
            "circulant_mix_matvec_halo_comm_jobs",
            "sparse_mix_matvec_halo_comm_jobs",
            "sparse_mix_matvec_halo_comm_rows_jobs"} == set(counts)


def test_wrappers_refuse_bad_operands():
    s = circulant_structure(j_make_network("ring", 8).W)
    kw = _tables(s)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tmm.circulant_mix_matvec(torch.zeros(8, 4, dtype=torch.float64),
                                 **kw)
    with pytest.raises(ValueError, match="contiguous"):
        tmm.circulant_mix_matvec(torch.zeros(4, 8).t(), **kw)
    with pytest.raises(ValueError, match="requires grad"):
        tmm.circulant_mix_matvec(torch.zeros(8, 4, requires_grad=True),
                                 **kw)
    with pytest.raises(ValueError, match=r"\(n, d\)"):
        tmm.circulant_mix_matvec(torch.zeros(8), **kw)
    with pytest.raises(ValueError, match="offsets must be torch.int32"):
        tmm.circulant_mix_matvec(torch.zeros(8, 4), w_self=s.w_self,
                                 offsets=kw["offsets"].long(),
                                 weights=kw["weights"])
    with pytest.raises(ValueError, match=r"weights must be .* shape \(2,\)"):
        tmm.circulant_mix_matvec(torch.zeros(8, 4), w_self=s.w_self,
                                 offsets=kw["offsets"],
                                 weights=kw["weights"][:1])
    with pytest.raises(TypeError, match="offsets must be a torch.Tensor"):
        tmm.circulant_mix_matvec(torch.zeros(8, 4), w_self=s.w_self,
                                 offsets=s.offsets, weights=kw["weights"])
    sp = sparse_structure(j_make_network("ring", 8).W)
    with pytest.raises(ValueError, match="int32"):
        tmm.sparse_mix_matvec(torch.zeros(8, 4), torch.as_tensor(sp.w_self),
                              torch.as_tensor(sp.neighbors).long(),
                              torch.as_tensor(sp.weights))
    with pytest.raises(ValueError, match=r"\(8, 1\)"):
        tmm.circulant_neumann_step(*(torch.zeros(8, 4) for _ in range(3)),
                                   torch.ones(8), beta=0.1, **kw)


def test_build_key_is_deterministic_and_covers_the_sources():
    """The library name hashes every csrc file and the nvcc flags; no
    build happens until a CUDA tensor reaches a wrapper."""
    assert _build.source_hash() == _build.source_hash()
    lib = _build.library_path("mixing_matvec")
    assert lib.parent == _build.BUILD_DIR
    assert lib.name == f"mixing_matvec-{_build.source_hash()}.so"
    assert (_build.CSRC / "mixing_matvec.cu").is_file()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
