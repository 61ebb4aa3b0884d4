"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device and skips without one; on the
H100 run them with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_kernels.py

Tolerances: f32 kernels and plain versions differ only by FMA
contraction (a few ulp of outputs of size ≤ ~10 → 1e-5 absolute); bf16
outputs are rounded from f32 accumulators and may differ by one bf16
ulp (2⁻⁷ relative to the largest output).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.problems import ho_regression, quadratic_bilevel
from repro_torch.kernels import mixing_matvec as mm
from repro_torch.kernels import ref
from repro_torch.solve import ScheduleSpec, SolverSpec, solve
from repro_torch.topology import make_mixing_op, make_network
from repro_torch.topology.structure import (circulant_structure,
                                            sparse_structure)

pytestmark = pytest.mark.gpu

SHAPES = [(16, 2010), (16, 157000), (3, 1), (7, 129), (128, 1000)]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on "
                    "the card")
    return torch.device("cuda")


def _close(got, want):
    if want.dtype == torch.float32:
        tol = 1e-5
    else:
        tol = 2.0 ** -7 * want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, (err, tol)


def _tables(s, dev):
    off, w = mm.circulant_tables(s.n, s.offsets, s.weights, dev)
    return dict(w_self=s.w_self, offsets=off, weights=w)


def _randn(shape, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal(shape),
                           dtype=torch.float32).to(dev).to(dtype)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("laplacian", [False, True])
@pytest.mark.parametrize("kind,offsets", [("ring", (1,)),
                                          ("circulant", (1, 2))])
def test_circulant_mix_kernel(cuda, shape, dtype, laplacian, kind, offsets):
    n, d = shape
    s = circulant_structure(make_network(kind, n, offsets=offsets).W)
    y = _randn(shape, dtype, cuda)
    before = mm.circulant_mix_matvec.launches
    got = mm.circulant_mix_matvec(y, laplacian=laplacian, **_tables(s, cuda))
    torch.cuda.synchronize()
    assert mm.circulant_mix_matvec.launches == before + 1
    assert got.dtype == dtype and got.shape == y.shape
    want = ref.circulant_mix_ref(y.float(), s.w_self, s.offsets,
                                 s.weights, laplacian).to(dtype)
    _close(got, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("laplacian", [False, True])
@pytest.mark.parametrize("kind", ["erdos_renyi", "star"])
def test_sparse_mix_kernel(cuda, shape, dtype, laplacian, kind):
    n, d = shape
    sp = sparse_structure(make_network(kind, n, r=0.5, seed=0).W)
    tabs = [torch.as_tensor(a, device=cuda)
            for a in (sp.w_self, sp.neighbors, sp.weights)]
    y = _randn(shape, dtype, cuda)
    before = mm.sparse_mix_matvec.launches
    got = mm.sparse_mix_matvec(y, *tabs, laplacian=laplacian)
    torch.cuda.synchronize()
    assert mm.sparse_mix_matvec.launches == before + 1
    want = ref.sparse_mix_padded_ref(y.float(), *tabs, laplacian).to(dtype)
    _close(got, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_circulant_neumann_kernel(cuda, shape, dtype):
    n, d = shape
    s = circulant_structure(make_network("ring", n).W)
    h, hvp, p = (_randn(shape, dtype, cuda, seed=i) for i in range(3))
    dsc = torch.as_tensor(np.random.default_rng(3).uniform(
        1.5, 3.0, (n, 1)), dtype=torch.float32).to(cuda)
    before = mm.circulant_neumann_step.launches
    got = mm.circulant_neumann_step(h, hvp, p, dsc, beta=0.1,
                                    **_tables(s, cuda))
    torch.cuda.synchronize()
    assert mm.circulant_neumann_step.launches == before + 1
    want = ref.neumann_step_ref(h.float(), hvp.float(), p.float(), dsc,
                                w_self=s.w_self, offsets=s.offsets,
                                weights=s.weights, beta=0.1).to(dtype)
    _close(got, want)


@pytest.mark.parametrize("d", [1, 129, 2010])
@pytest.mark.parametrize("dtype", DTYPES)
def test_many_offsets_circulant_kernels(cuda, d, dtype):
    """18 neighbors per agent (offsets ±1..±9 at n = 64): the auto rule
    takes the circulant tier, and both circulant kernels launch."""
    net = make_network("circulant", 64, offsets=tuple(range(1, 10)))
    s = circulant_structure(net.W)
    assert len(s.offsets) == 18
    assert make_mixing_op(net, device=cuda).backend == "circulant"
    y, hvp, p = (_randn((64, d), dtype, cuda, seed=i) for i in range(3))
    dsc = torch.as_tensor(np.random.default_rng(3).uniform(
        1.5, 3.0, (64, 1)), dtype=torch.float32).to(cuda)
    for lap in (False, True):
        got = mm.circulant_mix_matvec(y, laplacian=lap, **_tables(s, cuda))
        want = ref.circulant_mix_ref(y.float(), s.w_self, s.offsets,
                                     s.weights, lap).to(dtype)
        _close(got, want)
    got = mm.circulant_neumann_step(y, hvp, p, dsc, beta=0.1,
                                    **_tables(s, cuda))
    want = ref.neumann_step_ref(y.float(), hvp.float(), p.float(), dsc,
                                w_self=s.w_self, offsets=s.offsets,
                                weights=s.weights, beta=0.1).to(dtype)
    _close(got, want)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    s = circulant_structure(make_network("ring", 8).W)
    kw = _tables(s, cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        mm.circulant_mix_matvec(torch.zeros(8, 4, dtype=torch.float64,
                                            device=cuda), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        mm.circulant_mix_matvec(torch.zeros(4, 8, device=cuda).t(), **kw)
    with pytest.raises(ValueError, match="requires grad"):
        mm.circulant_mix_matvec(torch.zeros(8, 4, device=cuda,
                                            requires_grad=True), **kw)
    with pytest.raises(ValueError, match="on cuda"):
        mm.circulant_mix_matvec(torch.zeros(8, 4, device=cuda),
                                **_tables(s, "cpu"))
    sp = sparse_structure(make_network("ring", 8).W)
    with pytest.raises(ValueError, match="on cuda"):
        mm.sparse_mix_matvec(torch.zeros(8, 4, device=cuda),
                             torch.as_tensor(sp.w_self),
                             torch.as_tensor(sp.neighbors, device=cuda),
                             torch.as_tensor(sp.weights, device=cuda))


@pytest.mark.parametrize("kind", ["ring", "erdos_renyi", "star"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mixing_op_cuda_matches_cpu(cuda, kind, dtype):
    net = make_network(kind, 16, r=0.5, seed=0)
    y = _randn((16, 3, 70), torch.float32, "cpu")
    ops = {dev: make_mixing_op(net, dtype=dtype, device=dev)
           for dev in ("cpu", cuda)}
    for lap in (False, True):
        got = ops[cuda]._apply(y.to(cuda), lap).cpu()
        want = ops["cpu"]._apply(y, lap)
        if dtype == "f32":
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        else:
            _close(got.to(torch.bfloat16), want.to(torch.bfloat16))


@pytest.mark.parametrize("kind,n,family", [("ring", 8, "quadratic"),
                                           ("erdos_renyi", 16,
                                            "ho_regression")])
@pytest.mark.parametrize("dihgp", ["dense", "matrix_free"])
def test_solve_cuda_matches_cpu(cuda, kind, n, family, dihgp):
    """End to end on the card vs the CPU run through the plain versions
    (rtol 1e-4: reduction orders differ in the autodiff terms)."""
    net = make_network(kind, n, r=0.5, seed=0)
    make = {"quadratic": lambda dev: quadratic_bilevel(n, 5, 6, seed=1,
                                                       device=dev),
            "ho_regression": lambda dev: ho_regression(n, 6, seed=1,
                                                       device=dev)}[family]
    spec = SolverSpec(K=10, M=5, U=3, dihgp=dihgp, curvature=10.0,
                      schedule=ScheduleSpec(alpha=0.05, beta=0.05))
    rng = np.random.default_rng(0)
    probs = {dev: make(dev) for dev in ("cpu", "cuda")}
    x0 = 0.1 * rng.standard_normal((n, probs["cpu"].d1))
    y0 = 0.1 * rng.standard_normal((n, probs["cpu"].d2))
    mm.reset_launch_counts()
    gpu = solve(probs["cuda"], net, spec, x0=x0, y0=y0, device="cuda")
    counts = mm.launch_counts()
    cpu = solve(probs["cpu"], net, spec, x0=x0, y0=y0, device="cpu")
    assert sum(counts.values()) > 0
    torch.testing.assert_close(gpu.x.cpu(), cpu.x, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(gpu.y.cpu(), cpu.y, rtol=1e-4, atol=1e-5)
    assert gpu.ledger.total_bytes == cpu.ledger.total_bytes
