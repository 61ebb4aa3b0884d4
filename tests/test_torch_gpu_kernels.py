"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device and skips without one; on the
H100 run them with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_kernels.py

Tolerances: the kernels round each product and sum on their own, in
the plain versions' order, so f32 outputs are expected bitwise; the
pass mark is a few ulp of outputs of size ≤ ~10 (1e-5 absolute); bf16
outputs are rounded from f32 accumulators and may differ by one bf16
ulp (2⁻⁷ relative to the largest output).
"""
from __future__ import annotations

import functools
import types

import numpy as np
import pytest
import torch

from repro_torch.core.problems import ho_regression, quadratic_bilevel
from repro_torch.kernels import mixing_matvec as mm
from repro_torch.kernels import ref
from repro_torch.solve import CommSpec, ScheduleSpec, SolverSpec, solve
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


def _mix_route(offsets, n, d, dtype):
    """The counter of the plain circulant mix's route by the planner:
    the ring at bn = n or the unstaged kernel."""
    item = torch.tensor([], dtype=dtype).element_size()
    return "circulant_mix_matvec" if mm.circulant_ring_stages(
        n, *mm.halo_extents(offsets, n), itemsize=item, d=d) \
        else "circulant_mix_matvec_unstaged"


def _neumann_route(offsets, n, d, dtype):
    item = torch.tensor([], dtype=dtype).element_size()
    return "circulant_neumann_step" if mm.neumann_ring_plan(
        n, *mm.halo_extents(offsets, n), itemsize=item, d=d) \
        else "circulant_neumann_step_unstaged"


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
    route = _mix_route(s.offsets, n, d, dtype)
    before = mm.launch_counts()[route]
    got = mm.circulant_mix_matvec(y, laplacian=laplacian, **_tables(s, cuda))
    torch.cuda.synchronize()
    assert mm.launch_counts()[route] == before + 1
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
    before = mm.launch_counts()["sparse_mix_matvec"]
    got = mm.sparse_mix_matvec(y, *tabs, laplacian=laplacian)
    torch.cuda.synchronize()
    assert mm.launch_counts()["sparse_mix_matvec"] == before + 1
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
    route = _neumann_route(s.offsets, n, d, dtype)
    before = mm.launch_counts()[route]
    got = mm.circulant_neumann_step(h, hvp, p, dsc, beta=0.1,
                                    **_tables(s, cuda))
    torch.cuda.synchronize()
    assert mm.launch_counts()[route] == before + 1
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
    # the decoded-stripe entry points refuse a shared-memory size that
    # is not their width's stripe, a width they do not take, and a
    # stripe over what a block may use (planned under a raised budget),
    # and the wrappers raise: no retry on the unstaged kernels
    from repro_torch.comm import row_quant_params
    y = _randn((8, 8), torch.float32, cuda)
    out = torch.empty_like(y)
    zp, sc = row_quant_params(y, 8)
    off, w = kw["offsets"], kw["weights"]
    wire = (zp.data_ptr(), sc.data_ptr(), 1, 255.0)
    for cols, smem in ((128, 8 * 128 * 4 + 4), (96, 8 * 96 * 4),
                       (128, 0)):
        with pytest.raises(RuntimeError, match="launch failed"):
            mm._LIB.launch("circulant_mix_comm", cuda, y.data_ptr(),
                           out.data_ptr(), None, None, *wire, 8, 8,
                           s.w_self, 2, off.data_ptr(), w.data_ptr(), 0,
                           cols, smem)
    tabs = [torch.as_tensor(a, device=cuda)
            for a in (sp.w_self, sp.neighbors, sp.weights)]
    with pytest.raises(RuntimeError, match="launch failed"):
        mm._LIB.launch("sparse_mix_comm", cuda, y.data_ptr(),
                       out.data_ptr(), None, None, *wire,
                       *(t.data_ptr() for t in tabs), 8, 8, sp.k, 0, 128,
                       8 * 64 * 4)
    n, d = 500, 128 * 132       # 500 x 128 x 4 bytes > 232,448
    s500 = circulant_structure(make_network("ring", n).W)
    y = _randn((n, d), torch.float32, cuda)
    zp, sc = row_quant_params(y, 8)
    mm.reset_launch_counts()
    with mm.smem_budget(n * 128 * 4):
        assert mm.plan_comm_stripe_cols(n, d, mm._card_sms(y.device)) \
            == 128
        with pytest.raises(RuntimeError, match="launch failed"):
            mm.circulant_mix_matvec(y, zp, sc, 1, comm="int8",
                                    **_tables(s500, cuda))
    assert sum(mm.launch_counts().values()) == 0


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


# ---------------------------------------------------------------------------
# Comm-fused kernels (int8/int4 ± EF): the payload is bitwise the plain
# version's (no FMA contraction in the quantizer, IEEE division); the
# mixed output is held within the tolerances above.
# ---------------------------------------------------------------------------

COMMS = ["int8", "int4", "int8+ef", "int4+ef"]
FUSED_SHAPES = [(16, 2010), (16, 157000), (3, 1), (7, 129), (128, 1000)]


def _wire(y, comm, dev, seed=5):
    from repro_torch.comm import row_quant_params
    bits, ef = int(comm[3]), comm.endswith("+ef")
    hat = 0.5 * _randn(y.shape, torch.float32, dev, seed=seed) if ef \
        else None
    zp, sc = row_quant_params(y - hat if ef else y, bits)
    return bits, ef, zp, sc, hat


def _neumann_comm_route(n, d, dev):
    """The counter of the comm-fused Neumann step's route by the planner:
    the decoded stripe or the unstaged kernel."""
    return "circulant_neumann_step_comm" if \
        mm.plan_neumann_comm_stripe_cols(n, d, mm._card_sms(dev)) \
        else "circulant_neumann_step_comm_unstaged"


def _close_fused(got, want, ef):
    if ef:
        assert torch.equal(got[1], want[1])
        got, want = got[0], want[0]
    _close(got, want)


@pytest.mark.parametrize("shape", FUSED_SHAPES)
@pytest.mark.parametrize("comm", COMMS)
@pytest.mark.parametrize("laplacian", [False, True])
def test_circulant_mix_comm_kernel(cuda, shape, comm, laplacian):
    n, d = shape
    s = circulant_structure(make_network("circulant", n, offsets=(1, 2)).W
                            if n >= 6 else make_network("ring", n).W)
    y = _randn(shape, torch.float32, cuda)
    bits, ef, zp, sc, hat = _wire(y, comm, cuda)
    before = mm.launch_counts()["circulant_mix_matvec_comm"]
    got = mm.circulant_mix_matvec(y, zp, sc, 2 ** 31 - 2, hat,
                                  laplacian=laplacian, comm=comm,
                                  **_tables(s, cuda))
    torch.cuda.synchronize()
    assert mm.launch_counts()["circulant_mix_matvec_comm"] == before + 1
    want = ref.circulant_mix_fused_ref(y, zp, sc, 2 ** 31 - 2, hat,
                                       w_self=s.w_self, offsets=s.offsets,
                                       weights=s.weights,
                                       laplacian=laplacian, bits=bits)
    _close_fused(got, want, ef)


@pytest.mark.parametrize("shape", FUSED_SHAPES)
@pytest.mark.parametrize("comm", COMMS)
@pytest.mark.parametrize("kind", ["erdos_renyi", "star"])
def test_sparse_mix_comm_kernel(cuda, shape, comm, kind):
    n, d = shape
    sp = sparse_structure(make_network(kind, n, r=0.5, seed=0).W)
    tabs = [torch.as_tensor(a, device=cuda)
            for a in (sp.w_self, sp.neighbors, sp.weights)]
    y = _randn(shape, torch.float32, cuda, seed=1)
    bits, ef, zp, sc, hat = _wire(y, comm, cuda)
    before = mm.launch_counts()["sparse_mix_matvec_comm"]
    got = mm.sparse_mix_matvec(y, *tabs, zp, sc, 99, hat, laplacian=True,
                               comm=comm)
    torch.cuda.synchronize()
    assert mm.launch_counts()["sparse_mix_matvec_comm"] == before + 1
    want = ref.sparse_mix_fused_ref(y, *tabs, zp, sc, 99, hat,
                                    laplacian=True, bits=bits)
    _close_fused(got, want, ef)


@pytest.mark.parametrize("shape", FUSED_SHAPES)
@pytest.mark.parametrize("comm", ["int8", "int4"])
def test_circulant_neumann_comm_kernel(cuda, shape, comm):
    n, d = shape
    s = circulant_structure(make_network("ring", n).W)
    h, hvp, p = (_randn(shape, torch.float32, cuda, seed=i)
                 for i in range(3))
    dsc = torch.as_tensor(np.random.default_rng(3).uniform(
        1.5, 3.0, (n, 1)), dtype=torch.float32).to(cuda)
    bits, _, zp, sc, _ = _wire(h, comm, cuda)
    route = _neumann_comm_route(n, shape[1], cuda)
    before = mm.launch_counts()[route]
    got = mm.circulant_neumann_step(h, hvp, p, dsc, zp, sc, 7, beta=0.1,
                                    comm=comm, **_tables(s, cuda))
    torch.cuda.synchronize()
    assert mm.launch_counts()[route] == before + 1
    want = ref.neumann_step_fused_ref(h, hvp, p, dsc, zp, sc, 7,
                                      w_self=s.w_self, offsets=s.offsets,
                                      weights=s.weights, beta=0.1,
                                      bits=bits)
    _close(got, want)


@pytest.mark.parametrize("n,d", [(2, 1), (2, 157000), (3, 129),
                                 (16, 2010)])
def test_ring_laplacian_kernel(cuda, n, d):
    W = make_network("ring", n).W if n > 2 else np.full((2, 2), 0.5)
    w_self, w_edge = float(W[0, 0]), float(W[0, 1])
    y = _randn((n, d), torch.float32, cuda)
    before = mm.launch_counts()
    got = mm.ring_laplacian_matvec(y, w_self=w_self, w_edge=w_edge)
    torch.cuda.synchronize()
    after = mm.launch_counts()
    assert after["ring_laplacian_matvec"] == \
        before["ring_laplacian_matvec"] + 1
    assert after["circulant_mix_matvec"] == before["circulant_mix_matvec"]
    _close(got, ref.ring_laplacian_ref(y, w_self, w_edge))


def test_row_quant_params_on_the_card_is_the_cpus(cuda):
    """The wire metadata is bitwise equal on both devices (bf16 RNE casts
    and a tensor-by-tensor division)."""
    from repro_torch.comm import row_quant_params
    y = _randn((64, 5000), torch.float32, "cpu") \
        * torch.logspace(-3, 3, 64)[:, None]
    for bits in (4, 8):
        zc, sc = row_quant_params(y, bits)
        zg, sg = row_quant_params(y.to(cuda), bits)
        assert torch.equal(zg.cpu(), zc) and torch.equal(sg.cpu(), sc)
    u = ref.hash_uniform(12345, torch.arange(64, device=cuda)[:, None],
                         torch.arange(5000, device=cuda)[None, :])
    assert torch.equal(u.cpu(), ref.hash_uniform(
        12345, torch.arange(64)[:, None], torch.arange(5000)[None, :]))


@pytest.mark.parametrize("comm", ["int8", "int4", "int8+ef", "int4+ef",
                                  "bf16", "top_k:0.1+ef", "rand_k:0.25"])
@pytest.mark.parametrize("kind", ["ring", "erdos_renyi", "star"])
def test_solve_with_comm_cuda_matches_cpu(cuda, comm, kind):
    """Compressed solve on the card vs the CPU: the same send seeds give
    the same uniforms and rand-k indices on both devices, so the runs
    agree except where a ~1e-7 autodiff difference flips a stochastic
    rounding (one neighbor term moves by w·scale): norm-relative 1e-2."""
    n = 16
    net = make_network(kind, n, r=0.5, seed=0)
    spec = SolverSpec(K=6, M=4, U=2, dihgp="matrix_free", curvature=10.0,
                      comm=CommSpec(comm),
                      schedule=ScheduleSpec(alpha=0.05, beta=0.05))
    rng = np.random.default_rng(0)
    probs = {dev: quadratic_bilevel(n, 130, 40, seed=1, device=dev)
             for dev in ("cpu", "cuda")}
    x0 = 0.1 * rng.standard_normal((n, 130))
    y0 = 0.1 * rng.standard_normal((n, 40))
    mm.reset_launch_counts()
    gpu = solve(probs["cuda"], net, spec, x0=x0, y0=y0, device="cuda")
    counts = mm.launch_counts()
    cpu = solve(probs["cpu"], net, spec, x0=x0, y0=y0, device="cpu")
    fused = spec.comm.spec.startswith("int") and kind != "star"
    assert (sum(v for k, v in counts.items() if k.endswith("_comm")) > 0) \
        == fused
    for g, c in ((gpu.x, cpu.x), (gpu.y, cpu.y)):
        assert torch.isfinite(g).all()
        assert ((g.cpu() - c).norm() / c.norm()).item() <= 1e-2
    assert gpu.ledger.total_bytes == cpu.ledger.total_bytes \
        == spec.comm_ledger(130, 40).total_bytes


# ---------------------------------------------------------------------------
# Row-tiled halo kernels: for any valid row tile the plain outputs, the
# fused payloads and the fused outputs equal the full-operand kernels' bit
# for bit (same accumulation order and rounding, the same quantizer);
# against the plain versions the tolerances above hold.
# ---------------------------------------------------------------------------

HALO_SHAPES = [(64, 2010), (64, 129), (32, 1), (256, 1000)]
HALO_BNS = [8, 16, 32]
HALO_GRAPHS = [("ring", (1,)), ("circulant", (1, 2, 3))]


def _halo_case(kind, offsets, n):
    return circulant_structure(make_network(kind, n, offsets=offsets).W)


@pytest.mark.parametrize("shape", HALO_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bn", HALO_BNS)
@pytest.mark.parametrize("kind,offsets", HALO_GRAPHS)
def test_circulant_mix_halo_kernel(cuda, shape, dtype, bn, kind, offsets):
    n, d = shape
    s = _halo_case(kind, offsets, n)
    y = _randn(shape, dtype, cuda)
    for lap in (False, True):
        before = mm.launch_counts()["circulant_mix_matvec_halo"]
        got = mm.circulant_mix_matvec_halo(y, w_self=s.w_self,
                                           offsets=s.offsets,
                                           weights=s.weights, laplacian=lap,
                                           bn=bn)
        torch.cuda.synchronize()
        assert mm.launch_counts()["circulant_mix_matvec_halo"] == before + 1
        full = mm.circulant_mix_matvec(y, laplacian=lap, **_tables(s, cuda))
        assert torch.equal(got, full)
        _close(got, ref.circulant_mix_ref(y.float(), s.w_self, s.offsets,
                                          s.weights, lap).to(dtype))


@pytest.mark.parametrize("shape", HALO_SHAPES)
@pytest.mark.parametrize("comm", COMMS)
@pytest.mark.parametrize("bn", HALO_BNS)
@pytest.mark.parametrize("kind,offsets", HALO_GRAPHS)
def test_circulant_mix_halo_comm_kernel(cuda, shape, comm, bn, kind,
                                        offsets):
    n, d = shape
    s = _halo_case(kind, offsets, n)
    y = _randn(shape, torch.float32, cuda)
    bits, ef, zp, sc, hat = _wire(y, comm, cuda)
    for lap in (False, True):
        before = mm.launch_counts()["circulant_mix_matvec_halo_comm"]
        got = mm.circulant_mix_matvec_halo(
            y, zp, sc, 99, hat, w_self=s.w_self, offsets=s.offsets,
            weights=s.weights, laplacian=lap, bn=bn, comm=comm)
        torch.cuda.synchronize()
        assert mm.launch_counts()["circulant_mix_matvec_halo_comm"] \
            == before + 1
        full = mm.circulant_mix_matvec(y, zp, sc, 99, hat, laplacian=lap,
                                       comm=comm, **_tables(s, cuda))
        for g, f in zip(got if ef else (got,), full if ef else (full,)):
            assert torch.equal(g, f)
        want = ref.circulant_mix_fused_ref(y, zp, sc, 99, hat,
                                           w_self=s.w_self,
                                           offsets=s.offsets,
                                           weights=s.weights, laplacian=lap,
                                           bits=bits)
        _close_fused(got, want, ef)


def _er_tables(n, dev, r=0.2):
    sp = sparse_structure(make_network("erdos_renyi", n, r=r, seed=0).W)
    return [torch.as_tensor(a, device=dev)
            for a in (sp.w_self, sp.neighbors, sp.weights)]


@pytest.mark.parametrize("shape", HALO_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bn", HALO_BNS)
def test_sparse_mix_halo_kernel(cuda, shape, dtype, bn):
    n, d = shape
    tabs = _er_tables(n, cuda)
    y = _randn(shape, dtype, cuda)
    for lap in (False, True):
        before = mm.launch_counts()["sparse_mix_matvec_halo"]
        got = mm.sparse_mix_matvec_halo(y, *tabs, laplacian=lap, bn=bn)
        torch.cuda.synchronize()
        assert mm.launch_counts()["sparse_mix_matvec_halo"] == before + 1
        assert torch.equal(got, mm.sparse_mix_matvec(y, *tabs,
                                                     laplacian=lap))
        _close(got, ref.sparse_mix_padded_ref(y.float(), *tabs,
                                              lap).to(dtype))


@pytest.mark.parametrize("shape", HALO_SHAPES)
@pytest.mark.parametrize("comm", ["int8", "int4"])
@pytest.mark.parametrize("bn", HALO_BNS)
def test_sparse_mix_halo_comm_kernel(cuda, shape, comm, bn):
    n, d = shape
    tabs = _er_tables(n, cuda)
    y = _randn(shape, torch.float32, cuda)
    bits, _, zp, sc, _ = _wire(y, comm, cuda)
    for lap in (False, True):
        before = mm.launch_counts()["sparse_mix_matvec_halo_comm"]
        got = mm.sparse_mix_matvec_halo(y, *tabs, zp, sc, 7, laplacian=lap,
                                        bn=bn, comm=comm)
        torch.cuda.synchronize()
        assert mm.launch_counts()["sparse_mix_matvec_halo_comm"] \
            == before + 1
        assert torch.equal(got, mm.sparse_mix_matvec(
            y, *tabs, zp, sc, 7, laplacian=lap, comm=comm))
        _close(got, ref.sparse_mix_fused_ref(y, *tabs, zp, sc, 7,
                                             laplacian=lap, bits=bits))


def test_halo_kernels_at_the_planners_largest_tiles(cuda):
    """The planner's bn at n = 4096 (the shared memory a block opts into
    above 48 KB): plain f32 and bf16, fused and fused + EF."""
    n, d = 4096, 300
    s = circulant_structure(make_network("ring", n).W)
    kw = dict(w_self=s.w_self, offsets=s.offsets, weights=s.weights)
    y = _randn((n, d), torch.float32, cuda)
    for dtype in DTYPES:
        yt = y.to(dtype)
        bn = mm.pick_halo_bn(n, h_lo=1, h_hi=1, itemsize=yt.element_size())
        assert bn == {torch.float32: 128, torch.bfloat16: 256}[dtype]
        got = mm.circulant_mix_matvec_halo(yt, bn=bn, **kw)
        assert torch.equal(got, mm.circulant_mix_matvec(yt,
                                                        **_tables(s, cuda)))
    for comm in ("int8", "int8+ef"):
        bits, ef, zp, sc, hat = _wire(y, comm, cuda)
        bn = mm.pick_halo_bn(n, h_lo=1, h_hi=1,
                             blocks=mm.plan_blocks(True, ef))
        got = mm.circulant_mix_matvec_halo(y, zp, sc, 3, hat, bn=bn,
                                           comm=comm, **kw)
        full = mm.circulant_mix_matvec(y, zp, sc, 3, hat, comm=comm,
                                       **_tables(s, cuda))
        for g, f in zip(got if ef else (got,), full if ef else (full,)):
            assert torch.equal(g, f)
    tabs = _er_tables(n, cuda, r=0.004)
    got = mm.sparse_mix_matvec_halo(y, *tabs, bn=mm.pick_halo_bn(n),
                                    laplacian=True)
    assert torch.equal(got, mm.sparse_mix_matvec(y, *tabs, laplacian=True))


TIER_CASES = [
    # (graph, n, comm, launches of one mix_c + laplacian_c + neumann_step_c)
    # at d = 260: three column tiles, too few for the rings at n = 16 and,
    # for offsets ±100 at n = 1024, no ring tile fits (the unstaged
    # kernels); at n = 1024 the ring's Neumann tile (16 rows) has 192
    ("ring", 16, "identity", {"circulant_mix_matvec_unstaged": 2,
                              "circulant_neumann_step_unstaged": 1}),
    ("ring", 1024, "identity", {"circulant_mix_matvec_halo": 2,
                                "circulant_neumann_step": 1}),
    ("far", 1024, "identity", {"circulant_mix_matvec_unstaged": 2,
                               "circulant_neumann_step_unstaged": 1}),
    ("erdos_renyi", 16, "identity", {"sparse_mix_matvec": 3}),
    ("erdos_renyi", 1024, "identity", {"sparse_mix_matvec_halo": 3}),
    # (the comm-fused Neumann step's 3 column tiles: its unstaged kernel)
    ("ring", 16, "int8", {"circulant_mix_matvec_comm": 2,
                          "circulant_neumann_step_comm_unstaged": 1}),
    ("ring", 1024, "int8", {"circulant_mix_matvec_halo_comm": 3}),
    ("ring", 1024, "int8+ef", {"circulant_mix_matvec_halo_comm": 3}),
    ("far", 1024, "int8", {"circulant_mix_matvec_comm": 2,
                           "circulant_neumann_step_comm_unstaged": 1}),
    ("erdos_renyi", 16, "int8+ef", {"sparse_mix_matvec_comm": 3}),
    ("erdos_renyi", 1024, "int8", {"sparse_mix_matvec_halo_comm": 3}),
    ("erdos_renyi", 1024, "int8+ef", {"sparse_mix_matvec_halo": 3}),
]


def _tier_network(graph, n):
    if graph == "far":              # offsets beyond every row tile: "xla"
        return make_network("circulant", n, offsets=(1, 100))
    return make_network(graph, n, r=0.5 if n == 16 else 0.02, seed=0)


@pytest.mark.parametrize("graph,n,comm,launches", TIER_CASES)
def test_mixing_op_launches_each_tier(cuda, graph, n, comm, launches):
    """A gossip, a Laplacian gossip and a Neumann step through
    `MixingOp` on each tier of the planner (full operand at n = 16, halo
    at n = 1024, no row tile for offsets ±100) launch exactly the
    kernels the plan names and agree with the CPU's plain versions."""
    net = _tier_network(graph, n)
    ops = {dev: make_mixing_op(net, comm=comm, device=dev)
           for dev in ("cpu", cuda)}
    y, h, hvp, p = (_randn((n, 260), torch.float32, "cpu", seed=i)
                    for i in range(4))
    dsc = torch.full((n, 1), 2.0)
    out = {}
    for dev, op in ops.items():
        st = op.comm_channel("c", y.to(dev), seed=4)
        mm.reset_launch_counts()
        a, st = op.mix_c(y.to(dev), st)
        b, st = op.laplacian_c(y.to(dev), st)
        c, st = op.neumann_step_c(h.to(dev), hvp.to(dev), p.to(dev),
                                  dsc.to(dev), 0.1, st)
        out[dev] = (a.cpu(), b.cpu(), c.cpu(), mm.launch_counts())
    assert out[cuda][3] == {**dict.fromkeys(out[cuda][3], 0), **launches}
    assert sum(out["cpu"][3].values()) == 0
    for got, want in zip(out[cuda][:3], out["cpu"][:3]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("comm", COMMS)
def test_fused_kernels_match_the_plain_versions_on_tiny_and_nan_rows(
        cuda, comm):
    """The kernels' quantizer clips a NaN code to NaN, as torch.clamp
    does (fminf/fmaxf made it 0, so a NaN input reached the neighbors as
    zp); rows of tiny values take scale 1 (`row_quant_params`) and decode
    to zp on both sides.  Payloads are compared bitwise, NaN included."""
    n, d = 64, 300
    y = _randn((n, d), torch.float32, "cpu")
    y[1] = torch.linspace(0, 3e-40, d)
    y[2] = torch.linspace(0, 2e-38, d)
    y[5, 7] = float("nan")
    y = y.to(cuda)
    bits, ef, zp, sc, hat = _wire(y, comm, cuda)
    s = circulant_structure(make_network("ring", n).W)
    host = dict(w_self=s.w_self, offsets=s.offsets, weights=s.weights)
    want = ref.circulant_mix_fused_ref(y, zp, sc, 9, hat, bits=bits, **host)
    got = [mm.circulant_mix_matvec(y, zp, sc, 9, hat, comm=comm,
                                   **_tables(s, cuda)),
           mm.circulant_mix_matvec_halo(y, zp, sc, 9, hat, bn=16, comm=comm,
                                        **host)]
    if not ef:
        tabs = _er_tables(n, cuda)
        want = [want, ref.sparse_mix_fused_ref(y, *tabs, zp, sc, 9,
                                               bits=bits)]
        got = [got, [mm.sparse_mix_matvec(y, *tabs, zp, sc, 9, comm=comm),
                     mm.sparse_mix_matvec_halo(y, *tabs, zp, sc, 9, bn=16,
                                               comm=comm)]]
    else:
        want, got = [want], [got]
    for w, gs in zip(want, got):
        for g in gs:
            if ef:
                torch.testing.assert_close(g[1], w[1], rtol=0, atol=0,
                                           equal_nan=True)
                g, w_out = g[0], w[0]
            else:
                w_out = w
            torch.testing.assert_close(g, w_out, rtol=0, atol=1e-5,
                                       equal_nan=True)


# ---------------------------------------------------------------------------
# The compressed sparse gather's column slab (n ≤ 33,536): one hash per
# element, the neighbors gathered from shared memory.  Its outputs equal
# the plain version's bit for bit, NaN codes and tiny rows included.
# ---------------------------------------------------------------------------

def _bits_equal(got, want):
    """Bitwise, with NaN at the same places (a NaN's payload aside)."""
    nan = got.isnan()
    assert torch.equal(nan, want.isnan())
    assert torch.equal(got.view(torch.int32)[~nan],
                       want.view(torch.int32)[~nan])


@pytest.mark.parametrize("route", [8, 4, 2, 1, None])
@pytest.mark.parametrize("n,bn,d", [(4096, 64, 157000), (4096, 64, 2010),
                                    (4096, 64, 1001), (4121, 1, 2010),
                                    (4121, 1, 1001)])
@pytest.mark.parametrize("comm", ["int8", "int4"])
def test_sparse_halo_comm_every_route_bitwise(cuda, route, n, bn, d, comm):
    """Every route of the compressed sparse gather: the slab at the
    planner's c = 8 (the main path's ER gossip, n = 4096, r = 0.004,
    k = 36, at d1 and d2), then, under a lower planner budget
    (`smem_budget`), the slab at c = 4, 2, 1 and the row-tiled kernel
    (None), which the planner gives n > 33,536.  d = 1001 is no multiple
    of the slab width (element-wise staging, a ragged last slab); n =
    4121 (odd, bn = 1; k = 36, so the table stage takes 16-byte copies)
    puts the slab's end off 16 bytes at c = 2 and 1, where the stage
    must still start aligned.  Bitwise against the plain version, NaN
    codes and tiny rows included, and counted under the route's own
    name."""
    tabs = _er_tables(n, cuda, r=0.004)
    y = _randn((n, d), torch.float32, "cpu", seed=d)
    y[1] = torch.linspace(0, 3e-40, d)
    y[2] = torch.linspace(0, 2e-38, d)
    y[5, 7] = float("nan")
    y = y.to(cuda)
    bits, _, zp, sc, _ = _wire(y, comm, cuda)
    if route == 8:
        budget = mm.SMEM_BUDGET_BYTES
    elif route is None:
        budget = mm.slab_smem_bytes(n, 1) - 1
    else:
        budget = mm.slab_smem_bytes(n, route)
    counter = ("sparse_mix_matvec_halo_comm" if route is not None
               else "sparse_mix_matvec_halo_comm_rows")
    for lap in (False, True):
        want = ref.sparse_mix_halo_ref(y, *tabs, zp, sc, 5, laplacian=lap,
                                       bn=bn, bits=bits)
        mm.reset_launch_counts()
        with mm.smem_budget(budget):
            assert mm.plan_slab_cols(n) == route
            got = mm.sparse_mix_matvec_halo(y, *tabs, zp, sc, 5,
                                            laplacian=lap, bn=bn, comm=comm)
        torch.cuda.synchronize()
        counts = mm.launch_counts()
        assert counts == {**dict.fromkeys(counts, 0), counter: 1}
        _bits_equal(got, want)
        del got, want
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The plain sparse gather's column slab (`sparse_mix_slab_kernel`): rows in
# the row plan's degree order, padded slots from registers.  Every route
# equals the full-operand kernel and the plain version bit for bit, with
# NaN, ±inf and −0 in the operand.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _er_structure(n, r=0.004):
    return sparse_structure(make_network("erdos_renyi", n, r=r, seed=0).W)


@functools.lru_cache(maxsize=None)
def _circulant_structure(n, offsets):
    return circulant_structure(make_network("circulant", n,
                                            offsets=offsets).W)


def _special_rows(y):
    """NaN, ±inf and −0 in a few rows of a CPU operand (before the cast
    to its dtype, which keeps each)."""
    y[3, :4] = torch.tensor([float("nan"), float("inf"), -float("inf"),
                             -0.0])
    y[7] = -0.0
    y[11, 1::3] = float("inf")
    return y


@pytest.mark.parametrize("route", [0, 1, 2, 3, None])
@pytest.mark.parametrize("n,bn,d", [(4096, 64, 157000), (4096, 64, 2010),
                                    (4096, 64, 1001), (4121, 1, 2010),
                                    (4121, 1, 1001)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("planned", [True, False])
def test_sparse_halo_plain_every_route_bitwise(cuda, route, n, bn, d, dtype,
                                               planned):
    """Every route of the plain sparse gather: the slab at the planner's
    width (c = 8 f32, 16 bf16: the main path's ER gossip at n = 4096, r =
    0.004, k = 36, at d1 and d2), then, under a lower planner budget
    (`smem_budget`), the three narrower slabs (route 1-3 of
    `slab_cols_for`) and the row-tiled kernel (None), which the planner
    gives n > 33,536; each with and without the row plan (degree order,
    padded slots from registers; without it every slot is gathered in
    natural order).  d = 2010 takes 8-byte (f32) or 4-byte (bf16) copies,
    d = 1001 4-byte (f32) or 2-byte loads (bf16) and a ragged last slab;
    n = 4121 is odd (bn = 1, k = 36).  Bitwise against the full-operand
    kernel and the plain version, NaN, ±inf and −0 included, counted
    under the route's own name."""
    sp = _er_structure(n)
    tabs = [torch.as_tensor(a, device=cuda)
            for a in (sp.w_self, sp.neighbors, sp.weights)]
    plan = tuple(torch.as_tensor(a, device=cuda) for a in
                 mm.sparse_row_plan(sp.neighbors, sp.weights)) \
        if planned else None
    y = _special_rows(_randn((n, d), torch.float32, "cpu", seed=d))
    y = y.to(cuda).to(dtype)
    item = y.element_size()
    widths = mm.slab_cols_for(item)
    if route == 0:
        budget = mm.SMEM_BUDGET_BYTES
    elif route is None:
        budget = mm.slab_smem_bytes(n, widths[-1], item) - 1
    else:
        budget = mm.slab_smem_bytes(n, widths[route], item)
    cols = None if route is None else widths[route]
    counter = ("sparse_mix_matvec_halo" if route is not None
               else "sparse_mix_matvec_halo_rows")
    for lap in (False, True):
        full = mm.sparse_mix_matvec(y, *tabs, laplacian=lap)
        want = ref.sparse_mix_padded_ref(y.float(), *tabs, lap).to(dtype)
        mm.reset_launch_counts()
        with mm.smem_budget(budget):
            assert mm.plan_slab_cols(n, item) == cols
            got = mm.sparse_mix_matvec_halo(y, *tabs, laplacian=lap, bn=bn,
                                            row_plan=plan)
        torch.cuda.synchronize()
        counts = mm.launch_counts()
        assert counts == {**dict.fromkeys(counts, 0), counter: 1}
        assert got.dtype == dtype
        _bits_equal(got.float(), full.float())
        _bits_equal(got.float(), want.float())
        del got, full, want
        torch.cuda.empty_cache()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("offsets", [(1,), tuple(range(1, 10))])
@pytest.mark.parametrize("d", [160, 2010, 1001, 157000])
@pytest.mark.parametrize("tile", ["bn", "bn/2", "2bn"])
def test_circulant_halo_staged_ring_bitwise(cuda, dtype, offsets, d, tile):
    """The staged circulant kernel at n = 4096 on the ring and on a
    circulant with 18 offsets (halo 9 each side), at the planner's bn,
    half and twice it (a 1-stage ring: twice the tile leaves room for one
    buffer): d = 160 takes 16-byte copies and a ragged column tile, d =
    2010 8-byte (f32) or 4-byte (bf16) rows, d = 1001 4-byte (f32) or
    2-byte (bf16) rows, d = 157000 the main path's 16-byte ones.  Bitwise
    against the full-operand kernel, counted once per launch."""
    n = 4096
    s = _circulant_structure(n, offsets)
    h_lo, h_hi = mm.halo_extents(s.offsets, n)
    y = _special_rows(_randn((n, d), torch.float32, "cpu", seed=d))
    y = y.to(cuda).to(dtype)
    item = y.element_size()
    planned = mm.pick_halo_bn(n, h_lo=h_lo, h_hi=h_hi, itemsize=item)
    bn = {"bn": planned, "bn/2": planned // 2, "2bn": 2 * planned}[tile]
    stages = mm.halo_stages(h_lo + bn + h_hi, itemsize=item)
    assert stages == (1 if tile == "2bn" else 3)
    for lap in (False, True):
        full = mm.circulant_mix_matvec(y, laplacian=lap, **_tables(s, cuda))
        mm.reset_launch_counts()
        got = mm.circulant_mix_matvec_halo(y, w_self=s.w_self,
                                           offsets=s.offsets,
                                           weights=s.weights, laplacian=lap,
                                           bn=bn)
        torch.cuda.synchronize()
        counts = mm.launch_counts()
        assert counts == {**dict.fromkeys(counts, 0),
                          "circulant_mix_matvec_halo": 1}
        _bits_equal(got.float(), full.float())
        del got, full
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The plain full-operand sparse gather (`sparse_mix_stripe_kernel`): a
# column stripe of every row in shared memory at each width the planner
# can give, reached through `smem_budget`, and past the narrowest the
# unstaged kernel.  Every route equals the plain version bit for bit.
# ---------------------------------------------------------------------------

STRIPE_SHAPES = SHAPES + [(100, 1000), (4121, 129)]


def _tiny_and_special_rows(y):
    """Tiny values, NaN, ±inf and −0 in the rows a small operand has."""
    n = y.shape[0]
    y[1 % n] = torch.linspace(0, 3e-40, y.shape[1])
    if n > 11:
        _special_rows(y)
    return y


@pytest.mark.parametrize("shape", STRIPE_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_sparse_mix_stripe_every_route_bitwise(cuda, shape, dtype):
    """Every stripe width that fits at this n (128 .. 4 columns f32,
    256 .. 8 bf16: 512- to 16-byte rows), the planner's first, and the
    unstaged kernel one byte under the narrowest stripe.  d = 1 (4-byte
    f32 rows, 2-byte bf16 rows), 129 (odd), 2010 (8-byte f32 rows), 1000
    and 157000 cover every copy and store width and a ragged last stripe;
    n = 3, 7, 100 and 4121 rows that leave warps partly idle.  Erdős–Rényi
    r = 0.5 (k = 78 at n = 128), r = 0.004 at n = 4121.  Counted under
    the route's own name."""
    n, d = shape
    sp = _er_structure(n, r=0.5 if n <= 128 else 0.004)
    tabs = [torch.as_tensor(a, device=cuda)
            for a in (sp.w_self, sp.neighbors, sp.weights)]
    y = _tiny_and_special_rows(_randn(shape, torch.float32, "cpu", seed=d))
    y = y.to(cuda).to(dtype)
    item = y.element_size()
    widths = mm.stripe_cols_for(item)
    routes = [(c, mm.stripe_bytes(n, c, item)) for c in widths
              if mm.stripe_bytes(n, c, item) <= mm.SMEM_BUDGET_BYTES]
    assert routes[0][0] == mm.plan_stripe_cols(n, item)
    routes.append((None, mm.stripe_bytes(n, widths[-1], item) - 1))
    for lap in (False, True):
        want = ref.sparse_mix_padded_ref(y.float(), *tabs, lap).to(dtype)
        for cols, budget in routes:
            mm.reset_launch_counts()
            with mm.smem_budget(budget):
                assert mm.plan_stripe_cols(n, item) == cols
                got = mm.sparse_mix_matvec(y, *tabs, laplacian=lap)
            torch.cuda.synchronize()
            counts = mm.launch_counts()
            counter = ("sparse_mix_matvec" if cols is not None
                       else "sparse_mix_matvec_unstaged")
            assert counts == {**dict.fromkeys(counts, 0), counter: 1}
            assert got.dtype == dtype
            _bits_equal(got.float(), want.float())


# ---------------------------------------------------------------------------
# The fused circulant halo kernel's ring: every stage count that
# `halo_comm_stages` can give, output and payload bitwise.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("comm,stages", [
    ("int8", 3), ("int8", 2), ("int8", 1), ("int4", 3), ("int4", 2),
    ("int4", 1), ("int8+ef", 2), ("int8+ef", 1)])
@pytest.mark.parametrize("d", [4100, 2010])
def test_circulant_halo_comm_ring_bitwise(cuda, comm, stages, d):
    """The fused circulant halo kernel at n = 4096 on the ring, at the
    planner's bn (64), with the ring cut to `stages` raw stages by a
    lower budget: d = 4100 (16-byte copies, the main path's d1 rows cut
    to 33 column tiles and a ragged last one), d = 2010 (8-byte rows).
    Output and payload bitwise against the full-operand kernel and the
    plain version, with tiny rows, NaN, ±inf and −0 in the operand."""
    n = 4096
    s = _circulant_structure(n, (1,))
    h_lo, h_hi = mm.halo_extents(s.offsets, n)
    y = _tiny_and_special_rows(_randn((n, d), torch.float32, "cpu", seed=d))
    y = y.to(cuda)
    bits, ef, zp, sc, hat = _wire(y, comm, cuda)
    bn = mm.pick_halo_bn(n, h_lo=h_lo, h_hi=h_hi,
                         blocks=mm.plan_blocks(True, ef))
    assert bn == 64
    rows = h_lo + bn + h_hi
    budget = mm.halo_comm_buffers(stages, ef=ef) * mm.halo_smem_bytes(rows)
    host = dict(w_self=s.w_self, offsets=s.offsets, weights=s.weights)
    for lap in (False, True):
        full = mm.circulant_mix_matvec(y, zp, sc, 21, hat, laplacian=lap,
                                       comm=comm, **_tables(s, cuda))
        want = ref.circulant_mix_fused_ref(y, zp, sc, 21, hat,
                                           laplacian=lap, bits=bits, **host)
        mm.reset_launch_counts()
        with mm.smem_budget(budget):
            assert mm.halo_comm_stages(rows, ef=ef) == stages
            got = mm.circulant_mix_matvec_halo(y, zp, sc, 21, hat,
                                               laplacian=lap, bn=bn,
                                               comm=comm, **host)
        torch.cuda.synchronize()
        counts = mm.launch_counts()
        assert counts == {**dict.fromkeys(counts, 0),
                          "circulant_mix_matvec_halo_comm": 1}
        pairs = zip(got, full, want) if ef else [(got, full, want)]
        for g, f, w in pairs:
            _bits_equal(g, f)
            _bits_equal(g, w)
        del got, full, want
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The comm-fused full-operand gossips' decoded column stripe
# (`sparse_mix_stripe_comm_kernel`, `circulant_mix_stripe_comm_kernel`):
# every stripe width the planner gives, reached through `smem_budget`, and
# past the narrowest the unstaged kernels.  Output and payload equal the
# plain version bit for bit on every route.
# ---------------------------------------------------------------------------

def _offset_by_4_bytes(t):
    """A copy of t whose data starts 4 bytes past where torch would put
    it, so no row of it is 16-byte aligned."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.flatten()
    return buf[1:].view(t.shape)


def _comm_stripe_case(kind, n, d, comm, dev, offset=False):
    """(launch(y, hat, lap), plain version(y, hat, lap), y, hat) of one
    fused full-operand gossip: ER r = 0.5 or a circulant of offsets 1, 2
    (the ring below n = 5), tiny rows, NaN, ±inf and −0 in y."""
    y = _randn((n, d), torch.float32, "cpu", seed=d)
    if d >= 4:
        _tiny_and_special_rows(y)
    else:   # one column: a tiny value, NaN, +inf and −0
        y[1], y[3 % n], y[5 % n], y[7 % n] = 3e-40, float("nan"), \
            float("inf"), -0.0
    y = y.to(dev)
    bits, ef, zp, sc, hat = _wire(y, comm, dev)
    if offset:
        y, hat = _offset_by_4_bytes(y), hat if hat is None \
            else _offset_by_4_bytes(hat)
    if kind == "sparse":
        sp = _er_structure(n, r=0.5 if n <= 454 else 0.004)
        tabs = [torch.as_tensor(a, device=dev)
                for a in (sp.w_self, sp.neighbors, sp.weights)]

        def launch(y, hat, lap):
            return mm.sparse_mix_matvec(y, *tabs, zp, sc, 31, hat,
                                        laplacian=lap, comm=comm)

        def plain(y, hat, lap):
            return ref.sparse_mix_fused_ref(y, *tabs, zp, sc, 31, hat,
                                            laplacian=lap, bits=bits)
    else:
        s = circulant_structure(make_network("circulant", n, offsets=(1, 2)).W
                                if n >= 5 else make_network("ring", n).W)
        host = dict(w_self=s.w_self, offsets=s.offsets, weights=s.weights)

        def launch(y, hat, lap):
            return mm.circulant_mix_matvec(y, zp, sc, 31, hat, laplacian=lap,
                                           comm=comm, **_tables(s, dev))

        def plain(y, hat, lap):
            return ref.circulant_mix_fused_ref(y, zp, sc, 31, hat,
                                               laplacian=lap, bits=bits,
                                               **host)
    return launch, plain, y, hat


@pytest.mark.parametrize("d", [1, 129, 2010, 157000, "2012, 4 bytes off"])
@pytest.mark.parametrize("comm", COMMS)
@pytest.mark.parametrize("kind", ["sparse", "circulant"])
def test_comm_stripe_every_route_bitwise(cuda, d, comm, kind):
    """At n = 16 the planner's route, then a budget of exactly each
    width's stripe (the planner narrows d = 1, 129 and 2010 further: d =
    157000 reaches every width), and one byte under the narrowest (the
    unstaged kernel).  d = 1 and 129 take 4-byte copies, 2010 8-byte
    ones, 157000 16-byte ones; "2012, 4 bytes off" holds y and hat 4
    bytes past alignment, so 16-byte rows take 4-byte copies and loads.
    Each launch is counted under its route's own name."""
    n, offset = 16, isinstance(d, str)
    d = 2012 if offset else d
    launch, plain, y, hat = _comm_stripe_case(kind, n, d, comm, cuda,
                                              offset)
    ef = hat is not None
    name = ("sparse_mix_matvec_comm" if kind == "sparse"
            else "circulant_mix_matvec_comm")
    widths = mm.stripe_cols_for(4)
    budgets = [mm.SMEM_BUDGET_BYTES, *(mm.stripe_bytes(n, c) for c in widths),
               mm.stripe_bytes(n, widths[-1]) - 1]
    reached = set()
    for lap in (False, True):
        want = plain(y, hat, lap)
        for budget in budgets:
            mm.reset_launch_counts()
            with mm.smem_budget(budget):
                cols = mm.plan_comm_stripe_cols(n, d, mm._card_sms(y.device))
                got = launch(y, hat, lap)
            torch.cuda.synchronize()
            reached.add(cols)
            assert (cols is None) == (budget == budgets[-1])
            counts = mm.launch_counts()
            assert counts == {**dict.fromkeys(counts, 0),
                              name if cols else name + "_unstaged": 1}
            for g, w in (zip(got, want) if ef else [(got, want)]):
                _bits_equal(g, w)
    if d == 157000:
        assert reached == {*widths, None}


@pytest.mark.parametrize("n,d", [(3, 1), (7, 129), (100, 1001), (128, 2010),
                                 (454, 600), (455, 600), (4121, 129)])
@pytest.mark.parametrize("comm", ["int8", "int4+ef"])
@pytest.mark.parametrize("kind", ["sparse", "circulant"])
def test_comm_stripe_row_counts_bitwise(cuda, n, d, comm, kind):
    """Row counts that leave warps partly idle, n = 454 (the widest
    stripe at its largest n, one block per SM, 1024 threads), 455 (64
    columns) and 4121 (8 columns; the ER tables there are r = 0.004's,
    as the large-network path's)."""
    launch, plain, y, hat = _comm_stripe_case(kind, n, d, comm, cuda)
    ef = hat is not None
    got, want = launch(y, hat, True), plain(y, hat, True)
    torch.cuda.synchronize()
    for g, w in (zip(got, want) if ef else [(got, want)]):
        _bits_equal(g, w)


# ---------------------------------------------------------------------------
# The comm-fused Neumann step on the decoded stripe
# (`circulant_neumann_stripe_comm_kernel`) and its unstaged kernel: every
# width through `_neumann_comm_launch`'s `cols=` and through the
# planner's budget, the planner's route, bitwise against the plain version and against each other.
# ---------------------------------------------------------------------------

def _neumann_comm_case(n, d, comm, dev, offsets=(1, 2), offset=False):
    """(launch(cols), plain version, h) of one comm-fused Neumann step on
    a circulant of the given offsets (the ring below n = 5); tiny rows,
    NaN, ±inf and −0 in h; D̃ in [1.5, 3]."""
    h = _randn((n, d), torch.float32, "cpu", seed=d)
    if d >= 4:
        _tiny_and_special_rows(h)
    else:
        h[1 % n], h[3 % n] = 3e-40, float("nan")
    h = h.to(dev)
    hvp, p = (_randn((n, d), torch.float32, dev, seed=d + i)
              for i in (1, 2))
    dsc = torch.as_tensor(np.random.default_rng(n).uniform(
        1.5, 3.0, (n, 1)), dtype=torch.float32).to(dev)
    bits, _, zp, sc, _ = _wire(h, comm, dev)
    if offset:
        h, hvp, p = (_offset_by_4_bytes(t) for t in (h, hvp, p))
    s = circulant_structure(
        make_network("circulant", n, offsets=offsets).W if n >= 5
        else make_network("ring", n).W)
    want = ref.neumann_step_fused_ref(h, hvp, p, dsc, zp, sc, 17,
                                      w_self=s.w_self, offsets=s.offsets,
                                      weights=s.weights, beta=0.1,
                                      bits=bits)

    def launch(cols=None):
        if cols is None:
            return mm.circulant_neumann_step(h, hvp, p, dsc, zp, sc, 17,
                                             beta=0.1, comm=comm,
                                             **_tables(s, dev))
        return mm._neumann_comm_launch(h, hvp, p, dsc, zp, sc, 17, beta=0.1,
                                       comm=comm, cols=cols,
                                       **_tables(s, dev))
    return launch, want, h


@pytest.mark.parametrize("d", [1, 129, 2010, 157000, "2012, 4 bytes off"])
@pytest.mark.parametrize("comm", ["int8", "int4"])
def test_neumann_comm_every_route_bitwise(cuda, d, comm):
    """At n = 16: the planner's route, every stripe width through cols=
    and through a budget of exactly its stripe, and the unstaged kernel
    (cols=0, and one byte under the narrowest stripe); each launch counted
    under its route's name and bitwise the plain version.  "2012, 4
    bytes off" holds h, hvp_h and p 4 bytes past alignment (4-byte
    copies and loads)."""
    n, offset = 16, isinstance(d, str)
    d = 2012 if offset else d
    launch, want, h = _neumann_comm_case(n, d, comm, cuda, offset=offset)
    widths = mm.stripe_cols_for(4)
    runs = [({}, _neumann_comm_route(n, d, cuda))]
    runs += [(dict(cols=c), "circulant_neumann_step_comm") for c in widths]
    runs += [(dict(cols=0), "circulant_neumann_step_comm_unstaged")]
    runs += [(dict(budget=mm.stripe_bytes(n, c)),
              "circulant_neumann_step_comm"
              if mm.plan_neumann_comm_stripe_cols(n, d, mm._card_sms(cuda))
              else "circulant_neumann_step_comm_unstaged") for c in widths]
    runs += [(dict(budget=mm.stripe_bytes(n, widths[-1]) - 1),
              "circulant_neumann_step_comm_unstaged")]
    for kw, name in runs:
        mm.reset_launch_counts()
        if "budget" in kw:
            with mm.smem_budget(kw["budget"]):
                got = launch()
        else:
            got = launch(**kw)
        torch.cuda.synchronize()
        counts = mm.launch_counts()
        assert counts == {**dict.fromkeys(counts, 0), name: 1}, kw
        _bits_equal(got, want)


@pytest.mark.parametrize("n,d", [(3, 1), (7, 129), (100, 1001),
                                 (128, 2010), (454, 600), (455, 600),
                                 (4121, 129), (128, 157000)])
@pytest.mark.parametrize("comm", ["int8", "int4"])
def test_neumann_comm_stripe_row_counts_bitwise(cuda, n, d, comm):
    """Row counts that leave warps partly idle, n = 454 (the widest
    stripe at its largest n, one block per SM), 455 (64 columns), 4121
    (8 columns) and (128, d1), the stripe's shape on a wide operand: the
    stripe at the comm-fused gossips' width and the unstaged kernel,
    bitwise the plain version and each other."""
    launch, want, _ = _neumann_comm_case(n, d, comm, cuda)
    stripe = launch(cols=mm.plan_comm_stripe_cols(n, d, mm._card_sms(cuda)))
    unstaged = launch(cols=0)
    torch.cuda.synchronize()
    _bits_equal(stripe, want)
    _bits_equal(unstaged, want)
    _bits_equal(stripe, unstaged)


@pytest.mark.parametrize("comm", ["int8", "int4"])
def test_neumann_comm_stripe_many_offsets_bitwise(cuda, comm):
    """A circulant of 18 offsets (k = 18 neighbor terms, some repeated
    mod n) at n = 16 on every stripe width."""
    offsets = tuple(1 + t % 15 for t in range(18))
    launch, want, _ = _neumann_comm_case(16, 2010, comm, cuda,
                                         offsets=offsets)
    for cols in (0, *mm.stripe_cols_for(4)):
        got = launch(cols=cols)
        torch.cuda.synchronize()
        _bits_equal(got, want)


def test_neumann_comm_entry_refuses_what_it_does_not_take(cuda):
    """The stripe entry point refuses a shared-memory size that is not
    its width's stripe and a width it does not take, and a stripe over
    what a block may use (planned under a raised budget) fails the launch:
    no retry on the unstaged kernel."""
    from repro_torch.comm import row_quant_params
    s = circulant_structure(make_network("ring", 8).W)
    kw = _tables(s, cuda)
    h = _randn((8, 8), torch.float32, cuda)
    out = torch.empty_like(h)
    zp, sc = row_quant_params(h, 8)
    wire = (zp.data_ptr(), sc.data_ptr(), 1, 255.0)
    for cols, smem in ((128, 8 * 128 * 4 + 4), (96, 8 * 96 * 4), (128, 0),
                       (0, 4)):
        with pytest.raises(RuntimeError, match="launch failed"):
            mm._LIB.launch("circulant_neumann_comm", cuda, h.data_ptr(),
                           h.data_ptr(), h.data_ptr(), zp.data_ptr(),
                           out.data_ptr(), *wire, 8, 8, s.w_self, 2,
                           kw["offsets"].data_ptr(), kw["weights"].data_ptr(),
                           0.1, cols, smem)
    n, d = 500, 128 * 132       # 500 x 128 x 4 bytes > 232,448
    s500 = circulant_structure(make_network("ring", n).W)
    h = _randn((n, d), torch.float32, cuda)
    zp, sc = row_quant_params(h, 8)
    dsc = torch.full((n, 1), 2.0, device=cuda)
    mm.reset_launch_counts()
    with mm.smem_budget(n * 128 * 4):
        assert mm.plan_neumann_comm_stripe_cols(n, d, mm._card_sms(cuda)) \
            == 128
        with pytest.raises(RuntimeError, match="launch failed"):
            mm.circulant_neumann_step(h, h, h, dsc, zp, sc, 1, beta=0.1,
                                      comm="int8", **_tables(s500, cuda))
    assert sum(mm.launch_counts().values()) == 0


@pytest.mark.parametrize("kind,backend", [("ring", "circulant"),
                                          ("erdos_renyi", "sparse_gather")])
def test_explicit_backends_launch_nothing_and_backpropagate(cuda, kind,
                                                            backend):
    """An explicit XLA-named backend runs the plain PyTorch path on the
    card, whatever the switch: no kernel launches, and autograd runs
    through the gossip; "auto" with the switch off does the same, and
    with it on launches the kernels."""
    from repro_torch.kernels import ops as kops
    net = make_network(kind, 16, r=0.5, seed=0)
    W = torch.as_tensor(net.W, dtype=torch.float32, device=cuda)
    g = _randn((16, 40), torch.float32, cuda, seed=1)
    h, hvp, p = (_randn((16, 40), torch.float32, cuda, seed=s)
                 for s in (2, 3, 4))
    dsc = torch.full((16, 1), 2.0, device=cuda)
    for op, switch in ((make_mixing_op(net, backend, device=cuda), True),
                       (make_mixing_op(net, device=cuda), False)):
        with kops.kernel_mode(switch):
            mm.reset_launch_counts()
            y = _randn((16, 40), torch.float32, cuda).requires_grad_()
            (op.mix(y) * g).sum().backward()
            op.laplacian(y.detach())
            op.neumann_step(h, hvp, p, dsc, 0.1)
            torch.cuda.synchronize()
            assert sum(mm.launch_counts().values()) == 0
            torch.testing.assert_close(y.grad, W.T @ g, atol=1e-5, rtol=1e-5)
    op = make_mixing_op(net, device=cuda)
    mm.reset_launch_counts()
    op.mix(h)
    assert sum(mm.launch_counts().values()) == 1


# -- the circulant ring's Neumann step and plain full-operand mix -----------

RING_SHAPES = [(16, 1), (16, 3), (16, 5), (16, 2010), (16, 157000),
               (100, 2010), (100, 157000), (4096, 5), (4096, 2010),
               (4096, 157000)]
RING_GRAPHS = {
    "ring": lambda n: circulant_structure(make_network("ring", n).W),
    # a k = 4 circulant with asymmetric offsets +1, +2, −3, +5
    "asym": lambda n: types.SimpleNamespace(
        w_self=0.3, offsets=tuple(o % n for o in (1, 2, -3, 5)),
        weights=(0.25, 0.125, 0.2, 0.125))}


def _ring_routes(kernel, n, d, dtype, offsets):
    """Every route of `kernel` ("mix" or "neumann") at (n, d): [(keyword
    arguments, budget, counter)] — the planner's ring (or its unstaged
    kernel), the ring forced at each stage count (mix) or at the
    planner's tile, at n and at the shortest tile (Neumann), whatever
    the d2 rule says, and the unstaged kernel under a budget no tile
    fits."""
    item = torch.tensor([], dtype=dtype).element_size()
    h_lo, h_hi = mm.halo_extents(offsets, n)
    budget = mm.SMEM_BUDGET_BYTES
    name = "circulant_mix_matvec" if kernel == "mix" \
        else "circulant_neumann_step"
    route = _mix_route if kernel == "mix" else _neumann_route
    routes = [({}, budget, route(offsets, n, d, dtype)),
              ({}, 0, name + "_unstaged")]
    if kernel == "mix":
        for st in range(1, mm.halo_stages(h_lo + n + h_hi,
                                          itemsize=item) + 1):
            routes.append(({"ring": (n, st)}, budget, name))
        return routes
    plan = mm.neumann_ring_plan(n, h_lo, h_hi, itemsize=item)
    tiles = {plan[0]} if plan else set()
    for bn in (n, *mm.HALO_BNS, 4, 2):
        if bn <= n and n % bn == 0 and bn >= max(h_lo, h_hi) and \
                mm.neumann_stage_bytes(bn, h_lo, h_hi,
                                       itemsize=item) <= budget:
            tiles.add(bn)
    for bn in sorted(tiles)[:1] + sorted(tiles)[-1:] + (
            [plan[0]] if plan else []):
        st = min(mm.HALO_STAGES, budget
                 // mm.neumann_stage_bytes(bn, h_lo, h_hi, itemsize=item))
        routes.append(({"ring": (bn, st)}, budget, name))
    return routes


def _launch_ring(kernel, s, operands, **kw):
    host = dict(w_self=s.w_self, offsets=s.offsets, weights=s.weights)
    if kernel == "mix":
        return mm.circulant_mix_matvec(operands[0], laplacian=True, **host,
                                       **kw)
    return mm.circulant_neumann_step(*operands, beta=0.1, **host, **kw)


def _ring_operands(kernel, n, d, dtype, dev, offset=False):
    """y (mix) or h, hvp_h, p, D̃ (Neumann); with `offset` each (n, d)
    operand starts one value past an aligned allocation (4-byte f32,
    2-byte bf16 copies)."""
    def make(seed):
        t = _randn((n * d + offset,), dtype, dev, seed=seed)
        return t[int(offset):].view(n, d)
    if kernel == "mix":
        return (make(0),)
    dsc = torch.as_tensor(np.random.default_rng(3).uniform(
        1.5, 3.0, (n, 1)), dtype=torch.float32).to(dev)
    return make(0), make(1), make(2), dsc


def _ring_want(kernel, s, operands, dtype):
    if kernel == "mix":
        return ref.circulant_mix_ref(operands[0].float(), s.w_self,
                                     s.offsets, s.weights, True).to(dtype)
    h, hvp, p, dsc = operands
    return ref.neumann_step_ref(h.float(), hvp.float(), p.float(), dsc,
                                w_self=s.w_self, offsets=s.offsets,
                                weights=s.weights, beta=0.1).to(dtype)


def _check_every_ring_route(kernel, s, n, d, dtype, operands):
    want = _ring_want(kernel, s, operands, dtype)
    outs = []
    for kw, budget, counter in _ring_routes(kernel, n, d, dtype, s.offsets):
        with mm.smem_budget(budget):
            before = mm.launch_counts()
            got = _launch_ring(kernel, s, operands, **kw)
            torch.cuda.synchronize()
            after = mm.launch_counts()
        assert after[counter] == before[counter] + 1, (kw, budget, counter)
        assert sum(after.values()) == sum(before.values()) + 1
        assert got.dtype == dtype and got.shape == operands[0].shape
        assert torch.equal(got, want), (kw, budget)
        outs.append(got)
    for got in outs[1:]:
        assert torch.equal(got, outs[0])


@pytest.mark.parametrize("kernel", ["mix", "neumann"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,d", RING_SHAPES)
def test_circulant_ring_every_route_bitwise(cuda, kernel, dtype, n, d):
    """Each route of the ring's plain mix and Neumann step — the
    planner's, the ring at every stage count or tile, the unstaged
    kernel — equals the plain version and the others bit for bit, and
    bumps its own counter once."""
    s = RING_GRAPHS["ring"](n)
    _check_every_ring_route(kernel, s, n, d, dtype,
                            _ring_operands(kernel, n, d, dtype, cuda))


@pytest.mark.parametrize("kernel", ["mix", "neumann"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,d", [(16, 157000), (100, 2010)])
def test_circulant_ring_asymmetric_offsets_bitwise(cuda, kernel, dtype, n,
                                                   d):
    s = RING_GRAPHS["asym"](n)
    _check_every_ring_route(kernel, s, n, d, dtype,
                            _ring_operands(kernel, n, d, dtype, cuda))


@pytest.mark.parametrize("kernel", ["mix", "neumann"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [2010, 157000])
def test_circulant_ring_offset_pointer_bitwise(cuda, kernel, dtype, d):
    """Operands one value past an aligned allocation: the rings' copies
    narrow to 4 (f32) or 2 (bf16) bytes and stay bitwise."""
    n = 16
    s = RING_GRAPHS["ring"](n)
    operands = _ring_operands(kernel, n, d, dtype, cuda, offset=True)
    assert operands[0].data_ptr() % 16
    _check_every_ring_route(kernel, s, n, d, dtype, operands)


def test_circulant_ring_no_fallback_past_the_kernels_limits(cuda):
    """A ring the kernels do not take raises; it never gives way to the
    unstaged kernel or to the plain version."""
    n, d = 16, 157000
    s = RING_GRAPHS["ring"](n)
    h, hvp, p, dsc = _ring_operands("neumann", n, d, torch.float32, cuda)
    before = mm.launch_counts()
    with pytest.raises(ValueError, match="1 to 3"):
        _launch_ring("neumann", s, (h, hvp, p, dsc), ring=(8, 4))
    with pytest.raises(ValueError, match="within"):
        with mm.smem_budget(mm.neumann_stage_bytes(8, 1, 1) - 1):
            _launch_ring("neumann", s, (h, hvp, p, dsc), ring=(8, 1))
    with pytest.raises(ValueError, match="1 to 3 stages"):
        _launch_ring("mix", s, (h,), ring=(n, 4))
    assert mm.launch_counts() == before


def _same_bits_nan(got, want):
    """Bitwise, with NaN at the same places (a NaN's payload aside)."""
    nan = got.isnan()
    assert torch.equal(nan, want.isnan())
    ints = torch.int32 if got.dtype == torch.float32 else torch.int16
    assert torch.equal(got.view(ints)[~nan], want.view(ints)[~nan])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,d", [(16, 157000), (4096, 2010)])
def test_circulant_neumann_ring_special_values_bitwise(cuda, dtype, n, d):
    """Operands as a solve's DIHGP iterates hold them — mostly zeros, a
    share of subnormals — with ±inf and NaN, and D̃ of 1, tiny, zero and
    inf: the ring (which divides in f64) equals the unstaged kernel and
    the plain version bit for bit, NaN at the same places."""
    s = RING_GRAPHS["ring"](n)
    rng = np.random.default_rng(7)

    def operand(seed):
        x = rng.standard_normal((n, d)).astype(np.float32)
        u = rng.random((n, d))
        x[u < 0.8] = 0.0
        sub = rng.integers(1, 2 ** 23, (n, d)).astype(np.uint32).view(
            np.float32)
        x = np.where((u >= 0.8) & (u < 0.82), sub, x)
        x[seed % n, :3] = [np.inf, -np.inf, np.nan]
        return torch.as_tensor(x).to(cuda).to(dtype)
    h, hvp, p = (operand(i) for i in range(3))
    dsc = torch.as_tensor(rng.uniform(1.3, 141.0, (n, 1)),
                          dtype=torch.float32)
    dsc[:4, 0] = torch.tensor([1.0, 1e-30, 0.0, float("inf")])
    dsc = dsc.to(cuda)
    operands = (h, hvp, p, dsc)
    want = _ring_want("neumann", s, operands, dtype)
    item = torch.tensor([], dtype=dtype).element_size()
    plan = mm.neumann_ring_plan(n, 1, 1, itemsize=item)
    ring = _launch_ring("neumann", s, operands, ring=plan)
    with mm.smem_budget(0):
        old = _launch_ring("neumann", s, operands)
    _same_bits_nan(ring, want)
    _same_bits_nan(ring, old)


# ---------------------------------------------------------------------------
# Fault-masked gossip (`MixingOp.masked`): the padded sparse gather on one
# round's degraded tables — row 3's stripe at n ≤ 14,528, row 4's slab
# with the nominal tables' row plan at n = 4096 — bitwise against
# `sparse_mix_padded_ref` on the same tables.
# ---------------------------------------------------------------------------

MASKED_CASES = [("erdos_renyi", 16, 2010), ("erdos_renyi", 16, 157000),
                ("ring", 16, 2010), ("star", 16, 2010),
                ("erdos_renyi", 100, 2010), ("erdos_renyi", 4096, 2010)]


@pytest.mark.parametrize("kind,n,d", MASKED_CASES)
def test_masked_sparse_gather_bitwise(cuda, kind, n, d):
    from repro_torch.faults import FaultSpec, lower_faults
    r = 0.004 if n == 4096 else 0.5
    net = make_network(kind, n, r=r, seed=0)
    op = make_mixing_op(net, device=cuda)
    trace = lower_faults(FaultSpec(drop_prob=0.3, stragglers=(1,),
                                   straggle_prob=1.0, seed=n), net, 3)
    masks = trace.table_masks(op.sparse)
    y = _randn((n, d), torch.float32, cuda, seed=d)
    tier, _ = op._stripe_plan(y, blocks=mm.plan_blocks(False),
                              circulant=False)
    counter = "sparse_mix_matvec_halo" if tier == "halo" \
        else "sparse_mix_matvec"
    for k in range(masks.shape[0]):
        view = op.masked(torch.as_tensor(masks[k], device=cuda))
        for lap in (False, True):
            before = mm.launch_counts()[counter]
            got = view.laplacian(y) if lap else view.mix(y)
            torch.cuda.synchronize()
            assert mm.launch_counts()[counter] == before + 1
            want = ref.sparse_mix_padded_ref(y, view._sp_wself,
                                             view._sp_idx, view._sp_wts, lap)
            _bits_equal(got, want)


def test_masked_all_ones_is_the_padded_gather_bitwise(cuda):
    net = make_network("erdos_renyi", 16, r=0.5, seed=0)
    op = make_mixing_op(net, "sparse_gather_pallas", device=cuda)
    y = _randn((16, 2010), torch.float32, cuda, seed=3)
    view = op.masked(torch.ones(op.sparse.neighbors.shape, device=cuda))
    assert torch.equal(view._sp_wts, op._sp_wts)
    assert torch.equal(view._sp_wself, op._sp_wself)
    _bits_equal(view.mix(y), op.mix(y))
    _bits_equal(view.laplacian(y), op.laplacian(y))


# ---------------------------------------------------------------------------
# The baselines' widths: DGBO's d2² = 4,040,100 columns (rows 1, 1f, 3, 3f
# at n = 16) and DGTBO's d1·d2 = 315,570,000 (row 3 at n = 4, row 1 at
# n = 8, past 2^31 elements), bitwise against the plain versions.
# Operands drawn on the card.
# ---------------------------------------------------------------------------

D_DGBO, D_DGTBO = 2010 * 2010, 157000 * 2010


def _randn_card(shape, dev, seed=0):
    gen = torch.Generator(dev).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev)


@pytest.mark.parametrize("comm", [None, "int8+ef"])
@pytest.mark.parametrize("kind", ["circulant", "sparse"])
def test_dgbo_width_bitwise(cuda, kind, comm):
    n, d = 16, D_DGBO
    net = make_network("ring", n) if kind == "circulant" \
        else make_network("erdos_renyi", n, r=0.5, seed=0)
    y = _randn_card((n, d), cuda, seed=1)
    wire = ()
    hat = None
    if comm is not None:
        from repro_torch.comm import row_quant_params
        hat = 0.5 * _randn_card((n, d), cuda, seed=2)
        wire = row_quant_params(y - hat, 8) + (12345,)
    if kind == "circulant":
        s = circulant_structure(net.W)
        got = mm.circulant_mix_matvec(y, *wire, hat, laplacian=True,
                                      comm=comm, **_tables(s, cuda)) \
            if comm else mm.circulant_mix_matvec(y, laplacian=True,
                                                 **_tables(s, cuda))
        kw = dict(w_self=s.w_self, offsets=s.offsets, weights=s.weights,
                  laplacian=True)
        want = ref.circulant_mix_fused_ref(y, *wire, hat, bits=8, **kw) \
            if comm else ref.circulant_mix_ref(y, **kw)
    else:
        sp = sparse_structure(net.W)
        tables = tuple(torch.as_tensor(a, device=cuda)
                       for a in (sp.w_self, sp.neighbors, sp.weights))
        got = mm.sparse_mix_matvec(y, *tables, *wire, hat, laplacian=True,
                                   comm=comm)
        want = ref.sparse_mix_fused_ref(y, *tables, *wire, hat,
                                        laplacian=True, bits=8) \
            if comm else ref.sparse_mix_padded_ref(y, *tables, True)
    torch.cuda.synchronize()
    for g, w in (zip(got, want) if comm else [(got, want)]):
        _bits_equal(g, w)


def test_dgtbo_width_bitwise(cuda):
    n, d = 4, D_DGTBO
    sp = sparse_structure(make_network("ring", n).W)
    tables = tuple(torch.as_tensor(a, device=cuda)
                   for a in (sp.w_self, sp.neighbors, sp.weights))
    y = _randn_card((n, d), cuda, seed=4)
    before = mm.launch_counts()["sparse_mix_matvec"]
    got = mm.sparse_mix_matvec(y, *tables)
    torch.cuda.synchronize()
    assert mm.launch_counts()["sparse_mix_matvec"] == before + 1
    want = ref.sparse_mix_padded_ref(y, *tables)
    _bits_equal(got, want)


def test_dgtbo_width_ring_past_int32_bitwise(cuda):
    """(8, 315,570,000): 2,524,560,000 elements, past 2^31, on the ring's
    circulant kernel, as chip_smoke's DGTBO solve gossips it."""
    n, d = 8, D_DGTBO
    s = circulant_structure(make_network("ring", n).W)
    y = _randn_card((n, d), cuda, seed=5)
    before = mm.launch_counts()["circulant_mix_matvec"]
    got = mm.circulant_mix_matvec(y, laplacian=False, **_tables(s, cuda))
    torch.cuda.synchronize()
    assert mm.launch_counts()["circulant_mix_matvec"] == before + 1
    want = ref.circulant_mix_ref(y, s.w_self, s.offsets, s.weights)
    del y
    # normal draws hold no NaN: a plain bitwise compare, without
    # `_bits_equal`'s boolean-index copies of 10 GB operands
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    del got, want
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# A serve bucket's job axis (rows 5, 1f, 3f and 5f): each job's columns of
# a job-axis launch bitwise its solo launch on the job's slice and the
# plain version, on every route, for B ∈ {1, 3, 8} and odd in-job widths
# ---------------------------------------------------------------------------

JOB_CASES = [(1, 16, 2011), (3, 16, 2011), (8, 16, 2011), (3, 8, 7),
             (8, 128, 129)]


def _job_slice(t, j, d):
    return t[:, j * d:(j + 1) * d].contiguous()


def _job_inputs(B, n, d, dev, seed=0):
    h, hv, p = (_randn((n, B * d), torch.float32, dev, seed=seed + k)
                for k in range(3))
    rng = np.random.default_rng(seed)
    beta = torch.as_tensor(0.01 + 0.2 * rng.random(B), dtype=torch.float32,
                           device=dev)
    dsc = torch.as_tensor(1.5 + rng.random((n, B)), dtype=torch.float32,
                          device=dev)
    return h, hv, p, beta, dsc


def _job_wire(y, B, bits, hat=None):
    from repro_torch.comm import row_quant_params
    n = y.shape[0]
    q = y if hat is None else y - hat
    zp, sc = row_quant_params(q.reshape(n * B, -1), bits)
    return zp.reshape(n, B).contiguous(), sc.reshape(n, B).contiguous()


def _one_job_launch(counters):
    counts = mm.launch_counts()
    assert sum(counts.values()) == 1, counts
    assert sum(counts[c] for c in counters) == 1, counts


@pytest.mark.parametrize("route", ["planner", "unstaged"])
@pytest.mark.parametrize("B,n,d", JOB_CASES)
def test_job_axis_neumann_step_every_route(cuda, route, B, n, d):
    s = circulant_structure(make_network("ring", n).W)
    kw = _tables(s, cuda)
    h, hv, p, beta, dsc = _job_inputs(B, n, d, cuda)
    budget = 0 if route == "unstaged" else mm.SMEM_BUDGET_BYTES
    with mm.smem_budget(budget):
        mm.reset_launch_counts()
        out = mm.circulant_neumann_step(h, hv, p, dsc, beta=beta, **kw)
        _one_job_launch(("circulant_neumann_step_jobs",
                         "circulant_neumann_step_unstaged_jobs"))
        if route == "unstaged":
            assert mm.launch_counts()[
                "circulant_neumann_step_unstaged_jobs"] == 1
        want = ref.neumann_step_ref(h, hv, p, dsc, w_self=s.w_self,
                                    offsets=s.offsets, weights=s.weights,
                                    beta=beta)
        _bits_equal(out, want)
        for j in range(B):
            solo = mm.circulant_neumann_step(
                _job_slice(h, j, d), _job_slice(hv, j, d),
                _job_slice(p, j, d), dsc[:, j:j + 1].contiguous(),
                beta=float(beta[j]), **kw)
            _bits_equal(_job_slice(out, j, d), solo)


@pytest.mark.parametrize("route", ["planner", "unstaged"])
@pytest.mark.parametrize("comm", ["int8", "int4", "int8+ef", "int4+ef"])
@pytest.mark.parametrize("graph", ["ring", "erdos_renyi"])
@pytest.mark.parametrize("B,n,d", JOB_CASES)
def test_job_axis_comm_gossip_every_route(cuda, route, comm, graph, B, n,
                                          d):
    bits, ef = int(comm[3]), comm.endswith("+ef")
    y, hat, _, _, _ = _job_inputs(B, n, d, cuda, seed=B)
    hat = 0.1 * hat if ef else None
    zp, sc = _job_wire(y, B, bits, hat)
    seeds = [int(s) for s in np.random.default_rng(B).integers(
        0, 2 ** 31 - 1, B)]
    if graph == "ring":
        s = circulant_structure(make_network("ring", n).W)
        kw = _tables(s, cuda)
        counters = ("circulant_mix_matvec_comm_jobs",
                    "circulant_mix_matvec_comm_unstaged_jobs")

        def launch(yy, z, c, sd, hh):
            return mm.circulant_mix_matvec(yy, z, c, sd, hh, comm=comm,
                                           laplacian=True, **kw)

        def plain(yy, z, c, sd, hh):
            return ref.circulant_mix_fused_ref(
                yy, z, c, sd, hh, w_self=s.w_self, offsets=s.offsets,
                weights=s.weights, laplacian=True, bits=bits)
    else:
        sp = sparse_structure(make_network("erdos_renyi", n, r=0.5,
                                           seed=1).W)
        tabs = [torch.as_tensor(a, device=cuda)
                for a in (sp.w_self, sp.neighbors, sp.weights)]
        counters = ("sparse_mix_matvec_comm_jobs",
                    "sparse_mix_matvec_comm_unstaged_jobs")

        def launch(yy, z, c, sd, hh):
            return mm.sparse_mix_matvec(yy, *tabs, z, c, sd, hh, comm=comm)

        def plain(yy, z, c, sd, hh):
            return ref.sparse_mix_fused_ref(yy, *tabs, z, c, sd, hh,
                                            bits=bits)
    budget = 0 if route == "unstaged" else mm.SMEM_BUDGET_BYTES
    with mm.smem_budget(budget):
        mm.reset_launch_counts()
        out = launch(y, zp, sc, seeds, hat)
        _one_job_launch(counters)
        if route == "unstaged":
            assert mm.launch_counts()[counters[1]] == 1
        want = plain(y, zp, sc, seeds, hat)
        for got, w in (zip(out, want) if ef else ((out, want),)):
            _bits_equal(got, w)
        for j in range(B):
            solo = launch(_job_slice(y, j, d), zp[:, j:j + 1].contiguous(),
                          sc[:, j:j + 1].contiguous(), seeds[j],
                          None if hat is None else _job_slice(hat, j, d))
            pairs = zip(out, solo) if ef else ((out, solo),)
            for got, w in pairs:
                _bits_equal(_job_slice(got, j, d), w)


@pytest.mark.parametrize("cols", [None, 0, 32, 128])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("B,n,d", JOB_CASES)
def test_job_axis_comm_neumann_every_route(cuda, cols, bits, B, n, d):
    s = circulant_structure(make_network("ring", n).W)
    kw = _tables(s, cuda)
    h, hv, p, beta, dsc = _job_inputs(B, n, d, cuda, seed=11)
    zp, sc = _job_wire(h, B, bits)
    seeds = [7 + 13 * j for j in range(B)]
    comm = f"int{bits}"
    mm.reset_launch_counts()
    out = mm._neumann_comm_launch(h, hv, p, dsc, zp, sc, seeds, beta=beta,
                                  comm=comm, cols=cols, **kw)
    _one_job_launch(("circulant_neumann_step_comm_jobs",
                     "circulant_neumann_step_comm_unstaged_jobs"))
    if cols == 0:
        assert mm.launch_counts()[
            "circulant_neumann_step_comm_unstaged_jobs"] == 1
    want = ref.neumann_step_fused_ref(h, hv, p, dsc, zp, sc, seeds,
                                      w_self=s.w_self, offsets=s.offsets,
                                      weights=s.weights, beta=beta,
                                      bits=bits)
    _bits_equal(out, want)
    for j in range(B):
        solo = mm._neumann_comm_launch(
            _job_slice(h, j, d), _job_slice(hv, j, d), _job_slice(p, j, d),
            dsc[:, j:j + 1].contiguous(), zp[:, j:j + 1].contiguous(),
            sc[:, j:j + 1].contiguous(), seeds[j], beta=float(beta[j]),
            comm=comm, cols=cols, **kw)
        _bits_equal(_job_slice(out, j, d), solo)


# rows 2f and 4f on a job axis: (jobs, n, in-job width); odd widths put a
# job boundary inside row 2f's 4-column vectors and inside row 4f's slabs
HALO_JOB_CASES = [(1, 128, 2010), (3, 128, 2011), (8, 128, 2010),
                  (8, 128, 1003), (5, 16, 7), (64, 16, 3), (8, 128, 157000)]


@pytest.mark.parametrize("comm", ["int8", "int4", "int8+ef", "int4+ef"])
@pytest.mark.parametrize("B,n,d", HALO_JOB_CASES)
def test_job_axis_circulant_halo_comm(cuda, comm, B, n, d):
    """Row 2f on a job axis (the fused circulant halo at the planner's
    bn): one launch, counted as `circulant_mix_matvec_halo_comm_jobs`,
    output and EF payload bitwise the plain version and each job's solo
    halo launch over its own d columns; a 64-job seed table too."""
    bits, ef = int(comm[3]), comm.endswith("+ef")
    s = circulant_structure(make_network("ring", n).W)
    kw = dict(w_self=s.w_self, offsets=s.offsets, weights=s.weights,
              laplacian=True, bn=n // 2, comm=comm)
    y, hat, _, _, _ = _job_inputs(B, n, d, cuda, seed=3 * B)
    hat = 0.1 * hat if ef else None
    zp, sc = _job_wire(y, B, bits, hat)
    seeds = [int(v) for v in np.random.default_rng(B + 1).integers(
        0, 2 ** 31 - 1, B)]
    mm.reset_launch_counts()
    out = mm.circulant_mix_matvec_halo(y, zp, sc, seeds, hat, **kw)
    _one_job_launch(("circulant_mix_matvec_halo_comm_jobs",))
    want = ref.circulant_mix_fused_ref(
        y, zp, sc, seeds, hat, w_self=s.w_self, offsets=s.offsets,
        weights=s.weights, laplacian=True, bits=bits)
    for got, w in (zip(out, want) if ef else ((out, want),)):
        _bits_equal(got, w)
    for j in range(B):
        solo = mm.circulant_mix_matvec_halo(
            _job_slice(y, j, d), zp[:, j:j + 1].contiguous(),
            sc[:, j:j + 1].contiguous(), seeds[j],
            None if hat is None else _job_slice(hat, j, d), **kw)
        for got, w in (zip(out, solo) if ef else ((out, solo),)):
            _bits_equal(_job_slice(got, j, d), w)
    del out, want
    torch.cuda.empty_cache()


# the planner's slab (c = 8: at n = 128 its narrower slabs need more
# shared memory than it, their table stage being the larger) and the row
# tiles at every case; c = 4, 2, 1 at n = 4096 (ER r = 0.004, k = 36),
# where a lower budget reaches them
SPARSE_HALO_JOB_CASES = [
    (route, *case) for case in HALO_JOB_CASES for route in (8, None)] + [
    (route, B, 4096, d) for route in (4, 2, 1)
    for B, d in ((3, 1001), (8, 2010))]


@pytest.mark.parametrize("comm", ["int8", "int4"])
@pytest.mark.parametrize("route,B,n,d", SPARSE_HALO_JOB_CASES)
def test_job_axis_sparse_halo_comm_every_route(cuda, route, comm, B, n, d):
    """Row 4f on a job axis, on every route: the slab at c = 8 (the
    planner's at n = 128), at c = 4, 2, 1 under a lower budget
    (`smem_budget`, at n = 4096), and the row tiles (None).  One launch counted as
    the route's `*_jobs`, bitwise the plain version and each job's solo
    launch on the same route."""
    bits = int(comm[3])
    tabs = _er_tables(n, cuda, r=0.5 if n <= 128 else 0.004)
    y, _, _, _, _ = _job_inputs(B, n, d, cuda, seed=5 * B)
    y[1, :7] = float("nan")
    zp, sc = _job_wire(y, B, bits)
    seeds = [int(v) for v in np.random.default_rng(B + 2).integers(
        0, 2 ** 31 - 1, B)]
    if route == 8:
        budget = mm.SMEM_BUDGET_BYTES
    elif route is None:      # under every slab's shared memory
        budget = min(mm.slab_smem_bytes(n, c) for c in mm.SLAB_COLS) - 1
    else:
        budget = mm.slab_smem_bytes(n, route)
    counter = ("sparse_mix_matvec_halo_comm_jobs" if route is not None
               else "sparse_mix_matvec_halo_comm_rows_jobs")
    kw = dict(laplacian=True, bn=min(n // 2, 64), comm=comm)
    with mm.smem_budget(budget):
        assert mm.plan_slab_cols(n) == route
        mm.reset_launch_counts()
        out = mm.sparse_mix_matvec_halo(y, *tabs, zp, sc, seeds, **kw)
        _one_job_launch((counter,))
        _bits_equal(out, ref.sparse_mix_fused_ref(
            y, *tabs, zp, sc, seeds, laplacian=True, bits=bits))
        for j in range(B):
            solo = mm.sparse_mix_matvec_halo(
                _job_slice(y, j, d), *tabs, zp[:, j:j + 1].contiguous(),
                sc[:, j:j + 1].contiguous(), seeds[j], **kw)
            _bits_equal(_job_slice(out, j, d), solo)
    del out
    torch.cuda.empty_cache()


def test_job_axis_refusals_on_the_card(cuda):
    """The C entry points refuse an axis that does not fit the operand
    (the plain Neumann step's and the fused halo's)."""
    s = circulant_structure(make_network("ring", 8).W)
    kw = _tables(s, cuda)
    h, hv, p, beta, dsc = _job_inputs(3, 8, 5, cuda)
    out = torch.empty_like(h)
    for jobs, djob in ((3, 4), (0, 15), (65, 1)):
        with pytest.raises(RuntimeError, match="launch failed"):
            mm._LIB.launch("circulant_neumann_jobs", cuda, h.data_ptr(),
                           hv.data_ptr(), p.data_ptr(), dsc.data_ptr(),
                           out.data_ptr(), 8, 15, 0, s.w_self, 2,
                           kw["offsets"].data_ptr(), kw["weights"].data_ptr(),
                           beta.data_ptr(), jobs, djob)
    zp, sc = _job_wire(h, 3, 8)
    soff, wts = mm._signed_tables(8, tuple(s.offsets), tuple(s.weights),
                                  cuda)
    table = mm._seed_table([1, 2, 3])
    for jobs, djob in ((3, 4), (0, 15), (65, 1)):
        with pytest.raises(RuntimeError, match="launch failed"):
            mm._LIB.launch("circulant_mix_halo_comm_jobs", cuda,
                           h.data_ptr(), out.data_ptr(), None, None,
                           zp.data_ptr(), sc.data_ptr(),
                           __import__("ctypes").addressof(table), jobs,
                           djob, 255.0, 8, 15, s.w_self, len(s.offsets),
                           soff.data_ptr(), wts.data_ptr(), 0, 4, 1, 1, 1,
                           mm.halo_smem_bytes(6) * 2)


# ---------------------------------------------------------------------------
# The admission loop's scheduler thread launches the kernels
# ---------------------------------------------------------------------------

def _admission_spec(seed, K=4, comm="int8+ef"):
    from repro_torch.serve import JobSpec
    return JobSpec("quadratic", {"n": 8, "d1": 4, "d2": 8, "seed": seed},
                   SolverSpec(K=K, M=3, U=2, dihgp="matrix_free",
                              curvature=6.0,
                              schedule=ScheduleSpec(alpha=0.05, beta=0.1),
                              comm=CommSpec(comm)), seed=seed)


def test_admission_thread_launches_on_the_card(cuda, monkeypatch):
    """The scheduler thread launches every kernel of its buckets (the
    job-axis counters move), its first launch loads the kernel library
    once, under the build lock, on that thread; each job equals the
    same jobs run synchronously bit for bit and its solo solve within
    the card's serve band (rtol 1e-4 / atol 1e-5)."""
    import threading

    from repro_torch.kernels import _build
    from repro_torch.serve import build_network, build_problem
    from repro_torch.serve.admission import AdmissionLoop
    specs = [_admission_spec(s, K=4 if s % 2 else 8) for s in range(5)]
    sync = AdmissionLoop(chunk_rounds=2, max_width=4)
    sync.submit(specs)
    want = {r.job_id: r for r in sync.run()}
    loads = []
    real_build = _build.build

    def build(name):
        loads.append((name, threading.current_thread().name,
                      _build._LOCK.locked()))
        return real_build(name)
    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setitem(_build._LIBS, "mixing_matvec", None)
    del _build._LIBS["mixing_matvec"]
    mm.reset_launch_counts()
    with AdmissionLoop(chunk_rounds=2, max_width=4) as loop:
        ids = loop.submit(specs[:3])
        ids += loop.submit(specs[3:])
        got = {r.job_id: r for r in loop.as_completed(ids, timeout=600)}
    assert loads == [("mixing_matvec", "admission-loop", True)]
    counts = mm.launch_counts()
    assert sum(counts[c] for c in mm.JOB_COUNTERS) > 0, counts
    for jid, spec in zip(ids, specs):
        r = got[jid]
        assert torch.equal(r.x, want[jid].x) and torch.equal(r.y,
                                                            want[jid].y)
        ref = solve(build_problem(spec, cuda), build_network(spec),
                    spec.config, seed=spec.seed)
        torch.testing.assert_close(r.x.to(cuda), ref.x, rtol=1e-4,
                                   atol=1e-5)
        assert r.wire_bytes == ref.ledger.total_bytes


def test_admission_thread_kernel_error_reaches_result(cuda, monkeypatch):
    """A kernel launch the C entry point refuses on the scheduler thread
    (a job axis of 0 jobs) fails the run: `result()` and `stop()` raise
    with the launch error as the cause; the job is never reported
    finished."""
    from repro_torch.serve.admission import AdmissionLoop
    real = mm._LIB.launch
    refused = []

    def launch(entry, dev, *args):
        if entry == "circulant_mix_comm_jobs":
            refused.append(entry)
            args = args[:7] + (0,) + args[8:]
        return real(entry, dev, *args)
    monkeypatch.setattr(mm._LIB, "launch", launch)
    loop = AdmissionLoop(chunk_rounds=2, max_width=2, max_chunk_retries=0)
    loop.start()
    (jid,) = loop.submit(_admission_spec(0))
    with pytest.raises(RuntimeError, match="was not completed") as err:
        loop.result(jid, timeout=600)
    assert "launch failed" in str(err.value.__cause__)
    assert refused and jid not in loop._results
    with pytest.raises(RuntimeError, match="thread died"):
        loop.stop()
