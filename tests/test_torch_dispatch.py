"""Which tier a gossip takes, the float32 scope of the entry points, and
the column-slab planner of the compressed sparse gather, on the CPU.

* `MixingOp` resolves its kernel tier as `repro`'s `_resolve` does: "auto"
  takes the kernels while the switch is on (`kernel_mode`, read at the
  call) and never on a skewed graph's CSR path; an explicit "circulant"
  or "sparse_gather" stays on the plain PyTorch path, which autograd
  differentiates; the `*_pallas` names always take the kernels.  On a CPU
  tensor the kernel tier runs the wrappers' plain versions, so the tier
  is read from `_kernel_tier()` and `_fused_plan` here (the launches are
  counted on the card, `tests/test_torch_gpu_kernels.py`).
* `strict_f32` turns TF32 off inside an entry point and gives the
  caller's two flags back on exit, exception or not.
* `plan_slab_cols` picks the slab width from n and the shared-memory
  budget; the table stage after the slab starts on 16 bytes whatever n
  and c; `smem_budget` drives every route at n = 4096 and restores the
  budget.

Tolerances: the plain and the kernel tier compute the same sums in the
same order on the CPU (1e-6); gradients against W·g (1e-6).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.kernels import ops as jops
from repro.topology import MixingOp as JMixingOp
from repro.topology import make_network as j_make_network

from repro_torch import strict_f32
from repro_torch.core import problems as tp
from repro_torch.kernels import mixing_matvec as mm
from repro_torch.kernels import ops as tops
from repro_torch.solve import SolverSpec, solve
from repro_torch.topology import MixingOp, make_mixing_op, make_network

NETS = [("ring", {}), ("erdos_renyi", {"r": 0.5, "seed": 0}), ("star", {})]
BACKENDS = {"ring": ("auto", "circulant", "circulant_pallas",
                     "sparse_gather", "sparse_gather_pallas", "dense"),
            "erdos_renyi": ("auto", "sparse_gather", "sparse_gather_pallas",
                            "dense"),
            "star": ("auto", "sparse_gather", "sparse_gather_pallas",
                     "dense")}
CASES = [(kind, kw, b) for kind, kw in NETS for b in BACKENDS[kind]]


@pytest.fixture
def tf32_on(monkeypatch):
    """Both TF32 flags set by the caller, given back after the test."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)


# -- the kernel tier, against repro's resolution ------------------------

@pytest.mark.parametrize("kind,kw,backend", CASES)
@pytest.mark.parametrize("enabled", [True, False])
def test_kernel_tier_follows_repro_resolution(kind, kw, backend, enabled):
    """At a shape every `repro` tier takes (n % 8 == 0, d % 128 == 0),
    the port takes its kernels exactly where `repro` takes its Pallas
    kernels, for the plain gossip and for the comm-fused one."""
    n = 16
    jnet, tnet = j_make_network(kind, n, **kw), make_network(kind, n, **kw)
    jop = JMixingOp(jnet.W, backend=backend, comm="int8")
    top = MixingOp(tnet.W, backend=backend, comm="int8", device="cpu")
    assert top.requested == jop.requested == backend
    jflat = jnp.zeros((n, 128), jnp.float32)
    tflat = torch.zeros((n, 128))
    with jops.pallas_mode(enabled, interpret=True), \
            tops.kernel_mode(enabled):
        j_kernel = jop._resolve(jop.backend, jflat).endswith("_pallas")
        assert top._kernel_tier() == j_kernel
        assert (top._fused_plan(tflat) is None) \
            == (jop._fused_plan(jflat) is None)


@pytest.mark.parametrize("kind,kw,backend", [
    ("ring", {}, "circulant"), ("erdos_renyi", {"r": 0.5, "seed": 0},
                                "sparse_gather"),
    ("star", {}, "sparse_gather"), ("ring", {}, "dense")])
def test_explicit_backends_backpropagate(kind, kw, backend):
    """An explicit XLA-named backend stays on the plain path whatever the
    switch says, so autograd runs through it: the gradient of
    ⟨g, W·y⟩ is Wᵀ·g, and of ⟨g, (I−W)·y⟩ is g − Wᵀ·g."""
    n, d = 16, 7
    op = make_mixing_op(make_network(kind, n, **kw), backend, device="cpu")
    assert not op._kernel_tier()
    rng = np.random.default_rng(0)
    g = torch.as_tensor(rng.standard_normal((n, d)), dtype=torch.float32)
    W = torch.as_tensor(make_network(kind, n, **kw).W, dtype=torch.float32)
    for lap in (False, True):
        y = torch.as_tensor(rng.standard_normal((n, d)),
                            dtype=torch.float32).requires_grad_()
        out = op.laplacian(y) if lap else op.mix(y)
        (out * g).sum().backward()
        want = g - W.T @ g if lap else W.T @ g
        torch.testing.assert_close(y.grad, want, atol=1e-6, rtol=0)


def test_auto_takes_the_kernels_only_while_the_switch_is_on():
    """"auto" reads the switch at each gossip: on, the kernel tier (whose
    wrappers refuse an operand that requires grad, as the kernels have no
    backward); off, the plain path, which backpropagates.  Both give the
    same values."""
    op = make_mixing_op(make_network("erdos_renyi", 16, r=0.5, seed=0),
                        device="cpu")
    y = torch.as_tensor(np.random.default_rng(1).standard_normal((16, 9)),
                        dtype=torch.float32)
    assert op._kernel_tier()
    kernel_tier = op.mix(y)
    with pytest.raises(ValueError, match="requires grad"):
        op.mix(y.clone().requires_grad_())
    with tops.kernel_mode(False):
        assert not op._kernel_tier()
        yg = y.clone().requires_grad_()
        plain = op.mix(yg)
        plain.sum().backward()
        assert yg.grad is not None
    assert op._kernel_tier()
    torch.testing.assert_close(plain.detach(), kernel_tier, atol=1e-6,
                               rtol=0)


def test_skewed_graphs_never_take_the_gather_kernel():
    """The star's padded table is n·k_max ≫ nnz: "auto" keeps the CSR
    path even with the switch on (as `repro`), and only the explicit
    `sparse_gather_pallas` name takes the kernel."""
    net = make_network("star", 16)
    auto = make_mixing_op(net, device="cpu")
    assert auto.backend == "sparse_gather" and not auto._sp_use_padded
    with tops.kernel_mode(True):
        assert not auto._kernel_tier()
        assert auto._fused_plan(torch.zeros(16, 8)) is None
    assert make_mixing_op(net, "sparse_gather_pallas",
                          device="cpu")._kernel_tier()


@pytest.mark.parametrize("kind,kw,backend", [
    ("ring", {}, "circulant"),
    ("erdos_renyi", {"r": 0.5, "seed": 0}, "sparse_gather")])
def test_explicit_backend_matches_the_kernel_tier(kind, kw, backend):
    """The plain tier of an explicit backend computes what the kernel
    tier of "auto" computes: the mix, the Laplacian and the Neumann step
    (composed on the plain tier, fused on the circulant kernel tier)."""
    net = make_network(kind, 16, **kw)
    plain = make_mixing_op(net, backend, device="cpu")
    auto = make_mixing_op(net, device="cpu")
    rng = np.random.default_rng(2)
    h, hvp, p = (torch.as_tensor(rng.standard_normal((16, 11)),
                                 dtype=torch.float32) for _ in range(3))
    dsc = torch.full((16, 1), 2.5)
    for fn in ("mix", "laplacian"):
        torch.testing.assert_close(getattr(plain, fn)(h),
                                   getattr(auto, fn)(h), atol=1e-6, rtol=0)
    torch.testing.assert_close(plain.neumann_step(h, hvp, p, dsc, 0.2),
                               auto.neumann_step(h, hvp, p, dsc, 0.2),
                               atol=1e-6, rtol=0)


# -- strict_f32 -----------------------------------------------------------

def _flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def test_strict_f32_restores_the_flags_on_exit(tf32_on):
    with strict_f32():
        assert _flags() == (False, False)
    assert _flags() == (True, True)


def test_strict_f32_restores_the_flags_after_an_exception(tf32_on):
    with pytest.raises(KeyError):
        with strict_f32():
            assert _flags() == (False, False)
            raise KeyError("inside")
    assert _flags() == (True, True)


def test_strict_f32_keeps_mixed_flags_and_nests(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    with strict_f32():
        with strict_f32():
            assert _flags() == (False, False)
        assert _flags() == (False, False)
    assert _flags() == (True, False)


def test_entry_points_leave_the_callers_flags(tf32_on):
    """solve, MixingOp's gossips and `kernels.ops` run inside strict_f32:
    TF32 is off while they run, and the caller's flags are back after."""
    seen = []

    def metrics(*args):
        seen.append(_flags())
        return {"probe": torch.zeros(())}
    prob = tp.quadratic_bilevel(4, 3, 3, device="cpu")
    res = solve(prob, make_network("ring", 4), SolverSpec(K=2, M=1, U=1),
                device="cpu", metrics_fn=metrics)
    assert res.x.shape == (4, 3)
    assert seen == [(False, False)] * 2
    assert _flags() == (True, True)
    op = make_mixing_op(make_network("ring", 8), device="cpu")
    op.mix(torch.zeros(8, 3))
    st = op.comm_channel("c", torch.zeros(8, 3))
    op.laplacian_c(torch.zeros(8, 3), st)
    assert _flags() == (True, True)
    x = torch.zeros((1, 128, 1, 16))
    tops.attention(x, x, x)
    tops.wkv(x, x, x, x, torch.zeros(1, 16), chunk=64)
    tops.ring_laplacian(torch.zeros(8, 128), 0.5, 0.25)
    assert _flags() == (True, True)


# -- the column-slab planner ----------------------------------------------

@pytest.mark.parametrize("n,cols", [(16, 8), (4096, 8), (58112, None),
                                    (65536, None), (33536, 1),
                                    (33537, None), (20000, 1), (10000, 2),
                                    (6000, 4)])
def test_slab_planner_picks_the_widest_slab_that_fits(n, cols):
    """c = 8 at n = 4096 (one 32-byte sector per f32 row, 212,992 bytes
    with the table stage); narrower slabs as n grows; None, the row-tiled
    kernel, where not even c = 1 fits beside the stage."""
    assert mm.plan_slab_cols(n) == cols
    if cols is not None:
        assert mm.slab_smem_bytes(n, cols) <= mm.SMEM_BUDGET_BYTES
        wider = [c for c in mm.SLAB_COLS if c > cols]
        assert all(mm.slab_smem_bytes(n, c) > mm.SMEM_BUDGET_BYTES
                   for c in wider)
    assert mm.slab_smem_bytes(4096, 8) == 212_992


def test_slab_planner_reads_the_budget_at_the_call(monkeypatch):
    monkeypatch.setattr(mm, "SMEM_BUDGET_BYTES", 120_000)
    assert mm.plan_slab_cols(4096) == 1
    monkeypatch.setattr(mm, "SMEM_BUDGET_BYTES", 100_000)
    assert mm.plan_slab_cols(4096) is None


@pytest.mark.parametrize("n", [4096, 4097, 4098, 4099, 33535])
@pytest.mark.parametrize("cols", [8, 4, 2, 1])
def test_slab_stage_starts_on_16_bytes(n, cols):
    """The table stage takes 16-byte copies: the slab before it is
    rounded up to whole 16-byte chunks (an odd n at c = 2, or n % 4 != 0
    at c = 1, would leave it 4 or 8 bytes off)."""
    stage = mm.slab_smem_bytes(0, cols)
    slab = mm.slab_smem_bytes(n, cols) - stage
    assert slab % 16 == 0 and n * cols * 4 <= slab < n * cols * 4 + 16


@pytest.mark.parametrize("route", [8, 4, 2, 1, None])
def test_smem_budget_drives_every_route_at_n_4096(route):
    """A budget of exactly the route's slab gives that slab; one byte
    under c = 1's gives None, the row-tiled kernel; the planner's budget
    comes back on exit, exception or not."""
    n, saved = 4096, mm.SMEM_BUDGET_BYTES
    budget = (mm.slab_smem_bytes(n, route) if route is not None
              else mm.slab_smem_bytes(n, 1) - 1)
    with mm.smem_budget(budget):
        assert mm.plan_slab_cols(n) == route
        # the row-tiled kernel's (64, 128) f32 tile still fits
        assert mm.halo_smem_bytes(64) <= mm.SMEM_BUDGET_BYTES
    assert mm.SMEM_BUDGET_BYTES == saved
    with pytest.raises(RuntimeError):
        with mm.smem_budget(budget):
            raise RuntimeError
    assert mm.SMEM_BUDGET_BYTES == saved
