"""The sharded tier's `LocalRing` on the card: every gossip through the
circulant CUDA kernels (rows 1 and 1f at n = 16, rows 2 and 2f at n =
4096), each launch counted, against the same ring on the CPU, whose
wrappers run the kernels' plain versions.  Needs a CUDA device and
skips without one; on the H100:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_sharded.py

The kernels equal their plain versions bit for bit on the card, and the
plain versions' elementwise arithmetic rounds alike on both devices, so
gossips are held bitwise; solves go through cuBLAS in the autodiff
terms and hold to rtol 1e-4 / atol 1e-5, as the reference tier's card
against CPU tests.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.comm import channel_init, parse_comm_spec
from repro_torch.core import problems as tp
from repro_torch.distributed import LocalRing, ring_laplacian_c, ring_mix_c
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.solve import sharded_spec, solve

pytestmark = pytest.mark.gpu

COMMS = ("identity", "int8", "int8+ef", "int4", "int4+ef", "bf16")


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on "
                    "the card")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def _tree(n, dev):
    rng = np.random.default_rng(0)
    return {"w": torch.as_tensor(rng.standard_normal((n, 40, 7)).astype(
        np.float32), device=dev),
            "b": torch.as_tensor(rng.standard_normal((n, 9)).astype(
                np.float32), device=dev)}


def _counter(n: int, comm: str) -> str:
    halo = n >= 4096
    if comm in ("identity", "bf16"):
        return "circulant_mix_matvec_halo" if halo else None
    return "circulant_mix_matvec_halo_comm" if halo \
        else "circulant_mix_matvec_comm"


@pytest.mark.parametrize("n", [16, 4096])
@pytest.mark.parametrize("comm", COMMS)
def test_local_ring_gossips_on_the_kernels(cuda, n, comm):
    pol = parse_comm_spec(comm)
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        ring = LocalRing(n, device=dev)
        val = _tree(n, dev)
        st = channel_init(pol, "ch", val, 99)
        reset_launch_counts()
        m1, st = ring_mix_c(val, ring, pol, st)
        l2, st = ring_laplacian_c(val, ring, pol, st)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            counts = {k: v for k, v in launch_counts().items() if v}
            # two gossips of two leaves
            assert sum(counts.values()) == 4, counts
            name = _counter(n, comm)
            if name is not None:
                assert counts == {name: 4}
        outs[dev.type] = (m1, l2, st.hat)
    for got, want in zip(outs["cuda"][:2], outs["cpu"][:2]):
        for k in got:
            assert torch.equal(got[k].cpu(), want[k]), k
    if pol.ef:
        for k in outs["cpu"][2]:
            assert torch.equal(outs["cuda"][2][k].cpu(), outs["cpu"][2][k])


@pytest.mark.parametrize("comm", ["identity", "int8+ef"])
def test_local_ring_solve_on_the_card(cuda, comm):
    n, K = 16, 3
    spec = sharded_spec(alpha=0.05, beta=0.1, M=4, U=3, K=K, curvature=6.0,
                        comm=comm)
    res = {}
    for dev in ("cuda", "cpu"):
        prob = tp.quadratic_bilevel(n, 5, 12, seed=0, device=dev)
        y0 = (0.01 * np.random.default_rng(0).standard_normal(
            (n, 12))).astype(np.float32)
        reset_launch_counts()
        res[dev] = solve(prob, None, spec, mesh=LocalRing(n, device=dev),
                         y0=y0)
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = {k: v for k, v in launch_counts().items() if v}
            gossips = K * (4 + 3 + 1)       # + 1 consensus mix a round
            assert sum(counts.values()) == gossips + K, counts
    for name in ("x", "y"):
        torch.testing.assert_close(getattr(res["cuda"], name).cpu(),
                                   getattr(res["cpu"], name), rtol=1e-4,
                                   atol=1e-5)
    assert res["cuda"].ledger.total_bytes == res["cpu"].ledger.total_bytes
