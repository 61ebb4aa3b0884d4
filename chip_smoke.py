#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and hold every
kernel on that path against its plain PyTorch version.

    python3 chip_smoke.py        # from the repository root, one H100

Phases, in order (any failure exits non-zero before the last line):
  1. card    — nvidia-smi name and power limit, torch's device name/count;
  2. build   — compile src/repro_torch/kernels/csrc/*.cu with nvcc;
  3. kernels — each kernel vs its plain version on the card at the main
               path's shapes, with timings (CUDA events), the plain
               version's and a one-call PyTorch yardstick's times, and
               the bytes/operations bound;
  4. main    — `repro_torch.solve` on the paper's §6.2 hyper-
               representation MLP at its published widths (d=784,
               hidden=200: d1=157,000, d2=2,010; n=16 agents) on a ring
               (circulant + Neumann kernels) and an Erdős–Rényi graph
               (sparse-gather kernel), with exact launch counts, finite
               metrics and agreement with the same run on the CPU;
  5. the kernel list as one JSON line, then the device JSON line last.

Imports torch and the port only; needs no network.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
L2_BYTES = 50 * 2 ** 20

N_AGENTS = 16
D_IN, HIDDEN, N_CLASSES, M_PER = 784, 200, 10, 30
D1, D2 = D_IN * HIDDEN + HIDDEN, HIDDEN * N_CLASSES + N_CLASSES
K, M, U = 5, 5, 3

# tolerances: f32 kernels vs their plain versions differ only by FMA
# contraction (≤ a few ulp of outputs of size ≤ ~10); bf16 outputs are
# rounded from f32 accumulators, so they may differ by one bf16 ulp.
F32_TOL = 1e-5
BF16_REL_TOL = 2.0 ** -7
# end to end, GPU vs CPU: cuBLAS and CPU reductions in the autodiff
# terms sum in other orders, amplified over K rounds of the outer loop
E2E_RTOL, E2E_ATOL = 1e-3, 1e-4


def cuda_ms(torch, fn, pool, iters=200, warmup=10) -> float:
    """Mean ms per call of fn(operands) over `iters` launches (CUDA
    events), cycling through `pool` (see `operand_pool`)."""
    for i in range(warmup):
        fn(pool[i % len(pool)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(pool[i % len(pool)])
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(torch, fn, pool, symbol: str, iters=50) -> float:
    """Mean device time (ms) of the one CUDA kernel named like `symbol`
    that fn launches, from torch.profiler: the kernel alone, without the
    host's launch cost that `cuda_ms` includes.  The profiler may miss
    the first launch of its window, so the mean is over those it saw."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(pool[i % len(pool)])
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if symbol in e.key
            and getattr(e, "self_device_time_total", 0) > 0]
    count = sum(e.count for e in hits)
    if not iters - 2 <= count <= iters:
        raise AssertionError(f"profiler saw {count} launches of {symbol}, "
                             f"expected {iters}")
    return sum(e.self_device_time_total for e in hits) / count / 1e3


def operand_pool(torch, make, nbytes: int):
    """Copies of the operands to cycle through: enough to exceed 3× the
    L2 cache, so operands come from HBM, but at most 64.  The cap binds
    for operands under ~2.4 MB (the (16, 2010) rows: 64 copies are
    ~4-33 MB and stay in L2, as the main path's freshly written d2
    operands do); those times are launch-latency readings."""
    copies = max(1, min(64, math.ceil(3 * L2_BYTES / max(nbytes, 1))))
    return [make() for _ in range(copies)]


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(name, got, want, dtype_name) -> float:
    err = (got.float() - want.float()).abs().max().item()
    if dtype_name == "float32":
        tol = F32_TOL
    else:
        tol = BF16_REL_TOL * want.float().abs().max().item()
    status = "ok" if err <= tol else "FAIL"
    print(f"  {name}: max_abs_err={err:.3e} tol={tol:.3e} {status}")
    if err > tol:
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


def kernel_phase(torch, results: dict) -> None:
    from repro_torch.kernels import mixing_matvec as mm
    from repro_torch.kernels import ref
    from repro_torch.topology import make_network
    from repro_torch.topology.structure import (circulant_structure,
                                                sparse_structure)

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)

    def ring_case(n):
        s = circulant_structure(make_network("ring", n).W)
        off, w = mm.circulant_tables(n, s.offsets, s.weights, dev)
        return s, dict(w_self=s.w_self, offsets=off, weights=w)

    def er_case(n):
        net = make_network("erdos_renyi", n, r=0.5, seed=0)
        sp = sparse_structure(net.W)
        tabs = (torch.as_tensor(sp.w_self, device=dev),
                torch.as_tensor(sp.neighbors, device=dev),
                torch.as_tensor(sp.weights, device=dev))
        return net, sp, tabs

    shapes = [(N_AGENTS, D2), (N_AGENTS, D1)]
    dtypes = [("float32", torch.float32), ("bfloat16", torch.bfloat16)]

    def record(kname, key, row):
        results.setdefault(kname, {})[key] = row

    # -- circulant_mix_matvec ------------------------------------------
    print("kernel circulant_mix_matvec (ring W·Y and (I−W)·Y)")
    for n, d in shapes + [(128, D1)]:
        s, tabs = ring_case(n)
        I_minus = torch.eye(n, device=dev) - torch.as_tensor(
            make_network("ring", n).W, dtype=torch.float32, device=dev)
        W_dense = torch.as_tensor(make_network("ring", n).W,
                                  dtype=torch.float32, device=dev)
        for dname, dt in (dtypes if n == N_AGENTS else dtypes[:1]):
            item = torch.tensor([], dtype=dt).element_size()
            pool = operand_pool(torch, lambda: torch.randn(
                (n, d), generator=gen, device=dev).to(dt), n * d * item)
            for lap in (False, True):
                kw = dict(tabs, laplacian=lap)
                y = pool[0]
                got = mm.circulant_mix_matvec(y, **kw)
                want = ref.circulant_mix_ref(
                    y.float(), s.w_self, s.offsets, s.weights,
                    lap).to(dt)
                torch.cuda.synchronize()
                tag = f"({n}, {d}) {dname} laplacian={lap}"
                err = check(tag, got, want, dname)
                def launch(t):
                    return mm.circulant_mix_matvec(t, **kw)
                ms = cuda_ms(torch, launch, pool)
                dev_ms = device_ms(torch, launch, pool,
                                   "circulant_mix_kernel")
                plain = cuda_ms(torch, lambda t: ref.circulant_mix_ref(
                    t.float(), s.w_self, s.offsets, s.weights,
                    lap).to(dt), pool, iters=50)
                lib = None
                if dt == torch.float32:
                    Wl = I_minus if lap else W_dense
                    lib = cuda_ms(torch, lambda t: torch.matmul(Wl, t),
                                  pool)
                # one read of Y, one write of the output, the k-entry
                # offset and weight tables
                k = len(s.offsets)
                b_ms, b_by = bound(2 * n * d * item + 8 * k,
                                   (2 * (k + 1) + lap) * n * d)
                print(f"    ms={ms:.5f} device_ms={dev_ms:.5f} "
                      f"plain_ms={plain:.5f} "
                      f"library_ms(matmul)="
                      f"{'n/a' if lib is None else f'{lib:.5f}'} "
                      f"bound_ms={b_ms:.5f} ({b_by})")
                record("circulant_mix_matvec", (n, d, dname, lap),
                       dict(err=err, ms=ms, dev=dev_ms, plain=plain,
                            lib=lib, bound=b_ms, by=b_by))

    # -- sparse_mix_matvec ---------------------------------------------
    print("kernel sparse_mix_matvec (Erdős–Rényi r=0.5 W·Y and (I−W)·Y)")
    for n, d in shapes + [(128, D1)]:
        net, sp, (w_self, nbr, wts) = er_case(n)
        csr = torch.as_tensor(net.W, dtype=torch.float32,
                              device=dev).to_sparse_csr()
        csr_lap = (torch.eye(n, device=dev) - torch.as_tensor(
            net.W, dtype=torch.float32, device=dev)).to_sparse_csr()
        for dname, dt in (dtypes if n == N_AGENTS else dtypes[:1]):
            item = torch.tensor([], dtype=dt).element_size()
            pool = operand_pool(torch, lambda: torch.randn(
                (n, d), generator=gen, device=dev).to(dt), n * d * item)
            for lap in (False, True):
                y = pool[0]
                got = mm.sparse_mix_matvec(y, w_self, nbr, wts,
                                           laplacian=lap)
                want = ref.sparse_mix_padded_ref(y.float(), w_self, nbr,
                                                 wts, lap).to(dt)
                torch.cuda.synchronize()
                tag = f"({n}, {d}) {dname} laplacian={lap} k={sp.k}"
                err = check(tag, got, want, dname)
                def launch(t):
                    return mm.sparse_mix_matvec(t, w_self, nbr, wts,
                                                laplacian=lap)
                ms = cuda_ms(torch, launch, pool)
                dev_ms = device_ms(torch, launch, pool, "sparse_mix_kernel")
                plain = cuda_ms(torch, lambda t: ref.sparse_mix_padded_ref(
                    t.float(), w_self, nbr, wts, lap).to(dt), pool,
                    iters=50)
                lib = None
                if dt == torch.float32:
                    A = csr_lap if lap else csr
                    lib = cuda_ms(torch, lambda t: torch.sparse.mm(A, t),
                                  pool)
                # what this graph needs: each nonzero's weight and index,
                # the diagonal, one read of Y and one write of the output
                nbytes = 2 * n * d * item + sp.nnz * 8 + n * 4
                b_ms, b_by = bound(nbytes,
                                   (2 * (sp.nnz + n) + lap * n) * d)
                print(f"    ms={ms:.5f} device_ms={dev_ms:.5f} "
                      f"plain_ms={plain:.5f} "
                      f"library_ms(sparse.mm CSR)="
                      f"{'n/a' if lib is None else f'{lib:.5f}'} "
                      f"bound_ms={b_ms:.5f} ({b_by})")
                record("sparse_mix_matvec", (n, d, dname, lap),
                       dict(err=err, ms=ms, dev=dev_ms, plain=plain,
                            lib=lib, bound=b_ms, by=b_by))

    # -- circulant_neumann_step ----------------------------------------
    print("kernel circulant_neumann_step (ring, Eq. 14)")
    s, tabs = ring_case(N_AGENTS)
    beta = 0.1
    for n, d in shapes:
        def make():
            h, hvp, p = (torch.randn((n, d), generator=gen, device=dev)
                         for _ in range(3))
            dsc = 1.5 + 1.5 * torch.rand((n, 1), generator=gen,
                                         device=dev)
            return h, hvp, p, dsc
        pool = operand_pool(torch, make, 4 * n * d * 4)
        kw = dict(tabs, beta=beta)
        ref_kw = dict(w_self=s.w_self, offsets=s.offsets, weights=s.weights,
                      beta=beta)
        got = mm.circulant_neumann_step(*pool[0], **kw)
        want = ref.neumann_step_ref(*pool[0], **ref_kw)
        torch.cuda.synchronize()
        err = check(f"({n}, {d}) float32", got, want, "float32")
        def launch(t):
            return mm.circulant_neumann_step(*t, **kw)
        ms = cuda_ms(torch, launch, pool)
        dev_ms = device_ms(torch, launch, pool, "circulant_neumann_kernel")
        plain = cuda_ms(torch, lambda t: ref.neumann_step_ref(*t, **ref_kw),
                        pool, iters=50)
        k = len(s.offsets)
        b_ms, b_by = bound(4 * n * d * 4 + n * 4 + 8 * k,
                           (2 * (k + 1) + 6) * n * d)
        print(f"    ms={ms:.5f} device_ms={dev_ms:.5f} "
              f"plain_ms={plain:.5f} library_ms=n/a "
              f"bound_ms={b_ms:.5f} ({b_by})")
        record("circulant_neumann_step", (n, d, "float32", None),
               dict(err=err, ms=ms, dev=dev_ms, plain=plain, lib=None,
                    bound=b_ms, by=b_by))


def main_path_phase(torch, counts_out: dict) -> None:
    import numpy as np

    from repro_torch.core.problems import hyper_representation
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.solve import ScheduleSpec, SolverSpec, solve
    from repro_torch.topology import make_network

    spec = SolverSpec(method="dagm", K=K, M=M, U=U, dihgp="matrix_free",
                      schedule=ScheduleSpec(alpha=0.1, beta=0.1))
    probs = {dev: hyper_representation(N_AGENTS, d=D_IN, hidden=HIDDEN,
                                       n_classes=N_CLASSES, m_per=M_PER,
                                       seed=0, device=dev)
             for dev in ("cuda", "cpu")}
    assert (probs["cuda"].d1, probs["cuda"].d2) == (D1, D2)
    # the all-zero x0 is dead under ReLU: a random backbone, shared by
    # every agent, as the paper's MLP starts
    x0 = np.broadcast_to(
        0.3 * np.random.default_rng(42).standard_normal(D1),
        (N_AGENTS, D1)).astype(np.float32)
    y0 = (0.01 * np.random.default_rng(0).standard_normal(
        (N_AGENTS, D2))).astype(np.float32)
    graphs = [
        ("ring", make_network("ring", N_AGENTS),
         {"circulant_mix_matvec": K * (M + 1),
          "circulant_neumann_step": K * U, "sparse_mix_matvec": 0}),
        ("erdos_renyi", make_network("erdos_renyi", N_AGENTS, r=0.5,
                                     seed=0),
         {"circulant_mix_matvec": 0, "circulant_neumann_step": 0,
          "sparse_mix_matvec": K * (M + U + 1)}),
    ]
    for gname, net, expected in graphs:
        print(f"main path: solve(hyper_representation d1={D1} d2={D2}, "
              f"{net.name}, K={K} M={M} U={U} dihgp=matrix_free)")
        solve(probs["cuda"], net, spec, x0=x0, y0=y0, device="cuda")
        torch.cuda.synchronize()                     # warm-up run
        reset_launch_counts()
        t0 = time.perf_counter()
        res = solve(probs["cuda"], net, spec, x0=x0, y0=y0, device="cuda")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = launch_counts()
        print(f"  launches {counts} expected {expected}")
        if counts != expected:
            raise AssertionError(f"{gname}: launch counts {counts} != "
                                 f"{expected}")
        for name, c in counts.items():
            counts_out[name] = counts_out.get(name, 0) + c
        print(f"  seconds per round {dt / K:.6f} (host clock, {K} rounds, "
              f"after a warm-up run)")
        for key, val in res.metrics.items():
            if val.shape != (K,) or not torch.isfinite(val).all():
                raise AssertionError(f"{gname}: metric {key} not finite "
                                     f"(K,): {val}")
        for name, t, shape in (("x", res.x, (N_AGENTS, D1)),
                               ("y", res.y, (N_AGENTS, D2))):
            if tuple(t.shape) != shape or not torch.isfinite(t).all():
                raise AssertionError(f"{gname}: final {name} bad")
        print("  metrics", {k: [round(float(v), 6) for v in val.cpu()]
                            for k, val in res.metrics.items()})
        cpu = solve(probs["cpu"], net, spec, x0=x0, y0=y0, device="cpu")
        pairs = [("x", res.x, cpu.x), ("y", res.y, cpu.y)] + [
            (f"metrics[{k}]", res.metrics[k], cpu.metrics[k])
            for k in cpu.metrics]
        for name, g, c in pairs:
            err = (g.cpu() - c).abs().max().item()
            print(f"  vs CPU {name}: max_abs_err={err:.3e} "
                  f"(rtol={E2E_RTOL}, atol={E2E_ATOL})")
            torch.testing.assert_close(g.cpu(), c, rtol=E2E_RTOL,
                                       atol=E2E_ATOL)
        if res.ledger.total_bytes != cpu.ledger.total_bytes:
            raise AssertionError("ledger bytes differ between devices")
        print(f"  ledger total_bytes={res.ledger.total_bytes}")
        profile_run(torch, lambda: solve(probs["cuda"], net, spec, x0=x0,
                                         y0=y0, device="cuda"))


def profile_run(torch, run) -> None:
    """Device time by kernel and the device's busy share over one more
    run under torch.profiler (which slows the host, so its wall time is
    not the round time above)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(getattr(e, "self_device_time_total", 0.0), e.count, e.key)
            for e in prof.key_averages()
            if getattr(e, "self_device_time_total", 0.0) > 0]
    busy_us = sum(r[0] for r in rows)
    if not rows:
        print("  profiler: no device time recorded (not measured)")
        return
    print(f"  profiler: device busy {busy_us:.1f} us of {wall_us:.1f} us "
          f"wall (idle share {1 - busy_us / wall_us:.4f}); "
          f"{sum(r[1] for r in rows)} device ops")
    for us, count, key in sorted(rows, reverse=True)[:12]:
        print(f"    {us:10.1f} us  x{count:<5d} {key[:90]}")
    for us, count, key in rows:
        if "_mix_kernel" in key or "_neumann_kernel" in key:
            print(f"  port kernel: {us:.1f} us device in {count} launches "
                  f"({us / count:.2f} us each) {key[:70]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT / "src"))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{kind!r} count {count}")

    from repro_torch import resolve_device
    from repro_torch.kernels import _build
    resolve_device("cuda")              # TF32 off for the whole run
    # the CPU reference runs on the cores this process may use, not on
    # every core the host reports
    torch.set_num_threads(max(1, min(8, len(os.sched_getaffinity(0)))))
    took = _build.build("mixing_matvec")
    print(f"build: mixing_matvec "
          f"{'cached' if took is None else f'{took:.2f} s'}")
    for log in sorted(_build.BUILD_DIR.glob(f"*-{_build.source_hash()}.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {log.stem}: {line.strip()}")

    results: dict = {}
    kernel_phase(torch, results)
    counts: dict = {}
    main_path_phase(torch, counts)

    # one entry per kernel, at the main path's largest f32 launch
    pick = {
        "circulant_mix_matvec": ((N_AGENTS, D1, "float32", True),
                                 "mixing_matvec.py:274"),
        "sparse_mix_matvec": ((N_AGENTS, D1, "float32", True),
                              "mixing_matvec.py:598"),
        "circulant_neumann_step": ((N_AGENTS, D2, "float32", None),
                                   "mixing_matvec.py:852"),
    }
    kernels = []
    for name, (key, line) in pick.items():
        row = results[name][key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mixing_matvec.cu",
            "replaces": f"src/repro/kernels/{line}",
            "launches": counts[name],
            "max_abs_err": max(r["err"] for k, r in results[name].items()
                               if k[2] == "float32"),
            "ms": row["ms"], "device_ms": row["dev"],
            "plain_ms": row["plain"],
            "bound_ms": row["bound"], "bound_by": row["by"],
            "library_ms": row["lib"],
            "shape": [key[0], key[1]], "dtype": key[2]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
