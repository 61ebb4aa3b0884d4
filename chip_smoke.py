#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and hold every
kernel on that path against its plain PyTorch version.

    python3 chip_smoke.py        # from the repository root, one H100
    python3 chip_smoke.py --phase ring_sweep --phase kernel   # a probe:
                                 # those phases only, no result line

Phases, in order (any failure exits non-zero before the last line):
  1. card    — nvidia-smi name and power limit, torch's device name/count;
  2. build   — compile src/repro_torch/kernels/csrc/*.cu with nvcc (one
               process each, in parallel) and check that the attention
               kernel's SASS holds tensor-core HMMA for bf16 and TF32;
  3. kernels — each kernel vs its plain version on the card at the main
               path's shapes, with timings (CUDA events), the plain
               version's and a one-call PyTorch yardstick's times, and
               the bytes/operations bound: the plain circulant mix and
               Neumann step on the circulant ring and on their unstaged
               kernels (f32 and bf16, bitwise against each other, every
               stage count, at n = 16, 128 and 4096 and an odd d), the
               sparse-gather kernel, their comm-fused twins
               (int8/int4 ± error feedback; payload bitwise) and the
               ring Laplacian; the comm-fused circulant and sparse
               gossips on their decoded column stripe, also at (454,
               d1), where the widest stripe leaves one block per SM,
               and at n = 16 on every stripe width and their unstaged
               kernels (output and payload bitwise, through a lower
               shared-memory budget), the unstaged kernels timed beside
               each; the comm-fused Neumann step on its decoded stripe
               and on its unstaged kernel at (16, d2) int4 and int8 and
               (128, d1) and (454, d1) int8, each bitwise against the
               plain version and the other, both timed; the sparse gather's column stripe also at
               the paper's Fig. 2 size (100, d1) and, at n = 16, on every
               stripe width and its unstaged kernel (bitwise, through a
               lower shared-memory budget), the unstaged kernel timed;
               then the halo kernels at n = 4096: the circulant ones
               (plain and fused, each on its staged ring) at the
               planner's row tile and two others, bitwise against
               the full-operand kernels, and every route of the plain
               and the compressed sparse gathers (the column slab at
               each width, c = 8/4/2/1 f32, 16/8/4/2 bf16, and the
               row-tiled kernel, driven by a lower shared-memory budget;
               bitwise against the full-operand kernel and the plain
               version; the plain slab also without its row plan);
               and rows 2f and 4f on a job axis of 8 jobs at (128,
               8·d) for d2, d1 and an odd width (the fused circulant
               halo int8+ef and int8; the compressed sparse halo's slab
               and its row tiles, through a lower budget), bitwise
               against the plain version and the jobs' solo launches,
               timed against them; rows 1, 1f, 3 and 3f at the
               baselines' operands (DGBO's (16, d2²), DGTBO's (8, d1·d2)
               and, on an n = 4 ring, (4, d1·d2)), timed beside their
               plain versions and library calls;
  3b. sweep  — the Neumann ring at every (row tile, stages) its kernel
               takes at (4096, d2/d1), f32 and bf16, and (16, d2/d1),
               and the mix's ring at each stage count, bitwise against
               the unstaged kernels: the numbers behind the planners;
  4. main    — `repro_torch.solve` on the paper's §6.2 hyper-
               representation MLP at its published widths (d=784,
               hidden=200: d1=157,000, d2=2,010; n=16 agents) on a ring
               (circulant + Neumann kernels) and an Erdős–Rényi graph
               (sparse-gather kernel) on the identity wire, then
               compressed: ring int8+ef, ring int4 and ER int8+ef (the
               comm-fused kernels; ring int4 also bitwise against its
               run through the plain versions, its 15 Neumann steps'
               launches and device time by route).  Each run has exact launch counts,
               exact ledger bytes and finite metrics.  The ring identity
               run agrees with the same run on the CPU (the one CPU
               reference of the phase, beside its run from a nudged x0);
               the other four are bitwise the same run on the card
               through the kernels' plain versions, the compressed ones
               also bit for bit the same run through the fused gossips'
               unstaged kernels, whose device time per solve is profiled
               beside the decoded stripe's; the ring identity solve
               likewise through the plain ring kernels' unstaged kernels;
  4b. fig2   — the same solve on an Erdős–Rényi graph of 100 agents
               (r = 0.5, the paper's Fig. 2 size; K = 3, identity wire),
               every gossip through the sparse gather's column stripe:
               exact launch counts, bitwise equal to the same solve through
               the plain versions, seconds per round;
  5. large   — the same solve on n = 4096 agents (K = 3), where the
               shared-memory planner sends every gossip through the halo
               kernels (the compressed Erdős–Rényi gossip through the
               column-slab kernel): ring identity, int4 and int8+ef,
               Erdős–Rényi (r = 0.004) identity and int8, each with exact
               launch counts and ledger bytes, held against the same
               solve on the card through the plain versions, timed and
               profiled; the ring identity solve also through the
               unstaged kernels (bitwise), and the Neumann step timed on
               the operands that solve hands it;
  5b. routes — explicit "circulant" / "sparse_gather" MixingOps, and
               "auto" with the kernel switch off, launch no kernel and
               backpropagate; the entry points (solve, MixingOp,
               kernels.ops) hand back the caller's TF32 flags;
  6. ops     — the `kernels.ops` path (attention, wkv): the flash-
               attention and WKV-scan kernels against their plain
               versions at the head widths of qwen3-4b (train_4k, f32
               and bf16), mixtral-8x7b (prefill_32k, window 4096, f32
               and bf16) and rwkv6-7b (train_4k), and at head dims
               outside the powers of two (attention 80 and 256, f32 and
               bf16; WKV 96, 256 and 320, and rwkv6-7b with bf16
               inputs; the WKV scan's 3xTF32 HMMA counted in its
               SASS), timed beside
               scaled_dot_product_attention; then `ops.attention` and
               `ops.wkv` for OPS_LAYERS calls each with exact launch
               counts, and off the kernel route (switch off, S % 128,
               T % chunk) with none;
  7. baselines — `solve(method=...)` for DGBO (b = 3), MA-DBO and
               FedNest (U = 3) on the n = 16 ring and Erdős–Rényi graph,
               DGBO and MA-DBO with int8+ef on both, and DGTBO
               (N = 3) on an n = 8 ring (its (n, d1, d2) state cut n for
               memory), at the published widths, K = 3: exact launches
               (rows 1, 1f, 3 and 3f at DGBO's d2² = 4,040,100 columns,
               row 1 at DGTBO's d1·d2 = 315,570,000), ledger floats per
               agent per round against the closed forms, peak memory,
               each bitwise against its run through the plain versions,
               seconds per round in turns and the device time split
               between the gossip kernels and the rest; then all four at
               fig4's reduced size, card against CPU;
  8. faults  — DAGM under FaultSpec(drop_prob=0.3, stragglers=(3,),
               churn=((5, 1, 3),)) at n = 16 on the ring and the
               Erdős–Rényi graph, identity and int8+ef: every gossip on
               the masked sparse gather (row 3, 45 launches a solve),
               bitwise against the plain versions, every realized W_k
               symmetric and doubly stochastic; an all-ones mask bitwise
               against the unfaulted "sparse_gather_pallas" solve; the
               faulted Erdős–Rényi solve at n = 4096 (row 4's slab);
  9. serve   — five buckets of 10 jobs of the same MLP at n = 16 (K = 4,
               the identity ones K = 2; width 8, chunk_rounds 2; fig4's
               (α, β) ± 20 %): ring and ER identity, ring and ER
               int8+ef, ring int4, through `ServeEngine`: three jobs a
               bucket (the first and last slot of the first wave, the
               last backfilled job) against their solo solves on the
               card, every job's wire bytes exact, exact launches (one
               a bucket gossip, the job-axis counters of rows 5, 1f, 3f
               and 5f), each bucket's seconds per round and job-rounds
               per s beside the solo solves', device busy, idle share and
               peak memory; every captured job-axis launch bitwise its
               plain version and its jobs' solo launches, timed; a run
               crashed after its first chunk, its first wave halfway
               through the solve (checked off the checkpoint), and
               resumed by a fresh engine bitwise the uninterrupted run;
               then two buckets of 8 jobs at n = 128, where the
               compressed gossips plan the halo tiles (ring int8+ef: row
               2f; ER int8: row 4f's slab), exact launches, jobs 0 and 7
               bitwise their solo solves;
 10. obs     — the flight recorder and tracing on the ring int8+ef
               solve (bitwise the plain solve; the recorder's wire bytes
               the ledger's; the trace valid), a checkpoint round trip of
               f32, bf16 and int32 leaves on the card;
 11. admission — `AdmissionLoop` at n = 16: ring int8+ef jobs of two
               budgets (K = 4, 8) and three classes packed into one
               bucket, one chunk-boundary preemption, exact launches,
               one runner build, each job bitwise its solo solve; a
               checkpointed loop killed by SimulatedCrash and restored,
               the jobs never admitted back off the sidecar, bitwise;
               `drive_poisson_async` against `drive_poisson` on one
               seeded schedule of 8 jobs at half the wave engine's
               jobs/s: p50, p99, jobs/s, peak queue depth, idle share;
 12. sharded — `solve(tier="sharded")` (`repro_torch.distributed`) on
               the same MLP: a `LocalRing` of 16 agents on the card, K =
               3, identity, bf16, int4, int8+ef, int8+ef with persist_ef
               and identity with mix_every=2 (rows 1 and 1f), each with
               exact launches, ledger bytes and comm_sends equal to
               `sharded_comm_ledger` and its closed form, bitwise its run
               through the plain versions; seconds per round in turns
               beside the reference tier on the same ring and curvature;
               the identity run against the reference tier after 1, 2, 3
               rounds; raw g_fn / f_fn over the MLP's leaves (int8+ef
               bitwise, identity against the flat run); the recorder
               (inert, wire = ledger, one build); `LocalRing(4096)`, K =
               2, identity and int8+ef (rows 2 and 2f), bitwise, seconds
               per round and peak memory; a `ProcessRing` over NCCL at
               world size 1 (self P2P) against `LocalRing(1)`;
 13. lm      — the LM serving path (`repro_torch.models`) at full
               width in bf16, one model at a time: qwen3-4b (36 layers,
               d 2560) prefills a 2,048-token synthetic prompt on the
               flash-attention kernel (36 launches) and rwkv6-7b (d
               4096, depth cut from 32 layers to 16) a 1,024-token one
               on the WKV scan with its final state (16 launches), then
               16 greedy tokens
               each; every launch held against its plain version on its
               inputs, exact launch counts, prefill seconds, decode
               seconds per token, peak memory, idle share; then the
               weights cast to f32, and the kernel route, teacher-forced
               on the greedy tokens of its twin with the kernel switch
               off, held to that twin at the prefill and all 16 decode
               steps (logits within twice a probe's change, greedy
               tokens equal where the plain margin exceeds twice that);
               before them the WKV scan's state output against
               `rwkv6_ref` at rwkv6-7b's head shape (f32, bf16 inputs,
               and hd 96) and flash attention at qwen3-4b's prefill
               shape, timed;
 14. train   — the LM trainer (`models.steps.make_train_step`,
               `launch/`): AdamW on qwen3-4b at its published widths,
               depth 4 (1.18e9 parameters, f32), 6 steps of B 8 × S 512
               in 2 microbatches: losses finite and falling, step
               seconds, tokens/s, the model-FLOPs share (6·N·D, N
               without the input embedding) and the traced FLOPs' share
               of the f32 peak, peak memory, the
               idle share, no kernel launched in the step; the reduced
               model's step on the card against the CPU; the launcher
               (`launch.train.main --smoke`) run, checkpointed and
               resumed; the step on DTensor parameters at qwen3-4b's
               widths, depth 2, on a (data 1, model 2) mesh of two
               threads (torch's threaded process group) against the
               one-process step: losses, first-step gradients, shard
               shapes, the collectives per step; the paper's bilevel LM round
               (`launch.dagm_dryrun.build_dagm_bilevel` through
               `make_sharded_dagm` on LocalRing(4)) at qwen3-4b's widths,
               depth 1, bf16, 2 rounds on the identity wire and 2 on
               int8+ef: every gossip on rows 3 / 3f, exact launch counts,
               each launch bitwise its plain version, wire bytes equal to
               `sharded_comm_ledger`, no flash-attention launch; on the
               identity wire near its run with the kernel switch off;
               the timed rounds' x, y and metrics bitwise the counted
               ones'; seconds per
               round, peak, idle share, losses, consensus_x; one dry-run
               line (`launch.dryrun.run_one("qwen3-4b", "train_4k")` on
               the meta device) beside the measured step;
 15. the kernel list as one JSON line, then the device JSON line last.

Imports torch and the port only; needs no network.
"""
from __future__ import annotations

import contextlib
import functools
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
# 32-bit integer operations outside the tensor cores: 64 INT32 lanes per
# SM (half the 128 FP32 lanes, Hopper white paper) x 132 SMs x 1.98 GHz
INT32_OP_PER_S = 64 * 132 * 1.98e9
L2_BYTES = 50 * 2 ** 20

# the comm-fused kernels' quantizer, counted once per payload element:
# the hash (two murmur3 finalizers of 8 ops each, the row/column/seed mix
# of 3) and the 24-bit draw's shift are integer work; the draw's convert
# and scale, (x - zp)/scale + u, floor, the clamp's two compares and the
# decode zp + scale*q are f32 work (+2 under EF: y - hat, hat + q)
QUANT_INT_OPS, QUANT_F32_OPS = 20, 10
COMMS = ("int8", "int4", "int8+ef", "int4+ef")
SEED = 123456789

N_AGENTS = 16
D_IN, HIDDEN, N_CLASSES, M_PER = 784, 200, 10, 30
D1, D2 = D_IN * HIDDEN + HIDDEN, HIDDEN * N_CLASSES + N_CLASSES
# an odd width beside d2: 4-byte f32 and 2-byte bf16 copies on the rings
D_ODD = D2 + 1
K, M, U = 5, 5, 3
# the large-network path: one (4096, 157000) f32 state is 2.57 GB; an
# Erdős–Rényi graph with mean degree ~18 (k_max 36, the padded gather)
N_LARGE, K_LARGE, ER_R_LARGE = 4096, 3, 0.004
# the network size of the paper's Fig. 2 (a random graph of 100 agents),
# where the full-operand sparse gather stages its whole 128-column stripe
N_FIG2 = 100
# the largest n whose 128-column f32 stripe fits one block's shared
# memory (454 x 512 bytes = 232,448): one block per SM on the decoded
# stripe of the comm-fused full-operand gossips
N_STRIPE_MAX = 454

# tolerances: the kernels round each product and sum on its own, in
# their plain versions' order (no FMA contraction), so outputs are
# expected to agree bit for bit and `check` prints how many elements
# differ; the pass mark stays a few ulp of outputs of size ≤ ~10 for
# f32 and one bf16 ulp for bf16 outputs (rounded from f32 accumulators).
F32_TOL = 1e-5
BF16_REL_TOL = 2.0 ** -7
# end to end, GPU vs CPU: cuBLAS and CPU reductions in the autodiff
# terms sum in other orders, amplified over K rounds of the outer loop
E2E_RTOL, E2E_ATOL = 1e-3, 1e-4
# runs against the same solve on the card with each kernel replaced by
# its plain version (same autodiff, same device): the kernels equal
# their plain versions bit for bit, so the runs are held bitwise; the
# compressed ones are also printed by norm-relative error (stochastic
# rounding is discontinuous, so a run that differed anywhere would carry
# it on) and their per-round metrics by a wider band.
E2E_NORM_REL = 1e-3
E2E_METRIC_RTOL, E2E_METRIC_ATOL = 1e-2, 1e-4


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


def device_ms(torch, fn, pool, symbol: str, iters=50, attempts=3
              ) -> float:
    """Mean device time (ms) of the one CUDA kernel named like `symbol`
    that fn launches, from torch.profiler: the kernel alone, without the
    host's launch cost that `cuda_ms` includes.  The tracer misses the
    first launches of a window (up to 3 of 50 seen on the H100; late in
    a long run 4-6 of 50, or whole windows), so five launches run under
    the profiler's warm-up step before the step it records, and the
    mean is over those it saw; a window in which it saw fewer than
    iters - max(3, iters // 8) is profiled again, up to `attempts`
    times.  Past that the time comes
    from CUDA events around the same launches (`cuda_ms`, which for
    kernels shorter than their host launch cost reads the host's rate),
    and the line says so."""
    from torch.profiler import ProfilerActivity, profile, schedule
    for attempt in range(attempts):
        recorded = []
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: recorded.append(
                         p.key_averages())) as prof:
            for launches in (min(iters, 5), iters):
                for i in range(launches):
                    fn(pool[i % len(pool)])
                torch.cuda.synchronize()
                prof.step()
        hits = [e for e in (recorded[0] if recorded else ())
                if symbol in e.key
                and getattr(e, "self_device_time_total", 0) > 0]
        count = sum(e.count for e in hits)
        if iters - max(3, iters // 8) <= count <= iters:
            return sum(e.self_device_time_total for e in hits) / count / 1e3
        print(f"  profiler saw {count} launches of {symbol}, expected "
              f"{iters} (attempt {attempt + 1} of {attempts})")
    ms = cuda_ms(torch, fn, pool, iters=iters)
    print(f"  device ms of {symbol} from CUDA events instead (the profiler "
          f"missed launches in {attempts} windows): {ms:.5f}")
    return ms


def operand_pool(torch, make, nbytes: int):
    """Copies of the operands to cycle through: enough to exceed 3× the
    L2 cache, so operands come from HBM, but at most 64.  The cap binds
    for operands under ~2.4 MB (the (16, 2010) rows: 64 copies are
    ~4-33 MB and stay in L2, as the main path's freshly written d2
    operands do); those times are launch-latency readings."""
    copies = max(1, min(64, math.ceil(3 * L2_BYTES / max(nbytes, 1))))
    return [make() for _ in range(copies)]


def try_library(torch, fn, pool, **kw):
    """(ms, None) of a one-call PyTorch yardstick (`cuda_ms`), or (None,
    the error) where the card's PyTorch refuses the call (a bf16 CSR
    product, for one)."""
    try:
        return cuda_ms(torch, fn, pool, **kw), None
    except (RuntimeError, NotImplementedError, TypeError) as err:
        return None, f"{type(err).__name__}: {str(err).splitlines()[0][:160]}"


def csr_mm(torch, A, dt):
    """One `torch.sparse.mm` with the CSR matrix A in dtype dt, which is
    converted once, at the first call (inside `try_library`'s warm-up,
    so that a refused conversion is reported as the call's error)."""
    held = {}

    def call(t):
        if "A" not in held:
            held["A"] = A if A.dtype == dt else A.to(dt)
        return torch.sparse.mm(held["A"], t)
    return call


def lib_text(lib, lib_err) -> str:
    return f"{lib:.5f}" if lib is not None else (lib_err or "n/a")


def bound(nbytes: float, flops: float, int_ops: float = 0.0
          ) -> tuple[float, str]:
    """Least time (ms): bytes over the HBM rate, or the operations over
    their peak rates (f32 and int32 lanes run side by side, so the
    slower of the two), whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / F32_FLOP_PER_S, int_ops / INT32_OP_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(name, got, want, dtype_name) -> float:
    err = (got.float() - want.float()).abs().max().item()
    differ = int((got != want).sum().item())
    if dtype_name == "float32":
        tol = F32_TOL
    else:
        tol = BF16_REL_TOL * want.float().abs().max().item()
    status = "ok" if err <= tol else "FAIL"
    print(f"  {name}: max_abs_err={err:.3e} tol={tol:.3e} {status} "
          f"(elements differing {differ})")
    if err > tol:
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


def check_fused(name, got, want, ef: bool) -> float:
    """A comm-fused kernel vs its plain version: under EF the payload
    must be bitwise equal; the mixed output within F32_TOL."""
    if ef:
        (got, pay), (want, want_pay) = got, want
        diff = int((pay != want_pay).sum().item())
        print(f"  {name}: payload elements differing={diff} (bitwise)")
        if diff:
            raise AssertionError(f"{name}: payload not bitwise equal to "
                                 f"its plain version")
    return check(name, got, want, "float32")


def bitwise(tag, got, full, what="the full-operand kernel") -> None:
    """Every element of got (a tensor, or a tuple: output and payload)
    equal to full's."""
    pairs = zip(got, full) if isinstance(got, tuple) else [(got, full)]
    diff = sum(int((g != f).sum().item()) for g, f in pairs)
    print(f"  {tag}: elements differing from {what} {diff} (bitwise)")
    if diff:
        raise AssertionError(f"{tag}: not bitwise equal to {what}")


def wire_operands(torch, gen, n, d, comm, extra=0):
    """(bits, ef, pool): operands of one comm-fused launch, y (and hat),
    its row metadata, plus `extra` more (n, d) operands (the Neumann
    step's hvp_h and p), in an `operand_pool`."""
    from repro_torch.comm import row_quant_params
    bits, ef = int(comm[3]), comm.endswith("+ef")
    dev = gen.device

    def make():
        y = torch.randn((n, d), generator=gen, device=dev)
        hat = 0.5 * torch.randn((n, d), generator=gen, device=dev) \
            if ef else None
        zp, sc = row_quant_params(y - hat if ef else y, bits)
        more = tuple(torch.randn((n, d), generator=gen, device=dev)
                     for _ in range(extra))
        return (y, zp, sc, hat) + more
    return bits, ef, operand_pool(torch, make, n * d * 4 * (1 + ef + extra))


def fused_bound(n, d, k, ef, lap, table_bytes):
    """Bound of a comm-fused mix: reads y (and hat) and the (n, 1)
    zp/scale, writes out (and the payload); the mix's 2(k+1) FLOP plus
    the quantizer once per element."""
    nbytes = n * d * 4 * (2 + 2 * ef) + 8 * n + table_bytes
    return bound(nbytes,
                 (2 * (k + 1) + lap + QUANT_F32_OPS + 2 * ef) * n * d,
                 QUANT_INT_OPS * n * d)


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
        return s, dict(w_self=s.w_self, offsets=s.offsets,
                       weights=s.weights)

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
    # the circulant halo's ring at bn = n (the planner's route) at every
    # stage count, and the unstaged kernel (reached through a budget no
    # tile fits), each bitwise against the plain version and the other;
    # both timed, f32 and bf16, at the main path's shapes, at (128, d1)
    # and at an odd d (4-byte f32, 2-byte bf16 copies)
    print("kernel circulant_mix_matvec (ring W·Y and (I−W)·Y; the ring at "
          "bn = n, and the unstaged kernel)")
    for n, d in shapes + [(128, D1), (N_AGENTS, D_ODD)]:
        s, tabs = ring_case(n)
        W_dense = torch.as_tensor(make_network("ring", n).W,
                                  dtype=torch.float32, device=dev)
        I_minus = torch.eye(n, device=dev) - W_dense
        h_lo, h_hi = mm.halo_extents(s.offsets, n)
        for dname, dt in dtypes:
            item = torch.tensor([], dtype=dt).element_size()
            pool = operand_pool(torch, lambda: torch.randn(
                (n, d), generator=gen, device=dev).to(dt), n * d * item)
            one = mm.halo_smem_bytes(h_lo + n + h_hi, itemsize=item)
            top = mm.halo_stages(h_lo + n + h_hi, itemsize=item)
            planned = mm.circulant_ring_stages(n, h_lo, h_hi, itemsize=item,
                                               d=d)
            for lap in (False, True):
                kw = dict(tabs, laplacian=lap)
                y = pool[0]
                want = ref.circulant_mix_ref(
                    y.float(), s.w_self, s.offsets, s.weights,
                    lap).to(dt)
                got = mm.circulant_mix_matvec(y, **kw)
                torch.cuda.synchronize()
                tag = (f"({n}, {d}) {dname} laplacian={lap} planner: "
                       + (f"ring bn={n} stages={planned}" if planned
                          else "unstaged"))
                err = check(tag, got, want, dname)
                bitwise(tag, got, want, "the plain version")
                with mm.smem_budget(one - 1):
                    assert mm.circulant_ring_stages(n, h_lo, h_hi,
                                                    itemsize=item, d=d) == 0
                    old = mm.circulant_mix_matvec(y, **kw)
                torch.cuda.synchronize()
                tag = f"({n}, {d}) {dname} laplacian={lap} unstaged"
                bitwise(tag, old, want, "the plain version")
                err_old = check(tag, old, want, dname)
                for st in range(1, top + 1):
                    with mm.smem_budget(st * one):
                        got = mm.circulant_mix_matvec(y, ring=(n, st), **kw)
                    torch.cuda.synchronize()
                    tag = (f"({n}, {d}) {dname} laplacian={lap} ring "
                           f"stages={st}")
                    bitwise(tag, got, want, "the plain version")
                    bitwise(tag, got, old, "the unstaged kernel")
                    err = max(err, check(tag, got, want, dname))
                del got, old

                def launch(t, kw=kw):
                    return mm.circulant_mix_matvec(t, ring=(n, top), **kw)

                def go_old(t, kw=kw):
                    with mm.smem_budget(one - 1):
                        return mm.circulant_mix_matvec(t, **kw)
                ms = cuda_ms(torch, launch, pool)
                dev_ms = device_ms(torch, launch, pool,
                                   "circulant_mix_halo_kernel")
                ms_old = cuda_ms(torch, go_old, pool)
                dev_old = device_ms(torch, go_old, pool,
                                    "circulant_mix_kernel")
                plain = cuda_ms(torch, lambda t: ref.circulant_mix_ref(
                    t.float(), s.w_self, s.offsets, s.weights,
                    lap).to(dt), pool, iters=50)
                Wl = (I_minus if lap else W_dense).to(dt)
                lib, lib_err = try_library(torch,
                                           lambda t: torch.matmul(Wl, t),
                                           pool)
                # one read of Y, one write of the output, the k-entry
                # offset and weight tables
                k = len(s.offsets)
                b_ms, b_by = bound(2 * n * d * item + 8 * k,
                                   (2 * (k + 1) + lap) * n * d)
                print(f"    ring bn={n} stages={top}: ms={ms:.5f} "
                      f"device_ms={dev_ms:.5f}; unstaged: ms={ms_old:.5f} "
                      f"device_ms={dev_old:.5f}; plain_ms={plain:.5f} "
                      f"library_ms(matmul {dname})={lib_text(lib, lib_err)} "
                      f"bound_ms={b_ms:.5f} ({b_by})")
                row = dict(plain=plain, lib=lib, lib_err=lib_err,
                           bound=b_ms, by=b_by)
                record("circulant_mix_matvec", (n, d, dname, lap),
                       dict(row, err=err, ms=ms, dev=dev_ms, bn=n,
                            stages=top))
                record("circulant_mix_matvec_unstaged", (n, d, dname, lap),
                       dict(row, err=err_old, ms=ms_old, dev=dev_old))
            del pool

    # -- sparse_mix_matvec ---------------------------------------------
    # the column stripe at the planner's width (128 f32 / 256 bf16 columns
    # at these n), timed at the main path's shapes, at (128, d1) and at
    # the paper's Fig. 2 network size (100, d1); at n = 16 every stripe
    # width and the unstaged kernel, reached through a lower planner
    # budget, held bitwise; the unstaged kernel (n > 14,528) also timed
    print("kernel sparse_mix_matvec (Erdős–Rényi r=0.5 W·Y and (I−W)·Y; "
          "column stripe, and the unstaged kernel past it)")
    for n, d in shapes + [(128, D1), (100, D1)]:
        net, sp, (w_self, nbr, wts) = er_case(n)
        csr = torch.as_tensor(net.W, dtype=torch.float32,
                              device=dev).to_sparse_csr()
        csr_lap = (torch.eye(n, device=dev) - torch.as_tensor(
            net.W, dtype=torch.float32, device=dev)).to_sparse_csr()
        for dname, dt in (dtypes if n == N_AGENTS else dtypes[:1]):
            item = torch.tensor([], dtype=dt).element_size()
            pool = operand_pool(torch, lambda: torch.randn(
                (n, d), generator=gen, device=dev).to(dt), n * d * item)
            widths = mm.stripe_cols_for(item)
            unstaged = mm.stripe_bytes(n, widths[-1], item) - 1
            routes = [(c, mm.stripe_bytes(n, c, item)) for c in widths
                      ] + [(None, unstaged)] if n == N_AGENTS else []
            for lap in (False, True):
                y = pool[0]
                got = mm.sparse_mix_matvec(y, w_self, nbr, wts,
                                           laplacian=lap)
                want = ref.sparse_mix_padded_ref(y.float(), w_self, nbr,
                                                 wts, lap).to(dt)
                torch.cuda.synchronize()
                tag = (f"({n}, {d}) {dname} laplacian={lap} k={sp.k} "
                       f"stripe c={mm.plan_stripe_cols(n, item)}")
                err = check(tag, got, want, dname)
                bitwise(tag, got, want, "the plain version")
                errs = {}
                for cols, budget in routes:
                    with mm.smem_budget(budget):
                        assert mm.plan_stripe_cols(n, item) == cols
                        got = mm.sparse_mix_matvec(y, w_self, nbr, wts,
                                                   laplacian=lap)
                    torch.cuda.synchronize()
                    tag = (f"({n}, {d}) {dname} laplacian={lap} " + (
                        f"stripe c={cols}" if cols else "unstaged"))
                    bitwise(tag, got, want, "the plain version")
                    errs[cols] = check(tag, got, want, dname)
                del got

                def launch(t):
                    return mm.sparse_mix_matvec(t, w_self, nbr, wts,
                                                laplacian=lap)
                ms = cuda_ms(torch, launch, pool)
                dev_ms = device_ms(torch, launch, pool,
                                   "sparse_mix_stripe_kernel")
                plain = cuda_ms(torch, lambda t: ref.sparse_mix_padded_ref(
                    t.float(), w_self, nbr, wts, lap).to(dt), pool,
                    iters=50)
                lib, lib_err = try_library(
                    torch, csr_mm(torch, csr_lap if lap else csr, dt), pool)
                # what this graph needs: each nonzero's weight and index,
                # the diagonal, one read of Y and one write of the output
                nbytes = 2 * n * d * item + sp.nnz * 8 + n * 4
                b_ms, b_by = bound(nbytes,
                                   (2 * (sp.nnz + n) + lap * n) * d)
                print(f"    ms={ms:.5f} device_ms={dev_ms:.5f} "
                      f"plain_ms={plain:.5f} "
                      f"library_ms(sparse.mm CSR {dname})="
                      f"{lib_text(lib, lib_err)} "
                      f"bound_ms={b_ms:.5f} ({b_by})")
                row = dict(err=err, ms=ms, dev=dev_ms, plain=plain, lib=lib,
                           lib_err=lib_err, bound=b_ms, by=b_by,
                           stripe_cols=mm.plan_stripe_cols(n, item))
                record("sparse_mix_matvec", (n, d, dname, lap), row)
                if dt != torch.float32:
                    continue
                # the unstaged kernel on the same operands (plain, library
                # and bound as the stripe's row; ms includes the budget
                # switch, a few µs on the host)
                def go(t):
                    with mm.smem_budget(unstaged):
                        return launch(t)
                if None not in errs:
                    with mm.smem_budget(unstaged):
                        got = launch(y)
                    torch.cuda.synchronize()
                    tag = f"({n}, {d}) {dname} laplacian={lap} unstaged"
                    bitwise(tag, got, want, "the plain version")
                    errs[None] = check(tag, got, want, dname)
                    del got
                ms = cuda_ms(torch, go, pool, iters=50)
                dev_ms = device_ms(torch, go, pool,
                                   "sparse_mix_unstaged_kernel")
                print(f"    unstaged: ms={ms:.5f} device_ms={dev_ms:.5f}")
                record("sparse_mix_matvec_unstaged", (n, d, dname, lap),
                       dict(row, err=errs[None], ms=ms, dev=dev_ms,
                            stripe_cols=None))

    # -- circulant_neumann_step ----------------------------------------
    # the circulant ring at the planner's (bn, stages) and the unstaged
    # kernel (a budget no tile fits), bitwise against the plain version
    # and each other, f32 and bf16, at the main path's shapes, the large
    # path's (4096, d2) and (4096, d1), and an odd d; both timed
    print("kernel circulant_neumann_step (ring, Eq. 14; the circulant "
          "ring and the unstaged kernel)")
    beta = 0.1
    for n, d in shapes + [(N_LARGE, D2), (N_LARGE, D1), (N_AGENTS, D_ODD)]:
        s, tabs = ring_case(n)
        h_lo, h_hi = mm.halo_extents(s.offsets, n)
        for dname, dt in dtypes:
            item = torch.tensor([], dtype=dt).element_size()

            def make(n=n, d=d, dt=dt):
                h, hvp, p = (torch.randn((n, d), generator=gen,
                                         device=dev).to(dt)
                             for _ in range(3))
                dsc = 1.5 + 1.5 * torch.rand((n, 1), generator=gen,
                                             device=dev)
                return h, hvp, p, dsc
            pool = operand_pool(torch, make, 4 * n * d * item)
            kw = dict(tabs, beta=beta)
            ref_kw = dict(w_self=s.w_self, offsets=s.offsets,
                          weights=s.weights, beta=beta)

            def plain_fn(t, dt=dt):
                return ref.neumann_step_ref(*(a.float() for a in t[:3]),
                                            t[3], **ref_kw).to(dt)
            plan = mm.neumann_ring_plan(n, h_lo, h_hi, itemsize=item, d=d)
            ring = plan or mm.neumann_ring_plan(n, h_lo, h_hi, itemsize=item)
            want = plain_fn(pool[0])
            got = mm.circulant_neumann_step(*pool[0], **kw)
            torch.cuda.synchronize()
            tag = (f"({n}, {d}) {dname} planner: "
                   + (f"ring bn={plan[0]} stages={plan[1]}" if plan
                      else "unstaged"))
            err = check(tag, got, want, dname)
            bitwise(tag, got, want, "the plain version")
            with mm.smem_budget(0):
                assert mm.neumann_ring_plan(n, h_lo, h_hi, itemsize=item,
                                            d=d) is None
                old = mm.circulant_neumann_step(*pool[0], **kw)
            torch.cuda.synchronize()
            tag = f"({n}, {d}) {dname} unstaged"
            bitwise(tag, old, want, "the plain version")
            err_old = check(tag, old, want, dname)
            got = mm.circulant_neumann_step(*pool[0], ring=ring, **kw)
            torch.cuda.synchronize()
            tag = f"({n}, {d}) {dname} ring bn={ring[0]} stages={ring[1]}"
            bitwise(tag, got, want, "the plain version")
            bitwise(tag, got, old, "the unstaged kernel")
            del got, old

            def launch(t):
                return mm.circulant_neumann_step(*t, ring=ring, **kw)

            def go_old(t):
                with mm.smem_budget(0):
                    return mm.circulant_neumann_step(*t, **kw)
            big = d == D1 and n == N_LARGE
            it = 20 if big else 200
            ms = cuda_ms(torch, launch, pool, iters=it)
            dev_ms = device_ms(torch, launch, pool,
                               "circulant_neumann_ring_kernel")
            ms_old = cuda_ms(torch, go_old, pool, iters=it)
            dev_old = device_ms(torch, go_old, pool,
                                "circulant_neumann_kernel")
            plain = cuda_ms(torch, plain_fn, pool, iters=3 if big else 50,
                            warmup=1 if big else 10)
            k = len(s.offsets)
            # h, hvp_h and p read once, h+ written once, D~ and the tables
            b_ms, b_by = bound(4 * n * d * item + n * 4 + 8 * k,
                               (2 * (k + 1) + 6) * n * d)
            print(f"    ring bn={ring[0]} stages={ring[1]}: ms={ms:.5f} "
                  f"device_ms={dev_ms:.5f}; unstaged: ms={ms_old:.5f} "
                  f"device_ms={dev_old:.5f}; plain_ms={plain:.5f} "
                  f"library_ms=n/a bound_ms={b_ms:.5f} ({b_by})")
            row = dict(plain=plain, lib=None, bound=b_ms, by=b_by)
            record("circulant_neumann_step", (n, d, dname, None),
                   dict(row, err=err, ms=ms, dev=dev_ms, bn=ring[0],
                        stages=ring[1]))
            record("circulant_neumann_step_unstaged", (n, d, dname, None),
                   dict(row, err=err_old, ms=ms_old, dev=dev_old))
            del pool

    def wire_pool(n, d, comm, extra=0):
        return wire_operands(torch, gen, n, d, comm, extra)

    # -- circulant_mix_matvec, comm-fused --------------------------------
    def csr_pair(W):
        """CSR W and I − W on the card: `torch.sparse.mm`'s operands, the
        library yardstick of a mix (for a comm-fused kernel, of the
        uncompressed one)."""
        W = torch.as_tensor(W, dtype=torch.float32, device=dev)
        return (W.to_sparse_csr(),
                (torch.eye(W.shape[0], device=dev) - W).to_sparse_csr())

    # -- circulant_mix_matvec and sparse_mix_matvec, comm-fused ----------
    # the decoded column stripe at the planner's width, at the main path's
    # shapes, (128, d1) and (N_STRIPE_MAX, d1), where the widest stripe
    # leaves one block per SM (int8+ef (I−W)·Y and int8 W·Y there); every
    # launch held bitwise against the plain version, output and payload,
    # at n = 16 also on every stripe width and the unstaged kernel (n >
    # 14,528), reached through a lower planner budget; the unstaged kernel
    # (the old one) timed beside each on the same operands
    def ring_fused(n):
        s, tabs = ring_case(n)
        csr = csr_pair(make_network("ring", n).W)
        host = dict(w_self=s.w_self, offsets=s.offsets, weights=s.weights)

        def launch_of(comm, lap):
            return lambda t: mm.circulant_mix_matvec(
                *t[:3], SEED, t[3], laplacian=lap, comm=comm, **tabs)

        def plain_of(bits, lap):
            return lambda t: ref.circulant_mix_fused_ref(
                *t[:3], SEED, t[3], laplacian=lap, bits=bits, **host)
        k = len(s.offsets)
        return launch_of, plain_of, csr, k, k, 8 * k

    def er_fused(n):
        net, sp, (w_self, nbr, wts) = er_case(n)

        def launch_of(comm, lap):
            return lambda t: mm.sparse_mix_matvec(
                t[0], w_self, nbr, wts, *t[1:3], SEED, t[3], laplacian=lap,
                comm=comm)

        def plain_of(bits, lap):
            return lambda t: ref.sparse_mix_fused_ref(
                t[0], w_self, nbr, wts, *t[1:3], SEED, t[3], laplacian=lap,
                bits=bits)
        # what this graph needs: its nonzeros' weights and indices and the
        # diagonal, the mix's 2 FLOP per nonzero
        return (launch_of, plain_of, csr_pair(net.W), sp.k, sp.nnz / n,
                sp.nnz * 8 + n * 4)

    sms = mm._card_sms(dev)
    for kname, what, case, symbol in (
            ("circulant_mix_matvec_comm", "ring", ring_fused,
             "circulant_mix_"),
            ("sparse_mix_matvec_comm", "Erdős–Rényi r=0.5", er_fused,
             "sparse_mix_")):
        print(f"kernel {kname} ({what}, int8/int4 ± EF; decoded column "
              f"stripe, and the unstaged kernel past it)")
        for n, d in shapes + [(128, D1), (N_STRIPE_MAX, D1)]:
            launch_of, plain_of, csr, k, k_mean, table_bytes = case(n)
            widths = mm.stripe_cols_for(4)
            unstaged = mm.stripe_bytes(n, widths[-1]) - 1
            routes = [mm.stripe_bytes(n, c) for c in widths] \
                if n == N_AGENTS else []
            big = n == N_STRIPE_MAX
            cases = ({"int8+ef": (True,), "int8": (False,)} if big
                     else dict.fromkeys(COMMS, (False, True)))
            for comm, laps in cases.items():
                bits, ef, operands = wire_pool(n, d, comm)
                for lap in laps:
                    launch = launch_of(comm, lap)
                    plain_fn = plain_of(bits, lap)
                    got = launch(operands[0])
                    want = plain_fn(operands[0])
                    torch.cuda.synchronize()
                    cols = mm.plan_comm_stripe_cols(n, d, sms)
                    tag = (f"({n}, {d}) {comm} laplacian={lap} k={k} stripe "
                           f"c={cols}")
                    err = check_fused(tag, got, want, ef)
                    bitwise(tag, got, want, "the plain version")
                    errs = {}
                    for budget in routes + [unstaged]:
                        with mm.smem_budget(budget):
                            c = mm.plan_comm_stripe_cols(n, d, sms)
                            got = launch(operands[0])
                        torch.cuda.synchronize()
                        tag = (f"({n}, {d}) {comm} laplacian={lap} "
                               + (f"stripe c={c}" if c else "unstaged"))
                        bitwise(tag, got, want, "the plain version")
                        errs[c] = check_fused(tag, got, want, ef)
                    del got, want
                    ms = cuda_ms(torch, launch, operands, iters=50 if big
                                 else 200)
                    dev_ms = device_ms(torch, launch, operands,
                                       symbol + "stripe_comm_kernel")
                    plain = cuda_ms(torch, plain_fn, operands,
                                    iters=3 if big else 20, warmup=1)
                    A = csr[int(lap)]
                    lib = cuda_ms(torch, lambda t: torch.sparse.mm(A, t[0]),
                                  operands, iters=50 if big else 200)
                    b_ms, b_by = fused_bound(n, d, k_mean, ef, lap,
                                             table_bytes)

                    def go(t, launch=launch):
                        with mm.smem_budget(unstaged):
                            return launch(t)
                    ums = cuda_ms(torch, go, operands, iters=20 if big else 50,
                                  warmup=2)
                    udev = device_ms(torch, go, operands,
                                     symbol + "comm_unstaged_kernel",
                                     iters=20 if big else 50)
                    print(f"    ms={ms:.5f} device_ms={dev_ms:.5f} "
                          f"plain_ms={plain:.5f} "
                          f"library_ms(sparse.mm CSR)={lib:.5f} "
                          f"bound_ms={b_ms:.5f} ({b_by}); unstaged: "
                          f"ms={ums:.5f} device_ms={udev:.5f}")
                    row = dict(err=err, ms=ms, dev=dev_ms, plain=plain,
                               lib=lib, bound=b_ms, by=b_by,
                               stripe_cols=cols)
                    record(kname, (n, d, comm, lap), row)
                    record(kname + "_unstaged", (n, d, comm, lap),
                           dict(row, err=errs[None], ms=ums, dev=udev,
                                stripe_cols=None))
                del operands

    # -- circulant_neumann_step, comm-fused (no EF) ----------------------
    # both routes at every shape: the decoded stripe
    # (`circulant_neumann_stripe_comm_kernel`, at the comm-fused gossips'
    # width `plan_comm_stripe_cols`) and the unstaged kernel, each bitwise
    # against the plain version and the other; the planner's choice
    # (`plan_neumann_comm_stripe_cols`) is the route of the main path
    print("kernel circulant_neumann_step_comm (ring, Eq. 14, int8/int4; "
          "decoded stripe and unstaged kernel)")
    sms = mm._card_sms(dev)
    for n, d, comm in ((N_AGENTS, D2, "int4"), (N_AGENTS, D2, "int8"),
                       (N_AGENTS, D1, "int4"), (N_AGENTS, D1, "int8"),
                       (128, D1, "int4"), (128, D1, "int8"),
                       (N_STRIPE_MAX, D1, "int8")):
        s_, tabs = ring_case(n)
        k = len(s_.offsets)
        dsc = 1.5 + 1.5 * torch.rand((n, 1), generator=gen, device=dev)
        bits, _, pool = wire_pool(n, d, comm, extra=2)
        kw = dict(tabs, beta=beta, comm=comm)
        ref_kw = dict(w_self=s_.w_self, offsets=s_.offsets,
                      weights=s_.weights, beta=beta, bits=bits)
        stripe = mm.plan_comm_stripe_cols(n, d, sms)
        planned = mm.plan_neumann_comm_stripe_cols(n, d, sms)

        def plain_fn(t):
            return ref.neumann_step_fused_ref(t[0], t[4], t[5], dsc,
                                              *t[1:3], SEED, **ref_kw)
        want = plain_fn(pool[0])
        # reads h, hvp_h, p, D̃, zp/scale, writes h⁺
        b_ms, b_by = bound(4 * n * d * 4 + 12 * n + 8 * k,
                           (2 * (k + 1) + 6 + QUANT_F32_OPS) * n * d,
                           QUANT_INT_OPS * n * d)
        big = n == N_STRIPE_MAX
        plain = cuda_ms(torch, plain_fn, pool, iters=3 if big else 20,
                        warmup=1)
        outs = {}
        for kname, cols, symbol in (
                ("circulant_neumann_step_comm", stripe,
                 "circulant_neumann_stripe_comm_kernel"),
                ("circulant_neumann_step_comm_unstaged", 0,
                 "circulant_neumann_comm_kernel")):
            def launch(t, cols=cols):
                return mm._neumann_comm_launch(t[0], t[4], t[5], dsc,
                                               *t[1:3], SEED, cols=cols,
                                               **kw)
            got = launch(pool[0])
            torch.cuda.synchronize()
            tag = (f"({n}, {d}) {comm} " + (f"stripe c={cols}" if cols
                                            else "unstaged"))
            err = check(tag, got, want, "float32")
            bitwise(tag, got, want, "the plain version")
            outs[kname] = got
            ms = cuda_ms(torch, launch, pool, iters=50 if big else 200)
            dev_ms = device_ms(torch, launch, pool, symbol,
                               iters=20 if big else 50)
            print(f"    ms={ms:.5f} device_ms={dev_ms:.5f} "
                  f"plain_ms={plain:.5f} library_ms=n/a "
                  f"bound_ms={b_ms:.5f} ({b_by}); share of the bound "
                  f"{b_ms / dev_ms:.3f}")
            record(kname, (n, d, comm, None),
                   dict(err=err, ms=ms, dev=dev_ms, plain=plain, lib=None,
                        bound=b_ms, by=b_by,
                        stripe_cols=cols or None))
        bitwise(f"({n}, {d}) {comm} stripe", outs[
            "circulant_neumann_step_comm"], outs[
            "circulant_neumann_step_comm_unstaged"], "the unstaged kernel")
        print(f"  planner's route at ({n}, {d}): "
              + (f"stripe c={planned}" if planned else "unstaged"))
        del pool, want, outs

    # -- ring_laplacian_matvec -------------------------------------------
    print("kernel ring_laplacian_matvec ((I−W)·Y on a ring, over the "
          "plain circulant mix's route)")
    for n, d in [(2, D1), (N_AGENTS, D2), (N_AGENTS, D1)]:
        W = torch.as_tensor(make_network("ring", n).W, dtype=torch.float32,
                            device=dev) if n > 2 else torch.full(
            (2, 2), 0.5, device=dev)
        w_self, w_edge = float(W[0, 0]), float(W[0, 1])
        I_minus = torch.eye(n, device=dev) - W
        pool = operand_pool(torch, lambda: torch.randn(
            (n, d), generator=gen, device=dev), n * d * 4)

        def launch(t):
            return mm.ring_laplacian_matvec(t, w_self=w_self, w_edge=w_edge)
        offsets, weights = mm.ring_offsets(n, w_edge)

        def plain_fn(t):
            return ref.circulant_mix_ref(t, w_self, offsets, weights, True)
        got = launch(pool[0])
        torch.cuda.synchronize()
        err = check(f"({n}, {d}) float32", got, plain_fn(pool[0]),
                    "float32")
        check(f"({n}, {d}) vs ring_laplacian_ref", got,
              ref.ring_laplacian_ref(pool[0], w_self, w_edge), "float32")
        ms = cuda_ms(torch, launch, pool)
        h_lo, h_hi = mm.halo_extents(offsets, n)
        dev_ms = device_ms(torch, launch, pool, "circulant_mix_halo_kernel"
                           if mm.circulant_ring_stages(n, h_lo, h_hi, d=d)
                           else "circulant_mix_kernel")
        plain = cuda_ms(torch, plain_fn, pool, iters=50)
        lib = cuda_ms(torch, lambda t: torch.matmul(I_minus, t), pool)
        k = len(offsets)
        b_ms, b_by = bound(2 * n * d * 4 + 8 * k, (2 * (k + 1) + 1) * n * d)
        print(f"    ms={ms:.5f} device_ms={dev_ms:.5f} plain_ms={plain:.5f} "
              f"library_ms(matmul)={lib:.5f} bound_ms={b_ms:.5f} ({b_by})")
        record("ring_laplacian_matvec", (n, d, "float32", True),
               dict(err=err, ms=ms, dev=dev_ms, plain=plain, lib=lib,
                    bound=b_ms, by=b_by))
    halo_job_axis_kernels(torch, results)
    baseline_operand_kernels(torch, results)


# rows 2f and 4f on a serve bucket's job axis: 8 jobs at n = 128 (where
# the planner sends the compressed gossips to the halo tiles), at the
# §6.2 widths and at an odd in-job width
HALO_JOBS = 8
HALO_JOB_N = 128
HALO_JOB_WIDTHS = (D2, D1, D_ODD)


def halo_job_axis_kernels(torch, results: dict) -> None:
    """Rows 2f (the fused circulant halo, ring int8+ef and int8) and 4f
    (the compressed sparse halo, ER r = 0.5 int8, on the planner's slab
    and on the row tiles through a lower budget) on a job axis of
    HALO_JOBS jobs at (HALO_JOB_N, HALO_JOBS·d): one launch, bitwise its
    plain version and its jobs' solo launches over their own columns,
    timed against the solo launches, with its device time, the plain
    version's, one `torch.sparse.mm` of the uncompressed mix and the
    bound."""
    from repro_torch.comm import row_quant_params
    from repro_torch.kernels import mixing_matvec as mm
    from repro_torch.kernels import ref
    from repro_torch.topology import make_network
    from repro_torch.topology.structure import (circulant_structure,
                                                sparse_structure)
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(7)
    n, B = HALO_JOB_N, HALO_JOBS
    seeds = [SEED + 977 * j for j in range(B)]
    ring = circulant_structure(make_network("ring", n).W)
    er_net = make_network("erdos_renyi", n, r=0.5, seed=0)
    sp = sparse_structure(er_net.W)
    tabs = tuple(torch.as_tensor(a, device=dev)
                 for a in (sp.w_self, sp.neighbors, sp.weights))
    bn = mm.plan_row_tile(n, h_lo=1, h_hi=1, blocks=mm.plan_blocks(True))[1]
    cases = [("circulant_mix_matvec_halo_comm_jobs", "int8+ef", None),
             ("circulant_mix_matvec_halo_comm_jobs", "int8", None),
             ("sparse_mix_matvec_halo_comm_jobs", "int8", None),
             # a budget under every slab's shared memory: the row tiles
             ("sparse_mix_matvec_halo_comm_rows_jobs", "int8",
              min(mm.slab_smem_bytes(n, c) for c in mm.SLAB_COLS) - 1)]
    print(f"kernel rows 2f / 4f on a job axis of {B} jobs at n = {n} "
          f"(ring; ER r = 0.5, k = {sp.k}), bn = {bn}")
    for d in HALO_JOB_WIDTHS:
        width = B * d
        for counter, comm, budget in cases:
            bits, ef = int(comm[3]), comm.endswith("+ef")
            circ = counter.startswith("circulant")
            y = torch.randn((n, width), generator=gen, device=dev)
            hat = 0.5 * torch.randn((n, width), generator=gen, device=dev) \
                if ef else None
            q = y if hat is None else y - hat
            zp, sc = (t.reshape(n, B).contiguous() for t in
                      row_quant_params(q.reshape(n * B, d), bits))
            if circ:
                kw = dict(w_self=ring.w_self, offsets=ring.offsets,
                          weights=ring.weights, laplacian=True, bn=bn,
                          comm=comm)

                def launch(a, kw=kw):
                    return mm.circulant_mix_matvec_halo(*a, **kw)

                def plain(a):
                    return ref.circulant_mix_fused_ref(
                        *a, w_self=ring.w_self, offsets=ring.offsets,
                        weights=ring.weights, laplacian=True, bits=bits)
                args = (y, zp, sc, seeds, hat)
                symbol = "circulant_mix_halo_comm_kernel"
                W = torch.as_tensor(make_network("ring", n).W,
                                    dtype=torch.float32, device=dev)
                k = 2
            else:
                kw = dict(laplacian=True, bn=bn, comm=comm)

                def launch(a, kw=kw):
                    return mm.sparse_mix_matvec_halo(a[0], *tabs, *a[1:],
                                                     **kw)

                def plain(a):
                    return ref.sparse_mix_fused_ref(
                        a[0], *tabs, *a[1:], laplacian=True, bits=bits)
                args = (y, zp, sc, seeds)
                symbol = "sparse_mix_halo_comm_kernel" if budget \
                    else "sparse_mix_slab_comm_kernel"
                W = torch.as_tensor(er_net.W, dtype=torch.float32,
                                    device=dev)
                k = sp.k

            def solo(j):
                c = slice(j * d, (j + 1) * d)
                a = (y[:, c].contiguous(), zp[:, j:j + 1].contiguous(),
                     sc[:, j:j + 1].contiguous(), seeds[j])
                if circ:
                    a += (None if hat is None else hat[:, c].contiguous(),)
                return a
            solos = [solo(j) for j in range(B)]
            tag = f"{counter} ({n}, {B}x{d}) {comm}"
            with mm.smem_budget(budget if budget is not None
                                else mm.SMEM_BUDGET_BYTES):
                mm.reset_launch_counts()
                out = launch(args)
                torch.cuda.synchronize()
                counts = mm.launch_counts()
                if counts != {**dict.fromkeys(counts, 0), counter: 1}:
                    raise AssertionError(f"{tag}: launches {counts}")
                want = plain(args)
                bitwise(tag, out, want, "the plain version")
                err = max(((g - w).abs().max().item() for g, w in
                           (zip(out, want) if ef else ((out, want),))))
                del want
                diff = 0
                for j, a in enumerate(solos):
                    got = launch(a)
                    c = slice(j * d, (j + 1) * d)
                    parts = zip(out, got) if ef else ((out, got),)
                    diff += sum(int((o[:, c] != g).sum()) for o, g in parts)
                print(f"  {tag}: elements differing from the {B} jobs' "
                      f"solo launches {diff} (bitwise, job by job)")
                if diff:
                    raise AssertionError(f"{tag}: not bitwise its jobs' "
                                         f"solo launches")
                del out
                big = d == D1
                iters = 10 if big else 50
                ms = cuda_ms(torch, lambda _: launch(args), [None],
                             iters=iters, warmup=2)
                dev_ms = device_ms(torch, lambda _: launch(args), [None],
                                   symbol, iters=iters)
                ms_solo = cuda_ms(torch, lambda _: [launch(a) for a in solos],
                                  [None], iters=max(2, iters // 5),
                                  warmup=1)
            plain_ms = cuda_ms(torch, lambda _: plain(args), [None],
                               iters=2 if big else 5, warmup=1)
            A = W.to_sparse_csr()
            lib, lib_err = try_library(torch, csr_mm(torch, A, y.dtype),
                                       [y], iters=iters)
            nbytes = n * width * 4 * (2 + 2 * ef) + 8 * n * B \
                + (n * k * 8 if not circ else 0)
            b_ms, b_by = bound(nbytes, (2 * (k + 1) + 1 + QUANT_F32_OPS
                                        + 2 * ef) * n * width,
                               QUANT_INT_OPS * n * width)
            print(f"  {tag}: ms={ms:.5f} device_ms={dev_ms:.5f} "
                  f"{B} solo launches {ms_solo:.5f} ms, "
                  f"plain_ms={plain_ms:.5f} library_ms(sparse.mm, "
                  f"uncompressed)={lib_text(lib, lib_err)} "
                  f"bound_ms={b_ms:.5f} ({b_by})")
            results.setdefault(counter, {})[(n, width, comm, B)] = {
                "ms": ms, "dev": dev_ms, "plain": plain_ms, "bound": b_ms,
                "by": b_by, "lib": lib, "err": err, "solo_ms": ms_solo,
                "jobs": B}
            del y, hat, args, solos
            torch.cuda.empty_cache()


def baseline_operand_kernels(torch, results: dict) -> None:
    """Rows 1, 1f, 3 and 3f at the operands the baselines hand them:
    DGBO's (16, d2²) gossips (row 1 on the ring, rows 1f and 3f int8+ef
    W·Y on the ring and the Erdős–Rényi graph), DGTBO's (8, d1·d2) on
    row 1 (bn = n) and, on an n = 4 ring (the padded sparse gather, k =
    2), its (4, d1·d2) on row 3.  Each launch bitwise against the plain
    version; ms (CUDA events), device ms, the plain version's ms, the
    library call's (`torch.matmul` with the dense W for row 1,
    `torch.sparse.mm` with a CSR W, uncompressed, for the others) and
    the bound."""
    from repro_torch.kernels import mixing_matvec as mm
    from repro_torch.kernels import ref
    from repro_torch.topology import make_network
    from repro_torch.topology.structure import (circulant_structure,
                                                sparse_structure)
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(2)
    wide, huge = D2 * D2, D1 * D2
    print(f"kernel rows 1, 1f, 3, 3f at the baselines' operands (DGBO d2² "
          f"= {wide}, DGTBO d1·d2 = {huge} columns)")

    def measure(kname, key, label, pool, launch, plain_fn, lib_fn, symbol,
                b, iters, fused_ef=None):
        got, want = launch(pool[0]), plain_fn(pool[0])
        torch.cuda.synchronize()
        err = check(label, got, want, "float32") if fused_ef is None \
            else check_fused(label, got, want, fused_ef)
        bitwise(label, got, want, "the plain version")
        del got, want
        ms = cuda_ms(torch, launch, pool, iters=iters, warmup=2)
        dev_ms = device_ms(torch, launch, pool, symbol, iters=20)
        plain = cuda_ms(torch, plain_fn, pool, iters=3, warmup=1)
        lib, lib_err = try_library(torch, lib_fn, pool, iters=iters,
                                   warmup=2)
        print(f"    ms={ms:.5f} device_ms={dev_ms:.5f} plain_ms={plain:.5f} "
              f"library_ms={lib_text(lib, lib_err)} bound_ms={b[0]:.5f} "
              f"({b[1]})")
        results.setdefault(kname, {})[key] = dict(
            err=err, ms=ms, dev=dev_ms, plain=plain, lib=lib,
            lib_err=lib_err, bound=b[0], by=b[1])

    def ring_of(n):
        W = make_network("ring", n).W
        return W, circulant_structure(W), sparse_structure(W)

    # row 1, ring W·Y: DGBO (16, d2²), DGTBO (8, d1·d2)
    for n, d, iters in ((N_AGENTS, wide, 50), (N_DGTBO, huge, 10)):
        W, s, _ = ring_of(n)
        host = dict(w_self=s.w_self, offsets=s.offsets, weights=s.weights)
        Wt = torch.as_tensor(W, dtype=torch.float32, device=dev)
        pool = [torch.randn((n, d), generator=gen, device=dev)]
        k = len(s.offsets)
        measure("circulant_mix_matvec", (n, d, "float32", False),
                f"row 1 ({n}, {d}) W·Y ring", pool,
                lambda t: mm.circulant_mix_matvec(t, **host),
                lambda t: ref.circulant_mix_ref(t, s.w_self, s.offsets,
                                                s.weights),
                lambda t: torch.matmul(Wt, t), "circulant_mix_",
                bound(2 * n * d * 4 + 8 * k, 2 * (k + 1) * n * d), iters)
        del pool
        torch.cuda.empty_cache()

    # row 1f, ring int8+ef W·Y at DGBO's (16, d2²)
    W, s, _ = ring_of(N_AGENTS)
    host = dict(w_self=s.w_self, offsets=s.offsets, weights=s.weights)
    csr = torch.as_tensor(W, dtype=torch.float32, device=dev).to_sparse_csr()
    bits, ef, pool = wire_operands(torch, gen, N_AGENTS, wide, "int8+ef")
    k = len(s.offsets)
    measure("circulant_mix_matvec_comm", (N_AGENTS, wide, "int8+ef", False),
            f"row 1f ({N_AGENTS}, {wide}) int8+ef W·Y ring", pool,
            lambda t: mm.circulant_mix_matvec(*t[:3], SEED, t[3],
                                              comm="int8+ef", **host),
            lambda t: ref.circulant_mix_fused_ref(*t[:3], SEED, t[3],
                                                  bits=bits, **host),
            lambda t: torch.sparse.mm(csr, t[0]), "circulant_mix_",
            fused_bound(N_AGENTS, wide, k, ef, False, 8 * k), 50,
            fused_ef=ef)
    del pool

    # row 3f, Erdős–Rényi int8+ef W·Y at DGBO's (16, d2²)
    net = make_network("erdos_renyi", N_AGENTS, r=0.5, seed=0)
    sp = sparse_structure(net.W)
    tabs = [torch.as_tensor(a, device=dev) for a in (sp.w_self,
                                                     sp.neighbors,
                                                     sp.weights)]
    csr = torch.as_tensor(net.W, dtype=torch.float32,
                          device=dev).to_sparse_csr()
    bits, ef, pool = wire_operands(torch, gen, N_AGENTS, wide, "int8+ef")
    measure("sparse_mix_matvec_comm", (N_AGENTS, wide, "int8+ef", False),
            f"row 3f ({N_AGENTS}, {wide}) int8+ef W·Y Erdős–Rényi "
            f"k={sp.k}", pool,
            lambda t: mm.sparse_mix_matvec(t[0], *tabs, *t[1:3], SEED, t[3],
                                           comm="int8+ef"),
            lambda t: ref.sparse_mix_fused_ref(t[0], *tabs, *t[1:3], SEED,
                                               t[3], bits=bits),
            lambda t: torch.sparse.mm(csr, t[0]), "sparse_mix_",
            fused_bound(N_AGENTS, wide, sp.nnz / N_AGENTS, ef, False,
                        sp.nnz * 8 + N_AGENTS * 4), 50, fused_ef=ef)
    del pool

    # row 3, DGTBO's (4, d1·d2) on an n = 4 ring: the padded gather, k = 2
    n = 4
    W, _, sp = ring_of(n)
    tabs = [torch.as_tensor(a, device=dev) for a in (sp.w_self,
                                                     sp.neighbors,
                                                     sp.weights)]
    csr = torch.as_tensor(W, dtype=torch.float32, device=dev).to_sparse_csr()
    pool = [torch.randn((n, huge), generator=gen, device=dev)]
    measure("sparse_mix_matvec", (n, huge, "float32", False),
            f"row 3 ({n}, {huge}) W·Y ring n = 4 k={sp.k}", pool,
            lambda t: mm.sparse_mix_matvec(t, *tabs),
            lambda t: ref.sparse_mix_padded_ref(t, *tabs),
            lambda t: torch.sparse.mm(csr, t), "sparse_mix_",
            bound(2 * n * huge * 4 + sp.nnz * 8 + n * 4,
                  2 * (sp.nnz / n + 1) * n * huge), 10)
    del pool
    torch.cuda.empty_cache()


def ring_sweep_phase(torch, results: dict) -> None:
    """The circulant ring's shapes, swept on the card: the Neumann
    step's ring at every (bn, stages) its kernel takes at (4096, d2),
    (4096, d1) (f32 and bf16), (16, d2) and (16, d1), and the plain
    mix's ring at bn = n with each stage count at (16, d2), (16, d1)
    and (128, d1), each launch bitwise against the unstaged kernel and
    timed beside it (device ms).  `neumann_ring_plan` and
    `circulant_ring_stages` take their rules from these numbers."""
    from repro_torch.kernels import mixing_matvec as mm
    from repro_torch.topology import make_network
    from repro_torch.topology.structure import circulant_structure

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(2)
    beta = 0.1
    sweep = results.setdefault("ring_sweep", {})
    cases = [(N_LARGE, D2, torch.float32), (N_LARGE, D1, torch.float32),
             (N_LARGE, D2, torch.bfloat16), (N_LARGE, D1, torch.bfloat16),
             (N_AGENTS, D2, torch.float32), (N_AGENTS, D1, torch.float32)]
    for n, d, dt in cases:
        s = circulant_structure(make_network("ring", n).W)
        kw = dict(w_self=s.w_self, offsets=s.offsets, weights=s.weights,
                  beta=beta)
        h_lo, h_hi = mm.halo_extents(s.offsets, n)
        item = torch.tensor([], dtype=dt).element_size()

        def make(n=n, d=d, dt=dt):
            h, hvp, p = (torch.randn((n, d), generator=gen,
                                     device=dev).to(dt) for _ in range(3))
            return h, hvp, p, 1.5 + torch.rand((n, 1), generator=gen,
                                               device=dev)
        pool = operand_pool(torch, make, 4 * n * d * item)
        it = 20 if d == D1 and n == N_LARGE else 50

        def go_old(t):
            with mm.smem_budget(0):
                return mm.circulant_neumann_step(*t, **kw)
        old = go_old(pool[0])
        old_dev = device_ms(torch, go_old, pool, "circulant_neumann_kernel",
                            iters=it)
        plan = mm.neumann_ring_plan(n, h_lo, h_hi, itemsize=item, d=d)
        print(f"sweep circulant_neumann_step ({n}, {d}) {dt}: unstaged "
              f"device_ms={old_dev:.5f}; planner {plan}")
        best = None
        for bn in sorted({n, 128, 64, 32, 16, 8, 4, 2}, reverse=True):
            if bn > n or n % bn or bn < max(h_lo, h_hi):
                continue
            one = mm.neumann_stage_bytes(bn, h_lo, h_hi, itemsize=item)
            for st in range(1, min(mm.HALO_STAGES,
                                   mm.SMEM_BUDGET_BYTES // one) + 1):
                def go(t, ring=(bn, st)):
                    return mm.circulant_neumann_step(*t, ring=ring, **kw)
                got = go(pool[0])
                torch.cuda.synchronize()
                diff = int((got != old).sum().item())
                if diff:
                    raise AssertionError(f"sweep ({n}, {d}) bn={bn} "
                                         f"stages={st}: {diff} elements "
                                         f"differ from the unstaged kernel")
                dev_ms = device_ms(torch, go, pool,
                                   "circulant_neumann_ring_kernel", iters=it)
                print(f"  bn={bn} stages={st} smem={st * one} "
                      f"device_ms={dev_ms:.5f} (elements differing 0)")
                sweep[("neumann", n, d, str(dt), bn, st)] = dev_ms
                if best is None or dev_ms < best[0]:
                    best = (dev_ms, bn, st)
        print(f"  fastest: bn={best[1]} stages={best[2]} "
              f"device_ms={best[0]:.5f}")
        del pool, old
    for n, d in ((N_AGENTS, D2), (N_AGENTS, D1), (128, D1)):
        s = circulant_structure(make_network("ring", n).W)
        kw = dict(w_self=s.w_self, offsets=s.offsets, weights=s.weights)
        h_lo, h_hi = mm.halo_extents(s.offsets, n)
        one = mm.halo_smem_bytes(h_lo + n + h_hi)
        pool = operand_pool(torch, lambda n=n, d=d: torch.randn(
            (n, d), generator=gen, device=dev), n * d * 4)

        def go_old(t):
            with mm.smem_budget(one - 1):
                return mm.circulant_mix_matvec(t, **kw)
        old = go_old(pool[0])
        old_dev = device_ms(torch, go_old, pool, "circulant_mix_kernel")
        print(f"sweep circulant_mix_matvec ({n}, {d}) float32: unstaged "
              f"device_ms={old_dev:.5f}; planner stages "
              f"{mm.circulant_ring_stages(n, h_lo, h_hi, d=d)}")
        for st in range(1, mm.halo_stages(h_lo + n + h_hi) + 1):
            def go(t, st=st):
                return mm.circulant_mix_matvec(t, ring=(n, st), **kw)
            diff = int((go(pool[0]) != old).sum().item())
            if diff:
                raise AssertionError(f"sweep ({n}, {d}) stages={st}: "
                                     f"{diff} elements differ")
            dev_ms = device_ms(torch, go, pool, "circulant_mix_halo_kernel")
            print(f"  bn={n} stages={st} smem={st * one} "
                  f"device_ms={dev_ms:.5f} (elements differing 0)")
            sweep[("mix", n, d, "float32", n, st)] = dev_ms
        del pool, old


@functools.lru_cache(maxsize=None)
def large_networks():
    """The large-network path's graphs at n = N_LARGE: the ring and an
    Erdős–Rényi graph (r = ER_R_LARGE, seed 0)."""
    from repro_torch.topology import make_network
    return (make_network("ring", N_LARGE),
            make_network("erdos_renyi", N_LARGE, r=ER_R_LARGE, seed=0))


def halo_kernel_phase(torch, results: dict) -> None:
    """The row-tiled halo kernels at the large-network path's shapes,
    (4096, 157000) and (4096, 2010): at the planner's row tile and at
    half and twice it, each launch held bitwise against the full-operand
    kernel (plain output; fused payload and output) and within tolerance
    of its plain version; the compressed sparse gather on each of its
    routes (slab c = 8, 4, 2, 1; row tiles), bitwise against the
    full-operand kernel and its plain version; timed at the planner's
    row tile (and each route of the compressed gather), beside the
    full-operand kernel's device time and `torch.sparse.mm` with a CSR W
    (the library yardstick: it computes the uncompressed mix)."""
    from repro_torch.kernels import mixing_matvec as mm
    from repro_torch.kernels import ref
    from repro_torch.topology.structure import (circulant_structure,
                                                sparse_structure)

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(1)
    n = N_LARGE
    ring, er = large_networks()
    s = circulant_structure(ring.W)
    sp = sparse_structure(er.W)
    k = len(s.offsets)
    host = dict(w_self=s.w_self, offsets=s.offsets, weights=s.weights)
    tabs = host
    er_tabs = tuple(torch.as_tensor(a, device=dev)
                    for a in (sp.w_self, sp.neighbors, sp.weights))
    h_lo, h_hi = mm.halo_extents(s.offsets, n)
    eye = torch.eye(n, device=dev)
    csr = {}
    for name, net in (("ring", ring), ("er", er)):
        W = torch.as_tensor(net.W, dtype=torch.float32, device=dev)
        csr[name] = (W.to_sparse_csr(), (eye - W).to_sparse_csr())
    shapes = [(n, D1), (n, D2)]
    dtypes = [("float32", torch.float32), ("bfloat16", torch.bfloat16)]

    def tiles(planned):
        return [planned, planned // 2, planned * 2]

    def timings(kname, key, launch, plain_fn, pool, symbol, full_fn,
                full_symbol, lib_fn, b, err, bn):
        big = key[1] == D1
        ms = cuda_ms(torch, launch, pool, iters=50 if big else 200)
        dev_ms = device_ms(torch, launch, pool, symbol)
        full_dev = device_ms(torch, full_fn, pool, full_symbol)
        plain = cuda_ms(torch, plain_fn, pool, iters=3 if big else 20,
                        warmup=1)
        lib, lib_err = try_library(torch, lib_fn, pool,
                                   iters=20 if big else 200)
        print(f"    bn={bn} ms={ms:.5f} device_ms={dev_ms:.5f} "
              f"full-operand device_ms={full_dev:.5f} plain_ms={plain:.5f} "
              f"library_ms(sparse.mm CSR "
              f"{'float32' if key[2] in COMMS else key[2]})="
              f"{lib_text(lib, lib_err)} "
              f"bound_ms={b[0]:.5f} ({b[1]})")
        results.setdefault(kname, {})[key] = dict(
            err=err, ms=ms, dev=dev_ms, plain=plain, lib=lib,
            lib_err=lib_err, bound=b[0], by=b[1], bn=bn, full_dev=full_dev)

    # -- circulant_mix_matvec_halo ---------------------------------------
    print(f"kernel circulant_mix_matvec_halo (ring n={n}, row tiles)")
    for d_ in (D1, D2):
        for dname, dt in dtypes:
            item = torch.tensor([], dtype=dt).element_size()
            pool = operand_pool(torch, lambda: torch.randn(
                (n, d_), generator=gen, device=dev).to(dt), n * d_ * item)
            planned = mm.pick_halo_bn(n, h_lo=h_lo, h_hi=h_hi,
                                      itemsize=item)
            for lap in (False, True):
                y = pool[0]
                want = ref.circulant_mix_ref(y.float(), s.w_self, s.offsets,
                                             s.weights, lap).to(dt)
                full = mm.circulant_mix_matvec(y, laplacian=lap, **tabs)
                err = 0.0
                for bn in tiles(planned):
                    got = mm.circulant_mix_matvec_halo(y, laplacian=lap,
                                                       bn=bn, **host)
                    torch.cuda.synchronize()
                    tag = f"({n}, {d_}) {dname} laplacian={lap} bn={bn}"
                    bitwise(tag, got, full)
                    err = max(err, check(tag, got, want, dname))
                del got, full, want
                if lap != (d_ == D1):
                    continue        # time (I−W)·X at d1 and W·Y at d2

                def launch(t, lap=lap):
                    return mm.circulant_mix_matvec_halo(
                        t, laplacian=lap, bn=planned, **host)
                A = csr["ring"][int(lap)]
                timings("circulant_mix_matvec_halo", (n, d_, dname, lap),
                        launch, lambda t, lap=lap: ref.circulant_mix_ref(
                            t.float(), s.w_self, s.offsets, s.weights,
                            lap).to(t.dtype), pool, "circulant_mix_halo_kernel",
                        lambda t, lap=lap: mm.circulant_mix_matvec(
                            t, laplacian=lap, **tabs), "circulant_mix_kernel",
                        csr_mm(torch, A, dt),
                        bound(2 * n * d_ * item + 8 * k,
                              (2 * (k + 1) + lap) * n * d_), err, planned)
                rows = h_lo + planned + h_hi
                stages = mm.halo_stages(rows, itemsize=item)
                print(f"    the ring: {stages} stages of "
                      f"{mm.halo_smem_bytes(rows, itemsize=item)} bytes")
                results["circulant_mix_matvec_halo"][
                    (n, d_, dname, lap)]["stages"] = stages
            del pool

    # -- circulant_mix_matvec_halo, comm-fused ---------------------------
    print(f"kernel circulant_mix_matvec_halo_comm (ring n={n}, int8/int4 "
          f"± EF, row tiles)")
    for d_ in (D1, D2):
        for comm in COMMS:
            bits, ef, pool = wire_operands(torch, gen, n, d_, comm)
            planned = mm.pick_halo_bn(n, h_lo=h_lo, h_hi=h_hi,
                                      blocks=mm.plan_blocks(True, ef))
            for lap in (False, True):
                t = pool[0]
                want = ref.circulant_mix_fused_ref(
                    *t[:3], SEED, t[3], laplacian=lap, bits=bits, **host)
                full = mm.circulant_mix_matvec(*t[:3], SEED, t[3],
                                               laplacian=lap, comm=comm,
                                               **tabs)
                err = 0.0
                for bn in tiles(planned):
                    got = mm.circulant_mix_matvec_halo(
                        *t[:3], SEED, t[3], laplacian=lap, bn=bn, comm=comm,
                        **host)
                    torch.cuda.synchronize()
                    tag = f"({n}, {d_}) {comm} laplacian={lap} bn={bn}"
                    bitwise(tag, got, full)
                    err = max(err, check_fused(tag, got, want, ef))
                del got, full, want
                if lap != (d_ == D1):
                    continue

                def launch(t, lap=lap, comm=comm):
                    return mm.circulant_mix_matvec_halo(
                        *t[:3], SEED, t[3], laplacian=lap, bn=planned,
                        comm=comm, **host)
                A = csr["ring"][int(lap)]
                timings("circulant_mix_matvec_halo_comm", (n, d_, comm, lap),
                        launch, lambda t, lap=lap, bits=bits:
                        ref.circulant_mix_fused_ref(
                            *t[:3], SEED, t[3], laplacian=lap, bits=bits,
                            **host), pool, "circulant_mix_halo_comm_kernel",
                        lambda t, lap=lap, comm=comm: mm.circulant_mix_matvec(
                            *t[:3], SEED, t[3], laplacian=lap, comm=comm,
                            **tabs), "circulant_mix_stripe_comm_kernel",
                        lambda t: torch.sparse.mm(A, t[0]),
                        fused_bound(n, d_, k, ef, lap, 8 * k), err, planned)
                rows = h_lo + planned + h_hi
                stages = mm.halo_comm_stages(rows, ef=ef)
                print(f"    the ring: {stages} stages of "
                      f"{1 + ef} x {mm.halo_smem_bytes(rows)} bytes and "
                      f"the decoded tile")
                results["circulant_mix_matvec_halo_comm"][
                    (n, d_, comm, lap)]["stages"] = stages
            del pool

    # the sparse gathers' routes, driven at n = 4096 by a lower budget
    # (`smem_budget`): the slab at the planner's width, then the three
    # narrower ones, and the row-tiled kernel (None), which the planner
    # gives n > 33,536
    def slab_routes(item):
        widths = mm.slab_cols_for(item)
        routes = [(c, mm.slab_smem_bytes(n, c, item)) for c in widths]
        routes.append((None, mm.slab_smem_bytes(n, widths[-1], item) - 1))
        assert mm.plan_slab_cols(n, item) == widths[0]
        return routes

    def route_name(cols, bn):
        return f"slab c={cols}" if cols else f"row tiles bn={bn}"

    def on_route(budget, fn):
        def launch(t):
            with mm.smem_budget(budget):
                return fn(t)
        return launch

    # -- sparse_mix_matvec_halo ------------------------------------------
    # every route with MixingOp's row plan (degree order, padded slots from
    # registers), each launch bitwise against the full-operand kernel and
    # the plain version; the planner's slab also without the plan and with
    # the real degrees in natural order, so that each step of the walk has
    # its own time
    plan = tuple(torch.as_tensor(a, device=dev)
                 for a in mm.sparse_row_plan(sp.neighbors, sp.weights))
    walks = (("no row plan", None),
             ("natural order, padded slots from registers",
              (torch.arange(n, dtype=torch.int32, device=dev), plan[1])))
    tnames = {torch.float32: "float", torch.bfloat16: "__nv_bfloat16"}
    print(f"kernel sparse_mix_matvec_halo (Erdős–Rényi n={n} r={ER_R_LARGE}"
          f" k={sp.k}, mean degree {sp.nnz / n:.2f}; routes: "
          f"{', '.join(route_name(c, 'b') for c, _ in slab_routes(4))})")
    for d_ in (D1, D2):
        for dname, dt in dtypes:
            item = torch.tensor([], dtype=dt).element_size()
            pool = operand_pool(torch, lambda: torch.randn(
                (n, d_), generator=gen, device=dev).to(dt), n * d_ * item)
            planned = mm.pick_halo_bn(n, itemsize=item)
            routes = slab_routes(item)
            top = routes[0][0]

            def symbol(cols, dt=dt):
                return (f"sparse_mix_slab_kernel<{tnames[dt]}, {cols}>"
                        if cols else "sparse_mix_halo_kernel")
            for lap in (False, True):
                y = pool[0]
                want = ref.sparse_mix_padded_ref(y.float(), *er_tabs,
                                                 lap).to(dt)
                full = mm.sparse_mix_matvec(y, *er_tabs, laplacian=lap)
                err = {}
                for cols, budget in routes:
                    # the row tiles that fit the lowered budget
                    for bn in [planned] if cols else [
                            b for b in tiles(planned)
                            if mm.halo_smem_bytes(b, itemsize=item)
                            <= budget]:
                        with mm.smem_budget(budget):
                            assert mm.plan_slab_cols(n, item) == cols
                            got = mm.sparse_mix_matvec_halo(
                                y, *er_tabs, laplacian=lap, bn=bn,
                                row_plan=plan)
                        torch.cuda.synchronize()
                        tag = (f"({n}, {d_}) {dname} laplacian={lap} "
                               f"{route_name(cols, bn)}")
                        bitwise(tag, got, full)
                        bitwise(tag, got, want, "the plain version")
                        err[cols] = max(err.get(cols, 0.0),
                                        check(tag, got, want, dname))
                        del got
                for label, walk in walks:
                    got = mm.sparse_mix_matvec_halo(
                        y, *er_tabs, laplacian=lap, bn=planned,
                        row_plan=walk)
                    torch.cuda.synchronize()
                    tag = (f"({n}, {d_}) {dname} laplacian={lap} "
                           f"{route_name(top, planned)}, {label}")
                    bitwise(tag, got, full)
                    del got
                del full, want
                if lap != (d_ == D1):
                    continue        # time (I−W)·X at d1 and W·Y at d2

                def launch(t, lap=lap, walk=plan):
                    return mm.sparse_mix_matvec_halo(t, *er_tabs,
                                                     laplacian=lap,
                                                     bn=planned,
                                                     row_plan=walk)
                A = csr["er"][int(lap)]
                key = (n, d_, dname, lap)
                timings("sparse_mix_matvec_halo", key,
                        launch, lambda t, lap=lap: ref.sparse_mix_padded_ref(
                            t.float(), *er_tabs, lap).to(t.dtype), pool,
                        symbol(top),
                        lambda t, lap=lap: mm.sparse_mix_matvec(
                            t, *er_tabs, laplacian=lap),
                        "sparse_mix_stripe_kernel",
                        csr_mm(torch, A, dt),
                        bound(2 * n * d_ * item + sp.nnz * 8 + n * 4,
                              (2 * (sp.nnz + n) + lap * n) * d_), err[top],
                        planned)
                # the walk's steps and the other routes: ms and device ms
                # on the same operands (plain, library and bound as the
                # row above; a route's ms includes the budget switch, a
                # few µs on the host)
                row = results["sparse_mix_matvec_halo"][key]
                row.update(slab_cols=top, routes=[], walk={})
                big = d_ == D1
                it, warm = (5, 1) if big else (50, 5)
                for label, walk in walks:
                    go = functools.partial(launch, walk=walk)
                    ms = cuda_ms(torch, go, pool, iters=it, warmup=warm)
                    dev_ms = device_ms(torch, go, pool, symbol(top),
                                       iters=it)
                    print(f"    {route_name(top, planned)}, {label}: "
                          f"ms={ms:.5f} device_ms={dev_ms:.5f}")
                    row["walk"][label] = dict(ms=ms, device_ms=dev_ms)
                for cols, budget in routes[1:]:
                    go = on_route(budget, launch)
                    ms = cuda_ms(torch, go, pool, iters=it, warmup=warm)
                    dev_ms = device_ms(torch, go, pool, symbol(cols),
                                       iters=it)
                    print(f"    {route_name(cols, planned)}: ms={ms:.5f} "
                          f"device_ms={dev_ms:.5f}")
                    if cols:
                        row["routes"].append(dict(
                            slab_cols=cols, max_abs_err=err[cols], ms=ms,
                            device_ms=dev_ms, bitwise=True))
                    else:
                        results.setdefault(
                            "sparse_mix_matvec_halo_rows", {})[key] = dict(
                            err=err[cols], ms=ms, dev=dev_ms,
                            plain=row["plain"], lib=row["lib"],
                            bound=row["bound"], by=row["by"],
                            full_dev=row["full_dev"], bn=planned)
            del pool

    # -- sparse_mix_matvec_halo, comm-fused (no EF) ----------------------
    # every route (the slab at c = 8, 4, 2, 1 and the row-tiled kernel),
    # each launch bitwise against the full-operand kernel and the plain
    # version
    routes = slab_routes(4)

    print(f"kernel sparse_mix_matvec_halo_comm (Erdős–Rényi n={n}, "
          f"int8/int4; routes: "
          f"{', '.join(route_name(c, 'b') for c, _ in routes)})")
    for d_ in (D1, D2):
        for comm in ("int8", "int4"):
            bits, _, pool = wire_operands(torch, gen, n, d_, comm)
            planned = mm.pick_halo_bn(n, blocks=mm.plan_blocks(True))
            for lap in (False, True):
                t = pool[0]
                want = ref.sparse_mix_halo_ref(t[0], *er_tabs, *t[1:3],
                                               SEED, laplacian=lap,
                                               bn=planned, bits=bits)
                full = mm.sparse_mix_matvec(t[0], *er_tabs, *t[1:3], SEED,
                                            laplacian=lap, comm=comm)
                err = {}
                for cols, budget in routes:
                    for bn in [planned] if cols else tiles(planned):
                        with mm.smem_budget(budget):
                            assert mm.plan_slab_cols(n) == cols
                            got = mm.sparse_mix_matvec_halo(
                                t[0], *er_tabs, *t[1:3], SEED,
                                laplacian=lap, bn=bn, comm=comm)
                        torch.cuda.synchronize()
                        tag = (f"({n}, {d_}) {comm} laplacian={lap} "
                               f"{route_name(cols, bn)}")
                        bitwise(tag, got, full)
                        bitwise(tag, got, want, "the plain version")
                        err[cols] = max(err.get(cols, 0.0),
                                        check_fused(tag, got, want, False))
                        del got
                del full, want
                if lap != (d_ == D1):
                    continue

                def launch(t, lap=lap, comm=comm, bn=planned):
                    return mm.sparse_mix_matvec_halo(
                        t[0], *er_tabs, *t[1:3], SEED, laplacian=lap,
                        bn=bn, comm=comm)
                A = csr["er"][int(lap)]
                key = (n, d_, comm, lap)
                timings("sparse_mix_matvec_halo_comm", key,
                        launch, lambda t, lap=lap, bits=bits:
                        ref.sparse_mix_fused_ref(
                            t[0], *er_tabs, *t[1:3], SEED, laplacian=lap,
                            bits=bits), pool, "sparse_mix_slab_comm_kernel",
                        lambda t, lap=lap, comm=comm: mm.sparse_mix_matvec(
                            t[0], *er_tabs, *t[1:3], SEED, laplacian=lap,
                            comm=comm), "sparse_mix_stripe_comm_kernel",
                        lambda t: torch.sparse.mm(A, t[0]),
                        fused_bound(n, d_, sp.nnz / n, False, lap,
                                    sp.nnz * 8 + n * 4), err[routes[0][0]],
                        planned)
                # the other routes: ms and device ms on the same operands
                # (plain, library and bound as the slab's row above; ms
                # includes the budget switch, a few µs on the host)
                slab = results["sparse_mix_matvec_halo_comm"][key]
                slab["slab_cols"] = routes[0][0]
                slab["routes"] = []
                big = d_ == D1
                for cols, budget in routes[1:]:
                    go = on_route(budget, launch)
                    ms = cuda_ms(torch, go, pool, iters=5 if big else 50,
                                 warmup=1 if big else 5)
                    symbol = (f"sparse_mix_slab_comm_kernel<{cols}>" if cols
                              else "sparse_mix_halo_comm_kernel")
                    dev_ms = device_ms(torch, go, pool, symbol,
                                       iters=5 if big else 50)
                    print(f"    {route_name(cols, planned)}: ms={ms:.5f} "
                          f"device_ms={dev_ms:.5f}")
                    row = dict(err=err[cols], ms=ms, dev=dev_ms,
                               plain=slab["plain"], lib=slab["lib"],
                               bound=slab["bound"], by=slab["by"],
                               full_dev=slab["full_dev"])
                    if cols:
                        slab["routes"].append(dict(
                            slab_cols=cols, max_abs_err=err[cols], ms=ms,
                            device_ms=dev_ms, bitwise=True))
                    else:
                        results.setdefault(
                            "sparse_mix_matvec_halo_comm_rows",
                            {})[key] = dict(row, bn=planned)
            del pool


def main_path_phase(torch, counts_out: dict) -> None:
    import numpy as np

    from repro_torch.core.problems import hyper_representation
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.solve import CommSpec, ScheduleSpec, SolverSpec, solve
    from repro_torch.topology import make_network

    def spec_for(comm):
        return SolverSpec(method="dagm", K=K, M=M, U=U, dihgp="matrix_free",
                          schedule=ScheduleSpec(alpha=0.1, beta=0.1),
                          comm=CommSpec(comm))
    probs = {dev: hyper_representation(N_AGENTS, d=D_IN, hidden=HIDDEN,
                                       n_classes=N_CLASSES, m_per=M_PER,
                                       seed=0, device=dev)
             for dev in ("cuda", "cpu")}
    # the CPU reference runs only the ring identity solve (and its nudged
    # twin): every other run is held against the same solve on the card
    # through the kernels' plain versions, which the kernels equal bit
    # for bit
    assert (probs["cuda"].d1, probs["cuda"].d2) == (D1, D2)
    # the all-zero x0 is dead under ReLU: a random backbone, shared by
    # every agent, as the paper's MLP starts
    x0 = np.broadcast_to(
        0.3 * np.random.default_rng(42).standard_normal(D1),
        (N_AGENTS, D1)).astype(np.float32)
    y0 = (0.01 * np.random.default_rng(0).standard_normal(
        (N_AGENTS, D2))).astype(np.float32)
    ring = make_network("ring", N_AGENTS)
    er = make_network("erdos_renyi", N_AGENTS, r=0.5, seed=0)
    zero = dict.fromkeys(launch_counts(), 0)
    gossips = K * (M + U + 1)
    # (label, graph, comm spec, expected launches, ledger bytes)
    runs = [
        ("ring identity", ring, "identity",
         {**zero, **ring_identity_counts(N_AGENTS, K)}, 3461600),
        ("erdos_renyi identity", er, "identity",
         {**zero, "sparse_mix_matvec": gossips}, 3461600),
        ("ring int8+ef", ring, "int8+ef",
         {**zero, "circulant_mix_matvec_comm": gossips}, 865580),
        ("ring int4", ring, "int4",
         {**zero, "circulant_mix_matvec_comm": K * (M + 1),
          neumann_comm_counter(N_AGENTS): K * U}, 432880),
        ("erdos_renyi int8+ef", er, "int8+ef",
         {**zero, "sparse_mix_matvec_comm": gossips}, 865580),
    ]
    identity_metrics = {}
    timed, busy = {}, {}
    for label, net, comm, expected, ledger_bytes in runs:
        spec = spec_for(comm)
        print(f"main path: solve(hyper_representation d1={D1} d2={D2}, "
              f"{net.name}, K={K} M={M} U={U} dihgp=matrix_free, "
              f"comm={comm})")

        def run(dev, spec=spec, net=net, x0=x0, seed=0):
            return solve(probs[dev], net, spec, x0=x0, y0=y0, seed=seed,
                         device=dev)
        run("cuda")
        torch.cuda.synchronize()                     # warm-up run
        reset_launch_counts()
        t0 = time.perf_counter()
        res = run("cuda")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = launch_counts()
        timed[label] = run
        print(f"  launches {counts} expected {expected}")
        if counts != expected:
            raise AssertionError(f"{label}: launch counts {counts} != "
                                 f"{expected}")
        for name, c in counts.items():
            counts_out[name] = counts_out.get(name, 0) + c
        print(f"  seconds per round {dt / K:.6f} (host clock, {K} rounds, "
              f"after a warm-up run)")
        for key, val in res.metrics.items():
            if val.shape != (K,) or not torch.isfinite(val).all():
                raise AssertionError(f"{label}: metric {key} not finite "
                                     f"(K,): {val}")
        for name, t, shape in (("x", res.x, (N_AGENTS, D1)),
                               ("y", res.y, (N_AGENTS, D2))):
            if tuple(t.shape) != shape or not torch.isfinite(t).all():
                raise AssertionError(f"{label}: final {name} bad")
        metrics = {k: [round(float(v), 6) for v in val.cpu()]
                   for k, val in res.metrics.items()}
        print("  metrics", metrics)
        if comm == "identity":
            identity_metrics[net.name] = metrics
        else:
            print(f"  identity run's metrics on {net.name}",
                  identity_metrics[net.name])
        if label == "ring identity":
            cpu = run("cpu")
            compare_runs(torch, "CPU", res, cpu)
            nudged = run("cpu", x0=x0 * np.float32(1 + 1e-7))
            for name in ("x", "y"):
                print(f"  vs CPU {name}: norm_rel_err="
                      f"{norm_rel(getattr(res, name), getattr(cpu, name)):.3e}"
                      f"; CPU x0*(1+1e-7) "
                      f"{norm_rel(getattr(nudged, name), getattr(cpu, name)):.3e}")
            ref_bytes = cpu.ledger.total_bytes
        else:
            with plain_versions():
                plain = run("cuda")
            compare_runs(torch, "the card's plain versions", res, plain,
                         compressed=comm != "identity")
            # the kernels equal their plain versions bit for bit, and
            # nothing else differs between the two runs
            same_bits(torch, f"{label} vs the card's plain versions",
                      res, plain)
            ref_bytes = plain.ledger.total_bytes
            del plain
        preview = spec.comm_ledger(D1, D2).total_bytes
        print(f"  ledger total_bytes={res.ledger.total_bytes} (reference "
              f"run {ref_bytes}, spec preview {preview}, expected "
              f"{ledger_bytes})")
        if not res.ledger.total_bytes == ref_bytes == preview \
                == ledger_bytes:
            raise AssertionError(f"{label}: ledger bytes disagree")
        by_kernel = {}
        busy[label] = profile_run(torch, lambda: run("cuda"), by_kernel)
        if comm != "identity":
            unstaged_run(torch, label, run, res, expected, by_kernel)
        elif net is ring:
            ring_route_run(torch, label, run, res, K, by_kernel)
    idle_shares(busy, time_in_turns(torch, timed), K)


def neumann_comm_counter(n: int) -> str:
    """The counter of the comm-fused Neumann step's route at the n-agent
    solve's (n, d2) operands, by the planner."""
    from repro_torch.kernels import mixing_matvec as mm
    return "circulant_neumann_step_comm" if \
        mm.plan_neumann_comm_stripe_cols(n, D2) \
        else "circulant_neumann_step_comm_unstaged"


def same_bits(torch, what, res, other) -> None:
    """x, y and every metric of two runs equal bit for bit."""
    for name in ("x", "y"):
        diff = int((getattr(res, name) != getattr(other, name)).sum().item())
        print(f"  {what} {name}: elements differing {diff} (bitwise)")
        if diff:
            raise AssertionError(f"{what}: {name} differs")
    for key, val in res.metrics.items():
        if not torch.equal(val, other.metrics[key]):
            raise AssertionError(f"{what}: metric {key} differs")


def ring_identity_counts(n: int, rounds: int) -> dict:
    """The launches of a ring identity solve's rows 1 and 5 by the
    planners' routes: per round M d2 mixes and one d1 mix (on the full
    tier: the ring at bn = n or its unstaged kernel; on the halo tier the
    halo kernel) and U Neumann steps at d2 (the ring or its unstaged
    kernel)."""
    from repro_torch.kernels import mixing_matvec as mm
    counts: dict = {}
    for d, c in ((D2, rounds * M), (D1, rounds)):
        name = ring_mix_counter(n, d)
        counts[name] = counts.get(name, 0) + c
    name = "circulant_neumann_step" if mm.neumann_ring_plan(
        n, 1, 1, d=D2) else "circulant_neumann_step_unstaged"
    counts[name] = rounds * U
    return counts


# the ring solves' kernels of rows 1, 2 and 5, by their device symbols
RING_KERNELS = (("circulant_mix_halo_kernel", "the circulant ring's mix "
                 "(row 1 at bn = n, row 2 on the halo tier)"),
                ("circulant_mix_kernel", "row 1's unstaged kernel"),
                ("circulant_neumann_ring_kernel", "row 5 on the ring"),
                ("circulant_neumann_kernel", "row 5's unstaged kernel"))


def ring_route_run(torch, label, run, res, rounds, by_kernel) -> None:
    """The same ring identity solve with rows 1 and 5 on their unstaged
    kernels, reached through a budget no tile fits (which at n = 4096
    also moves the mix off the halo ring onto row 1's unstaged kernel):
    exact launch counts, equal to the planner's run bit for bit, and
    the device time per solve of each ring kernel on both routes from
    one profiled run each."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels import mixing_matvec as mm
    moved = {**dict.fromkeys(launch_counts(), 0),
             "circulant_mix_matvec_unstaged": rounds * (M + 1),
             "circulant_neumann_step_unstaged": rounds * U}
    old_kernels = {}
    with mm.smem_budget(0):
        reset_launch_counts()
        old = run("cuda")
        torch.cuda.synchronize()
        counts = launch_counts()
        print(f"  unstaged route: launches {counts} expected {moved}")
        if counts != moved:
            raise AssertionError(f"{label}: unstaged launch counts {counts} "
                                 f"!= {moved}")
        profile_run(torch, lambda: run("cuda"), old_kernels)
    for name in ("x", "y"):
        diff = int((getattr(res, name) != getattr(old, name)).sum().item())
        print(f"  unstaged route vs the planner's {name}: elements "
              f"differing {diff} (bitwise)")
        if diff:
            raise AssertionError(f"{label}: the unstaged route's {name} "
                                 f"differs from the planner's")
    for key, val in res.metrics.items():
        if not torch.equal(val, old.metrics[key]):
            raise AssertionError(f"{label}: metric {key} differs between "
                                 f"the routes")
    del old
    for route, by in (("planner", by_kernel), ("unstaged", old_kernels)):
        parts = []
        for symbol, what in RING_KERNELS:
            us = sum(v for key, v in by.items()
                     if f"{symbol}<" in key or key.endswith(symbol))
            parts.append(f"{what} {us:.1f} us")
        print(f"  ring kernels, device time per solve, {route} route: "
              + "; ".join(parts))


def unstaged_run(torch, label, run, res, expected, by_kernel) -> None:
    """The same compressed solve with the fused full-operand gossips on
    their unstaged kernels (the kernels the decoded stripe replaced,
    reached through a lower planner budget): exact launch counts, equal
    to the stripe run bit for bit, and the gossips' device time per
    solve on each route from one profiled run."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels import mixing_matvec as mm
    fused = ("circulant_mix_matvec_comm", "sparse_mix_matvec_comm",
             "circulant_neumann_step_comm")
    moved = {**dict.fromkeys(expected, 0),
             **{name + "_unstaged" if name in fused else name: c
                for name, c in expected.items() if c}}
    old_kernels = {}
    with mm.smem_budget(mm.stripe_bytes(N_AGENTS,
                                        mm.stripe_cols_for(4)[-1]) - 1):
        reset_launch_counts()
        old = run("cuda")
        torch.cuda.synchronize()
        counts = launch_counts()
        print(f"  unstaged route: launches {counts} expected {moved}")
        if counts != moved:
            raise AssertionError(f"{label}: unstaged launch counts {counts} "
                                 f"!= {moved}")
        profile_run(torch, lambda: run("cuda"), old_kernels)
    for name in ("x", "y"):
        diff = int((getattr(res, name) != getattr(old, name)).sum().item())
        print(f"  unstaged route vs decoded stripe {name}: elements "
              f"differing {diff} (bitwise)")
        if diff:
            raise AssertionError(f"{label}: the unstaged route's {name} "
                                 f"differs from the decoded stripe's")
    for key, val in res.metrics.items():
        if not torch.equal(val, old.metrics[key]):
            raise AssertionError(f"{label}: metric {key} differs between "
                                 f"the routes")
    new_us = sum(us for key, us in by_kernel.items()
                 if "stripe_comm_kernel" in key and "neumann" not in key)
    old_us = sum(us for key, us in old_kernels.items()
                 if "comm_unstaged_kernel" in key)
    print(f"  fused full-operand gossips, device time per solve: decoded "
          f"stripe {new_us:.1f} us, unstaged kernels {old_us:.1f} us "
          f"(saved {old_us - new_us:.1f} us)")
    steps = expected.get("circulant_neumann_step_comm", 0) \
        + expected.get("circulant_neumann_step_comm_unstaged", 0)
    if steps:
        for route, by, counts in (("planner", by_kernel, expected),
                                  ("unstaged", old_kernels, moved)):
            parts = []
            for symbol, counter in (
                    ("circulant_neumann_stripe_comm_kernel",
                     "circulant_neumann_step_comm"),
                    ("circulant_neumann_comm_kernel",
                     "circulant_neumann_step_comm_unstaged")):
                us = sum(v for key, v in by.items() if symbol in key)
                parts.append(f"{counter} x{counts.get(counter, 0)} "
                             f"{us:.1f} us")
            print(f"  Neumann steps ({steps} a solve), device time per "
                  f"solve, {route} route: " + "; ".join(parts))


def fig2_network_phase(torch, counts_out: dict) -> None:
    """The §6.2 solve on an Erdős–Rényi graph of N_FIG2 agents (r = 0.5,
    the network size of the paper's Fig. 2), K = K_LARGE rounds on the
    identity wire: every gossip goes through the full-operand sparse
    gather's column stripe.  Exact launch counts, exact ledger bytes,
    finite metrics, equality bit for bit with the same solve on the card
    through the plain versions, and seconds per round (median of three
    runs after a warm-up run)."""
    import numpy as np

    from repro_torch.core.problems import hyper_representation
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.solve import ScheduleSpec, SolverSpec, solve
    from repro_torch.topology import make_network

    n = N_FIG2
    prob = hyper_representation(n, d=D_IN, hidden=HIDDEN,
                                n_classes=N_CLASSES, m_per=M_PER, seed=0,
                                device="cuda")
    x0 = np.broadcast_to(
        0.3 * np.random.default_rng(42).standard_normal(D1),
        (n, D1)).astype(np.float32)
    y0 = (0.01 * np.random.default_rng(0).standard_normal(
        (n, D2))).astype(np.float32)
    net = make_network("erdos_renyi", n, r=0.5, seed=0)
    spec = SolverSpec(method="dagm", K=K_LARGE, M=M, U=U,
                      dihgp="matrix_free",
                      schedule=ScheduleSpec(alpha=0.1, beta=0.1))
    print(f"fig2: solve(hyper_representation n={n} d1={D1} d2={D2}, "
          f"{net.name} r=0.5, K={K_LARGE} M={M} U={U} dihgp=matrix_free, "
          f"comm=identity)")

    def run():
        return solve(prob, net, spec, x0=x0, y0=y0, seed=0, device="cuda")
    run()
    torch.cuda.synchronize()                         # warm-up run
    reset_launch_counts()
    res = run()
    torch.cuda.synchronize()
    counts = launch_counts()
    expected = {**dict.fromkeys(counts, 0),
                "sparse_mix_matvec": K_LARGE * (M + U + 1)}
    print(f"  launches {counts} expected {expected}")
    if counts != expected:
        raise AssertionError(f"fig2: launch counts {counts} != {expected}")
    for name, c in counts.items():
        counts_out[name] = counts_out.get(name, 0) + c
    for key, val in res.metrics.items():
        if val.shape != (K_LARGE,) or not torch.isfinite(val).all():
            raise AssertionError(f"fig2: metric {key} not finite (K,): "
                                 f"{val}")
    for name, t, shape in (("x", res.x, (n, D1)), ("y", res.y, (n, D2))):
        if tuple(t.shape) != shape or not torch.isfinite(t).all():
            raise AssertionError(f"fig2: final {name} bad")
    print("  metrics", {k: [round(float(v), 6) for v in val.cpu()]
                        for k, val in res.metrics.items()})
    preview = spec.comm_ledger(D1, D2).total_bytes
    print(f"  ledger total_bytes={res.ledger.total_bytes} (spec preview "
          f"{preview})")
    if res.ledger.total_bytes != preview:
        raise AssertionError("fig2: ledger bytes disagree")
    with plain_versions():
        plain = run()
    for name in ("x", "y"):
        got, want = getattr(res, name), getattr(plain, name)
        diff = int((got != want).sum().item())
        print(f"  vs the card's plain versions {name}: elements differing "
              f"{diff} (bitwise)")
        if diff:
            raise AssertionError(f"fig2: {name} differs from the run "
                                 f"through the plain versions")
    for key, val in res.metrics.items():
        if not torch.equal(val, plain.metrics[key]):
            raise AssertionError(f"fig2: metric {key} differs from the run "
                                 f"through the plain versions")
    del res, plain
    seconds = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        seconds.append((time.perf_counter() - t0) / K_LARGE)
    print(f"  seconds per round median {median(seconds):.6f} all "
          f"{' '.join(f'{t:.6f}' for t in seconds)} (host clock, {K_LARGE} "
          f"rounds per run, after a warm-up run)")
    busy = profile_run(torch, run)
    if busy is not None:
        wall = median(seconds) * K_LARGE * 1e6
        print(f"  device busy {busy:.1f} us of {wall:.1f} us unprofiled "
              f"(idle share {1 - busy / wall:.4f})")


def large_network_phase(torch, counts_out: dict) -> None:
    """The same §6.2 solve on n = N_LARGE agents, K = K_LARGE rounds:
    the shared-memory planner sends every gossip through a halo kernel.
    Each run: exact launch counts, exact ledger bytes, agreement with the
    same solve on the card through the plain versions, seconds per
    round, peak device memory and one profiled run."""
    import numpy as np

    from repro_torch.core.problems import hyper_representation
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.solve import CommSpec, ScheduleSpec, SolverSpec, solve
    from repro_torch.topology import ops as tops

    n = N_LARGE
    prob = hyper_representation(n, d=D_IN, hidden=HIDDEN,
                                n_classes=N_CLASSES, m_per=M_PER, seed=0,
                                device="cuda")
    assert (prob.d1, prob.d2) == (D1, D2)
    # x0 and y0 as in the n = 16 runs, put on the card once: the 2.57 GB
    # host-to-device copy of x0 is set-up, not a round
    x0 = torch.as_tensor(np.broadcast_to(
        0.3 * np.random.default_rng(42).standard_normal(D1),
        (n, D1)).astype(np.float32), device="cuda")
    y0 = torch.as_tensor((0.01 * np.random.default_rng(0).standard_normal(
        (n, D2))).astype(np.float32), device="cuda")
    ring, er = large_networks()
    timed, busy = {}, {}
    zero = dict.fromkeys(launch_counts(), 0)
    gossips = K_LARGE * (M + U + 1)
    # (label, graph, comm spec, expected launches, ledger bytes): per
    # agent, K_LARGE rounds of M + U d2 gossips and one d1 gossip
    runs = [
        ("ring identity", ring, "identity",
         {**zero, **ring_identity_counts(n, K_LARGE)}, 2076960),
        ("ring int4", ring, "int4",
         {**zero, "circulant_mix_matvec_halo_comm": gossips}, 259728),
        ("ring int8+ef", ring, "int8+ef",
         {**zero, "circulant_mix_matvec_halo_comm": gossips}, 519348),
        ("erdos_renyi identity", er, "identity",
         {**zero, "sparse_mix_matvec_halo": gossips}, 2076960),
        ("erdos_renyi int8", er, "int8",
         {**zero, "sparse_mix_matvec_halo_comm": gossips}, 519348),
    ]
    for label, net, comm, expected, ledger_bytes in runs:
        spec = SolverSpec(method="dagm", K=K_LARGE, M=M, U=U,
                          dihgp="matrix_free",
                          schedule=ScheduleSpec(alpha=0.1, beta=0.1),
                          comm=CommSpec(comm))
        print(f"large: solve(hyper_representation n={n} d1={D1} d2={D2}, "
              f"{net.name}, K={K_LARGE} M={M} U={U} dihgp=matrix_free, "
              f"comm={comm})")

        def run(dev="cuda", spec=spec, net=net):
            return solve(prob, net, spec, x0=x0, y0=y0, seed=0,
                         device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        counts = launch_counts()
        print(f"  launches {counts} expected {expected}")
        if counts != expected:
            raise AssertionError(f"{label}: launch counts {counts} != "
                                 f"{expected}")
        for name, c in counts.items():
            counts_out[name] = counts_out.get(name, 0) + c
        print(f"  peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        for key, val in res.metrics.items():
            if val.shape != (K_LARGE,) or not torch.isfinite(val).all():
                raise AssertionError(f"{label}: metric {key} not finite "
                                     f"(K,): {val}")
        for name, t, shape in (("x", res.x, (n, D1)), ("y", res.y, (n, D2))):
            if tuple(t.shape) != shape or not torch.isfinite(t).all():
                raise AssertionError(f"{label}: final {name} bad")
        print("  metrics", {k: [round(float(v), 6) for v in val.cpu()]
                            for k, val in res.metrics.items()})
        preview = spec.comm_ledger(D1, D2).total_bytes
        print(f"  ledger total_bytes={res.ledger.total_bytes} (spec preview "
              f"{preview}, expected {ledger_bytes})")
        if not res.ledger.total_bytes == preview == ledger_bytes:
            raise AssertionError(f"{label}: ledger bytes disagree")
        with plain_versions():
            plain = run()
        compare_runs(torch, "the card's plain versions", res, plain,
                     compressed=comm != "identity", norm_rel_xy=True)
        del plain
        print(f"  seconds per round of the first run {first / K_LARGE:.6f} "
              f"(host clock)")
        timed[label] = run
        by_kernel = {}
        busy[label] = profile_run(torch, run, by_kernel)
        if label == "ring identity":
            ring_route_run(torch, label, run, res, K_LARGE, by_kernel)
            neumann_on_solve_operands(torch, run)
        del res
    # every solve builds its MixingOp (structure detection over the dense
    # (n, n) W on the host), set-up that the K_LARGE rounds share: timed
    # inside each timed run, so each run's rounds are its time less its
    # own set-up
    spent = []

    def timed_build(*args, **kw):
        t0 = time.perf_counter()
        op = build(*args, **kw)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return op
    build, tops.make_mixing_op = tops.make_mixing_op, timed_build
    try:
        seconds = time_in_turns(torch, timed, rounds=K_LARGE)
    finally:
        tops.make_mixing_op = build
    idle_shares(busy, seconds, K_LARGE)
    print("net of each run's MixingOp set-up (make_mixing_op inside solve):")
    for j, (label, ts) in enumerate(seconds.items()):
        setups = spent[j::len(seconds)]
        net = median([t * K_LARGE - u for t, u in zip(ts, setups)])
        line = (f"  {label}: set-up median {median(setups):.3f} s, all "
                f"{' '.join(f'{u:.3f}' for u in setups)}; seconds per round "
                f"net {net / K_LARGE:.6f}")
        if busy[label] is not None:
            line += (f"; device busy {busy[label] / 1e6:.6f} s of {net:.6f} s "
                     f"(idle share {1 - busy[label] / 1e6 / net:.4f})")
        print(line)


def neumann_on_solve_operands(torch, run) -> None:
    """Row 5 on the operands the n = 4096 ring identity solve hands it
    (captured from one more run) and on random ones of the same shape:
    device ms of the planner's ring, of nearby (bn, stages) and of the
    unstaged kernel, each over both pools in turn, so that a gap between
    the solve's per-launch time and the kernel phase's reads as the
    operands' or the solve's surroundings'.  Also the operands' share of
    zeros and of subnormals (IEEE division takes its slow path there)."""
    from repro_torch.kernels import mixing_matvec as mm
    from repro_torch.topology import ops as tops
    captured = []
    real = tops.circulant_neumann_step

    def capture(*args, **kw):
        captured.append((tuple(a.clone() for a in args), kw))
        return real(*args, **kw)
    tops.circulant_neumann_step = capture
    try:
        run()
    finally:
        tops.circulant_neumann_step = real
    torch.cuda.synchronize()
    kw = captured[0][1]
    solve_pool = [a for a, _ in captured]
    h = solve_pool[0][0]
    gen = torch.Generator(h.device).manual_seed(3)
    random_pool = [tuple(torch.randn(h.shape, generator=gen,
                                     device=h.device) for _ in range(3))
                   + (a[3],) for a in solve_pool]
    tiny = 1.1754944e-38
    for name, i in (("h", 0), ("hvp_h", 1), ("p", 2)):
        t = torch.stack([a[i] for a in solve_pool])
        print(f"  row 5 on the solve's operands: {name} zeros "
              f"{(t == 0).float().mean().item():.4f}, subnormal "
              f"{((t != 0) & (t.abs() < tiny)).float().mean().item():.6f}")
    dsc = torch.stack([a[3] for a in solve_pool])
    print(f"  D~ in [{dsc.min().item():.6g}, {dsc.max().item():.6g}] over "
          f"{len(solve_pool)} launches at {tuple(h.shape)}")
    plans = [None, (8, 1), (8, 2), (16, 2), (32, 1), (32, 2), "unstaged"]
    for pool_name, pool in (("solve", solve_pool), ("random", random_pool)):
        parts = []
        for plan in plans:
            def go(t, plan=plan):
                if plan == "unstaged":
                    with mm.smem_budget(0):
                        return real(*t, **kw)
                return real(*t, ring=plan, **kw) if plan else real(*t, **kw)
            symbol = "circulant_neumann_kernel" if plan == "unstaged" \
                else "circulant_neumann_ring_kernel"
            ms = device_ms(torch, go, pool, symbol, iters=45)
            parts.append(f"{plan or 'planner'} {ms:.5f}")
        print(f"  row 5 device_ms on the {pool_name} operands: "
              + "; ".join(parts))
    del captured, solve_pool, random_pool


def routes_phase(torch, out: dict) -> None:
    """MixingOp's routes on the card, at the main path's n = 16 and d2
    width: an explicit "circulant" or "sparse_gather" backend, and "auto"
    with the kernel switch off, launch no kernel and backpropagate (the
    gradient of <g, W·y> is Wᵀ·g); "auto" with the switch on launches.
    Then the caller's TF32 flags, set here to True, are unchanged after
    solve, MixingOp's gossips and kernels.ops (each runs inside
    `strict_f32`)."""
    from repro_torch.core.problems import quadratic_bilevel
    from repro_torch.kernels import (kernel_mode, launch_counts, ops,
                                     reset_launch_counts)
    from repro_torch.solve import SolverSpec, solve
    from repro_torch.topology import make_mixing_op, make_network

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(SEED)
    ring = make_network("ring", N_AGENTS)
    er = make_network("erdos_renyi", N_AGENTS, r=0.5, seed=0)
    h, hvp, p, g = (torch.randn((N_AGENTS, D2), generator=gen, device=dev)
                    for _ in range(4))
    dsc = torch.full((N_AGENTS, 1), 2.0, device=dev)
    cases = [("ring, explicit circulant", ring, "circulant", True, 0),
             ("ER, explicit sparse_gather", er, "sparse_gather", True, 0),
             ("ring, auto, switch off", ring, "auto", False, 0),
             ("ER, auto, switch off", er, "auto", False, 0),
             ("ring, auto, switch on", ring, "auto", True, 3),
             ("ER, auto, switch on", er, "auto", True, 3)]
    for label, net, backend, switch, launches in cases:
        op = make_mixing_op(net, backend, device=dev)
        W = torch.as_tensor(net.W, dtype=torch.float32, device=dev)
        with kernel_mode(switch):
            reset_launch_counts()
            if launches:
                op.mix(h)
                grad_err = 0.0
            else:
                y = h.clone().requires_grad_()
                (op.mix(y) * g).sum().backward()
                grad_err = (y.grad - W.T @ g).abs().max().item()
            op.laplacian(h)
            op.neumann_step(h, hvp, p, dsc, 0.1)
            torch.cuda.synchronize()
        n = sum(launch_counts().values())
        print(f"  routes: {label}: launches {n} expected {launches}"
              + ("" if launches else f"; gradient vs Wᵀ·g max_abs_err "
                                     f"{grad_err:.3e}"))
        if n != launches or not grad_err <= 1e-5:
            raise AssertionError(f"routes: {label}")
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = True
    try:
        make_mixing_op(er, device=dev).mix(h)
        q = torch.randn((1, 128, 2, 64), generator=gen, device=dev)
        ops.attention(q, q, q)
        solve(quadratic_bilevel(8, 4, 4, device="cuda"),
              make_network("ring", 8), SolverSpec(K=1, M=1, U=1),
              device="cuda")
        torch.cuda.synchronize()
        flags = (matmul.allow_tf32, cudnn.allow_tf32)
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved
    print(f"  routes: TF32 flags after MixingOp, ops.attention and solve "
          f"{flags}, set to (True, True) by the caller")
    if flags != (True, True):
        raise AssertionError("an entry point left TF32 flags changed")
    out["routes"] = len(cases)


# The kernels.ops path (attention and the RWKV6 WKV mix) at the head widths
# of three configurations the repo ships (src/repro/configs) and the
# sequence lengths of configs/base.py INPUT_SHAPES; the batch is cut from
# the global batch (256 at train_4k, 32 at prefill_32k) to one card's.
ATTN_CASES = {
    # name: (B, S, q heads, kv heads, hd, causal, window, dtype)
    "qwen3-4b train_4k f32": (2, 4096, 32, 8, 128, True, 0, "float32"),
    "qwen3-4b train_4k bf16": (2, 4096, 32, 8, 128, True, 0, "bfloat16"),
    "mixtral-8x7b prefill_32k bf16": (1, 32768, 32, 8, 128, True, 4096,
                                      "bfloat16"),
    # the window's tile skip held at f32's tolerance: one 64-key tile
    # dropped or added moves outputs by ~3e-3
    "mixtral-8x7b prefill_32k f32": (1, 32768, 32, 8, 128, True, 4096,
                                     "float32"),
    # pins the kernel's semantics: the window holds without causal
    "non-causal window 32 f32": (1, 1024, 4, 4, 128, False, 32, "float32"),
    # head dims outside the powers of two, padded to 80 and 256 in shared
    # memory: the kernels' whole range (no shipped configuration has them)
    "head dim 80 f32": (1, 2048, 8, 8, 80, True, 0, "float32"),
    "head dim 80 bf16": (1, 2048, 8, 8, 80, True, 0, "bfloat16"),
    "head dim 256 f32": (1, 2048, 8, 8, 256, True, 0, "float32"),
    "head dim 256 bf16": (1, 2048, 8, 8, 256, True, 0, "bfloat16"),
}
WKV_CASE = ("rwkv6-7b train_4k f32", (4, 4096, 64, 64))   # B, T, H, hd
# rwkv6-7b with bf16 inputs, and head dims off the 64-row tiles (hd 96:
# a half tile; 320: five tiles, above the old kernel's limit of 256);
# name: ((B, T, H, hd), input dtype, the replaced kernel's device ms on
# the H100 at 700 W (PR 16 chip_smoke, PERF.md row 8), or None)
WKV_CASES = {
    WKV_CASE[0]: (WKV_CASE[1], "float32", 2.36928),
    "rwkv6-7b train_4k bf16": (WKV_CASE[1], "bfloat16", None),
    "head dim 96 f32": ((1, 2048, 16, 96), "float32", 2.73199),
    "head dim 256 f32": ((1, 2048, 8, 256), "float32", 5.21522),
    "head dim 320 f32": ((1, 2048, 8, 320), "float32", None),
}
OPS_LAYERS = 4           # calls per configuration on the path: 4 layers
# tensor-core peaks.  f32 attention's least time is taken at the fastest
# f32-accurate rate: 3xTF32 (three TF32 mma per product, each input split
# into a TF32 high and low part) at 495 / 3 = 165 TFLOP/s of f32 work,
# above the CUDA cores' 67; bf16 at one bf16 mma per product
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 495e12
TF32_SPLIT = 3
# (atol, rtol).  f32 and the WKV scan as tests/test_kernels.py holds
# repro's kernels.  bf16: the kernel and its plain version both compute
# in f32 from the same bf16 inputs and round once to bf16, so they may
# differ by one bf16 rounding, ≤ 2^-7·|want|, plus f32 summation-order
# noise (far below 1e-6 for outputs of size ~1).
ATTN_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-6, 2.0 ** -7)}
WKV_TOL = (1e-4, 1e-4)


def allclose_err(name, got, want, tol) -> float:
    """max |got − want|; fails unless |got − want| ≤ atol + rtol·|want|
    everywhere, with (atol, rtol) = tol."""
    atol, rtol = tol
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    excess = (diff - atol - rtol * want.float().abs()).max().item()
    ok = excess <= 0 and all_finite(got)
    print(f"  {name}: max_abs_err={err:.3e} (atol={atol:g}, "
          f"rtol={rtol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


def all_finite(t) -> bool:
    return bool(t.float().isfinite().all().item())


def attention_pairs(S: int, causal: bool, window: int) -> int:
    """Unmasked (q, k) pairs of one head: the kernel's masks."""
    total = 0
    for qi in range(S):
        lo = max(0, qi - window + 1) if window else 0
        hi = qi + 1 if causal else S
        total += hi - lo
    return total


def events_ms(torch, fn, args, iters: int) -> float:
    """Mean ms per launch of back-to-back launches between two CUDA
    events, one launch already in flight when the first event is
    recorded: for kernels that run far longer than their host launch
    cost (~10-20 µs) the device never waits for the host, so this is
    the kernels' device time."""
    fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    fn(*args)
    start.record()
    for _ in range(iters):
        fn(*args)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms_of(torch, fn, args, symbol: str, iters: int,
                 attempts: int = 2):
    """(device ms, method) of the kernel named like `symbol`, the mean
    over `iters` launches.  First from torch.profiler ("profiler"): the
    tracer misses the first launches of a window (up to 3 of 50 on the
    H100), and of a window of a few long launches all of them, so one
    step of the same launches runs under the profiler's warm-up before
    the step it records.  Where no attempt records all `iters` launches,
    a kernel that runs 0.1 ms or more is timed by `events_ms` ("events");
    a shorter one is not measured (None)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    for attempt in range(attempts):
        recorded = []
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: recorded.append(
                         p.key_averages())) as prof:
            for _ in range(2):
                for _ in range(iters):
                    fn(*args)
                torch.cuda.synchronize()
                prof.step()
        hits = [e for e in (recorded[0] if recorded else ())
                if symbol in e.key
                and getattr(e, "self_device_time_total", 0) > 0]
        count = sum(e.count for e in hits)
        if count == iters:
            return (sum(e.self_device_time_total for e in hits) / count
                    / 1e3, "profiler")
        print(f"  profiler saw {count} launches of {symbol}, expected "
              f"{iters} (attempt {attempt + 1} of {attempts})")
    ms = events_ms(torch, fn, args, iters)
    if ms >= 0.1:
        print(f"  device ms of {symbol} from CUDA events around {iters} "
              f"back-to-back launches: {ms:.5f}")
        return ms, "events"
    print(f"  device ms of {symbol}: not measured (the profiler did not "
          f"record all {iters} launches, and {ms:.5f} ms is too short for "
          f"the events to stand for device time)")
    return None, "not measured"


def ops_kernel_phase(torch, out: dict) -> None:
    """The flash-attention and WKV-scan kernels against their plain
    versions at the three configurations' widths, timed; then the
    `kernels.ops` path (attention and wkv, OPS_LAYERS calls each) with
    exact launch counts, the switch off, and shapes off the kernel
    route."""
    import torch.nn.functional as F

    from repro_torch.kernels import (kernel_mode, launch_counts, ops,
                                     reset_launch_counts)
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels._cuda_lib import card_sms
    from repro_torch.kernels.rwkv6_scan import plan_wkv_cols, rwkv6_scan

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(SEED)

    def randn(shape, dtype=torch.float32, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)
                ).to(dtype)

    def attn_inputs(B, S, H, KV, hd, dtype):
        """q (B, S, H, hd); k, v with KV heads broadcast to H outside the
        kernel, as `repro`'s flash_attention docstring asks."""
        q = randn((B, S, H, hd), dtype)
        k, v = (randn((B, S, KV, hd), dtype).repeat_interleave(H // KV, 2)
                for _ in range(2))
        return q, k, v

    def wkv_inputs(B, T, H, hd, dtype=torch.float32):
        """Drawn as tests/test_kernels.py draws them, in dtype (u f32)."""
        r, k, v = (randn((B, T, H, hd), dtype, scale=0.5) for _ in range(3))
        logw = (-torch.exp(randn((B, T, H, hd)).clamp(-8, 2))).to(dtype)
        return r, k, v, logw, randn((H, hd), scale=0.5)

    rows = out.setdefault("rows", {})
    for name, (B, S, H, KV, hd, causal, window, dt) in ATTN_CASES.items():
        dtype = getattr(torch, dt)
        print(f"kernel flash_attention: {name} (B={B}, S={S}, H={H}, "
              f"kv heads {KV}, hd={hd}) causal={causal} window={window}")
        q, k, v = attn_inputs(B, S, H, KV, hd, dtype)
        kw = dict(causal=causal, window=window)
        got = flash_attention(q, k, v, **kw)
        want = ref.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err = allclose_err("vs flash_attention_ref", got, want, ATTN_TOL[dt])
        if not causal and window:
            gap = (want.float() - ref.attention_ref(q, k, v, **kw).float()
                   ).abs().max().item()
            print(f"  attention_ref (window only under causal) differs by "
                  f"{gap:.3e}: the kernel's masks hold, as repro's kernel")
            if gap < 1e-2:
                raise AssertionError("the window did not apply without "
                                     "causal")
        del got, want
        long = S * S * B * H > 2 ** 31
        ms = cuda_ms(torch, lambda t: flash_attention(*t, **kw), [(q, k, v)],
                     iters=3 if long else 10, warmup=1)
        dev_ms, dev_how = device_ms_of(
            torch, functools.partial(flash_attention, **kw), (q, k, v),
            "flash_attention_kernel", iters=2 if long else 5)
        plain = cuda_ms(torch, lambda t: ref.flash_attention_ref(*t, **kw),
                        [(q, k, v)], iters=1 if long else 3, warmup=1)
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        if window:            # an explicit (S, S) mask: SDPA has no window
            i = torch.arange(S, device=dev)
            keep = (i[:, None] - i[None, :]) < window
            if causal:
                keep &= i[None, :] <= i[:, None]
            sdpa_kw = dict(attn_mask=keep)
        else:
            sdpa_kw = dict(is_causal=causal)
        lib = cuda_ms(torch, lambda t: F.scaled_dot_product_attention(
            *t, **sdpa_kw), [(qt, kt, vt)], iters=3 if long else 10,
            warmup=1)
        del sdpa_kw
        pairs = attention_pairs(S, causal, window) * B * H
        nbytes = 4 * B * S * H * hd * q.element_size()
        flops = 4 * hd * pairs
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / (BF16_FLOP_PER_S if dt == "bfloat16"
                         else TF32_FLOP_PER_S / TF32_SPLIT) * 1e3
        b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else \
            (t_ops, "operations")
        print(f"    ms={ms:.5f} device_ms={dev_ms} ({dev_how}) "
              f"plain_ms={plain:.5f} "
              f"library_ms(scaled_dot_product_attention)={lib:.5f} "
              f"bound_ms={b_ms:.5f} ({b_by}: {pairs} unmasked pairs x "
              f"4·{hd} FLOP = {flops:.4e} FLOP; {nbytes} bytes)")
        rows[("flash_attention", name)] = dict(
            err=err, ms=ms, dev=dev_ms, dev_how=dev_how, plain=plain,
            lib=lib, bound=b_ms, by=b_by, shape=[B, S, H, hd], dtype=dt)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()

    for name, ((B, T, H, hd), dt, old_ms) in WKV_CASES.items():
        dtype = getattr(torch, dt)
        cols = plan_wkv_cols(B, H, hd, card_sms(dev))
        print(f"kernel rwkv6_scan: {name} (B={B}, T={T}, H={H}, hd={hd}, "
              f"{dt} inputs; {cols}-column state tiles)")
        ins = wkv_inputs(B, T, H, hd, dtype)
        got = rwkv6_scan(*ins)
        want = ref.rwkv6_scan_ref(*ins)
        torch.cuda.synchronize()
        err = allclose_err("vs rwkv6_scan_ref", got, want, WKV_TOL)
        ms = cuda_ms(torch, lambda t: rwkv6_scan(*t), [ins], iters=10,
                     warmup=2)
        dev_ms, dev_how = device_ms_of(torch, rwkv6_scan, ins,
                                       "rwkv6_scan_kernel", iters=5)
        plain = cuda_ms(torch, lambda t: ref.rwkv6_scan_ref(*t), [ins],
                        iters=1, warmup=0)
        # r, k, v, logw read once, u read once, out (f32) written once;
        # 5·hd² FLOP per step: the products r·S and k·v (4 hd²) at the
        # fastest f32-accurate rate, 3xTF32's (as attention's f32 bound),
        # the decay w·S (hd²) at the f32 rate
        item = ins[0].element_size()
        nbytes = B * T * H * hd * (4 * item + 4) + H * hd * 4
        flops = 5 * B * T * H * hd * hd
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = (0.8 * flops / (TF32_FLOP_PER_S / TF32_SPLIT)
                 + 0.2 * flops / F32_FLOP_PER_S) * 1e3
        b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else \
            (t_ops, "operations")
        old = (f"; PR 16's kernel {old_ms:.5f} ms (PERF.md row 8)"
               if old_ms else "")
        print(f"    ms={ms:.5f} device_ms={dev_ms} ({dev_how}) "
              f"plain_ms={plain:.5f} library_ms=n/a (no PyTorch call "
              f"computes the WKV recurrence) bound_ms={b_ms:.5f} ({b_by}: "
              f"{nbytes} bytes; {flops:.4e} FLOP){old}")
        if (B, T, H, hd) == WKV_CASE[1]:
            # the staging's copy width: every row 16-byte aligned against
            # the same operands one element past alignment (4-byte copies
            # in f32, 2-byte loads in bf16), the same bits, device ms by
            # CUDA events in turns
            def shifted(t):
                buf = torch.empty(t.numel() + 1, dtype=t.dtype,
                                  device=t.device)
                buf[1:] = t.flatten()
                return buf[1:].view(t.shape)
            off = (*(shifted(a) for a in ins[:4]), ins[4])
            if not torch.equal(rwkv6_scan(*off), got):
                raise AssertionError(f"{name}: the views one element past "
                                     f"alignment give other bits")
            turns = {"aligned": [], "one element off": []}
            for _ in range(3):
                for key, args in (("aligned", ins),
                                  ("one element off", off)):
                    turns[key].append(events_ms(torch, rwkv6_scan, args,
                                                10))
            print("    staging, device ms by CUDA events (3 turns of 10): "
                  + "; ".join(f"{key} median {median(v):.5f} all "
                              + " ".join(f"{x:.5f}" for x in v)
                              for key, v in turns.items())
                  + "; bitwise equal")
            del off
        rows[("rwkv6_scan", name)] = dict(
            err=err, ms=ms, dev=dev_ms, dev_how=dev_how, plain=plain,
            lib=None, bound=b_ms, by=b_by, shape=[B, T, H, hd], dtype=dt,
            cols=cols)
        del got, want, ins

    # -- the path: kernels.ops.attention and .wkv ------------------------
    zero = dict.fromkeys(launch_counts(), 0)
    path = ["qwen3-4b train_4k bf16", "mixtral-8x7b prefill_32k bf16"]
    reset_launch_counts()
    t0 = time.perf_counter()
    last = {}
    for name in path:
        B, S, H, KV, hd, causal, window, dt = ATTN_CASES[name]
        q, k, v = attn_inputs(B, S, H, KV, hd, getattr(torch, dt))
        for layer in range(OPS_LAYERS):
            o = ops.attention(q, k, v, causal=causal, window=window)
            if o.shape != q.shape or o.dtype != q.dtype \
                    or not all_finite(o):
                raise AssertionError(f"ops.attention {name} layer {layer}: "
                                     f"bad output")
            q = o                      # the next layer attends from this
        last[name] = (q, k, v)
    wr, wk, wv, wlogw, wu = wkv_inputs(*WKV_CASE[1])
    for layer in range(OPS_LAYERS):
        o = ops.wkv(wr, wk, wv, wlogw, wu)
        if o.shape != wr.shape or o.dtype != torch.float32 \
                or not all_finite(o):
            raise AssertionError(f"ops.wkv layer {layer}: bad output")
        wr = 0.5 * o / o.abs().max()   # the next layer's receptance
    torch.cuda.synchronize()
    counts = launch_counts()
    expected = {**zero, "flash_attention": OPS_LAYERS * len(path),
                "rwkv6_scan": OPS_LAYERS}
    print(f"ops path: {OPS_LAYERS} layers of ops.attention at "
          f"{', '.join(path)} and of ops.wkv at {WKV_CASE[0]}: "
          f"{time.perf_counter() - t0:.1f} s")
    print(f"  launches {counts} expected {expected}")
    if counts != expected:
        raise AssertionError(f"ops path: launch counts {counts} != "
                             f"{expected}")
    out["counts"] = counts

    # the same entry points off the kernel route launch nothing; where
    # the two routes' semantics agree (causal, no window) their outputs do
    q, k, v = last["qwen3-4b train_4k bf16"]
    on_attn = ops.attention(q, k, v, causal=True)
    on_wkv = ops.wkv(wr, wk, wv, wlogw, wu)
    off = [
        ("kernel_mode(False) attention, qwen3-4b", False,
         lambda: ops.attention(q, k, v, causal=True), on_attn,
         ATTN_TOL["bfloat16"]),
        ("attention at S = 4032 (S % 128 != 0), qwen3-4b", True,
         lambda: ops.attention(q[:, :4032], k[:, :4032], v[:, :4032]),
         None, None),
        ("kernel_mode(False) wkv, rwkv6-7b", False,
         lambda: ops.wkv(wr, wk, wv, wlogw, wu), on_wkv, WKV_TOL),
        ("wkv at T = 4000 (T % 64 != 0), rwkv6-7b", True,
         lambda: ops.wkv(*(a[:, :4000] for a in (wr, wk, wv, wlogw)), wu),
         None, None),
    ]
    for label, enabled, call, kernel_out, tol in off:
        reset_launch_counts()
        with kernel_mode(enabled):
            o = call()
        torch.cuda.synchronize()
        counts = launch_counts()
        print(f"  {label}: launches {sum(counts.values())} expected 0")
        if counts != zero or not all_finite(o):
            raise AssertionError(f"{label}: {counts}")
        if kernel_out is not None:
            allclose_err("kernel route vs this oracle route", kernel_out, o,
                         tol)


# The paper's baselines (Table 2) at the §6.2 MLP's published widths.
# DGTBO's JHIP state is (n, d1, d2) f32, n x 1.26 GB: a solve peaked at
# 4.74 GiB per agent at n = 4 (H100 80GB HBM3), and its plain-version
# twin holds two more such arrays in the ring's rolls, so it runs at
# n = N_DGTBO, cut from 16 for memory: a ring whose 315,570,000-column
# gossips take the circulant kernel (row 1), over 2^31 elements.
K_BASE, B_DGBO, N_JHIP, N_DGTBO = 3, 3, 3, 8
# ledger floats per agent per outer round at the published widths (M =
# 5, U = 3, b = 3, N = 3): (measured — what runs, Appendix-S1 closed
# form — `comm_floats_per_round`)
BASE_FLOATS = {"dgbo": (M * D2 + B_DGBO * D2 * D2 + D1, 328018370),
               "dgtbo": (M * D2 + N_JHIP * D1 * D2 + D1, 946877050),
               "fednest": (354200, 354200),
               "ma_dbo": (M * D2 + U * D2 + 2 * D1, 330080)}
# fig4's reduced size (benchmarks/fig4_hyperrep.py): d = 20, hidden = 40,
# n = 10 agents on an Erdős–Rényi graph (r = 0.5), card against CPU
FIG4_N, FIG4_D, FIG4_HIDDEN = 10, 20, 40
BASE_RTOL, BASE_ATOL = 1e-4, 1e-5


def ring_mix_counter(n: int, d: int) -> str:
    """The counter of the plain ring mix's route at (n, d) by the
    planners: the halo kernel on the halo tier, else the ring at bn = n
    or its unstaged kernel."""
    from repro_torch.kernels import mixing_matvec as mm
    if mm.plan_row_tile(n, h_lo=1, h_hi=1)[0] == "halo":
        return "circulant_mix_matvec_halo"
    return "circulant_mix_matvec" if mm.circulant_ring_stages(n, 1, 1, d=d) \
        else "circulant_mix_matvec_unstaged"


def baseline_gossips(method: str) -> list[tuple[int, int]]:
    """(width, gossips per round) of a baseline's gossips at the
    published widths (`core.baselines`)."""
    return {"dgbo": [(D2, M), (D2 * D2, B_DGBO), (D1, 1)],
            "dgtbo": [(D2, M), (D1 * D2, N_JHIP), (D1, 1)],
            "fednest": [],
            "ma_dbo": [(D2, M + U), (D1, 2)]}[method]


def baseline_counts(method: str, backend: str, comm: str, n: int) -> dict:
    """A baseline solve's launches per kernel over K_BASE rounds."""
    counts: dict = {}
    for d, c in baseline_gossips(method):
        if backend == "sparse_gather":
            name = "sparse_mix_matvec" if comm == "identity" \
                else "sparse_mix_matvec_comm"
        elif comm == "identity":
            name = ring_mix_counter(n, d)
        else:
            name = "circulant_mix_matvec_comm"
        counts[name] = counts.get(name, 0) + K_BASE * c
    return counts


def inputs(torch, n: int, d1: int, d2: int, dev):
    """x0 = 0.3·N(0, I) with seed 42, the same for every agent, as
    `benchmarks/fig4_hyperrep.py`; y0 = 0.01·N(0, I) with seed 0."""
    import numpy as np
    x0 = torch.as_tensor(np.broadcast_to(
        0.3 * np.random.default_rng(42).standard_normal(d1),
        (n, d1)).astype(np.float32), device=dev)
    y0 = torch.as_tensor((0.01 * np.random.default_rng(0)
                          .standard_normal((n, d2))).astype(np.float32),
                         device=dev)
    return x0, y0


def check_finite(torch, label, res, rounds, n, d1, d2) -> None:
    """Finite (rounds,) metrics and finite final iterates of shape
    (n, d1) and (n, d2)."""
    for key, val in res.metrics.items():
        if val.shape != (rounds,) or not torch.isfinite(val).all():
            raise AssertionError(f"{label}: metric {key} not finite "
                                 f"(K,): {val}")
    for name, t, shape in (("x", res.x, (n, d1)), ("y", res.y, (n, d2))):
        if tuple(t.shape) != shape or not torch.isfinite(t).all():
            raise AssertionError(f"{label}: final {name} bad")


def device_split(by_kernel: dict, busy_us) -> str:
    """The profiled run's device time: the port's gossip kernels and the
    rest."""
    gossip = sum(by_kernel.values())
    if busy_us is None:
        return "device split not measured (the profiler saw no device time)"
    return (f"device {busy_us:.1f} us: gossip kernels {gossip:.1f} us, the "
            f"rest {busy_us - gossip:.1f} us")


def baselines_phase(torch, counts_out: dict) -> None:
    """`solve(method=...)` for the paper's four baselines on the §6.2 MLP
    at its published widths, K = K_BASE rounds: DGBO (b = 3), MA-DBO
    (U = 3) and FedNest (U = 3) on the n = 16 ring and Erdős–Rényi graph,
    DGBO and MA-DBO again with comm="int8+ef" on both, and DGTBO (N = 3)
    on an n = N_DGTBO ring.  Each run: exact launches per kernel, ledger
    floats and bytes per agent per round against the closed forms, peak
    memory, bitwise against the same solve through the plain versions,
    device time split between the gossip kernels and the rest, and
    seconds per round (median of three in turns).  Then all four
    methods at fig4's reduced size, card against CPU.  DGBO's batched
    LU and MA-DBO's Cholesky run where `core.baselines` puts them
    (cuSOLVER, `_cusolver`); this phase sets no library."""
    from repro_torch.core.problems import hyper_representation
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.solve import CommSpec, ScheduleSpec, SolverSpec, solve
    from repro_torch.topology import make_mixing_op, make_network

    probs = {n: hyper_representation(n, d=D_IN, hidden=HIDDEN,
                                     n_classes=N_CLASSES, m_per=M_PER,
                                     seed=0, device="cuda")
             for n in (N_AGENTS, N_DGTBO)}
    iterates = {n: inputs(torch, n, D1, D2, "cuda") for n in probs}
    ring = make_network("ring", N_AGENTS)
    er = make_network("erdos_renyi", N_AGENTS, r=0.5, seed=0)
    small_ring = make_network("ring", N_DGTBO)
    zero = dict.fromkeys(launch_counts(), 0)
    runs = [("dgbo", ring, "identity"), ("dgbo", er, "identity"),
            ("ma_dbo", ring, "identity"), ("ma_dbo", er, "identity"),
            ("fednest", ring, "identity"), ("fednest", er, "identity"),
            ("dgbo", ring, "int8+ef"), ("ma_dbo", ring, "int8+ef"),
            ("dgbo", er, "int8+ef"), ("ma_dbo", er, "int8+ef"),
            ("dgtbo", small_ring, "identity")]
    timed, busy = {}, {}
    for method, net, comm in runs:
        t_run = time.perf_counter()
        n = net.n
        label = f"{method} {net.name} {comm}"
        backend = make_mixing_op(net, device="cpu").backend
        expected = {**zero, **baseline_counts(method, backend, comm, n)}
        spec = SolverSpec(method=method, K=K_BASE, M=M, U=U, b=B_DGBO,
                          N=N_JHIP, schedule=ScheduleSpec(alpha=0.1,
                                                          beta=0.1),
                          comm=CommSpec(comm))
        print(f"baselines: solve(hyper_representation n={n} d1={D1} "
              f"d2={D2}, {net.name} ({backend}), method={method}, "
              f"K={K_BASE} M={M} U={U} b={B_DGBO} N={N_JHIP}, comm={comm})")

        def run(dev="cuda", spec=spec, net=net, n=n):
            x0, y0 = iterates[n]
            return solve(probs[n], net, spec, x0=x0, y0=y0, seed=0,
                         device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        res = run()
        torch.cuda.synchronize()
        counts = launch_counts()
        print(f"  launches {counts} expected {expected}")
        if counts != expected:
            raise AssertionError(f"{label}: launch counts {counts} != "
                                 f"{expected}")
        for name, c in counts.items():
            counts_out[name] = counts_out.get(name, 0) + c
        print(f"  peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        check_finite(torch, label, res, K_BASE, n, D1, D2)
        print("  metrics", {k: [round(float(v), 6) for v in val.cpu()]
                            for k, val in res.metrics.items()})
        floats, closed = BASE_FLOATS[method]
        per_round = res.ledger.total_floats / K_BASE
        print(f"  ledger per agent per round: {per_round:.0f} floats "
              f"(expected {floats}), {res.ledger.total_bytes / K_BASE:.0f} "
              f"bytes; comm_floats_per_round "
              f"{res.extras['comm_floats_per_round']} (Appendix S1, "
              f"expected {closed})")
        if per_round != floats \
                or res.extras["comm_floats_per_round"] != closed:
            raise AssertionError(f"{label}: ledger floats disagree")
        torch.cuda.reset_peak_memory_stats()
        with plain_versions():
            plain = run()
        torch.cuda.synchronize()
        print(f"  peak device memory of the plain-version run "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        same_bits(torch, f"{label} vs the card's plain versions", res,
                  plain)
        del res, plain
        by_kernel = {}
        busy[label] = profile_run(torch, run, by_kernel)
        print(f"  {device_split(by_kernel, busy[label])} per solve; the "
              f"run's checks took {time.perf_counter() - t_run:.1f} s")
        timed[label] = run
    t0 = time.perf_counter()
    idle_shares(busy, time_in_turns(torch, timed, rounds=K_BASE),
                K_BASE)
    print(f"baselines: the timing in turns took "
          f"{time.perf_counter() - t0:.1f} s")
    del timed
    torch.cuda.empty_cache()

    # fig4's reduced size, card against CPU.  After torch.set_num_threads
    # with more than one thread (main() sets the CPU's), MKL's batched LU
    # solve on the CPU (DGBO's torch.linalg.solve) fails "Parameter 6 was
    # incorrect on entry to SLASWP" and hangs (torch 2.11 and 2.13), so
    # the CPU runs take one thread
    net = make_network("erdos_renyi", FIG4_N, r=0.5, seed=0)
    small = {dev: hyper_representation(FIG4_N, d=FIG4_D, hidden=FIG4_HIDDEN,
                                       n_classes=N_CLASSES, m_per=M_PER,
                                       seed=0, device=dev)
             for dev in ("cuda", "cpu")}
    d1, d2 = small["cpu"].d1, small["cpu"].d2
    threads = torch.get_num_threads()
    for method in ("dgbo", "dgtbo", "fednest", "ma_dbo"):
        spec = SolverSpec(method=method, K=K_BASE, M=M, U=U, b=B_DGBO,
                          N=N_JHIP, schedule=ScheduleSpec(alpha=0.1,
                                                          beta=0.1))
        def run(dev, spec=spec):
            x0, y0 = inputs(torch, FIG4_N, d1, d2, dev)
            return solve(small[dev], net, spec, x0=x0, y0=y0, device=dev)
        t0 = time.perf_counter()
        got = run("cuda")
        torch.set_num_threads(1)
        try:
            want = run("cpu")
        finally:
            torch.set_num_threads(threads)
        errs = {name: (getattr(got, name).cpu() - getattr(want, name))
                .abs().max().item() for name in ("x", "y")}
        errs.update({key: (got.metrics[key].cpu() - val).abs().max().item()
                     for key, val in want.metrics.items()})
        print(f"baselines fig4 size (d1={d1} d2={d2} n={FIG4_N} ER) "
              f"{method}: card vs CPU max_abs_err "
              + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
              + f" (rtol {BASE_RTOL}, atol {BASE_ATOL}); both runs "
              f"{time.perf_counter() - t0:.1f} s")
        for name in ("x", "y"):
            torch.testing.assert_close(getattr(got, name).cpu(),
                                       getattr(want, name),
                                       rtol=BASE_RTOL, atol=BASE_ATOL)
        for key, val in want.metrics.items():
            torch.testing.assert_close(got.metrics[key].cpu(), val,
                                       rtol=BASE_RTOL, atol=BASE_ATOL)


def check_realized(trace, W) -> None:
    """Every realized W_k of a lowered fault trace is nonnegative,
    symmetric and doubly stochastic (on the host)."""
    import numpy as np
    worst = 0.0
    for k in range(trace.rounds):
        Wk = trace.realized_W(W, k)
        err = max(np.abs(Wk - Wk.T).max(), np.abs(Wk.sum(0) - 1).max(),
                  np.abs(Wk.sum(1) - 1).max())
        worst = max(worst, err)
        if Wk.min() < 0 or err > 1e-12:
            raise AssertionError(f"realized W_{k} is not symmetric doubly "
                                 f"stochastic (error {err})")
    print(f"  realized W_k, {trace.rounds} rounds: nonnegative, symmetric "
          f"and doubly stochastic (largest error {worst:.1e})")


def faults_phase(torch, counts_out: dict) -> None:
    """DAGM (matrix-free DIHGP, M = 5, U = 3) under
    FaultSpec(drop_prob=0.3, stragglers=(3,), churn=((5, 1, 3),)) at
    n = 16 on the ring and the Erdős–Rényi graph, K = K rounds, identity
    and int8+ef: every gossip on the masked sparse gather (row 3), each
    run bitwise against its run through the plain versions, the realized
    W_k checked.  An all-ones mask against the unfaulted solve on
    "sparse_gather_pallas", bitwise.  Then the faulted solve on the
    n = N_LARGE Erdős–Rényi graph, K = 2, identity: the masked slab
    (row 4)."""
    from repro_torch.core.problems import hyper_representation
    from repro_torch.faults import FaultSpec
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels import mixing_matvec as mm
    from repro_torch.solve import (CommSpec, MixingSpec, ScheduleSpec,
                                   SolverSpec, solve)
    from repro_torch.topology import make_network

    faults = FaultSpec(drop_prob=0.3, stragglers=(3,), churn=((5, 1, 3),),
                       seed=0)

    def spec_for(comm="identity", rounds=K, faults=faults, backend="auto"):
        return SolverSpec(method="dagm", K=rounds, M=M, U=U,
                          dihgp="matrix_free",
                          schedule=ScheduleSpec(alpha=0.1, beta=0.1),
                          mixing=MixingSpec(backend=backend),
                          comm=CommSpec(comm), faults=faults)

    prob = hyper_representation(N_AGENTS, d=D_IN, hidden=HIDDEN,
                                n_classes=N_CLASSES, m_per=M_PER, seed=0,
                                device="cuda")
    x0, y0 = inputs(torch, N_AGENTS, D1, D2, "cuda")
    ring = make_network("ring", N_AGENTS)
    er = make_network("erdos_renyi", N_AGENTS, r=0.5, seed=0)
    zero = dict.fromkeys(launch_counts(), 0)
    gossips = K * (M + U + 1)
    expected = {**zero, "sparse_mix_matvec": gossips}
    timed, busy = {}, {}
    for net in (ring, er):
        for comm in ("identity", "int8+ef"):
            label = f"faulted {net.name} {comm}"
            spec = spec_for(comm)
            print(f"faults: solve(hyper_representation d1={D1} d2={D2}, "
                  f"{net.name}, K={K} M={M} U={U} dihgp=matrix_free, "
                  f"comm={comm}, faults={faults})")

            def run(dev="cuda", spec=spec, net=net):
                return solve(prob, net, spec, x0=x0, y0=y0, seed=0,
                             device=dev)
            t_run = time.perf_counter()
            reset_launch_counts()
            res = run()
            torch.cuda.synchronize()
            counts = launch_counts()
            print(f"  launches {counts} expected {expected}")
            if counts != expected:
                raise AssertionError(f"{label}: launch counts {counts} != "
                                     f"{expected}")
            for name, c in counts.items():
                counts_out[name] = counts_out.get(name, 0) + c
            print(f"  alive fraction "
                  f"{res.extras['fault_alive_fraction']:.6f}; ledger "
                  f"{res.ledger.total_bytes / K:.0f} bytes per agent per "
                  f"round (nominal sends)")
            check_finite(torch, label, res, K, N_AGENTS, D1, D2)
            check_realized(res.extras["fault_trace"], net.W)
            with plain_versions():
                plain = run()
            same_bits(torch, f"{label} vs the card's plain versions", res,
                      plain)
            del res, plain
            if net is ring and comm == "identity":  # one profile: the split
                by_kernel = {}
                busy[label] = profile_run(torch, run, by_kernel)
                print(f"  {device_split(by_kernel, busy[label])} per solve")
            print(f"  the run's checks took {time.perf_counter() - t_run:.1f} "
                  f"s")
            timed[label] = run
        # the same solve without faults, timed in the same turns
        timed[f"unfaulted {net.name} identity"] = \
            lambda dev="cuda", net=net: solve(prob, net, spec_for(
                faults=None), x0=x0, y0=y0, seed=0, device=dev)
    idle_shares(busy, time_in_turns(torch, timed), K)
    del timed

    # an all-ones mask (a FaultSpec that injects nothing) reproduces the
    # unfaulted solve on the padded sparse-gather kernel bit for bit
    t_part = time.perf_counter()
    for net in (ring, er):
        reset_launch_counts()
        ones = solve(prob, net, spec_for(faults=FaultSpec()), x0=x0, y0=y0,
                     seed=0, device="cuda")
        bare = solve(prob, net,
                     spec_for(faults=None, backend="sparse_gather_pallas"),
                     x0=x0, y0=y0, seed=0, device="cuda")
        torch.cuda.synchronize()
        counts = launch_counts()
        want = {**zero, "sparse_mix_matvec": 2 * gossips}
        print(f"faults: all-ones mask on {net.name}: alive fraction "
              f"{ones.extras['fault_alive_fraction']}; launches of both "
              f"solves {counts} expected {want}")
        if counts != want or ones.extras["fault_alive_fraction"] != 1.0:
            raise AssertionError(f"all-ones mask on {net.name}")
        same_bits(torch, f"all-ones mask vs unfaulted sparse_gather_pallas "
                  f"on {net.name}", ones, bare)
        del ones, bare
    print(f"faults: the all-ones checks took "
          f"{time.perf_counter() - t_part:.1f} s")
    del prob, x0, y0
    torch.cuda.empty_cache()

    # the faulted solve at n = N_LARGE: every gossip on the masked slab
    t_part = time.perf_counter()
    n, rounds = N_LARGE, 2
    prob = hyper_representation(n, d=D_IN, hidden=HIDDEN,
                                n_classes=N_CLASSES, m_per=M_PER, seed=0,
                                device="cuda")
    x0, y0 = inputs(torch, n, D1, D2, "cuda")
    _, er = large_networks()
    tier, _ = mm.plan_row_tile(n, itemsize=4, blocks=mm.plan_blocks(False))
    name = "sparse_mix_matvec_halo" if tier == "halo" \
        and mm.plan_slab_cols(n) else "sparse_mix_matvec_halo_rows" \
        if tier == "halo" else "sparse_mix_matvec"
    expected = {**zero, name: rounds * (M + U + 1)}
    spec = spec_for(rounds=rounds)
    print(f"faults: solve(hyper_representation n={n} d1={D1} d2={D2}, "
          f"{er.name}, K={rounds} M={M} U={U} dihgp=matrix_free, "
          f"faults={faults})")

    def run(dev="cuda"):
        return solve(prob, er, spec, x0=x0, y0=y0, seed=0, device=dev)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    print(f"  launches {counts} expected {expected}")
    if counts != expected:
        raise AssertionError(f"faulted n={n}: launch counts {counts} != "
                             f"{expected}")
    for key, c in counts.items():
        counts_out[key] = counts_out.get(key, 0) + c
    print(f"  seconds per round of the first run {dt / rounds:.6f} (host "
          f"clock, set-up included); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; alive "
          f"fraction {res.extras['fault_alive_fraction']:.6f}")
    check_finite(torch, f"faulted n={n}", res, rounds, n, D1, D2)
    check_realized(res.extras["fault_trace"], er.W)
    with plain_versions():
        plain = run()
    same_bits(torch, f"faulted n={n} {er.name} vs the card's plain "
              f"versions", res, plain)
    del res, plain
    by_kernel = {}
    us = profile_run(torch, run, by_kernel)
    print(f"  {device_split(by_kernel, us)} per solve; n = {n} took "
          f"{time.perf_counter() - t_part:.1f} s with its problem")


# ---------------------------------------------------------------------------
# serve: buckets of the §6.2 MLP through the engine, on the job axis
# ---------------------------------------------------------------------------

# K = 4 rounds a job in chunks of 2, so that every job's carry (x, y, the
# wire's EF residuals and send counters) crosses a chunk boundary; the
# identity buckets at n = 16 run K = SERVE_K_IDENTITY = 2, one chunk a
# wave (the admission phase carries identity jobs across chunks)
SERVE_JOBS, SERVE_K, SERVE_T, SERVE_WIDTH = 10, 4, 2, 8
SERVE_K_IDENTITY = 2
# fig4's neighbourhood: its (α, β) = (0.1, 0.1), swept ±20 %
SERVE_GRID = ((0.1, 0.1), (0.08, 0.1), (0.12, 0.1), (0.1, 0.08),
              (0.1, 0.12), (0.09, 0.11), (0.11, 0.09), (0.08, 0.12),
              (0.12, 0.08), (0.1, 0.1))
# a served job against its solo solve on the card: the gossips of both
# are bitwise (each job-axis launch equals the job's solo launch), but
# the autodiff terms run as batched (bmm) operations whose reductions may
# sum in another order than the solo run's, amplified over K rounds:
# elementwise at the GPU-vs-CPU band on the identity wire, by
# norm-relative error under stochastic rounding (see E2E_NORM_REL)
SERVE_RTOL, SERVE_ATOL = E2E_RTOL, E2E_ATOL
# the least network at which the compressed gossips plan the halo tiles
# (ring int8+ef and ER int8): their buckets of SERVE_WIDTH jobs
SERVE_HALO_N = 128


@functools.lru_cache(maxsize=None)
def serve_problem(seed: int, device: str = "cuda", n: int = N_AGENTS):
    """The §6.2 MLP on the data of `seed`, its backbone x offset by the
    main path's random start (a data leaf, so a serve job, which starts
    at x = 0, starts where the main path's solve does instead of at the
    ReLU's dead zero).  Cached: the engine's buckets and the solo solves
    share one instance per seed."""
    import numpy as np

    from repro_torch.core.problems import (BilevelProblem,
                                           hyper_representation)
    base = hyper_representation(n, d=D_IN, hidden=HIDDEN,
                                n_classes=N_CLASSES, m_per=M_PER,
                                seed=seed, device=device)
    x_base = np.broadcast_to(
        0.3 * np.random.default_rng(42).standard_normal(D1),
        (n, D1)).astype(np.float32)
    data = dict(base.data, x_base=__import__("torch").as_tensor(
        x_base, device=device))

    def f(x_i, y_i, d):
        return base.f(x_i + d["x_base"], y_i, d)

    def g(x_i, y_i, d):
        return base.g(x_i + d["x_base"], y_i, d)
    return BilevelProblem("hyper_representation_x0", base.n, base.d1,
                          base.d2, f, g, data, base.mu_g)


def serve_specs(comm: str, graph: str, family=serve_problem,
                n: int = N_AGENTS, jobs: int = SERVE_JOBS,
                budgets=None, classes=None):
    """JobSpecs of `jobs` jobs sweeping SERVE_GRID (cycled), K = SERVE_K
    or the per-job `budgets`, in the per-job priority `classes`."""
    from repro_torch.serve import JobSpec
    from repro_torch.solve import CommSpec, ScheduleSpec, SolverSpec
    gk = {"r": 0.5, "seed": 0} if graph == "erdos_renyi" else {}
    problem = {"seed": 0} if n == N_AGENTS else {"seed": 0, "n": n}
    if family == "hyper_representation":
        problem = {"n": n, "d": D_IN, "hidden": HIDDEN,
                   "n_classes": N_CLASSES, "m_per": M_PER}
    budgets = budgets or [SERVE_K] * jobs
    classes = classes or ["standard"] * jobs
    return [JobSpec(family, dict(problem, seed=s),
                    SolverSpec(K=budgets[s], M=M, U=U, dihgp="matrix_free",
                               schedule=ScheduleSpec(alpha=a, beta=b),
                               comm=CommSpec(comm)),
                    graph=graph, graph_kwargs=dict(gk, n=n), seed=s,
                    klass=classes[s])
            for s, (a, b) in ((s, SERVE_GRID[s % len(SERVE_GRID)])
                              for s in range(jobs))]


def serve_rounds(jobs: int = SERVE_JOBS, k: int = SERVE_K) -> int:
    """Rounds a bucket of `jobs` jobs of K = `k` runs: SERVE_WIDTH jobs
    for K rounds, then the backfilled rest for K more, in chunks of
    SERVE_T."""
    waves = -(-jobs // SERVE_WIDTH)
    return waves * k


def serve_held(jobs: int) -> list[int]:
    """The jobs of a bucket held against their solo solves: the first
    slot, the last slot of the first wave and the last backfilled job."""
    return sorted({0, min(jobs, SERVE_WIDTH) - 1, jobs - 1})


def serve_counts(graph: str, comm: str, n: int = N_AGENTS,
                 rounds: int | None = None) -> dict:
    """The exact launches of `rounds` bucket rounds (serve_rounds() by
    default), by the planners' routes at the bucket's (n, width·d)
    operands: one launch per gossip.  At n = 16 the compressed gossips
    run the full-operand kernels; where they plan the halo tiles (n =
    128) every gossip runs the fused circulant halo (row 2f) or the
    compressed sparse halo's slab (row 4f), EF on ER composing with the
    plain mix."""
    from repro_torch.kernels import mixing_matvec as mm
    r = serve_rounds() if rounds is None else rounds
    d2, d1 = SERVE_WIDTH * D2, SERVE_WIDTH * D1
    sms = mm.CARD_SMS
    ef = comm.endswith("+ef")
    tier, bn = mm.plan_row_tile(n, h_lo=1 if graph == "ring" else 0,
                                h_hi=1 if graph == "ring" else 0,
                                blocks=mm.plan_blocks(True, ef))
    if comm != "identity" and tier == "halo":
        if graph == "ring":
            return {"circulant_mix_matvec_halo_comm_jobs": r * (M + U + 1)}
        if not ef:
            name = "sparse_mix_matvec_halo_comm_jobs" \
                if mm.plan_slab_cols(n) else \
                "sparse_mix_matvec_halo_comm_rows_jobs"
            return {name: r * (M + U + 1)}
    if comm == "identity" and graph == "ring":
        counts = {}
        for d, c in ((d2, r * M), (d1, r)):
            name = ring_mix_counter(n, d)
            counts[name] = counts.get(name, 0) + c
        name = "circulant_neumann_step_jobs" if mm.neumann_ring_plan(
            n, 1, 1, d=d2) else "circulant_neumann_step_unstaged_jobs"
        counts[name] = r * U
        return counts
    if comm == "identity":
        return {"sparse_mix_matvec": r * (M + U + 1)}
    kind = "circulant" if graph == "ring" else "sparse"
    counts = {}
    gossips = [(d2, r * M), (d1, r)]
    if ef or graph != "ring":
        gossips.append((d2, r * U))
    else:
        name = "circulant_neumann_step_comm_jobs" \
            if mm.plan_neumann_comm_stripe_cols(n, d2, sms) \
            else "circulant_neumann_step_comm_unstaged_jobs"
        counts[name] = r * U
    for d, c in gossips:
        name = f"{kind}_mix_matvec_comm" + (
            "" if mm.plan_comm_stripe_cols(n, d, sms)
            else "_unstaged") + "_jobs"
        counts[name] = counts.get(name, 0) + c
    return counts


# the kernel wrappers MixingOp calls on a job axis, with the position of
# the seed (table) among their arguments
JOB_WRAPPER_SEED_AT = {"circulant_mix_matvec": 3, "sparse_mix_matvec": 6,
                       "circulant_neumann_step": 6,
                       "circulant_mix_matvec_halo": 3,
                       "sparse_mix_matvec_halo": 6}
# each job-axis counter's kernel, as the profiler names it
JOB_KERNEL_SYMBOL = {
    "circulant_neumann_step_jobs": "circulant_neumann_ring_kernel",
    "circulant_neumann_step_unstaged_jobs": "circulant_neumann_kernel",
    "circulant_mix_matvec_comm_jobs": "circulant_mix_stripe_comm_kernel",
    "circulant_mix_matvec_comm_unstaged_jobs":
        "circulant_mix_comm_unstaged_kernel",
    "sparse_mix_matvec_comm_jobs": "sparse_mix_stripe_comm_kernel",
    "sparse_mix_matvec_comm_unstaged_jobs":
        "sparse_mix_comm_unstaged_kernel",
    "circulant_neumann_step_comm_jobs":
        "circulant_neumann_stripe_comm_kernel",
    "circulant_neumann_step_comm_unstaged_jobs":
        "circulant_neumann_comm_kernel",
    "circulant_mix_matvec_halo_comm_jobs": "circulant_mix_halo_comm_kernel",
    "sparse_mix_matvec_halo_comm_jobs": "sparse_mix_slab_comm_kernel",
    "sparse_mix_matvec_halo_comm_rows_jobs": "sparse_mix_halo_comm_kernel",
}


@contextlib.contextmanager
def capture_job_launches(store: dict):
    """Record the first job-axis call of each (wrapper, comm, width) that
    MixingOp makes, its operands cloned: the launches chip_smoke then
    holds, job by job, against the solo launch and the plain version."""
    from repro_torch.kernels.ref import is_seed_table
    from repro_torch.topology import ops
    names = tuple(JOB_WRAPPER_SEED_AT)
    saved = {name: getattr(ops, name) for name in names}

    def clone(a):
        return a.clone() if hasattr(a, "clone") else a

    def wrap(name, fn):
        def call(*args, **kw):
            seed_at = JOB_WRAPPER_SEED_AT[name]
            jobs = len(args) > seed_at and is_seed_table(args[seed_at]) \
                or hasattr(kw.get("beta"), "shape")
            if jobs:
                key = (name, kw.get("comm"), tuple(args[0].shape))
                if key not in store:
                    store[key] = (tuple(clone(a) for a in args),
                                  {k: clone(v) for k, v in kw.items()})
            return fn(*args, **kw)
        return call
    for name in names:
        setattr(ops, name, wrap(name, saved[name]))
    try:
        yield
    finally:
        for name in names:
            setattr(ops, name, saved[name])


def job_axis_checks(torch, store: dict, results: dict) -> None:
    """Each captured job-axis launch: bitwise its plain version on the
    card and, job by job, the solo launch on the job's slice; timed
    against the B solo launches, the plain version and one PyTorch call
    of the uncompressed mix (torch.matmul with the dense W), with its
    bound.  Launches here are not the main path's: counts are read
    before and reset after."""
    from repro_torch.kernels import mixing_matvec as mm
    from repro_torch.kernels import ref
    from repro_torch.kernels.ref import is_seed_table
    for (name, comm, shape), (args, kw) in sorted(store.items(),
                                                  key=lambda t: str(t[0])):
        n, width = shape
        fn = getattr(mm, name)
        mm.reset_launch_counts()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        counter = next(c for c, v in mm.launch_counts().items() if v)
        neumann = name == "circulant_neumann_step"
        if neumann:
            B = kw["beta"].shape[0]
        else:
            B = len(args[JOB_WRAPPER_SEED_AT[name]])
        d = width // B
        host = (lambda t: t.tolist() if hasattr(t, "tolist") else list(t))
        tag = f"{counter} ({n}, {B}x{d}) comm={comm}"
        bits = None if comm in (None, "identity") else int(comm[3])
        ef = comm is not None and comm.endswith("+ef")
        if name.startswith("circulant_mix_matvec"):
            circ = dict(w_self=kw["w_self"], offsets=host(kw["offsets"]),
                        weights=host(kw["weights"]),
                        laplacian=kw.get("laplacian", False))

            def plain(a):
                return ref.circulant_mix_fused_ref(*a[:5], bits=bits,
                                                   **circ)
        elif name.startswith("sparse_mix_matvec"):
            def plain(a):
                return ref.sparse_mix_fused_ref(
                    *a[:8], laplacian=kw.get("laplacian", False),
                    bits=bits)
        else:
            circ = dict(w_self=kw["w_self"], offsets=host(kw["offsets"]),
                        weights=host(kw["weights"]), beta=kw["beta"])

            def plain(a):
                if bits is None:
                    return ref.neumann_step_ref(*a[:4], **circ)
                return ref.neumann_step_fused_ref(*a[:7], bits=bits, **circ)
        want = plain(args)
        bitwise(tag, out, want, "the plain version")
        err = max(((g.float() - w.float()).abs().max().item()
                   for g, w in (zip(out, want) if ef else ((out, want),))),
                  default=0.0)

        # the positions of the operands (n, B·d), the per-job tables (n,
        # B) and the seed table in each wrapper's arguments
        states, tables, seeds_at = {
            "circulant_mix_matvec": ((0, 4), (1, 2), 3),
            "circulant_mix_matvec_halo": ((0, 4), (1, 2), 3),
            "sparse_mix_matvec": ((0, 7), (4, 5), 6),
            "sparse_mix_matvec_halo": ((0,), (4, 5), 6),
            "circulant_neumann_step": ((0, 1, 2), (3, 4, 5), 6)}[name]

        def solo_args(j):
            a = list(args)
            for i in states:
                if i < len(a) and a[i] is not None:
                    a[i] = a[i][:, j * d:(j + 1) * d].contiguous()
            for i in tables:
                if i < len(a) and a[i] is not None:
                    a[i] = a[i][:, j:j + 1].contiguous()
            if seeds_at < len(a):
                a[seeds_at] = int(a[seeds_at][j])
            k = dict(kw)
            if neumann:
                k["beta"] = float(kw["beta"][j])
            return a, k
        solos = [solo_args(j) for j in range(B)]
        diff = 0
        for j, (a, k) in enumerate(solos):
            got = fn(*a, **k)
            parts = zip(out, got) if ef else ((out, got),)
            diff += sum(int((o[:, j * d:(j + 1) * d] != g).sum())
                        for o, g in parts)
        print(f"  {tag}: elements differing from the {B} jobs' solo "
              f"launches {diff} (bitwise, job by job)")
        if diff:
            raise AssertionError(f"{tag}: not bitwise its jobs' solo "
                                 f"launches")
        iters = 10 if n * width > 1 << 26 else 50
        ms = cuda_ms(torch, lambda _: fn(*args, **kw), [None], iters=iters)
        dev_ms = device_ms(torch, lambda _: fn(*args, **kw), [None],
                           JOB_KERNEL_SYMBOL[counter], iters=iters)
        ms_solo = cuda_ms(torch, lambda _: [fn(*a, **k) for a, k in solos],
                          [None], iters=max(2, iters // 5))
        plain_ms = cuda_ms(torch, lambda _: plain(args), [None], iters=5,
                           warmup=1)
        W = torch.full((n, n), 1.0 / n, device=args[0].device)
        lib, lib_err = try_library(torch, lambda _: torch.matmul(W, args[0]),
                                   [None], iters=50)
        k_nbr = args[2].shape[1] if name.startswith("sparse") else 2
        streams = (3 if neumann else 1) + (1 if ef else 0)
        nbytes = n * width * 4 * (streams + 1 + (1 if ef else 0)) \
            + (8 * n * B if bits else 0) + (4 * n * B if neumann else 0)
        flops = (2 * (k_nbr + 1) + (6 if neumann else 0)
                 + (QUANT_F32_OPS if bits else 0)) * n * width
        b_ms, b_by = bound(nbytes, flops,
                           QUANT_INT_OPS * n * width if bits else 0.0)
        print(f"  {tag}: {ms:.5f} ms on the job axis (device "
              f"{dev_ms:.5f} ms), {B} solo launches "
              f"{ms_solo:.5f} ms, plain version {plain_ms:.5f} ms, "
              f"torch.matmul (uncompressed) {lib_text(lib, lib_err)} ms, "
              f"bound {b_ms:.5f} ms ({b_by}); CUDA events, operands "
              f"L2-warm (one copy)")
        results.setdefault(counter, {})[(n, width, comm or "identity",
                                         B)] = {
            "ms": ms, "dev": dev_ms, "plain": plain_ms, "bound": b_ms,
            "by": b_by, "lib": lib, "err": err, "solo_ms": ms_solo,
            "jobs": B}
    mm.reset_launch_counts()


def serve_phase(torch, out: dict) -> None:
    """Five buckets of SERVE_JOBS jobs of the §6.2 MLP at n = 16 and two
    of SERVE_WIDTH jobs at n = SERVE_HALO_N through `ServeEngine`, the
    `serve_held` jobs of each held against their solo solves on the card
    (bitwise at n = 128), and the engine's crash-restart bitwise, with
    jobs halfway through their solve at the crash (see the module
    docstring)."""
    import glob
    import pickle
    import tempfile

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import ServeEngine, SimulatedCrash
    from repro_torch.solve import solve
    from repro_torch.topology import make_network
    results, counts_out = out["results"], out["counts"]
    zero = dict.fromkeys(launch_counts(), 0)
    store: dict = {}
    # n = 16: the full-operand kernels' job axis; n = 128 (8 jobs, no
    # backfill): the compressed gossips on the halo tiles (rows 2f, 4f),
    # each job held bitwise against its solo solve
    for graph, comm, n, jobs, k in (
            ("ring", "identity", N_AGENTS, SERVE_JOBS, SERVE_K_IDENTITY),
            ("erdos_renyi", "identity", N_AGENTS, SERVE_JOBS,
             SERVE_K_IDENTITY),
            ("ring", "int8+ef", N_AGENTS, SERVE_JOBS, SERVE_K),
            ("erdos_renyi", "int8+ef", N_AGENTS, SERVE_JOBS, SERVE_K),
            ("ring", "int4", N_AGENTS, SERVE_JOBS, SERVE_K),
            ("ring", "int8+ef", SERVE_HALO_N, SERVE_WIDTH, SERVE_K),
            ("erdos_renyi", "int8", SERVE_HALO_N, SERVE_WIDTH, SERVE_K)):
        label = f"{graph} {comm} n={n}"
        net = make_network(graph, n, **({"r": 0.5, "seed": 0}
                                        if graph == "erdos_renyi" else {}))
        specs = serve_specs(comm, graph, n=n, jobs=jobs, budgets=[k] * jobs)
        rounds = serve_rounds(jobs, k)
        expected = {**zero, **serve_counts(graph, comm, n, rounds)}
        exact = n != N_AGENTS
        held = serve_held(jobs)
        print(f"serve: {jobs} jobs of hyper_representation d1={D1} "
              f"d2={D2} on {label}, K={k} M={M} U={U}, "
              f"chunk_rounds={SERVE_T}, max_width={SERVE_WIDTH}")

        def run_bucket(specs=specs):
            eng = ServeEngine(chunk_rounds=SERVE_T, max_width=SERVE_WIDTH)
            eng.submit(specs)
            return eng, eng.run()
        t_bucket = time.perf_counter()
        # the profiled run first: it is also the timed run's warm-up
        busy = profile_run(torch, run_bucket)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        with capture_job_launches(store):
            eng, res = run_bucket()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"  launches {counts} expected {expected}")
        if counts != expected:
            raise AssertionError(f"serve {label}: launch counts {counts} "
                                 f"!= {expected}")
        for name, c in counts.items():
            counts_out[name] = counts_out.get(name, 0) + c
        if eng.stats.traces != 1 or eng.stats.chunks != rounds // SERVE_T:
            raise AssertionError(f"serve {label}: {eng.stats}")
        for r in res:
            if r.rounds != k or r.quarantined \
                    or not (torch.isfinite(r.x).all()
                            and torch.isfinite(r.y).all()):
                raise AssertionError(f"serve {label}: {r.job_id} ran "
                                     f"{r.rounds} rounds, finite "
                                     f"{all_finite(r.x) and all_finite(r.y)}")
        worst = {"x": 0.0, "y": 0.0}
        differing = 0
        solo_wall = 0.0
        solo_bytes = set()
        for j in held:
            spec, r = specs[j], res[j]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ref_run = solve(serve_problem(spec.seed, n=n), net,
                            spec.config, seed=spec.seed)
            torch.cuda.synchronize()
            solo_wall += time.perf_counter() - t1
            for name in ("x", "y"):
                got = getattr(r, name).to(ref_run.x.device)
                want = getattr(ref_run, name)
                rel = norm_rel(got, want)
                worst[name] = max(worst[name], rel)
                differing += int((got != want).sum())
                if exact:
                    continue
                if comm == "identity":
                    torch.testing.assert_close(got, want, rtol=SERVE_RTOL,
                                               atol=SERVE_ATOL)
                elif not rel <= E2E_NORM_REL:
                    raise AssertionError(f"serve {label} {r.job_id}: "
                                         f"{name} norm-relative error "
                                         f"{rel} > {E2E_NORM_REL}")
            solo_bytes.add(ref_run.ledger.total_bytes)
            del ref_run
        # the jobs of a bucket share K, graph and wire, so every job's
        # wire bytes are the held jobs' solo ledger's
        if len(solo_bytes) != 1 or any(r.wire_bytes not in solo_bytes
                                       for r in res):
            raise AssertionError(f"serve {label}: wire bytes "
                                 f"{[r.wire_bytes for r in res]} against "
                                 f"the solo ledgers' {solo_bytes}")
        led = eng.ledgers[res[0].signature]
        if int(led.per_job_bytes().sum()) != led.total_bytes \
                != sum(r.wire_bytes for r in res):
            raise AssertionError(f"serve {label}: ledger bytes disagree")
        print(f"  jobs {held} vs their solo solves on the card: elements "
              f"of x and y differing {differing}, worst norm_rel_err x "
              f"{worst['x']:.3e} y {worst['y']:.3e} "
              f"({'bitwise' if exact else 'elementwise rtol ' + str(SERVE_RTOL) if comm == 'identity' else 'bound ' + str(E2E_NORM_REL)}); "
              f"every job's wire bytes the solo ledger's, ledger "
              f"{led.total_bytes} B")
        if exact and differing:
            raise AssertionError(f"serve {label}: jobs not bitwise their "
                                 f"solo solves")
        job_rounds, solo_rounds = jobs * k, len(held) * k
        print(f"  bucket: {wall / rounds:.6f} s per round ({rounds} rounds "
              f"of width {SERVE_WIDTH}), {job_rounds / wall:.2f} job-rounds "
              f"per s; {len(held)} solo solves: "
              f"{solo_wall / solo_rounds:.6f} s per round, "
              f"{solo_rounds / solo_wall:.2f} job-rounds per s; peak memory "
              f"{peak:.2f} GiB (host clock, after a warm-up run)")
        if busy is not None:
            print(f"  bucket device busy {busy:.1f} us of "
                  f"{wall * 1e6:.1f} us unprofiled (idle share "
                  f"{1 - busy / (wall * 1e6):.4f})")
        print(f"  {label}: {time.perf_counter() - t_bucket:.1f} s with its "
              f"solo solves (these {solo_wall:.1f} s)")
        del eng, res
    print(f"serve: {len(store)} captured job-axis launches")
    t_part = time.perf_counter()
    job_axis_checks(torch, store, results)
    del store
    print(f"serve: job-axis checks {time.perf_counter() - t_part:.1f} s")
    t_part = time.perf_counter()
    # crash and restart: the zoo family (a callable family does not
    # survive a restart), ring int8+ef, K = SERVE_K: the crash after the
    # first chunk leaves the first wave halfway through its solve, EF
    # residuals and send counters included
    specs = serve_specs("int8+ef", "ring", family="hyper_representation")
    eng = ServeEngine(chunk_rounds=SERVE_T, max_width=SERVE_WIDTH)
    eng.submit(specs)
    full = eng.run()
    with tempfile.TemporaryDirectory() as ckdir:
        eng = ServeEngine(chunk_rounds=SERVE_T, max_width=SERVE_WIDTH,
                          checkpoint_dir=ckdir, crash_after_chunks=1)
        eng.submit(specs)
        try:
            eng.run()
            raise AssertionError("serve: crash_after_chunks did not fire")
        except SimulatedCrash:
            pass
        with open(max(glob.glob(os.path.join(ckdir, "state_*.pkl"))),
                  "rb") as f:
            slots = pickle.load(f)["bucket_host"]
        mid = int((slots["active"] & (slots["rounds"] > 0)
                   & (slots["rounds"] < slots["budget"])).sum())
        if not mid:
            raise AssertionError(f"serve: no job halfway through its solve "
                                 f"at the crash: rounds {slots['rounds']}, "
                                 f"budgets {slots['budget']}")
        # the resumed run checkpoints no more (the restart is what is
        # checked; each step is a ~190 MB compressed write)
        eng = ServeEngine(chunk_rounds=SERVE_T, max_width=SERVE_WIDTH,
                          checkpoint_dir=ckdir, checkpoint_every=10 ** 6)
        resumed = eng.run()
        if eng.stats.restarts != 1:
            raise AssertionError(f"serve: resume {eng.stats}")
    diff = sum(int((a.x != b.x).sum()) + int((a.y != b.y).sum())
               + abs(a.wire_bytes - b.wire_bytes)
               for a, b in zip(full, resumed))
    print(f"serve: crash after chunk 1 and restart (ring int8+ef, "
          f"{SERVE_JOBS} jobs, K = {SERVE_K}; {mid} jobs at rounds "
          f"{sorted(set(slots['rounds'][slots['active']].tolist()))} of "
          f"{SERVE_K} at the crash): elements differing from the "
          f"uninterrupted run {diff} (bitwise), restarts "
          f"{eng.stats.restarts}; {time.perf_counter() - t_part:.1f} s")
    if diff:
        raise AssertionError("serve: the resumed run differs")


def obs_phase(torch, _unused) -> None:
    """The flight recorder and tracing on the main path's ring int8+ef
    solve (inert: bitwise the plain solve; the recorder's wire bytes the
    ledger's; the trace valid), and a checkpoint round trip on the card."""
    import tempfile

    import numpy as np

    from repro_torch import checkpoint as ckpt
    from repro_torch import obs
    from repro_torch.core.problems import hyper_representation
    from repro_torch.solve import CommSpec, ScheduleSpec, SolverSpec, solve
    from repro_torch.topology import make_network
    prob = hyper_representation(N_AGENTS, d=D_IN, hidden=HIDDEN,
                                n_classes=N_CLASSES, m_per=M_PER, seed=0,
                                device="cuda")
    x0 = np.broadcast_to(
        0.3 * np.random.default_rng(42).standard_normal(D1),
        (N_AGENTS, D1)).astype(np.float32)
    net = make_network("ring", N_AGENTS)
    spec = SolverSpec(K=K, M=M, U=U, dihgp="matrix_free",
                      schedule=ScheduleSpec(alpha=0.1, beta=0.1),
                      comm=CommSpec("int8+ef"))

    def run(**kw):
        res = solve(prob, net, spec, x0=x0, **kw)
        torch.cuda.synchronize()
        return res
    base = run()
    rec = run(recorder=obs.RecorderSpec(capacity=64))
    same_bits(torch, "ring int8+ef with the flight recorder vs without",
              rec, base)
    flight = rec.extras["flight"]
    wire = flight[:, obs.FIELDS.index("wire_bytes")]
    per_round = spec.comm_ledger(D1, D2, rounds=1).total_bytes
    want = [per_round * (k + 1) for k in range(K)]
    print(f"obs: flight rows {flight.shape}, wire_bytes column "
          f"{wire.tolist()} (ledger {rec.ledger.total_bytes} B, "
          f"{per_round} B a round)")
    if wire.tolist() != want or wire[-1] != rec.ledger.total_bytes:
        raise AssertionError("obs: the recorder's wire bytes disagree with "
                             "the ledger")
    if not np.isfinite(flight).all():
        raise AssertionError("obs: flight rows not finite")
    with obs.tracing() as tr:
        traced = run()
    same_bits(torch, "ring int8+ef under obs.tracing() vs without",
              traced, base)
    events = obs.trace_events(tr)
    obs.validate_trace(events)
    print(f"obs: traced solve: {len(events)} trace events, valid; spans "
          f"{sorted({e.name for e in tr.events()})}")
    tr.clear()
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(5)
    tree = {"carry": ((torch.randn((N_AGENTS, D2), generator=gen,
                                   device=dev),
                       torch.randn((N_AGENTS, D1), generator=gen,
                                   device=dev).to(torch.bfloat16)),
                      obs.FlightBuffer(rows=torch.tensor(flight, device=dev),
                                       count=torch.tensor(K, dtype=torch.int32,
                                                          device=dev))),
            "data": {k: v for k, v in prob.data.items()}}
    def zeros(t):
        if isinstance(t, dict):
            return {k: zeros(v) for k, v in t.items()}
        if isinstance(t, tuple):
            return type(t)(*map(zeros, t)) if hasattr(t, "_fields") \
                else tuple(map(zeros, t))
        return torch.zeros_like(t)

    def leaves(t):
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in leaves(t[k])]
        if isinstance(t, tuple):
            return [x for v in t for x in leaves(v)]
        return [t]
    with tempfile.TemporaryDirectory() as d:
        ckpt.save_checkpoint(d, 1, tree)
        back = ckpt.restore_checkpoint(d, 1, zeros(tree))
    pairs = list(zip(leaves(back), leaves(tree)))
    diff = 0
    for got, want in pairs:
        if got.device != want.device or got.dtype != want.dtype:
            raise AssertionError("obs: checkpoint leaf moved device/dtype")
        a, b = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t
                for t in (got, want))
        diff += int((a != b).sum())
    print(f"obs: checkpoint on the card round trip ({len(pairs)} leaves, "
          f"bf16 included): elements differing {diff} (bitwise)")
    if diff:
        raise AssertionError("obs: checkpoint round trip differs")


# ---------------------------------------------------------------------------
# admission: the always-on loop over the serve engine, at n = 16
# ---------------------------------------------------------------------------

# jobs of the Poisson schedule the two drivers are held against
# 16 jobs (24 until the sharded phase joined the run, to keep the whole
# run near its time)
# jobs of the Poisson schedule the two drivers are held against
# 8 jobs (24 until the sharded phase joined the run, 16 until the lm
# phase did, to keep the whole run near its time)
ADMIT_POISSON_JOBS = 8


def admission_phase(torch, out: dict) -> None:
    """`AdmissionLoop` on the §6.2 MLP at n = 16 (width SERVE_WIDTH,
    chunk_rounds SERVE_T): (1) ring int8+ef, four batch-class jobs of K
    = 8 and four standard ones of K = 4 packed into one bucket, then a
    realtime job that preempts one batch job at a chunk boundary: exact
    launches, one runner build, every job bitwise its solo solve on the
    card, the preempted one included; (2) a checkpointed loop killed by
    SimulatedCrash after its first chunk and restored by a fresh loop:
    the jobs that were queued but never admitted come back off the
    sidecar and finish bitwise; (3) `drive_poisson_async` against
    `drive_poisson` on one seeded schedule of ADMIT_POISSON_JOBS jobs at
    half the jobs/s the wave engine reaches here: p50, p99, jobs/s,
    peak queue depth and the device's idle share of each."""
    import tempfile

    from repro_torch import obs
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import ServeEngine, SimulatedCrash, build_problem
    from repro_torch.serve.admission import AdmissionLoop
    from repro_torch.serve.slo import drive_poisson, drive_poisson_async
    from repro_torch.solve import solve
    from repro_torch.topology import make_network
    counts_out = out["counts"]
    zero = dict.fromkeys(launch_counts(), 0)
    net = make_network("ring", N_AGENTS)

    def differing(res, spec, prob):
        torch.cuda.synchronize()
        ref = solve(prob, net, spec.config, seed=spec.seed)
        diff = sum(int((getattr(res, k).to(ref.x.device)
                        != getattr(ref, k)).sum()) for k in ("x", "y"))
        if res.wire_bytes != ref.ledger.total_bytes:
            raise AssertionError(f"admission {res.job_id}: wire bytes "
                                 f"{res.wire_bytes} != "
                                 f"{ref.ledger.total_bytes}")
        return diff

    # (1) two budgets packed, three classes, one preemption
    t_part = time.perf_counter()
    W = SERVE_WIDTH
    specs = serve_specs("int8+ef", "ring", jobs=W + 1,
                        budgets=[2 * SERVE_K] * (W // 2)
                        + [SERVE_K] * (W // 2 + 1),
                        classes=["batch"] * (W // 2)
                        + ["standard"] * (W // 2) + ["realtime"])
    print(f"admission: ring int8+ef, {W // 2} batch jobs of K = "
          f"{2 * SERVE_K} and {W // 2} standard jobs of K = {SERVE_K} "
          f"packed into one bucket of width {W}, then one realtime job of "
          f"K = {SERVE_K}; chunk_rounds={SERVE_T}")
    obs.reset_metrics()
    loop = AdmissionLoop(chunk_rounds=SERVE_T, max_width=W)
    reset_launch_counts()
    ids = loop.submit(specs[:W])
    loop.step()
    ids += loop.submit(specs[W])
    loop.pump()
    torch.cuda.synchronize()
    counts = launch_counts()
    expected = {**zero, **serve_counts("ring", "int8+ef", N_AGENTS,
                                       loop.stats.chunks * SERVE_T)}
    print(f"  launches {counts} expected {expected} ({loop.stats.chunks} "
          f"chunks)")
    if counts != expected:
        raise AssertionError(f"admission: launch counts {counts} != "
                             f"{expected}")
    for name, c in counts.items():
        counts_out[name] = counts_out.get(name, 0) + c
    npre = obs.counter_value("serve_preemptions_total")
    print(f"  preemptions {npre:.0f}, runner builds {loop.stats.traces}, "
          f"buckets {loop.stats.buckets}, restarts {loop.stats.restarts}")
    if npre != 1 or loop.stats.traces != 1 or loop.stats.buckets != 1:
        raise AssertionError(f"admission: {npre} preemptions, "
                             f"{loop.stats}")
    total = 0
    for jid, spec in zip(ids, specs):
        r = loop.result(jid)
        if r.rounds != spec.config.K:
            raise AssertionError(f"admission {jid}: {r.rounds} rounds")
        diff = differing(r, spec, serve_problem(spec.seed))
        total += diff
        print(f"  {jid} ({spec.klass}, K = {spec.config.K}): elements of "
              f"x and y differing from its solo solve {diff} (bitwise)")
    if total:
        raise AssertionError("admission: jobs not bitwise their solo "
                             "solves")
    del loop
    print(f"  {time.perf_counter() - t_part:.1f} s with the solo solves")

    # (2) crash and restore: queued-but-never-admitted jobs off the
    # sidecar (the zoo family: a callable family does not survive a
    # restart; identity wire, width 2, 4 jobs)
    t_part = time.perf_counter()
    specs = serve_specs("identity", "ring", family="hyper_representation",
                        jobs=4)
    base = AdmissionLoop(chunk_rounds=SERVE_T, max_width=2)
    base.submit(specs)
    ref = base.run()
    with tempfile.TemporaryDirectory() as ckdir:
        crash = AdmissionLoop(chunk_rounds=SERVE_T, max_width=2,
                              checkpoint_dir=ckdir, checkpoint_every=1,
                              crash_after_chunks=1, telemetry=False)
        crash.submit(specs)
        try:
            crash.pump()
            raise AssertionError("admission: crash_after_chunks did not "
                                 "fire")
        except SimulatedCrash:
            pass
        fresh = AdmissionLoop(chunk_rounds=SERVE_T, max_width=2,
                              checkpoint_dir=ckdir, telemetry=False)
        fresh._maybe_restore()
        queued = fresh.queue.job_ids()
        fresh.pump()
    if queued != ["job2", "job3"] or fresh.stats.restarts != 1:
        raise AssertionError(f"admission: restored queue {queued}, "
                             f"{fresh.stats}")
    total = 0
    for i, (spec, r) in enumerate(zip(specs, ref)):
        got = fresh.result(f"job{i}")
        diff = sum(int((getattr(got, k) != getattr(r, k)).sum())
                   for k in ("x", "y"))
        if f"job{i}" in queued:
            diff += differing(got, spec, build_problem(spec, "cuda"))
        total += diff
    print(f"admission: crash after chunk 1 and restore (ring identity, 4 "
          f"jobs, width 2): queued and never admitted {queued}, restored "
          f"off the sidecar; elements differing from the uninterrupted "
          f"loop and, for those two, their solo solves {total} (bitwise); "
          f"{time.perf_counter() - t_part:.1f} s")
    if total:
        raise AssertionError("admission: the restored loop differs")
    del base, crash, fresh, ref

    # (3) the two drivers on one seeded Poisson schedule
    t_part = time.perf_counter()
    specs = serve_specs("identity", "ring", jobs=ADMIT_POISSON_JOBS)
    for s in specs:
        serve_problem(s.seed)                 # data made before the clock
    eng = ServeEngine(chunk_rounds=SERVE_T, max_width=W)
    eng.submit(specs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wave_jobs_s = len(specs) / (time.perf_counter() - t0)
    rate = 0.5 * wave_jobs_s
    print(f"admission: the wave engine drains {len(specs)} jobs (ring "
          f"identity, K = {SERVE_K}, width {W}) at {wave_jobs_s:.4f} "
          f"jobs/s; Poisson rate {rate:.4f} jobs/s (half), seed {SEED}")
    reports = {}
    for label, drive, make in (
            ("drive_poisson", drive_poisson,
             lambda: ServeEngine(chunk_rounds=SERVE_T, max_width=W)),
            ("drive_poisson_async", drive_poisson_async,
             lambda: AdmissionLoop(chunk_rounds=SERVE_T, max_width=W))):
        engine = make()

        def run(drive=drive, engine=engine, label=label):
            reports[label] = drive(engine, specs, rate, seed=SEED,
                                   driver=label)
        print(f"  {label} (under the profiler, device activity only):")
        busy = profile_run(torch, run)
        rep = reports[label]
        idle = "not measured" if busy is None \
            else f"{1 - busy / (rep.wall_s * 1e6):.4f}"
        print(f"  {label}: p50 {rep.p50_s:.6f} s p99 {rep.p99_s:.6f} s, "
              f"{rep.throughput_jobs_s:.4f} jobs/s, peak queue depth "
              f"{rep.peak_queue_depth}, waves {rep.waves}, idle share "
              f"{idle}, wall {rep.wall_s:.3f} s, retired {rep.retired} of "
              f"{rep.jobs}")
        if rep.retired != len(specs) or any(
                r.rounds != SERVE_K or not torch.isfinite(r.x).all()
                for r in rep.results):
            raise AssertionError(f"admission: {label} did not retire "
                                 f"every job")
        del engine
    print(f"admission: drivers {time.perf_counter() - t_part:.1f} s")


# the sharded tier (`repro_torch.distributed`) on the main phase's MLP:
# n = 16 agents on one card's LocalRing, K = 3; n = 4096, K = 2
SHARD_K, SHARD_K_LARGE = 3, 2
# the sharded tier against the reference tier (matrix-free DIHGP) on the
# same ring, init and curvature: tests/test_torch_sharded.py's bound
SHARD_REF_ATOL = 1e-4
RIDGE = 1e-2      # hyper_representation's inner ridge


def mlp_trees(x, y):
    """The flat (n, d1) / (n, d2) MLP iterates as trees of its leaves: x
    the (784, 200) weight and (200,) bias, y the (200, 10) and (10,)."""
    n = x.shape[0]
    cut1, cut2 = D_IN * HIDDEN, HIDDEN * N_CLASSES
    return ({"W1": x[:, :cut1].reshape(n, D_IN, HIDDEN),
             "b1": x[:, cut1:]},
            {"W2": y[:, :cut2].reshape(n, HIDDEN, N_CLASSES),
             "b2": y[:, cut2:]})


def mlp_tree_objectives(torch):
    """g and f of `hyper_representation` written on the tree leaves."""
    def head_ce(yt, feat, lab):
        logits = feat @ yt["W2"] + yt["b2"]
        true = torch.gather(logits, -1, lab[:, None])[:, 0]
        return torch.mean(torch.logsumexp(logits, dim=-1) - true)

    def backbone(xt, Z):
        return torch.relu(Z @ xt["W1"] + xt["b1"])

    def g(xt, yt, b):
        return head_ce(yt, backbone(xt, b["Ztr"]), b["ltr"]) \
            + 0.5 * RIDGE * (torch.sum(yt["W2"] * yt["W2"])
                             + torch.sum(yt["b2"] * yt["b2"]))

    def f(xt, yt, b):
        return head_ce(yt, backbone(xt, b["Zval"]), b["lval"])
    return g, f


def sharded_counts(n: int, comm: str, rounds: int, inner: int,
                   widths_x=(D1,), widths_y=(D2,)) -> dict:
    """A sharded solve's launches on a LocalRing: per round `inner` inner
    and U DIHGP gossips of each y leaf and one of each x leaf, on the
    wire (rows 1/2 plain, 1f/2f fused), plus the consensus metric's
    full-precision (I−W)·x of each x leaf (row 1/2)."""
    from repro_torch.kernels import mixing_matvec as mm
    counts: dict = {}

    def add(name, c):
        counts[name] = counts.get(name, 0) + c

    for widths, gossips in ((widths_y, rounds * (inner + U)),
                            (widths_x, rounds)):
        for d in widths:
            if comm in ("identity", "bf16"):
                add(ring_mix_counter(n, d), gossips)
            elif mm.plan_row_tile(n, h_lo=1, h_hi=1)[0] == "halo":
                add("circulant_mix_matvec_halo_comm", gossips)
            else:
                add("circulant_mix_matvec_comm"
                    if mm.plan_comm_stripe_cols(n, d)
                    else "circulant_mix_matvec_comm_unstaged", gossips)
    for d in widths_x:
        add(ring_mix_counter(n, d), rounds)
    return counts


def wire_bytes(comm: str, widths) -> int:
    """One agent's bytes of one send of leaves `widths` on `comm` (one
    wire row per leaf): f32 / bf16 values, or int8 / int4 codes plus a
    4-byte bf16 (zp, scale) header."""
    per = {"identity": lambda d: 4 * d, "bf16": lambda d: 2 * d,
           "int8": lambda d: d + 4, "int4": lambda d: -(-d // 2) + 4}
    return sum(per[comm.removesuffix("+ef")](d) for d in widths)


def sharded_phase(torch, out: dict) -> None:
    """`solve(tier="sharded")` on the §6.2 MLP at its published widths,
    `sharded_spec(alpha=0.1, beta=0.1, M=5, U=3, curvature=c)`, c the
    power-iteration bound at (x0, y0): (1) `LocalRing(16)`, K = 3:
    identity, bf16, int4, int8+ef, int8+ef with persist_ef and identity
    with mix_every=2, each with exact launches, ledger bytes and
    comm_sends equal to `sharded_comm_ledger` and its closed form,
    finite metrics, and bitwise its run through the plain versions;
    seconds per round in turns and the idle share of identity and
    int8+ef; (2) the identity run against the reference tier
    (matrix-free, curvature c, the ring W) after 1, 2 and 3 rounds; (3)
    raw g_fn / f_fn over the MLP's leaves: int8+ef (one wire row per
    leaf, ledger exact, bitwise its plain-version run) and identity
    (within E2E tolerance of the flat run); (4) the flight recorder on
    int8+ef: bitwise inert, wire column the cumulative ledger, one
    build; (5) `LocalRing(4096)`, K = 2, identity and int8+ef (rows 2 and
    2f), bitwise their plain-version runs, seconds per round and peak
    memory; (6) a `ProcessRing` over NCCL at world size 1 (both
    neighbours the agent itself) against `LocalRing(1)`."""
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import obs
    from repro_torch.core.dihgp import estimate_curvature_bound
    from repro_torch.core.problems import hyper_representation
    from repro_torch.distributed import LocalRing, sharded_comm_ledger
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.solve import dagm_spec, sharded_spec, solve
    from repro_torch.topology import make_network
    counts_out = out["counts"]
    zero = dict.fromkeys(launch_counts(), 0)
    K_ = SHARD_K

    def mlp(n):
        prob = hyper_representation(n, d=D_IN, hidden=HIDDEN,
                                    n_classes=N_CLASSES, m_per=M_PER,
                                    seed=0, device="cuda")
        x0, y0 = inputs(torch, n, D1, D2, "cuda")
        curv = float(estimate_curvature_bound(
            lambda v: prob.hvp_yy_g(x0, y0, v), y0.shape,
            device=y0.device).max())
        return prob, x0, y0, curv

    def spec_of(curv, comm="identity", K=K_, **kw):
        return sharded_spec(alpha=0.1, beta=0.1, M=M, U=U, curvature=curv,
                            K=K, comm=comm, **kw)

    def counted(label, run, expected):
        reset_launch_counts()
        res = run()
        torch.cuda.synchronize()
        counts = launch_counts()
        print(f"  launches {dict((k, v) for k, v in counts.items() if v)}")
        if counts != expected:
            raise AssertionError(f"{label}: launch counts {counts} != "
                                 f"{expected}")
        for name, c in counts.items():
            counts_out[name] = counts_out.get(name, 0) + c
        return res

    def ledger_check(label, res, spec, x_leaves, y_leaves, closed, rounds):
        static = sharded_comm_ledger(spec, x_leaves, y_leaves,
                                     rounds=rounds)
        print(f"  ledger total_bytes={res.ledger.total_bytes} (static "
              f"{static.total_bytes}, closed form {closed})")
        if not res.ledger.total_bytes == static.total_bytes == closed:
            raise AssertionError(f"{label}: ledger bytes disagree")
        per_round = static.total_sends() // rounds
        sends = res.metrics["comm_sends"].cpu()
        want = per_round * torch.arange(1, rounds + 1) \
            if spec.comm.persist_ef else torch.full((rounds,), per_round)
        if not torch.equal(sends, want.float()):
            raise AssertionError(f"{label}: comm_sends {sends} != {want}")

    t_phase = time.perf_counter()
    n = N_AGENTS
    prob, x0, y0, curv = mlp(n)
    print(f"sharded: hyper_representation d1={D1} d2={D2} n={n}, curvature "
          f"bound c={curv:.6f} (power iteration at x0, y0)")
    ring = LocalRing(n)
    runs = [("identity", {}), ("bf16", dict(comm="bf16")),
            ("int4", dict(comm="int4")), ("int8+ef", dict(comm="int8+ef")),
            ("int8+ef persist_ef", dict(comm="int8+ef", persist_ef=True)),
            ("identity mix_every=2", dict(mix_every=2))]
    results, timed, busy = {}, {}, {}
    for label, kw in runs:
        spec = spec_of(curv, **kw)
        comm = spec.comm.spec
        inner = M // 2 if kw.get("mix_every") == 2 else M
        print(f"sharded: LocalRing({n}) {label}, K={K_} M={M} U={U}")

        def run(dev=None, spec=spec):
            return solve(prob, None, spec, mesh=ring, x0=x0, y0=y0, seed=0)
        if not results:
            run()                                  # the card's warm-up
        res = counted(label, run, {**zero, **sharded_counts(
            n, comm, K_, inner)})
        check_finite(torch, label, res, K_, n, D1, D2)
        closed = K_ * ((inner + U) * wire_bytes(comm, (D2,))
                       + wire_bytes(comm, (D1,)))
        ledger_check(label, res, spec, x0[0], y0[0], closed, K_)
        print("  metrics", {k: [float(v) for v in val.cpu()]
                            for k, val in res.metrics.items()})
        with plain_versions():
            plain = run()
        same_bits(torch, f"sharded {label} vs the card's plain versions",
                  res, plain)
        del plain
        results[label] = res
        if label in ("identity", "int8+ef"):
            timed[label] = run
            busy[label] = profile_run(torch, run)
    # the reference tier on the same ring, spec and curvature, timed in
    # the same turns (the main phase's reference solves estimate the
    # curvature by power iteration every round)
    net = make_network("ring", n)
    for comm in ("identity", "int8+ef"):
        rspec = dagm_spec(alpha=0.1, beta=0.1, K=K_, M=M, U=U,
                          dihgp="matrix_free", curvature=curv, comm=comm)

        def ref_run(dev=None, rspec=rspec):
            return solve(prob, net, rspec, x0=x0, y0=y0, device="cuda")
        ref_run()
        label = f"reference tier {comm}, curvature c"
        timed[label] = ref_run
        busy[label] = profile_run(torch, ref_run)
    idle_shares(busy, time_in_turns(torch, timed, K_), K_)

    # the identity run against the reference tier, round by round
    for k in range(1, K_ + 1):
        sh = results["identity"] if k == K_ else solve(
            prob, None, spec_of(curv, K=k), mesh=ring, x0=x0, y0=y0)
        rf = solve(prob, net, dagm_spec(alpha=0.1, beta=0.1, K=k, M=M, U=U,
                                        dihgp="matrix_free", curvature=curv),
                   x0=x0, y0=y0, device="cuda")
        dx = (sh.x - rf.x).abs().max().item()
        dy = (sh.y - rf.y).abs().max().item()
        dl = abs(float(sh.metrics["outer_loss"][-1])
                 - float(rf.metrics["outer_obj"][-1]))
        print(f"sharded vs reference tier after {k} round(s): max|dx|="
              f"{dx:.3e} max|dy|={dy:.3e} |d outer_loss|={dl:.3e} (atol "
              f"{SHARD_REF_ATOL})")
        if max(dx, dy, dl) > SHARD_REF_ATOL:
            raise AssertionError("the sharded tier left the reference tier")
    del sh, rf

    # raw objectives over the MLP's leaves
    g_tree, f_tree = mlp_tree_objectives(torch)
    xt, yt = mlp_trees(x0, y0)
    wx, wy = (D_IN * HIDDEN, HIDDEN), (HIDDEN * N_CLASSES, N_CLASSES)
    for comm in ("int8+ef", "identity"):
        spec = spec_of(curv, comm)
        print(f"sharded: LocalRing({n}) tree of the MLP's leaves, {comm}")

        def run(spec=spec):
            return solve(None, None, spec, mesh=ring, g_fn=g_tree,
                         f_fn=f_tree, batch=prob.data, x0=xt, y0=yt)
        res = counted(f"tree {comm}", run, {**zero, **sharded_counts(
            n, comm, K_, M, widths_x=wx, widths_y=wy)})
        closed = K_ * ((M + U) * wire_bytes(comm, wy) + wire_bytes(comm, wx))
        ledger_check(f"tree {comm}", res, spec,
                     {k: v[0] for k, v in xt.items()},
                     {k: v[0] for k, v in yt.items()}, closed, K_)
        flat_x = torch.cat([res.x["W1"].reshape(n, -1), res.x["b1"]], 1)
        flat_y = torch.cat([res.y["W2"].reshape(n, -1), res.y["b2"]], 1)
        if comm == "int8+ef":
            with plain_versions():
                plain = run()
            for name in res.x:
                if not torch.equal(res.x[name], plain.x[name]):
                    raise AssertionError(f"tree x[{name}] not bitwise")
            for name in res.y:
                if not torch.equal(res.y[name], plain.y[name]):
                    raise AssertionError(f"tree y[{name}] not bitwise")
            print("  tree int8+ef vs the card's plain versions: x, y "
                  "bitwise")
            del plain
        else:
            flat = results["identity"]
            for name, a, b in (("x", flat_x, flat.x), ("y", flat_y, flat.y)):
                print(f"  tree vs flat identity {name}: max_abs_err="
                      f"{(a - b).abs().max().item():.3e}")
                torch.testing.assert_close(a, b, rtol=E2E_RTOL,
                                           atol=E2E_ATOL)
        del res

    # the flight recorder on int8+ef
    spec = spec_of(curv, "int8+ef")
    t0 = obs.counter_value("jit_traces_total", name="sharded_dagm_step")
    rres = solve(prob, None, spec, mesh=ring, x0=x0, y0=y0, seed=0,
                 recorder=obs.RecorderSpec(capacity=32))
    builds = obs.counter_value("jit_traces_total",
                               name="sharded_dagm_step") - t0
    same_bits(torch, "sharded int8+ef with the recorder vs without", rres,
              results["int8+ef"])
    fl = rres.extras["flight"]
    wire = fl[:, obs.FIELDS.index("wire_bytes")]
    led = [float(sharded_comm_ledger(spec, x0[0], y0[0],
                                     rounds=k + 1).total_bytes)
           for k in range(K_)]
    print(f"sharded recorder: {fl.shape[0]} rows, wire {wire.tolist()} "
          f"ledger {led}, builds {builds}")
    if fl.shape[0] != K_ or wire.tolist() != led or builds != 1:
        raise AssertionError("sharded recorder: rows, wire or builds wrong")
    del results, rres

    # n = 4096: rows 2 and 2f
    nb = N_LARGE
    prob_b, xb, yb, curv_b = mlp(nb)
    t0 = time.perf_counter()
    ring_b = LocalRing(nb)
    for comm in ("identity", "int8+ef"):
        ring_b.op(comm)
    print(f"sharded: LocalRing({nb}) set-up {time.perf_counter() - t0:.3f} "
          f"s (its two MixingOps), curvature bound c={curv_b:.6f}")
    for comm in ("identity", "int8+ef"):
        spec = spec_of(curv_b, comm, K=SHARD_K_LARGE)
        print(f"sharded: LocalRing({nb}) {comm}, K={SHARD_K_LARGE}")

        def run(spec=spec):
            return solve(prob_b, None, spec, mesh=ring_b, x0=xb, y0=yb)
        res = counted(f"n={nb} {comm}", run, {**zero, **sharded_counts(
            nb, comm, SHARD_K_LARGE, M)})
        check_finite(torch, f"n={nb} {comm}", res, SHARD_K_LARGE, nb, D1, D2)
        del res
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / SHARD_K_LARGE
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"  seconds per round {dt:.6f} (host clock, after a warm-up "
              f"run, ring set-up excluded), peak memory {peak:.2f} GiB")
        idle_shares({comm: profile_run(torch, run)}, {comm: [dt]},
                    SHARD_K_LARGE)
        with plain_versions():
            plain = run()
        same_bits(torch, f"sharded n={nb} {comm} vs the card's plain "
                  f"versions", res, plain)
        del res, plain
    # the reference tier at the same curvature: its solve builds its
    # MixingOp, so its rounds are read off its `chunk` span (under
    # tracing the span waits for the device)
    net_b = make_network("ring", nb)
    rspec = dagm_spec(alpha=0.1, beta=0.1, K=SHARD_K_LARGE, M=M, U=U,
                      dihgp="matrix_free", curvature=curv_b)

    def ref_run(dev=None):
        return solve(prob_b, net_b, rspec, x0=xb, y0=yb, device="cuda")
    with obs.tracing() as tr:
        tr.clear()
        t0 = time.perf_counter()
        ref_run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        chunk = [e.dur_us for e in tr.events() if e.name == "chunk"][0]
    net_s = chunk * 1e-6 / SHARD_K_LARGE
    print(f"sharded: the reference tier at n={nb}, identity, curvature c: "
          f"seconds per round {dt / SHARD_K_LARGE:.6f} with its MixingOp "
          f"set-up, {net_s:.6f} its rounds alone (the chunk span)")
    idle_shares({"reference tier, its rounds": profile_run(torch, ref_run)},
                {"reference tier, its rounds": [net_s]}, SHARD_K_LARGE)
    del prob_b, xb, yb, ring_b
    torch.cuda.empty_cache()

    # a ProcessRing over NCCL at world size 1 against LocalRing(1)
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
        p1 = hyper_representation(1, d=D_IN, hidden=HIDDEN,
                                  n_classes=N_CLASSES, m_per=M_PER, seed=0,
                                  device="cuda")
        spec = spec_of(curv)
        a = solve(p1, None, spec, mesh=mesh, x0=x0[:1], y0=y0[:1])
        b = solve(p1, None, spec, mesh=LocalRing(1), x0=x0[:1], y0=y0[:1])
        torch.cuda.synchronize()
        print(f"sharded: ProcessRing over NCCL, world size 1 (self P2P), "
              f"against LocalRing(1)")
        compare_runs(torch, "LocalRing(1)", a, b)
    finally:
        dist.destroy_process_group()
    print(f"sharded: phase {time.perf_counter() - t_phase:.1f} s")


# The LM serving path (`repro_torch.models`: `Model.prefill`, greedy
# `decode_step`) at the full width of two configurations the repo ships
# (src/repro_torch/configs), weights in bf16 as served, drawn on the card
# from a seeded generator; cut to one prompt (B = 1) and 16 greedy
# tokens.  qwen3-4b's prefill takes the flash-attention kernel in each of
# its 36 layers, rwkv6-7b's the WKV scan with its final state in each of
# its layers.
LM_CASES = {
    # arch: (prompt tokens, greedy decode steps, prefill kernel counter,
    # layers: None for the configuration's depth)
    "qwen3-4b": (2048, 16, "flash_attention", None),
    # each checked launch's plain version walks the prompt step by step:
    # 16 of the 32 layers leave room in the run's time for the train
    # phase's model-parallel step
    "rwkv6-7b": (1024, 16, "rwkv6_scan_state", 16),
}
LM_SEED = 0
# Tolerances.  (1) Every launch on the path is held against its plain
# version on the same inputs: |got − want| ≤ atol·m + rtol·|want|, (atol,
# rtol) ATTN_TOL's line for the dtype (the WKV scan's output and state:
# WKV_TOL) and m = max(1, max |want|).  The kernels and the plain versions
# sum in f32 in other orders, and their f32 errors scale with the size of
# the values summed, which ATTN_TOL and WKV_TOL take as O(1) (the ops
# phase's N(0, 1) inputs): at qwen3-4b's layers (outputs up to ~3.9)
# elements near 0 left by cancellation differed by ~1e-6, over bf16's
# atol of 1e-6 (PERF.md §6: the kernel's f32 route was 9e-5 from an f64
# truth there, its bf16 outputs within one rounding of it), so atol is
# taken relative to the output's largest value.  (2) The model against
# its twin with the kernel switch off (`_sdpa` / `rwkv6_ref`).  In bf16
# the twins differ by a few flipped roundings a layer, and random deep
# weights amplify them to ~1 logit (rwkv6-7b, PERF.md §6), so a bf16
# comparison cannot tell a right kernel from one off by a percent.  The
# twins run in f32 instead (the served bf16 weights cast up), where the
# kernels differ from the plain versions by f32 summation order.  The
# plain twin decodes its own greedy tokens; the kernel route is
# teacher-forced on them, so the two hold the same cache positions and
# every one of the 17 logit vectors (prefill, 16 decode steps) is
# compared.  A probe measures how far the model carries the kernels'
# differences: the kernel route again, each launch's output (and state)
# moved elementwise by ±e (ξ = ±1, seeded), e the largest |kernel −
# plain| that this launch showed on its own inputs in the checked run,
# so every element moves by as much as the kernel moved its worst one.
# Step s's logits move by Δ_s from the kernel run's, and the kernel run
# is held to
#     max |logits_s − plain logits_s| ≤ tol_s = LM_PROBE_FACTOR · Δ_s
# (the factor 2 covers the spread of a random perturbation's effect).
# Two logits each move by ≤ tol_s, so the kernel route's argmax must be
# the plain twin's token wherever the plain top-2 margin exceeds 2·tol_s.
LM_PROBE_FACTOR = 2.0
# the WKV state output at rwkv6-7b's head shape and the prompt's length:
# (B, T, H, hd), input dtype
WKV_STATE_CASES = {
    "rwkv6-7b prefill_1k f32": ((1, 1024, 64, 64), "float32"),
    "rwkv6-7b prefill_1k bf16": ((1, 1024, 64, 64), "bfloat16"),
    "head dim 96 f32": ((1, 512, 16, 96), "float32"),
}


@contextlib.contextmanager
def checked_launches(torch, errs: list):
    """Hold every flash-attention and WKV-scan launch made through
    `kernels.ops` inside the block against its plain version on the same
    inputs (ATTN_TOL by dtype, WKV_TOL for the output and the state, atol
    relative to the output's largest value); append one (max |error| of
    the output, of the state or None) per launch to `errs`."""
    from repro_torch.kernels import ops, ref
    attention, scan = ops.flash_attention, ops.rwkv6_scan

    def held(got, want, tol, what):
        atol, rtol = tol
        want = want.float()
        diff = (got.float() - want).abs()
        atol *= max(1.0, want.abs().max().item())
        if (diff - atol - rtol * want.abs()).max().item() > 0 \
                or not all_finite(got):
            raise AssertionError(f"{what} launch {len(errs)} disagrees "
                                 f"with its plain version: max err "
                                 f"{diff.max().item():.3e}")
        return diff.max().item()

    def attention_checked(q, k, v, **kw):
        out = attention(q, k, v, **kw)
        errs.append((held(out, ref.flash_attention_ref(q, k, v, **kw),
                          ATTN_TOL[str(q.dtype).removeprefix("torch.")],
                          "flash_attention"), None))
        return out

    def scan_checked(r, k, v, logw, u, **kw):
        res = scan(r, k, v, logw, u, **kw)
        out, state = res if kw.get("return_state") else (res, None)
        want, want_state = ref.rwkv6_ref(r, k, v, logw, u)
        err = held(out, want, WKV_TOL, "rwkv6_scan")
        errs.append((err, None if state is None else
                     held(state, want_state, WKV_TOL, "rwkv6_scan state")))
        return res

    ops.flash_attention, ops.rwkv6_scan = attention_checked, scan_checked
    try:
        yield errs
    finally:
        ops.flash_attention, ops.rwkv6_scan = attention, scan


@contextlib.contextmanager
def probed_launches(torch, errs: list, seed: int):
    """Inside the block launch i of flash attention or the WKV scan (in
    the order of `errs`, which `checked_launches` filled on the same run)
    returns its output, and its state, each moved elementwise by e·ξ: e
    that launch's max |error| from `errs`, ξ = ±1 drawn from a generator
    seeded with `seed`."""
    from repro_torch.kernels import ops
    attention, scan = ops.flash_attention, ops.rwkv6_scan
    gen = torch.Generator("cuda").manual_seed(seed)
    launch = iter(errs)

    def moved(t, e):
        sign = torch.randint(0, 2, t.shape, generator=gen, device=t.device,
                             dtype=torch.float32).mul_(2).sub_(1)
        return (t.float() + e * sign).to(t.dtype)

    def attention_probed(*a, **kw):
        return moved(attention(*a, **kw), next(launch)[0])

    def scan_probed(*a, **kw):
        res = scan(*a, **kw)
        e_out, e_state = next(launch)
        if kw.get("return_state"):
            return moved(res[0], e_out), moved(res[1], e_state)
        return moved(res, e_out)

    ops.flash_attention, ops.rwkv6_scan = attention_probed, scan_probed
    try:
        yield
    finally:
        ops.flash_attention, ops.rwkv6_scan = attention, scan


def lm_kernel_checks(torch, out: dict) -> None:
    """The two kernels at the shapes the LM path gives them: the WKV scan
    with its final-state output against `rwkv6_ref(...)` (output and
    state, WKV_TOL; the output bitwise the output-only launch's), and
    flash attention at qwen3-4b's prefill, timed."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(SEED + 1)

    def randn(shape, dtype=torch.float32, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)
                ).to(dtype)

    rows = out.setdefault("rows", {})
    for name, ((B, T, H, hd), dt) in WKV_STATE_CASES.items():
        dtype = getattr(torch, dt)
        print(f"kernel rwkv6_scan with state: {name} (B={B}, T={T}, H={H}, "
              f"hd={hd}, {dt} inputs)")
        r, k, v = (randn((B, T, H, hd), dtype, 0.5) for _ in range(3))
        logw = (-torch.exp(randn((B, T, H, hd)).clamp(-8, 2))).to(dtype)
        ins = (r, k, v, logw, randn((H, hd), scale=0.5))
        got, state = rwkv6_scan(*ins, return_state=True)
        alone = rwkv6_scan(*ins)
        want, want_state = ref.rwkv6_ref(*ins)
        torch.cuda.synchronize()
        if not torch.equal(got, alone):
            raise AssertionError(f"{name}: the output with the state "
                                 f"differs from the output-only launch's")
        err = allclose_err("output vs rwkv6_ref(...)[0]", got, want,
                           WKV_TOL)
        err_s = allclose_err("state vs rwkv6_ref(...)[1]", state, want_state,
                             WKV_TOL)
        print("  output bitwise the output-only launch's")
        ms = cuda_ms(torch, lambda t: rwkv6_scan(*t, return_state=True),
                     [ins], iters=10, warmup=2)
        dev_ms, dev_how = device_ms_of(
            torch, functools.partial(rwkv6_scan, return_state=True), ins,
            "rwkv6_scan_kernel", iters=5)
        plain = cuda_ms(torch, lambda t: ref.rwkv6_ref(*t), [ins], iters=1,
                        warmup=0)
        item = r.element_size()
        nbytes = B * T * H * hd * (4 * item + 4) + H * hd * 4 \
            + B * H * hd * hd * 4
        flops = 5 * B * T * H * hd * hd
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = (0.8 * flops / (TF32_FLOP_PER_S / TF32_SPLIT)
                 + 0.2 * flops / F32_FLOP_PER_S) * 1e3
        b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else \
            (t_ops, "operations")
        print(f"    ms={ms:.5f} device_ms={dev_ms} ({dev_how}) "
              f"plain_ms(rwkv6_ref)={plain:.5f} library_ms=n/a "
              f"bound_ms={b_ms:.5f} ({b_by}: {nbytes} bytes; "
              f"{flops:.4e} FLOP)")
        rows[("rwkv6_scan_state", name)] = dict(
            err=max(err, err_s), ms=ms, dev=dev_ms, dev_how=dev_how,
            plain=plain, lib=None, bound=b_ms, by=b_by,
            shape=[B, T, H, hd], dtype=dt)
        del got, state, alone, want, want_state, ins

    # flash attention at qwen3-4b's prefill: 32 query heads over its 8 kv
    # heads expanded, as the model hands them over
    import torch.nn.functional as F
    B, S, H, KV, hd = 1, 2048, 32, 8, 128
    name = "qwen3-4b prefill_2k bf16"
    print(f"kernel flash_attention: {name} (B={B}, S={S}, H={H}, kv heads "
          f"{KV} expanded, hd={hd}) causal")
    q = randn((B, S, H, hd), torch.bfloat16)
    k, v = (randn((B, S, KV, hd), torch.bfloat16).repeat_interleave(
        H // KV, 2) for _ in range(2))
    got = flash_attention(q, k, v, causal=True)
    want = ref.flash_attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = allclose_err("vs flash_attention_ref", got, want,
                       ATTN_TOL["bfloat16"])
    ms = cuda_ms(torch, lambda t: flash_attention(*t), [(q, k, v)],
                 iters=10, warmup=1)
    dev_ms, dev_how = device_ms_of(torch, flash_attention, (q, k, v),
                                   "flash_attention_kernel", iters=5)
    plain = cuda_ms(torch, lambda t: ref.flash_attention_ref(*t),
                    [(q, k, v)], iters=3, warmup=1)
    lib = cuda_ms(torch, lambda t: F.scaled_dot_product_attention(
        *(a.transpose(1, 2) for a in t), is_causal=True), [(q, k, v)],
        iters=10, warmup=1)
    pairs = attention_pairs(S, True, 0) * B * H
    nbytes = 4 * B * S * H * hd * q.element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * hd * pairs / BF16_FLOP_PER_S * 1e3
    b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else \
        (t_ops, "operations")
    print(f"    ms={ms:.5f} device_ms={dev_ms} ({dev_how}) "
          f"plain_ms={plain:.5f} library_ms(scaled_dot_product_attention)="
          f"{lib:.5f} bound_ms={b_ms:.5f} ({b_by})")
    rows[("flash_attention", name)] = dict(
        err=err, ms=ms, dev=dev_ms, dev_how=dev_how, plain=plain, lib=lib,
        bound=b_ms, by=b_by, shape=[B, S, H, hd], dtype="bfloat16")


def lm_phase(torch, out: dict) -> None:
    """Each LM_CASES model at full width: init on the card in bf16 as
    served; a warm-up in which every launch is held against its plain
    version on its inputs; the served request (prefill of the prompt, 16
    greedy tokens) on the kernel route with exact launch counts; seconds,
    tokens per s, peak memory and the idle share of a profiled rerun;
    then the weights cast to f32 and the kernel route, teacher-forced on
    the greedy tokens of its twin with the kernel switch off, held to
    that twin at all 17 steps within LM_PROBE_FACTOR times the probe's
    logit change; the model freed before the next."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenDataConfig, make_token_batch
    from repro_torch.kernels import (kernel_mode, launch_counts,
                                     reset_launch_counts)
    from repro_torch.launch.costs import reduced_depth
    from repro_torch.models import build_model
    from repro_torch.models.steps import (make_decode_step, make_prefill_step,
                                          sample_greedy)

    lm_kernel_checks(torch, out)
    zero = dict.fromkeys(launch_counts(), 0)
    counts_all = out.setdefault("counts", dict(zero))
    for arch, (S, n_steps, kname, layers) in LM_CASES.items():
        t_arch = time.perf_counter()
        cfg = get_config(arch)
        if layers is not None:
            cfg = reduced_depth(cfg, layers)
        model = build_model(cfg)
        expected = {**zero, kname: cfg.num_layers}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = model.init(seed=LM_SEED, dtype=torch.bfloat16,
                            device="cuda")
        params.requires_grad_(False)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in params.parameters())
        print(f"lm {arch}: {cfg.num_layers} layers, d {cfg.d_model}, "
              f"{n_params} parameters in bf16 "
              f"({n_params * 2 / 2 ** 30:.2f} GiB), drawn on the card in "
              f"{time.perf_counter() - t0:.2f} s")
        data = TokenDataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                               global_batch=1, seed=LM_SEED)
        prompt = {"tokens": make_token_batch(data, 0, device="cuda")
                  ["tokens"]}
        decode = make_decode_step(model)

        def serve(prefill, steps=n_steps, forced=None):
            """(prefill s, decode s, logits of each step, tokens fed):
            greedy tokens, or those of `forced`."""
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = prefill(params, prompt, cache_len=S + n_steps)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logit_steps, toks = [logits], []
            for step in range(steps):
                tok = sample_greedy(logits)[:, None] if forced is None \
                    else forced[step]
                toks.append(tok)
                logits, cache = decode(params, tok, cache)
                logit_steps.append(logits)
            torch.cuda.synchronize()
            return t1 - t0, time.perf_counter() - t1, logit_steps, toks

        def largest(errs):
            return max(e for pair in errs for e in pair if e is not None)

        def exact_launches(what):
            counts = launch_counts()
            on = ", ".join(f"{k}: {n}" for k, n in counts.items() if n)
            print(f"  {what}: launches {{{on}}} expected {{{kname}: "
                  f"{cfg.num_layers}}}, every other 0")
            if counts != expected:
                raise AssertionError(f"lm {arch} {what}: launch counts "
                                     f"{counts} != {expected}")
            return counts

        # the served request, bf16
        prefill = make_prefill_step(model, cache_dtype=torch.bfloat16)
        errs: list = []
        with checked_launches(torch, errs):          # warm-up
            serve(prefill, steps=1)
        if len(errs) != cfg.num_layers:
            raise AssertionError(f"lm {arch}: {len(errs)} launch checks")
        print(f"  warm-up: {len(errs)} launches each held against its "
              f"plain version on its inputs, max err {largest(errs):.3e}")
        reset_launch_counts()
        pre_s, dec_s, got, _ = serve(prefill)
        counts = exact_launches("served bf16 run")
        counts_all[kname] = counts_all.get(kname, 0) + counts[kname]
        for step, lg in enumerate(got):
            if lg.shape != (1, cfg.padded_vocab) or not all_finite(lg):
                raise AssertionError(f"lm {arch} step {step}: bad logits "
                                     f"{tuple(lg.shape)}")
        busy = profile_run(torch, lambda: serve(prefill))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        wall_us = (pre_s + dec_s) * 1e6
        idle = None if busy is None else 1 - busy / wall_us
        print(f"  kernel route: prefill {pre_s:.6f} s ({S / pre_s:.1f} "
              f"tokens/s), decode {dec_s / n_steps:.6f} s per token "
              f"({n_steps / dec_s:.2f} tokens/s); peak {peak:.2f} GiB; "
              f"device busy "
              f"{'not measured' if busy is None else f'{busy:.1f} us'} of "
              f"{wall_us:.1f} us unprofiled (idle share "
              f"{'not measured' if idle is None else f'{idle:.4f}'})")
        del got

        # the twins, f32: the plain route's own greedy stream, the kernel
        # route teacher-forced on it (each launch checked), then the probe
        params.float()
        torch.cuda.empty_cache()
        prefill = make_prefill_step(model, cache_dtype=torch.float32)
        reset_launch_counts()
        with kernel_mode(False):
            p_pre_s, p_dec_s, want, toks = serve(prefill)
        if any(launch_counts().values()):
            raise AssertionError(f"lm {arch}: the switched-off twin "
                                 f"launched {launch_counts()}")
        reset_launch_counts()
        errs = []
        with checked_launches(torch, errs):
            got = serve(prefill, forced=toks)[2]
        exact_launches("f32 kernel route")
        if len(errs) != cfg.num_layers:
            raise AssertionError(f"lm {arch}: {len(errs)} launch checks")
        print(f"  f32 kernel route: {len(errs)} launches each held against "
              f"its plain version on its inputs, max err {largest(errs):.3e}")
        with probed_launches(torch, errs, LM_SEED):
            probe = serve(prefill, forced=toks)[2]
        compared, worst = 0, 0.0
        for step, (g, w, p) in enumerate(zip(got, want, probe)):
            g, w = g.float(), w.float()
            diff = (g - w).abs().max().item()
            tol = LM_PROBE_FACTOR * (p.float() - g).abs().max().item()
            top2 = torch.topk(w[0], 2).values
            margin = (top2[0] - top2[1]).item()
            held = margin > 2 * tol
            same = torch.equal(sample_greedy(g), sample_greedy(w))
            print(f"  step {step}: max|Δlogit| {diff:.4e} (tol {tol:.4e}, "
                  f"largest plain logit {w.abs().max().item():.4e}); plain "
                  f"top-2 margin {margin:.4e}; greedy tokens "
                  f"{'equal' if same else 'differ'}"
                  f"{'' if held else ' (margin <= 2·tol: not held)'}")
            if not diff <= tol or not all_finite(g):
                raise AssertionError(f"lm {arch} step {step}: logits differ "
                                     f"by {diff:.4e} > {tol:.4e}")
            if held and not same:
                raise AssertionError(f"lm {arch} step {step}: greedy token "
                                     f"differs at margin {margin:.4e} > "
                                     f"2·tol")
            compared += held
            worst = max(worst, diff / tol if tol else 0.0)
        print(f"  greedy tokens held at {compared} of {n_steps + 1} steps; "
              f"largest |Δlogit| / tol {worst:.4f}; plain f32 twin: prefill "
              f"{p_pre_s:.6f} s, decode {p_dec_s / n_steps:.6f} s per token; "
              f"{time.perf_counter() - t_arch:.1f} s in all")
        out.setdefault("runs", {})[arch] = dict(
            prefill_s=pre_s, decode_s_per_token=dec_s / n_steps,
            plain_prefill_s=p_pre_s, peak_gib=peak, idle=idle,
            compared=compared, worst_of_tol=worst)
        del params, got, want, probe, prompt
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the LM trainer and the paper's decentralized bilevel LM round
# ---------------------------------------------------------------------------

TRAIN_ARCH = "qwen3-4b"
# the AdamW step: qwen3-4b's published widths at depth 4 (1.18e9
# parameters, f32), a global batch of 8 × 512 tokens in 2 microbatches
TRAIN_LAYERS = 4
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 8, 512, 2, 6
# the launcher's default rate (at 1e-3 a step moved the logits of the
# 2560-wide unembedding by ~2 and the loss rose before it fell, on the
# H100)
TRAIN_LR, TRAIN_WARMUP = 3e-4, 1
TRAIN_TIMED = 4             # the step time is the median of the last 4
# card against CPU: the reduced model's step, tests/test_torch_train.py's
# rate and tolerance (the two sum in other orders; AdamW's normalised
# update carries that into the parameters in proportion to the rate)
TRAIN_TWIN_LR, TRAIN_TOL = 3e-4, dict(rtol=1e-4, atol=1e-5)
LAUNCH_STEPS, LAUNCH_RESUMED = 8, 12
# the bilevel LM round: 4 agents on one card (rows 3 / 3f), qwen3-4b at
# its widths and depth 1 in bf16 (one f32 tree is ~14 GB at n = 4, and a
# round holds ~8), B·S per agent cut to 2 × 128; examples/train_lm_dagm.py's
# step sizes and loops
LM_DAGM_AGENTS, LM_DAGM_BATCH, LM_DAGM_SEQ, LM_DAGM_ROUNDS = 4, 2, 128, 2
LM_DAGM_SPEC = dict(alpha=0.3, beta=0.1, M=2, U=2, curvature=8.0)
LM_DAGM_COMMS = ("identity", "int8+ef")
LM_DAGM_CHUNK = 1 << 24     # columns a plain-version check holds at once
# the switch-off twin sums each bf16 gossip in bf16 where the kernels (and
# their plain versions) sum in f32 and round once: per launch ~1-2 bf16
# ulps apart (3.9e-3 at these leaves), which two rounds carried to 0.92 %
# of y's leaves and 1.8e-4 of the losses (on the H100); held at 2^-5 =
# 3.1 %, a check of the route (the kernels are held bitwise in (a)).
# x and the DIHGP's metrics pass through an ill-conditioned solve (the
# hyper-gradient grows 1e5-fold in round 1 at these widths: curvature 8
# does not bound the LM's Hessian) and are printed, not held
LM_DAGM_OFF_REL = 2.0 ** -5


def train_step_run(torch, out: dict) -> None:
    """make_train_step on qwen3-4b at depth TRAIN_LAYERS: the losses of
    TRAIN_STEPS AdamW steps (finite, falling), the step seconds (median of
    the last TRAIN_TIMED), tokens per s, the model-FLOPs share, peak
    memory, the idle share of a profiled step, and no kernel launched."""
    from torch.utils._pytree import tree_leaves
    from repro_torch.configs import InputShape, get_config
    from repro_torch.data import TokenDataConfig, make_token_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.costs import (forward_flops,
                                          model_flops_convention,
                                          reduced_depth)
    from repro_torch.launch.mesh import H100_PEAK_FLOPS_BF16
    from repro_torch.models import build_model
    from repro_torch.models.layers import param_tree
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import adamw, cosine_schedule

    cfg = reduced_depth(get_config(TRAIN_ARCH), TRAIN_LAYERS)
    model = build_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = param_tree(model.init(seed=0, device="cuda"))
    n_params = sum(t.numel() for t in tree_leaves(params))
    # the input embedding is a gather: 6·N·D counts the rest
    n_matmul = n_params - sum(t.numel() for t in tree_leaves(params["embed"]))
    opt = adamw(cosine_schedule(TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS))
    state = opt.init(params)
    step = make_train_step(model, opt, microbatches=TRAIN_MICRO)
    data = TokenDataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                           global_batch=TRAIN_BATCH, seed=0)
    batches = [make_token_batch(data, s, device="cuda")
               for s in range(TRAIN_STEPS)]
    print(f"train {TRAIN_ARCH}: {cfg.num_layers} layers, d {cfg.d_model}, "
          f"{n_params} parameters f32 ({n_params * 4 / 2 ** 30:.2f} GiB); "
          f"batch {TRAIN_BATCH} x {TRAIN_SEQ} in {TRAIN_MICRO} microbatches; "
          f"adamw(cosine_schedule({TRAIN_LR}, {TRAIN_WARMUP}, "
          f"{TRAIN_STEPS}))")
    reset_launch_counts()
    losses, seconds = [], []
    for s, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batch)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        print(f"  step {s}: loss {losses[-1]:.6f} ({seconds[-1]:.6f} s)")
    launched = {k: n for k, n in launch_counts().items() if n}
    if launched:
        raise AssertionError(f"train: the step launched {launched}")
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"train: losses {losses} not finite and "
                             f"falling")
    step_s = median(seconds[-TRAIN_TIMED:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    shape = InputShape("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    model_flops = model_flops_convention(cfg, shape, n_matmul)
    step_flops = 3 * forward_flops(cfg, TRAIN_SEQ, ctx=TRAIN_SEQ,
                                   batch=TRAIN_BATCH)
    busy = profile_run(torch, lambda: step(params, state, batches[-1]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    idle = None if busy is None else 1 - busy / (step_s * 1e6)
    print(f"  step {step_s:.6f} s (median of the last {TRAIN_TIMED}: "
          f"{' '.join(f'{t:.6f}' for t in seconds[-TRAIN_TIMED:])}), "
          f"{tokens / step_s:.1f} tokens/s; model FLOPs 6·N·D with N "
          f"{n_matmul} (the parameters outside the input embedding) "
          f"{model_flops:.4e}: {model_flops / step_s / 1e12:.2f} TFLOP/s, "
          f"{model_flops / step_s / H100_PEAK_FLOPS_BF16:.4f} of the bf16 "
          f"peak, {model_flops / step_s / F32_FLOP_PER_S:.4f} of the f32 "
          f"peak (the step runs in f32 without TF32); traced-equivalent "
          f"{step_flops:.4e} FLOP ({step_flops / step_s / 1e12:.2f} "
          f"TFLOP/s, {step_flops / step_s / F32_FLOP_PER_S:.4f} of the f32 "
          f"peak); peak {peak:.2f} GiB; idle share "
          f"{'not measured' if idle is None else f'{idle:.4f}'}; "
          f"launches {{}}")
    out["step"] = dict(seconds=step_s, tokens_per_s=tokens / step_s,
                       model_flops=model_flops, step_flops=step_flops,
                       peak_gib=peak, idle=idle, losses=losses)
    del params, state, batches
    torch.cuda.empty_cache()


def train_card_vs_cpu(torch) -> None:
    """The reduced qwen3-4b step on the card against the same step on the
    CPU from the same draw: 2 steps (microbatches 2), f32 (TF32 off),
    losses, parameters and AdamW moments to TRAIN_TOL."""
    from torch.utils._pytree import tree_flatten, tree_map
    from repro_torch.configs import get_config
    from repro_torch.data import TokenDataConfig, make_token_batch
    from repro_torch.models import build_model
    from repro_torch.models.layers import param_tree
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import adamw, cosine_schedule

    cfg = get_config(TRAIN_ARCH).reduced()
    model = build_model(cfg)
    data = TokenDataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                           global_batch=4, seed=0)
    runs = {}
    cpu_params = param_tree(model.init(seed=0, device="cpu"))
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda t: t.to(dev), cpu_params)
        opt = adamw(cosine_schedule(TRAIN_TWIN_LR, 1, 4))
        state = opt.init(params)
        step = make_train_step(model, opt, microbatches=2)
        losses = []
        for s in range(2):
            params, state, m = step(params, state,
                                    make_token_batch(data, s, device=dev))
            losses.append(m["loss"].cpu())
        runs[dev] = (losses, params, state.mu, state.nu)
    worst = 0.0
    for what, got, want in zip(("losses", "params", "mu", "nu"),
                               runs["cuda"], runs["cpu"]):
        for g, w in zip(tree_flatten(got)[0], tree_flatten(want)[0]):
            g = g.cpu()
            torch.testing.assert_close(g, w, **TRAIN_TOL)
            worst = max(worst, (g - w).abs().max().item())
    print(f"  card vs CPU, reduced {TRAIN_ARCH}, 2 steps f32: losses, "
          f"parameters and moments within rtol {TRAIN_TOL['rtol']} atol "
          f"{TRAIN_TOL['atol']} (largest |difference| {worst:.3e})")


def train_launcher_run(torch) -> None:
    """`launch.train.main` on the card: --smoke for LAUNCH_STEPS steps with
    checkpoints, then resumed from `latest_step` to LAUNCH_RESUMED."""
    import io
    import shutil
    import tempfile
    from repro_torch.checkpoint import latest_step
    from repro_torch.launch import train
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_train_")
    argv = ["--arch", TRAIN_ARCH, "--smoke", "--device", "cuda",
            "--ckpt-dir", ckpt, "--ckpt-every", "4", "--log-every", "4"]
    try:
        for steps, restored in ((LAUNCH_STEPS, None),
                                (LAUNCH_RESUMED, LAUNCH_STEPS)):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                code = train.main(argv + ["--steps", str(steps)])
            text = buf.getvalue()
            for line in text.splitlines():
                print(f"  {line}")
            print(f"  launcher exit {code}, latest_step "
                  f"{latest_step(ckpt)}, {time.perf_counter() - t0:.1f} s")
            if code != 0 or latest_step(ckpt) != steps:
                raise AssertionError(f"train launcher: exit {code}, latest "
                                     f"step {latest_step(ckpt)} != {steps}")
            if restored and f"restored step {restored}" not in text:
                raise AssertionError("train launcher: no resume")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


# the model-parallel step: qwen3-4b's widths at depth 2 (f32, TF32 off), a
# global batch of 4 × 512 in 2 microbatches, 2 AdamW steps at 3e-4, on a
# (data 1, model 2) mesh whose two ranks are two threads of this process in
# torch's threaded process group (one card holds no NCCL group of two
# ranks), against the one-process step on the same batch: the losses
# within 1e-4 relative, the first step's gradients within 1e-4 of each
# leaf's largest element
MP_LAYERS, MP_BATCH, MP_SEQ, MP_MICRO, MP_STEPS, MP_LR = 2, 4, 512, 2, 2, 3e-4
MP_WORLD, MP_LOSS_RTOL, MP_GRAD_TOL, MP_JOIN_S = 2, 1e-4, 1e-4, 600


def threaded_ranks(torch, world: int, fn) -> list:
    """[fn(rank)] with each rank a thread of this process in torch's
    threaded process group (its ranks' collectives are tensor ops on the
    same card).  A rank's failure wakes the others and fails the call."""
    import threading
    import torch.distributed as dist
    from torch.testing._internal.distributed import multi_threaded_pg as mt
    isolate = torch._C._distributed_c10d._set_thread_isolation_mode
    if dist.is_initialized():
        raise AssertionError("threaded ranks: a process group exists")
    hook = sys.excepthook           # each rank's init chains its own
    isolate(True)
    mt._install_threaded_pg()
    store = dist.HashStore()
    results, errors = [None] * world, []

    def body(rank):
        # each thread's group lives in the threaded world, which
        # `_uninstall_threaded_pg` drops whole (torch 2.11's
        # `destroy_process_group` cannot read that world)
        try:
            dist.init_process_group("threaded", rank=rank, world_size=world,
                                    store=store)
            results[rank] = fn(rank)
        except BaseException as e:          # reported below, after join
            errors.append((rank, e))
            mt.ProcessLocalGroup.exception_handle(e)

    threads = [threading.Thread(target=body, args=(r,), daemon=True)
               for r in range(world)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(MP_JOIN_S)
        hung = [r for r, t in enumerate(threads) if t.is_alive()]
    finally:
        mt.ProcessLocalGroup.reset()
        mt._uninstall_threaded_pg()
        isolate(False)
        sys.excepthook = hook
    if hung:
        raise AssertionError(f"threaded ranks {hung} did not finish in "
                             f"{MP_JOIN_S} s")
    if errors:
        rank, err = errors[0]
        raise AssertionError(f"threaded rank {rank} failed: {err!r}") from err
    return results


def comm_bytes_mode(torch):
    """A `CommDebugMode` that also sums each collective's tensor operand
    bytes by kind (`.bytes`)."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils._pytree import tree_leaves

    class CommBytes(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.bytes = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            kind = func.__name__.split(".")[0]
            if out is not NotImplemented and getattr(func, "namespace", "") \
                    in ("_c10d_functional", "c10d_functional", "c10d") \
                    and not kind.startswith(("wait", "_")):
                self.bytes[kind] = self.bytes.get(kind, 0) + sum(
                    t.numel() * t.element_size()
                    for t in tree_leaves((args, kwargs))
                    if isinstance(t, torch.Tensor))
            return out

    return CommBytes()


def train_model_parallel(torch, out: dict) -> None:
    """`make_train_step(rules=)` on DTensor parameters (`distribute_params`
    on `tree_param_sharding`'s placements) at qwen3-4b's widths, two
    ranks in threads (`threaded_ranks`) on a (data 1, model 2) mesh,
    against the one-process step run first and freed: each step's loss
    within MP_LOSS_RTOL relative, the first step's gradients (taken as
    the step takes them, then gathered) within MP_GRAD_TOL of each leaf's
    largest element, each leaf's local shard the shape its placements
    give; the step seconds (two ranks on one card: not a speed), peak
    memory, and each step's collectives by kind and bytes
    (`CommDebugMode`) beside `launch.dryrun.train_collective_bytes`."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard
    from torch.utils._pytree import tree_flatten, tree_unflatten
    from repro_torch.configs import InputShape, get_config
    from repro_torch.data import TokenDataConfig, make_token_batch
    from repro_torch.distributed.sharding import (distribute_params,
                                                  make_rules,
                                                  replicate_plain_tensors,
                                                  use_rules)
    from repro_torch.kernels import kernel_mode
    from repro_torch.launch.costs import reduced_depth
    from repro_torch.launch.dryrun import MeshShape, train_collective_bytes
    from repro_torch.models import build_model
    from repro_torch.models.layers import param_tree
    from repro_torch.models.steps import make_train_step
    from repro_torch.optim import adamw

    cfg = reduced_depth(get_config(TRAIN_ARCH), MP_LAYERS)
    model = build_model(cfg)
    axes = model.param_axes()
    data = TokenDataConfig(vocab_size=cfg.vocab_size, seq_len=MP_SEQ,
                           global_batch=MP_BATCH, seed=0)
    batches = [make_token_batch(data, s, device="cuda")
               for s in range(MP_STEPS)]

    def first_grads(params, batch, rules):
        leaves, spec = tree_flatten(params)
        live = [t.detach().requires_grad_() for t in leaves]
        with use_rules(rules), replicate_plain_tensors(), \
                kernel_mode(False):
            loss, _ = model.loss(tree_unflatten(live, spec), batch)
            grads = torch.autograd.grad(loss, live)
        if rules is None:
            return list(grads)
        return [g.redistribute(p.device_mesh, p.placements)
                for g, p in zip(grads, leaves)]

    # the one-process step, then freed
    torch.cuda.empty_cache()
    params = param_tree(model.init(seed=0, device="cuda"))
    ref_grads = first_grads(params, batches[0], None)
    opt = adamw(MP_LR)
    state = opt.init(params)
    step = make_train_step(model, opt, microbatches=MP_MICRO)
    ref_losses = []
    for batch in batches:
        params, state, metrics = step(params, state, batch)
        ref_losses.append(float(metrics["loss"]))
    del params, state, step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t_all = time.perf_counter()

    def rank_fn(rank):
        mesh = init_device_mesh("cuda", (1, MP_WORLD),
                                mesh_dim_names=("data", "model"))
        rules = make_rules(cfg, mesh)
        params = distribute_params(param_tree(model.init(seed=0,
                                                         device="cuda")),
                                   axes, rules)
        names = list(axes)
        wrong = []
        for name, t in zip(names, tree_flatten(params)[0]):
            want = list(t.shape)
            for i, p in enumerate(t.placements):
                if isinstance(p, Shard):
                    want[p.dim] //= mesh.size(i)
            if list(t.to_local().shape) != want:
                wrong.append((name, list(t.to_local().shape), want))
        feed = lambda b: {k: DTensor.from_local(
            v, mesh, rules.placements("batch", None), run_check=False)
            for k, v in b.items()}
        grads = first_grads(params, feed(batches[0]), rules)
        worst = (0.0, "")
        for name, g, r in zip(names, grads, ref_grads):
            e = ((g.full_tensor() - r).abs().max()
                 / r.abs().max().clamp(min=1e-30)).item()
            worst = max(worst, (e, name))
        del grads
        opt = adamw(MP_LR)
        state = opt.init(params)
        step = make_train_step(model, opt, microbatches=MP_MICRO,
                               rules=rules)
        losses, seconds, comms = [], [], []
        for batch in batches:
            mode = comm_bytes_mode(torch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with mode:
                params, state, metrics = step(params, state, feed(batch))
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
            comms.append(({str(k).split(".")[-1]: v for k, v in
                           mode.get_comm_counts().items()}, mode.bytes))
        return dict(wrong=wrong, worst=worst, losses=losses,
                    seconds=seconds, comms=comms)

    # the kernel switch is one flag for the process, and each rank's step
    # saves it, turns it off and restores it: two threads doing so at once
    # left it off after them on the card, so it is off around them
    with kernel_mode(False):
        runs = threaded_ranks(torch, MP_WORLD, rank_fn)
    wall = time.perf_counter() - t_all
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del ref_grads
    torch.cuda.empty_cache()
    res = runs[0]
    rules = make_rules(cfg, MeshShape.of({"data": 1, "model": MP_WORLD}))
    shapes = {n: tuple(t.shape) for n, t in
              model.init(device="meta").named_parameters()}
    planned = train_collective_bytes(
        cfg, InputShape("train", MP_SEQ, MP_BATCH, "train"), rules, axes,
        shapes, MP_MICRO)
    print(f"  model parallel, {TRAIN_ARCH} depth {MP_LAYERS} f32, mesh "
          f"(data 1, model {MP_WORLD}) in {MP_WORLD} threads "
          f"(threaded process group), B {MP_BATCH} x {MP_SEQ} in "
          f"{MP_MICRO} microbatches, adamw({MP_LR}): losses "
          f"{res['losses']} (one process {ref_losses}); first-step "
          f"gradients within {res['worst'][0]:.3e} of each leaf's largest "
          f"element (worst {res['worst'][1]}); step seconds "
          f"{' '.join(f'{t:.6f}' for t in res['seconds'])} (two ranks share "
          f"the card: not a speed); peak {peak:.2f} GiB; {wall:.1f} s in all")
    for s, (counts, nbytes) in enumerate(res["comms"]):
        print(f"  step {s} collectives (rank 0, CommDebugMode): {counts}; "
              f"operand bytes {nbytes}")
    print(f"  launch.dryrun.train_collective_bytes for this mesh (bf16 "
          f"parameters, per device): {planned}")
    for r, run in enumerate(runs):
        if run["wrong"]:
            raise AssertionError(f"model parallel rank {r}: local shards "
                                 f"{run['wrong'][:4]} != their placements")
        if not run["worst"][0] <= MP_GRAD_TOL:
            raise AssertionError(f"model parallel rank {r}: gradient "
                                 f"{run['worst']} over {MP_GRAD_TOL}")
        far = [(a, b) for a, b in zip(run["losses"], ref_losses)
               if not abs(a - b) <= MP_LOSS_RTOL * abs(b)]
        if far or not all(math.isfinite(v) for v in run["losses"]):
            raise AssertionError(f"model parallel rank {r}: losses "
                                 f"{run['losses']} vs {ref_losses}")
    out["model_parallel"] = dict(losses=res["losses"], ref=ref_losses,
                                 grad_err=res["worst"][0],
                                 seconds=res["seconds"], peak_gib=peak,
                                 comms=res["comms"], planned=planned)


@contextlib.contextmanager
def sparse_gossips(torch, record: list, errs: list | None = None):
    """Every sparse gather that `MixingOp` launches inside the block:
    (operand shape, dtype, comm) appended to `record`.  With `errs`, each
    launch is held bitwise against its plain version on the same inputs
    (a plain gather by LM_DAGM_CHUNK columns at a time; a comm-fused one
    with its payload), and the largest |difference| between its output
    and the switch-off route's arithmetic on those inputs (a bf16 operand
    summed in bf16; a compressed one composed as `MixingOp` composes it)
    is appended to `errs`."""
    from repro_torch.kernels import ref
    from repro_torch.topology import ops
    real = ops.sparse_mix_matvec

    def checked(y, w_self, nbr, wts, zp=None, scale=None, seed=None,
                hat=None, *, laplacian=False, comm=None):
        res = real(y, w_self, nbr, wts, zp, scale, seed, hat,
                   laplacian=laplacian, comm=comm)
        record.append((tuple(y.shape), y.dtype, comm or "identity"))
        out = res[0] if isinstance(res, tuple) else res
        if errs is not None:
            e = 0.0
            if comm in (None, "identity"):
                for c0 in range(0, y.shape[1], LM_DAGM_CHUNK):
                    yc = y[:, c0:c0 + LM_DAGM_CHUNK]
                    want = ref.sparse_mix_padded_ref(
                        yc.float(), w_self, nbr, wts, laplacian).to(y.dtype)
                    got = out[:, c0:c0 + LM_DAGM_CHUNK]
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"sparse_mix_matvec {tuple(y.shape)} "
                            f"{y.dtype}: not bitwise its plain version")
                    off = ref.sparse_mix_padded_ref(yc, w_self, nbr, wts,
                                                    laplacian)
                    e = max(e, (got.float() - off.float()).abs().max()
                            .item())
            else:
                want = ref.sparse_mix_fused_ref(
                    y, w_self, nbr, wts, zp, scale, seed, hat,
                    laplacian=laplacian, bits=int(comm[3]))
                if not all(torch.equal(g, w) for g, w in zip(
                        res if isinstance(res, tuple) else (res,),
                        want if isinstance(want, tuple) else (want,))):
                    raise AssertionError(f"sparse_mix_matvec {comm}: not "
                                         f"bitwise its plain version")
                pay = ref._payload(y, zp, scale, seed, hat, int(comm[3]))
                off = ref.sparse_mix_padded_ref(pay, w_self, nbr, wts) \
                    + w_self[:, None] * (y - pay)
                off = y - off if laplacian else off
                e = (out - off).abs().max().item()
            errs.append(e)
        return res

    ops.sparse_mix_matvec = checked
    try:
        yield record
    finally:
        ops.sparse_mix_matvec = real


def lm_dagm_rounds(torch, out: dict) -> None:
    """`build_dagm_bilevel` through `make_sharded_dagm` on LocalRing(4) at
    qwen3-4b's widths, depth 1, bf16: LM_DAGM_ROUNDS rounds on each wire
    from the same draw, (a) every gossip launch recorded and held bitwise
    against its plain version, exact launch counts (rows 3 / 3f, one a
    leaf a gossip; no flash-attention launch), the wire bytes equal to
    `sharded_comm_ledger`; on the identity wire, (b) the kernel switch
    off (`kernel_mode(False)` around the step, whose gossips sum a bf16
    operand in bf16): each leaf of y and the losses within
    LM_DAGM_OFF_REL, x and the DIHGP's metrics printed (int8+ef's
    launches are held one by one in (a); its y gossips compose the
    quantizer with the same row-3 launches, its x gossip is row 3f);
    (c) timed: seconds per round, its metrics and every leaf of y
    bitwise (a)'s, x too, then one more round
    profiled for the idle share;
    peak, the losses, consensus_x.  All under deterministic algorithms;
    the runs' results are compared on the card, leaf by leaf, against a
    pinned host copy of (a)'s.  (a) holds each launch bitwise its plain
    version on its own inputs, so a run through `plain_versions()`
    would hold the kernels to nothing more."""
    from torch.utils._pytree import tree_flatten
    from repro_torch.configs import get_config
    from repro_torch.distributed import (LocalRing, make_sharded_dagm,
                                         round_channels,
                                         sharded_comm_ledger,
                                         sharded_policy)
    from repro_torch.kernels import (kernel_mode, launch_counts,
                                     reset_launch_counts)
    from repro_torch.launch import dagm_dryrun as dd
    from repro_torch.launch.costs import reduced_depth
    from repro_torch.models import build_model
    from repro_torch.solve import sharded_spec

    n = LM_DAGM_AGENTS
    cfg = reduced_depth(get_config(TRAIN_ARCH), 1)
    model = build_model(cfg)
    # one agent's autodiff at a time: four agents' HVPs at once do not fit
    ring = LocalRing(n, device="cuda", agent_chunk=1)
    batches = [dd.agent_batches(cfg, n, LM_DAGM_SEQ, LM_DAGM_BATCH, k,
                                device="cuda")
               for k in range(LM_DAGM_ROUNDS + 1)]
    zero = dict.fromkeys(launch_counts(), 0)
    counts_all = out.setdefault("counts", dict(zero))
    torch.cuda.empty_cache()
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)

    def leaves_of(x, y):
        return [x] + tree_flatten(y)[0]

    try:
        for comm in LM_DAGM_COMMS:
            spec = sharded_spec(comm=comm, **LM_DAGM_SPEC)
            pol = sharded_policy(spec)
            g_fn, f_fn = dd.build_dagm_bilevel(
                cfg, seq_len=LM_DAGM_SEQ, batch_per_agent=LM_DAGM_BATCH,
                dcfg=spec)
            step, _ = make_sharded_dagm(g_fn, f_fn, spec, ring)

            def run(timed=None, rounds=LM_DAGM_ROUNDS):
                """(x, y) on the card after `rounds` rounds from the seeded
                draw, and each round's metrics."""
                y = dd.init_agents(model, n, seed=0, dtype=torch.bfloat16,
                                   device="cuda")
                x = torch.zeros((n, dd.N_DOMAINS + 1), device="cuda")
                metrics = []
                for k in range(rounds):
                    ch = round_channels(spec, x, y, 0, k)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    # the round's returned channels are not kept: their
                    # EF replicas are two model-sized trees
                    x, y, m = step(x, y, batches[k], ch)[:3]
                    torch.cuda.synchronize()
                    if timed is not None:
                        timed.append(time.perf_counter() - t0)
                    metrics.append({k_: float(v) for k_, v in m.items()})
                return x, y, metrics

            one = tree_flatten(dd.init_agents(
                model, 1, dtype=torch.bfloat16, device="meta"))[0]
            L = len(one)
            led = sharded_comm_ledger(
                spec, torch.empty(dd.N_DOMAINS + 1, device="meta"),
                [t[0] for t in one])
            # (a) the counted run, kept in pinned host memory
            record, errs = [], []
            reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            with sparse_gossips(torch, record, errs):
                x, y, metrics = run()
            counts = launch_counts()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            got = []
            for t in leaves_of(x, y):
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                got.append(host.copy_(t))
            del x, y
            gossips = spec.M + spec.U
            fused = pol.stochastic          # x's outer gossip on row 3f
            want = {**zero, "sparse_mix_matvec": LM_DAGM_ROUNDS * (
                gossips * L + (1 if fused else 2))}
            if fused:
                want["sparse_mix_matvec_comm"] = LM_DAGM_ROUNDS
            on = {k: v for k, v in counts.items() if v}
            print(f"  {comm}: {L} leaves; launches {on} (expected "
                  f"{ {k: v for k, v in want.items() if v} }); "
                  f"{len(errs)} launches each bitwise its plain version; "
                  f"peak {peak:.2f} GiB")
            if counts != want or len(record) != sum(want.values()):
                raise AssertionError(f"lm dagm {comm}: launches {counts} "
                                     f"!= {want}")
            for k_, v in counts.items():
                counts_all[k_] = counts_all.get(k_, 0) + v
            per_round = len(record) // LM_DAGM_ROUNDS
            wire = 0
            for r in range(LM_DAGM_ROUNDS):
                launches = record[r * per_round:(r + 1) * per_round]
                shape_c, _, comm_c = launches[-1]   # the consensus mix
                if shape_c != (n, dd.N_DOMAINS + 1) or comm_c != "identity":
                    raise AssertionError(f"lm dagm: the round's last launch "
                                         f"{launches[-1]} is not the "
                                         f"consensus mix")
                wire += sum(pol.compressor.payload_bytes((s[1],))
                            for s, _, _ in launches[:-1])
            if wire != led.total_bytes * LM_DAGM_ROUNDS or any(
                    m["comm_sends"] != led.total_sends() for m in metrics):
                raise AssertionError(f"lm dagm {comm}: wire bytes {wire} "
                                     f"!= ledger {led.total_bytes} x "
                                     f"{LM_DAGM_ROUNDS}")
            print(f"  wire bytes per agent {wire // LM_DAGM_ROUNDS} a round "
                  f"= sharded_comm_ledger {led.total_bytes} "
                  f"({led.total_sends()} sends); flash_attention launches "
                  f"{counts.get('flash_attention', 0)}")
            if comm == "identity":
                # (b) the switch-off twin: its bf16 gossips sum in bf16
                with kernel_mode(False):
                    x, y, off_m = run()
                rel = {f"y{i}": norm_rel(d, h) for i, (h, d) in
                       enumerate(zip(got[1:], leaves_of(x, y)[1:]))}
                for r, (g, o) in enumerate(zip(metrics, off_m)):
                    rel.update((f"round {r} {key}", abs(o[key] - g[key])
                                / abs(g[key])) for key in
                               ("outer_loss", "inner_loss"))
                shown = {"x": norm_rel(x, got[0])}
                for r, (g, o) in enumerate(zip(metrics, off_m)):
                    shown.update((f"round {r} {key}", abs(o[key] - g[key])
                                  / max(abs(g[key]), 1e-30)) for key in
                                 ("hypergrad_norm", "consensus_x"))
                del x, y
                worst = max(rel, key=rel.get)
                print(f"  vs the switch-off run: each leaf of y and the "
                      f"losses within {rel[worst]:.4e} relative ({worst}; "
                      f"held at {LM_DAGM_OFF_REL}); per-launch |kernel - "
                      f"switch-off arithmetic| up to {max(errs):.3e}")
                print("    " + ", ".join(f"{k} {v:.3e}" for k, v in
                                         {**rel, **shown}.items()))
                if not rel[worst] <= LM_DAGM_OFF_REL:
                    raise AssertionError(f"lm dagm {comm}: the switch-off "
                                         f"run's {worst} differs by "
                                         f"{rel[worst]:.4e}")
            # (c) timed, then one more round profiled
            seconds = []
            torch.cuda.reset_peak_memory_stats()
            x, y, timed_m = run(timed=seconds)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            apart = {}
            for i, (h, d) in enumerate(zip(got, leaves_of(x, y))):
                h = h.to("cuda", non_blocking=True)
                if not torch.equal(h, d):
                    apart[f"y{i - 1}" if i else "x"] = (
                        (h != d).sum().item(),
                        (h.float() - d.float()).abs().max().item())
            del got
            if apart or timed_m != metrics:
                raise AssertionError(
                    f"lm dagm {comm}: the timed run is not the counted "
                    f"run: leaves apart (elements, largest |difference|) "
                    f"{apart}; metrics {timed_m} against {metrics}")
            k = LM_DAGM_ROUNDS
            ch = round_channels(spec, x, y, 0, k)
            busy = profile_run(torch, lambda: step(x, y, batches[k], ch))
            del x, y, ch
            idle = None if busy is None else \
                1 - busy / (median(seconds) * 1e6)
            for r, m in enumerate(timed_m):
                print(f"  round {r}: {seconds[r]:.6f} s, outer loss "
                      f"{m['outer_loss']:.6f}, inner loss "
                      f"{m['inner_loss']:.6f}, consensus_x "
                      f"{m['consensus_x']:.4e}, hypergrad_norm "
                      f"{m['hypergrad_norm']:.4e}")
            if timed_m != metrics or not all(
                    math.isfinite(v) for m in timed_m for v in m.values()):
                raise AssertionError(f"lm dagm {comm}: the timed run's "
                                     f"metrics differ or are not finite")
            print(f"  {comm}: the timed run's x, y and metrics bitwise "
                  f"the counted run's")
            print(f"  {comm}: {median(seconds):.6f} s per round (median of "
                  f"{LM_DAGM_ROUNDS}); peak {peak:.2f} GiB; idle share of "
                  f"round {k} "
                  f"{'not measured' if idle is None else f'{idle:.4f}'}")
            out.setdefault("dagm", {})[comm] = dict(
                seconds=seconds, peak_gib=peak, idle=idle,
                launches={k_: v for k_, v in want.items() if v},
                wire_bytes=led.total_bytes, metrics=timed_m)
    finally:
        torch.use_deterministic_algorithms(was_deterministic)


def train_dryrun_line(torch, out: dict) -> None:
    """`launch.dryrun.run_one("qwen3-4b", "train_4k")` on the meta device,
    its roofline terms beside the measured step scaled to the same
    per-device FLOPs."""
    from repro_torch.launch.dryrun import run_one
    res = run_one(TRAIN_ARCH, "train_4k")
    if not res.ok:
        raise AssertionError(f"dry run: {res.error}")
    rf = res.roofline()
    step = out["step"]
    scaled = step["seconds"] * res.flops / step["step_flops"]
    print(f"  dry run {TRAIN_ARCH} train_4k (16x16, {res.microbatches} "
          f"microbatches, traced in {res.compile_s:.1f} s): per device "
          f"{res.flops:.4e} FLOP, {res.hbm_bytes_accessed:.4e} bytes of "
          f"traced operands, peak {res.peak_memory_per_device / 1e9:.2f} "
          f"GB, collectives {sum(res.collective_bytes.values()):.4e} "
          f"bytes; roofline compute {rf['compute_s']:.6f} s, memory "
          f"{rf['memory_s']:.6f} s, collective {rf['collective_s']:.6f} s "
          f"({rf['bottleneck']}); the measured step (f32, no TF32, one "
          f"card) scaled to the same FLOPs {scaled:.6f} s, "
          f"{scaled / rf['compute_s']:.1f}x the compute term")


def train_phase(torch, out: dict) -> None:
    """The LM trainer and the paper's bilevel LM round (the module
    docstring's phase 14)."""
    t0 = time.perf_counter()
    train_step_run(torch, out)
    print(f"  ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    train_card_vs_cpu(torch)
    train_launcher_run(torch)
    print(f"  ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    train_model_parallel(torch, out)
    print(f"  ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    lm_dagm_rounds(torch, out)
    print(f"  ({time.perf_counter() - t0:.1f} s)")
    train_dryrun_line(torch, out)


def median(values):
    return sorted(values)[len(values) // 2]


# passes of `time_in_turns`: two (three before the train phase, whose
# time they paid for); the median of two is their larger
TURNS = 2


def time_in_turns(torch, timed: dict, rounds: int = K) -> dict:
    """Seconds per round of every main-path run, timed in turns (each
    run once per pass, TURNS passes), so that the host's drift over the
    script falls on all of them alike; returns {label: seconds per round
    of each pass, in pass order}."""
    seconds = {label: [] for label in timed}
    for _ in range(TURNS):
        for label, run in timed.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run("cuda")
            torch.cuda.synchronize()
            seconds[label].append((time.perf_counter() - t0) / rounds)
    print(f"seconds per round, {TURNS} passes in turns (host clock, "
          f"{rounds} rounds per run):")
    for label, ts in seconds.items():
        ts = sorted(ts)
        print(f"  {label}: median {median(ts):.6f} min {ts[0]:.6f} "
              f"max {ts[-1]:.6f} all {' '.join(f'{t:.6f}' for t in ts)}")
    return seconds


def idle_shares(busy: dict, seconds: dict, rounds: int) -> None:
    """The device's idle share of an unprofiled run: 1 − (device busy µs
    of the profiled run) / (median seconds per round × rounds)."""
    for label, us in busy.items():
        if us is not None:
            wall = median(seconds[label]) * rounds * 1e6
            print(f"  {label}: device busy {us:.1f} us of {wall:.1f} us "
                  f"unprofiled (idle share {1 - us / wall:.4f})")


def norm_rel(a, b) -> float:
    """‖a − b‖ / ‖b‖ in float64, on a's device."""
    a, b = a.double(), b.to(a.device).double()
    return ((a - b).norm() / b.norm()).item()


def compare_runs(torch, what, res, ref_run, compressed=False,
                 norm_rel_xy=False) -> None:
    """The card's run against a reference run of the same solve:
    elementwise on the identity wire (by norm-relative error with
    `norm_rel_xy`); by norm-relative error (x, y) and a wider metric band
    when compressed (see E2E_NORM_REL)."""
    for name, g, c in (("x", res.x, ref_run.x), ("y", res.y, ref_run.y)):
        c = c.to(g.device)
        err = (g - c).abs().max().item()
        rel = norm_rel(g, c)
        print(f"  vs {what} {name}: max_abs_err={err:.3e} norm_rel_err="
              f"{rel:.3e}")
        if compressed or norm_rel_xy:
            if not rel <= E2E_NORM_REL:
                raise AssertionError(f"{name}: norm-relative error {rel} "
                                     f"> {E2E_NORM_REL} against {what}")
        else:
            torch.testing.assert_close(g, c, rtol=E2E_RTOL, atol=E2E_ATOL)
    rtol, atol = (E2E_METRIC_RTOL, E2E_METRIC_ATOL) if compressed \
        else (E2E_RTOL, E2E_ATOL)
    for key in ref_run.metrics:
        g, c = res.metrics[key].cpu(), ref_run.metrics[key].cpu()
        err = (g - c).abs().max().item()
        print(f"  vs {what} metrics[{key}]: max_abs_err={err:.3e} "
              f"(rtol={rtol}, atol={atol})")
        torch.testing.assert_close(g, c, rtol=rtol, atol=atol)


@contextlib.contextmanager
def plain_versions():
    """MixingOp with every kernel wrapper replaced by its plain PyTorch
    version, run on the card's tensors: the same solve, same device,
    same autodiff, without the kernels."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.topology import ops

    def host(table):      # MixingOp passes host tuples or device tables
        return table.tolist() if hasattr(table, "tolist") else list(table)

    def by_columns(fn, y):
        """fn(y) column slab by column slab (each column's result is its
        own: the same bits), so that an LM leaf's f32 plain version holds
        one slab at a time; a bf16 operand is summed in f32 and rounded
        once, as the kernel."""
        out = torch.empty_like(y)
        for c0 in range(0, y.shape[1], LM_DAGM_CHUNK):
            cols = slice(c0, c0 + LM_DAGM_CHUNK)
            out[:, cols] = fn(y[:, cols].float()).to(y.dtype)
        return out

    def circ(y, zp=None, scale=None, seed=None, hat=None, *, w_self,
             offsets, weights, laplacian=False, comm=None):
        kw = dict(w_self=w_self, offsets=host(offsets),
                  weights=host(weights), laplacian=laplacian)
        if comm in (None, "identity"):
            return by_columns(lambda t: ref.circulant_mix_ref(t, **kw), y)
        return ref.circulant_mix_fused_ref(y, zp, scale, seed, hat,
                                           bits=int(comm[3]), **kw)

    def sparse(y, w_self, nbr, wts, zp=None, scale=None, seed=None,
               hat=None, *, laplacian=False, comm=None):
        if comm in (None, "identity"):
            return by_columns(lambda t: ref.sparse_mix_padded_ref(
                t, w_self, nbr, wts, laplacian), y)
        return ref.sparse_mix_fused_ref(y, w_self, nbr, wts, zp, scale,
                                        seed, hat, laplacian=laplacian,
                                        bits=int(comm[3]))

    def neumann(h, hvp, p, dsc, zp=None, scale=None, seed=None, *, w_self,
                offsets, weights, beta, comm=None):
        kw = dict(w_self=w_self, offsets=host(offsets),
                  weights=host(weights), beta=beta)
        if comm in (None, "identity"):
            return ref.neumann_step_ref(h, hvp, p, dsc, **kw)
        return ref.neumann_step_fused_ref(h, hvp, p, dsc, zp, scale, seed,
                                          bits=int(comm[3]), **kw)
    def circ_halo(y, zp=None, scale=None, seed=None, hat=None, *, bn,
                  comm=None, **kw):
        bits = None if comm in (None, "identity") else int(comm[3])
        return ref.circulant_mix_halo_ref(y, zp, scale, seed, hat, bn=bn,
                                          bits=bits, **kw)

    def sparse_halo(y, w_self, nbr, wts, zp=None, scale=None, seed=None, *,
                    laplacian=False, bn, comm=None, row_plan=None):
        bits = None if comm in (None, "identity") else int(comm[3])
        return ref.sparse_mix_halo_ref(y, w_self, nbr, wts, zp, scale, seed,
                                       laplacian=laplacian, bn=bn, bits=bits)
    names = ("circulant_mix_matvec", "sparse_mix_matvec",
             "circulant_neumann_step", "circulant_mix_matvec_halo",
             "sparse_mix_matvec_halo")
    saved = [getattr(ops, n) for n in names]
    for n, fn in zip(names, (circ, sparse, neumann, circ_halo,
                             sparse_halo)):
        setattr(ops, n, fn)
    try:
        yield
    finally:
        for n, fn in zip(names, saved):
            setattr(ops, n, fn)


def profile_run(torch, run, by_kernel: dict | None = None) -> float | None:
    """Device time by kernel and the device's busy share over one more
    run under torch.profiler (which slows the host, so its wall time is
    not the round time above); returns the device's busy µs, and fills
    `by_kernel` with {kernel name: device µs} of the port's kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_rows(activities):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e6
        # device activities only (kernels, copies, sets): an operator's
        # row repeats the time of the kernels it launched, and the
        # tracer's own buffer requests are not the program's work
        return wall, [(e.self_device_time_total, e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0
                      and not e.key.startswith("Activity Buffer Request")]
    # the device's activity alone: the host's operator events of a serve
    # bucket (~10^5) took the profiler ~30 s a run to aggregate
    wall_us, rows = device_rows([ProfilerActivity.CUDA])
    if not rows:
        print("  profiler: no device rows without the host's activity; "
              "profiling with it")
        wall_us, rows = device_rows([ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA])
    busy_us = sum(r[0] for r in rows)
    if not rows:
        print("  profiler: no device time recorded (not measured)")
        return None
    print(f"  profiler: device busy {busy_us:.1f} us of {wall_us:.1f} us "
          f"wall (idle share {1 - busy_us / wall_us:.4f}); "
          f"{sum(r[1] for r in rows)} device ops")
    for us, count, key in sorted(rows, reverse=True)[:12]:
        print(f"    {us:10.1f} us  x{count:<5d} {key[:90]}")
    for us, count, key in rows:
        if any(tag in key for tag in ("_mix_kernel", "_neumann_kernel",
                                      "_comm_kernel", "_halo_kernel",
                                      "_slab_kernel", "_stripe_kernel",
                                      "_unstaged_kernel", "_ring_kernel")):
            print(f"  port kernel: {us:.1f} us device in {count} launches "
                  f"({us / count:.2f} us each) {key[:70]}")
            if by_kernel is not None:
                by_kernel[key] = by_kernel.get(key, 0.0) + us
    return busy_us


def tensor_core_instructions(lib) -> dict:
    """{"BF16": (count, first line), "TF32": (...)}: the tensor-core
    instructions (HMMA) of a built library's SASS, by input type, from
    the toolkit's cuobjdump."""
    from repro_torch.kernels import _build
    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=600).stdout
    found = {}
    for line in sass.splitlines():
        if "HMMA" in line:
            kind = next((t for t in ("BF16", "TF32") if f".{t}" in line),
                        "other")
            count, first = found.get(kind,
                                     (0, " ".join(line.split(";")[0].split())))
            found[kind] = (count + 1, first)
    return found


PHASES = ("kernel", "halo", "ring_sweep", "main", "fig2", "large",
          "routes", "ops", "baselines", "faults", "serve", "obs",
          "admission", "sharded", "lm", "train")


def main() -> int:
    started = time.perf_counter()
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phase", action="append", choices=PHASES,
                        help="run only these phases (a probe: no kernel "
                             "list and no result line)")
    only = parser.parse_args().phase
    # cuBLAS reads its workspace setting when it starts; the train phase's
    # deterministic runs need a fixed one (32 MiB, as PyTorch's own default
    # on this card), so it is set before anything touches cuBLAS
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    # the bilevel LM round holds ~8 parameter trees of 7 GB on the card;
    # growable segments keep the allocator's free blocks usable for them
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
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

    from repro_torch import resolve_device, strict_f32
    from repro_torch.kernels import _build
    resolve_device("cuda")
    # the CPU reference runs on the cores this process may use, not on
    # every core the host reports
    torch.set_num_threads(max(1, min(8, len(os.sched_getaffinity(0)))))
    # one nvcc per source, all started together
    from concurrent.futures import ThreadPoolExecutor
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        took = dict(zip(sources, pool.map(_build.build, sources)))
    for name in sources:
        print(f"build: {name} "
              f"{'cached' if took[name] is None else f'{took[name]:.2f} s'}")
    print(f"build: {time.perf_counter() - t0:.2f} s in all")
    for log in sorted(_build.BUILD_DIR.glob(f"*-{_build.source_hash()}.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {log.stem}: {line.strip()}")
    # the attention kernel's products run on the tensor cores in both
    # dtypes: bf16 mma and the f32 path's 3xTF32 mma
    hmma = tensor_core_instructions(_build.library_path("flash_attention"))
    for itype in ("BF16", "TF32"):
        n_hmma, first = hmma.get(itype, (0, ""))
        print(f"sass flash_attention: {n_hmma} HMMA .{itype} instructions, "
              f"e.g. {first}")
        if not n_hmma:
            raise AssertionError(f"flash_attention has no {itype} HMMA")
    # the chunked WKV scan's inter product, state update and intra term:
    # 3xTF32 mma
    n_hmma, first = tensor_core_instructions(
        _build.library_path("rwkv6_scan")).get("TF32", (0, ""))
    print(f"sass rwkv6_scan: {n_hmma} HMMA .TF32 instructions, e.g. {first}")
    if not n_hmma:
        raise AssertionError("rwkv6_scan has no TF32 HMMA")

    results: dict = {}
    counts: dict = {}
    ops_out: dict = {}
    lm_out: dict = {}
    train_out: dict = {}
    routes: dict = {}
    # the plain versions' matmuls in full f32 for the whole run
    with strict_f32():
        for name, (phase, args) in zip(PHASES, (
                (kernel_phase, results),
                (halo_kernel_phase, results),
                (ring_sweep_phase, results),
                (main_path_phase, counts),
                (fig2_network_phase, counts),
                (large_network_phase, counts),
                (routes_phase, routes),
                (ops_kernel_phase, ops_out),
                (baselines_phase, counts),
                (faults_phase, counts),
                (serve_phase, {"results": results, "counts": counts}),
                (obs_phase, None),
                (admission_phase, {"counts": counts}),
                (sharded_phase, {"counts": counts}),
                (lm_phase, lm_out),
                (train_phase, train_out))):
            if only and name not in only:
                continue
            t0 = time.perf_counter()
            phase(torch, args)
            print(f"phase {phase.__name__}: "
                  f"{time.perf_counter() - t0:.1f} s")
    if only:
        print(f"chip_smoke: probe of {', '.join(only)} done in "
              f"{time.perf_counter() - started:.1f} s (no result line)")
        return 0

    # one entry per kernel, at the main path's largest f32 launch (the
    # Neumann steps: the d2 launch they run at, (4096, d2) on the ring and
    # (16, d2) on the unstaged kernels, which the planners keep at the
    # n = 16 path's d2; the halo kernels: the (4096, d1) gossip of the
    # large-network path); ring_laplacian_matvec
    # is not on the main path and reports its (16, d1) check, the
    # full-operand gossips' unstaged kernels (n > 14,528) their (16, d1)
    # launches under a lower budget, the row-tiled sparse gathers (n >
    # 33,536) their (4096, d1) launches under a lower budget, and the
    # slabs' entries their narrower routes (and the plain slab the steps
    # of its walk)
    src = "src/repro/kernels/mixing_matvec.py"
    neumann_on_path = neumann_comm_counter(N_AGENTS)
    pick = {
        "circulant_mix_matvec": ((N_AGENTS, D1, "float32", True), 274),
        "circulant_mix_matvec_unstaged": ((N_AGENTS, D2, "float32", True),
                                          274),
        "sparse_mix_matvec": ((N_AGENTS, D1, "float32", True), 598),
        "sparse_mix_matvec_unstaged": ((N_AGENTS, D1, "float32", True),
                                       598),
        "circulant_neumann_step": ((N_LARGE, D2, "float32", None), 852),
        "circulant_neumann_step_unstaged": (
            (N_AGENTS, D2, "float32", None), 852),
        "circulant_mix_matvec_comm": ((N_AGENTS, D1, "int8+ef", True),
                                      232),
        "circulant_mix_matvec_comm_unstaged": (
            (N_AGENTS, D1, "int8+ef", True), 232),
        "sparse_mix_matvec_comm": ((N_AGENTS, D1, "int8+ef", True), 551),
        "sparse_mix_matvec_comm_unstaged": ((N_AGENTS, D1, "int8+ef", True),
                                            551),
        # the comm-fused Neumann step's route on the main path at the n = 16
        # ring int4 solve's (16, d2), the other at (128, d1) int8
        "circulant_neumann_step_comm": (
            (N_AGENTS, D2, "int4", None) if neumann_on_path
            == "circulant_neumann_step_comm" else (128, D1, "int8", None),
            826),
        "circulant_neumann_step_comm_unstaged": (
            (N_AGENTS, D2, "int4", None) if neumann_on_path
            == "circulant_neumann_step_comm_unstaged"
            else (128, D1, "int8", None), 826),
        "ring_laplacian_matvec": ((N_AGENTS, D1, "float32", True), 923),
        "circulant_mix_matvec_halo": ((N_LARGE, D1, "float32", True), 439),
        "circulant_mix_matvec_halo_comm": ((N_LARGE, D1, "int8+ef", True),
                                           439),
        "sparse_mix_matvec_halo": ((N_LARGE, D1, "float32", True), 739),
        "sparse_mix_matvec_halo_rows": ((N_LARGE, D1, "float32", True), 739),
        "sparse_mix_matvec_halo_comm": ((N_LARGE, D1, "int8", True), 739),
        "sparse_mix_matvec_halo_comm_rows": ((N_LARGE, D1, "int8", True),
                                             739),
    }
    off_path = ("ring_laplacian_matvec", "sparse_mix_matvec_unstaged",
                "circulant_mix_matvec_comm_unstaged",
                "sparse_mix_matvec_comm_unstaged",
                "sparse_mix_matvec_halo_rows",
                "sparse_mix_matvec_halo_comm_rows",
                {"circulant_neumann_step_comm":
                 "circulant_neumann_step_comm_unstaged"}.get(
                     neumann_on_path, "circulant_neumann_step_comm"))
    kernels = []
    for name, (key, line) in pick.items():
        row = results[name][key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mixing_matvec.cu",
            "replaces": f"{src}:{line}",
            "launches": counts[name],
            # the DAGM paths' launches, and the train path's (the bilevel
            # LM round on LocalRing(4): rows 3 / 3f)
            "launches_by_path": {"dagm": counts[name],
                                 "train": train_out["counts"].get(name, 0)},
            "max_abs_err": max(r["err"] for k, r in results[name].items()
                               if k[2] != "bfloat16"),
            "ms": row["ms"], "device_ms": row["dev"],
            "plain_ms": row["plain"],
            "bound_ms": row["bound"], "bound_by": row["by"],
            "library_ms": row["lib"],
            "shape": [key[0], key[1]], "dtype": "float32",
            "comm": key[2] if key[2] in COMMS else "identity",
            "on_main_path": name not in off_path,
            **({"bn": row["bn"]} if "bn" in row else {}),
            **({"slab_cols": row["slab_cols"], "routes": row["routes"]}
               if "routes" in row else {}),
            **({key: row[key] for key in ("walk", "stages", "stripe_cols")
                if key in row})})
    # the job axis of rows 5, 1f, 2f, 3f, 4f and 5f: every route measured
    # here — the ones the serve and admission phases' buckets launched,
    # each from its captured launch, and rows 2f and 4f (both routes)
    # from the kernel phase's checks at n = 128 — each row at its widest
    # operand, timed beside the B solo launches
    from repro_torch.kernels.mixing_matvec import JOB_COUNTERS
    job_rows = {"circulant_neumann_step": 852, "circulant_mix_matvec_comm":
                232, "sparse_mix_matvec_comm": 551,
                "circulant_neumann_step_comm": 826,
                "circulant_mix_matvec_halo_comm": 439,
                "sparse_mix_matvec_halo_comm": 739,
                "sparse_mix_matvec_halo_comm_rows": 739}
    for name in JOB_COUNTERS:
        if counts.get(name) and name not in results:
            raise AssertionError(f"{name}: launched on the path, never "
                                 f"checked")
        if name not in results:
            continue
        base = name.removesuffix("_jobs").removesuffix("_unstaged")
        key = max(results[name], key=lambda k: k[1])
        row = results[name][key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mixing_matvec.cu",
            "replaces": f"{src}:{job_rows[base]}",
            "launches": counts.get(name, 0),
            "max_abs_err": max(r["err"] for r in results[name].values()),
            "ms": row["ms"], "device_ms": row["dev"],
            "plain_ms": row["plain"],
            "bound_ms": row["bound"], "bound_by": row["by"],
            "library_ms": row["lib"], "solo_launches_ms": row["solo_ms"],
            "shape": [key[0], key[1]], "jobs": key[3], "dtype": "float32",
            "comm": key[2], "job_axis": True,
            "on_main_path": bool(counts.get(name))})
    # rows 7-8: not on DAGM's main path.  Each is on the LM serving path
    # (the lm phase's prefills: flash attention 36 launches in qwen3-4b,
    # the WKV scan with its state 32 in rwkv6-7b) and on the kernels.ops
    # path; `launches` is the lm path's count (the ops path's where the
    # lm path does not launch it), `launches_by_path` both.  The times and
    # error come from the check at qwen3-4b's train_4k (attention, bf16)
    # and rwkv6-7b's (the output-only scan) as before, the state launch's
    # from its check at rwkv6-7b's prefill, and `lm_case` is the kernel
    # at the shape the lm path gives it
    rows_all = {**ops_out["rows"], **lm_out["rows"]}
    for name, case, lm_case in (
            ("flash_attention", "qwen3-4b train_4k bf16",
             "qwen3-4b prefill_2k bf16"),
            ("rwkv6_scan", WKV_CASE[0], None),
            ("rwkv6_scan_state", "rwkv6-7b prefill_1k f32", None)):
        row = rows_all[(name, case)]
        by_path = {"kernels.ops": ops_out["counts"].get(name, 0),
                   "lm": lm_out["counts"].get(name, 0)}
        src_line = ("src/repro/kernels/flash_attention.py:71"
                    if name == "flash_attention"
                    else "src/repro/kernels/rwkv6_scan.py:51")
        entry = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/"
                      f"{name.removesuffix('_state')}.cu",
            "replaces": src_line,
            "launches": by_path["lm"] or by_path["kernels.ops"],
            "launches_by_path": by_path,
            "max_abs_err": row["err"],
            "ms": row["ms"], "device_ms": row["dev"],
            "device_ms_method": row["dev_how"],
            "plain_ms": row["plain"],
            "bound_ms": row["bound"], "bound_by": row["by"],
            "library_ms": row["lib"],
            "shape": row["shape"], "dtype": row["dtype"],
            "case": case, "on_main_path": bool(by_path["lm"])}
        if lm_case is not None:
            lm_row = rows_all[(name, lm_case)]
            entry["lm_case"] = {
                "case": lm_case, "shape": lm_row["shape"],
                "dtype": lm_row["dtype"], "max_abs_err": lm_row["err"],
                "ms": lm_row["ms"], "device_ms": lm_row["dev"],
                "plain_ms": lm_row["plain"], "bound_ms": lm_row["bound"],
                "bound_by": lm_row["by"], "library_ms": lm_row["lib"]}
        kernels.append(entry)
    for name in ("flash_attention", "rwkv6_scan_state"):
        if not lm_out["counts"].get(name):
            raise AssertionError(f"{name}: not launched on the lm path")
    for name in ("sparse_mix_matvec", "sparse_mix_matvec_comm"):
        if not train_out["counts"].get(name):
            raise AssertionError(f"{name}: not launched on the train path")
    print(f"chip_smoke: {time.perf_counter() - started:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
