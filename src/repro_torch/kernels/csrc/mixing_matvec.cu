// Gossip mat-vecs on stacked per-agent state Y (n agents x d features),
// the only cross-agent operations of DAGM (Algorithm 2):
//
//   circulant_mix      W.Y or (I-W).Y for shift-invariant W (ring, circulant)
//   sparse_mix         W.Y or (I-W).Y for any W from padded (n, k) tables
//   circulant_neumann  one DIHGP Neumann iteration (Eq. 14) fused with W.h
//                      (circulant_neumann_ring: the same on the circulant
//                      halo's cp.async ring)
//
// and their comm-fused twins, which gossip an int8/int4 stochastically
// quantized payload instead of Y (compressed gossip, comm="int8|int4[+ef]"):
//
//   circulant_mix_comm, sparse_mix_comm   (+ EF: also write the payload)
//   circulant_neumann_comm                (no EF; on the decoded stripe
//                                          where the planner gives one)
//
// circulant_neumann(_ring), circulant_mix_comm, sparse_mix_comm and
// circulant_neumann_comm have *_jobs twins for a serve bucket's job axis
// (JobAxis below: per-job beta, D~, wire metadata and seed).
//
// Plain C entry points (bottom of the file), loaded with ctypes by
// repro_torch/kernels/mixing_matvec.py.  Each launches on the caller's
// stream, allocates nothing, and returns cudaGetLastError().
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridRows = 65535;

// Circulant row of W: W[i, i] = w_self, W[i, (i + off[t]) mod n] = w[t]
// for t < k, with off/w device tables of any length k and every offset
// in [0, n).  All threads of a warp read the same entry at once (one
// broadcast load through the read-only cache), so the tables cost
// nothing next to the k neighbor rows.
struct Circ {
  float w_self;
  int k;
  const int* off;
  const float* w;
};

__device__ __forceinline__ float load_f32(const float* p, size_t i) {
  return p[i];
}
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f32(float* p, size_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, size_t i,
                                          float v) {
  p[i] = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

// One term of a mix, acc + w * v with the product and the sum each
// rounded on its own, as the plain versions' separate torch operations
// (no FMA contraction): a kernel's output is bitwise its plain version's,
// and every kernel with the same order agrees with the others bit for bit.
__device__ __forceinline__ float term(float acc, float w, float v) {
  return __fadd_rn(acc, __fmul_rn(w, v));
}

// Eq. 14, (D*h - (h - mix) - beta*hvp - p) / D, in the plain version's
// order of operations, each rounded on its own (IEEE division).
__device__ __forceinline__ float neumann_update(float h, float mix,
                                                float hvp, float p, float d,
                                                float beta) {
  const float num = __fsub_rn(
      __fsub_rn(__fsub_rn(__fmul_rn(d, h), __fsub_rn(h, mix)),
                __fmul_rn(beta, hvp)),
      p);
  return __fdiv_rn(num, d);
}

// The job axis of a serve bucket's launch.  A bucket of `jobs` jobs
// gossips its (n, jobs * djob) view: column c belongs to job c / djob,
// at in-job column c % djob.  Per job: beta (a device table, or the
// launch's scalar beta when betas is nullptr), the Neumann step's D~
// (an (n, jobs) table, row-major) and the quantizer's zp/scale ((n,
// jobs) tables) and seed (smix[job] = seed * 0xC2B2AE3D, the hash's
// seed mix).  A solo launch is jobs = 1, djob = d, and computes what it
// computed before the axis existed, bit for bit.  Kernels take it as a
// __grid_constant__ parameter, so a job's entry is read from the
// parameter bank, never copied.
constexpr int kMaxJobs = 64;
// a compile-time flag for a generic lambda's two instantiations
template <bool B>
struct Flag {
  static constexpr bool value = B;
};
struct JobAxis {
  int jobs;
  int djob;
  const float* betas;
  uint32_t smix[kMaxJobs];
  // the job of column j (j < jobs * djob)
  __device__ __forceinline__ int job(int j) const {
    return jobs == 1 ? 0 : j / djob;
  }
  __device__ __forceinline__ float beta(int job, float scalar) const {
    return betas ? __ldg(betas + job) : scalar;
  }
};

// Replaces repro/kernels/mixing_matvec.py:circulant_mix_matvec (plain
// path, _mix_body) where the ring at bn = n does not serve
// (circulant_mix_halo_kernel below; circulant_ring_stages in
// mixing_matvec.py): no (h_lo + n + h_hi)-row tile fits, or the operand
// is as narrow as the rule there says.
// Bound: bytes.  Each output element needs its own input plus k neighbor
// rows and 2(k+1) FLOP, so per byte moved (one read of Y, one write of
// out) the work is < 1 FLOP/B, far below the H100's ~20 FLOP/B f32 ridge.
// Design: one thread per output element (i, j), threads along the
// feature axis j, so every neighbor-row read of a warp is one coalesced
// segment; the k re-reads of a row by other agents' blocks hit L2.
// f32 accumulation in repro's order: w_self*y_i, then + c_t*y_{(i+o_t)%n}
// in offset order (`term`, no FMA), then y_i - acc for the Laplacian, so
// the output is bitwise the plain version's and the row-tiled halo
// twin's.  The ragged edge j >= d is masked, so any d works.
template <typename T>
__global__ void circulant_mix_kernel(const T* __restrict__ y,
                                     T* __restrict__ out, int n, int d,
                                     Circ c, int laplacian) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= d) return;
  for (int i = blockIdx.y; i < n; i += gridDim.y) {
    const size_t at = (size_t)i * d + j;
    const float yi = load_f32(y, at);
    float acc = __fmul_rn(c.w_self, yi);
    for (int t = 0; t < c.k; ++t) {
      int src = i + __ldg(c.off + t);
      if (src >= n) src -= n;
      acc = term(acc, __ldg(c.w + t), load_f32(y, (size_t)src * d + j));
    }
    if (laplacian) acc = __fsub_rn(yi, acc);
    store_f32(out, at, acc);
  }
}

// Replaces repro/kernels/mixing_matvec.py:sparse_mix_matvec (plain path,
// _sparse_body) where no column stripe fits in shared memory
// (sparse_mix_stripe_kernel below): n > 14,528 rows.
// Bound: bytes, as circulant_mix (2(k+1) FLOP per element; the (n, k)
// tables are small next to Y).
// Design: the same thread layout.  A block works on one row i, so all
// its threads read the same k indices and weights (one broadcast each)
// and then k coalesced neighbor-row segments from device memory (k reads
// of Y, from L2 where Y fits there).  Padded slots point at row i with
// weight 0 and add 0, as in repro's padded reference.
template <typename T>
__global__ void sparse_mix_unstaged_kernel(const T* __restrict__ y,
                                           T* __restrict__ out,
                                           const float* __restrict__ w_self,
                                           const int* __restrict__ nbr,
                                           const float* __restrict__ wts,
                                           int n, int d, int k,
                                           int laplacian) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= d) return;
  for (int i = blockIdx.y; i < n; i += gridDim.y) {
    const size_t at = (size_t)i * d + j;
    const float yi = load_f32(y, at);
    float acc = __fmul_rn(w_self[i], yi);
    const int* ni = nbr + (size_t)i * k;
    const float* wi = wts + (size_t)i * k;
    for (int t = 0; t < k; ++t) {
      acc = term(acc, wi[t], load_f32(y, (size_t)ni[t] * d + j));
    }
    if (laplacian) acc = __fsub_rn(yi, acc);
    store_f32(out, at, acc);
  }
}

// Replaces repro/kernels/mixing_matvec.py:circulant_neumann_step (plain
// path, _neumann_body) where the planner gives no ring tile
// (circulant_neumann_ring_kernel below; neumann_ring_plan in
// mixing_matvec.py).
// Bound: bytes: reads h, hvp_h and p once and writes h+, with
// 2(k+1) + 6 FLOP per element.
// Design: circulant_mix's layout; the mix stays in a register and the
// Eq. 14 update (D*h - (h - mix) - beta*hvp - p) / D is applied in the
// same thread (`neumann_update`), dividing as repro does.  beta is a
// runtime scalar, or on a bucket's job axis (JobAxis) a table read once
// per thread with D~'s column of the thread's job.
template <typename T>
__global__ void circulant_neumann_kernel(const T* __restrict__ h,
                                         const T* __restrict__ hvp,
                                         const T* __restrict__ p,
                                         const float* __restrict__ dsc,
                                         T* __restrict__ out, int n, int d,
                                         Circ c, float beta,
                                         const __grid_constant__ JobAxis ja) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= d) return;
  const int job = ja.job(j);
  const float bj = ja.beta(job, beta);
  for (int i = blockIdx.y; i < n; i += gridDim.y) {
    const size_t at = (size_t)i * d + j;
    const float hi = load_f32(h, at);
    float mix = __fmul_rn(c.w_self, hi);
    for (int t = 0; t < c.k; ++t) {
      int src = i + __ldg(c.off + t);
      if (src >= n) src -= n;
      mix = term(mix, __ldg(c.w + t), load_f32(h, (size_t)src * d + j));
    }
    const float di = dsc[(size_t)i * ja.jobs + job];
    store_f32(out, at, neumann_update(hi, mix, load_f32(hvp, at),
                                      load_f32(p, at), di, bj));
  }
}

// ---------------------------------------------------------------------------
// Comm-fused kernels: the int8/int4 stochastic quantizer inside the mix
// ---------------------------------------------------------------------------
//
// Wire protocol (repro/comm): agent r broadcasts its row once, quantized
// with its own per-row metadata (zp[r], scale[r], from row_quant_params):
//   q = clip(floor((x - zp)/scale + u), 0, levels),  decode = zp + scale*q,
// with x = y[r, j], or x = y[r, j] - hat[r, j] and decode + hat[r, j] under
// error feedback (EF).  The uniform u is a pure function of (seed, r, j)
// (murmur3 counter hash, repro/kernels/mixing_matvec.py:_hash_uniform), so a
// thread can recompute any neighbor's decoded value from that neighbor's
// inputs: the payload is never materialized, and every consumer of row r
// sees the same decoded values.  The quantizer uses the _rn intrinsics (no
// FMA contraction) and IEEE division, so payloads are bitwise equal to the
// plain PyTorch versions' (repro_torch/kernels/ref.py); the mixes
// accumulate with `term`, in the plain kernels' order.

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// U[0, 1) keyed on (seed, global row, global column); smix is
// seed * 0xC2B2AE3D.  24 bits per draw, exact in f32.
__device__ __forceinline__ float hash_uniform(uint32_t smix, int row,
                                              int col) {
  const uint32_t base = (uint32_t)row * 0x9E3779B9u + (uint32_t)col;
  const uint32_t h = fmix32(fmix32(base ^ smix));
  return __fmul_rn((float)(h >> 8), 5.9604644775390625e-8f);  // 2^-24
}

// One wire: the per-row metadata, the EF replica (nullptr without EF),
// the seed and the number of levels (2^bits - 1).
struct Wire {
  const float* zp;
  const float* scale;
  const float* hat;
  uint32_t smix;
  float levels;
};

// The quantizer's round trip of one value x of a row with metadata
// (zp, sc), given its uniform u: zp + sc * clip(floor((x - zp)/sc + u),
// 0, levels).
__device__ __forceinline__ float roundtrip(float x, float zp, float sc,
                                           float u, float levels) {
  const float z = __fadd_rn(__fdiv_rn(__fsub_rn(x, zp), sc), u);
  // clip to [0, levels] keeping NaN, as torch.clamp and jnp.clip do
  // (fminf/fmaxf would turn a NaN code into 0)
  float q = floorf(z);
  q = q < 0.0f ? 0.0f : (q > levels ? levels : q);
  return __fadd_rn(zp, __fmul_rn(sc, q));
}

// The decoded broadcast of element (r, j) of y (n x d, f32).  On a
// bucket's job axis the draw is keyed on (the job's seed, row r, in-job
// column) and the metadata are the job's, so every element decodes to
// what the job's solo send decodes it to.
__device__ __forceinline__ float decoded(const float* __restrict__ y,
                                         const Wire& w, const JobAxis& ja,
                                         int r, int j, int d) {
  const int job = ja.job(j);
  const size_t at = (size_t)r * d + j;
  const size_t m = (size_t)r * ja.jobs + job;
  const float u = hash_uniform(ja.smix[job], r, j - job * ja.djob);
  const float h = w.hat ? w.hat[at] : 0.0f;
  const float x = w.hat ? __fsub_rn(y[at], h) : y[at];
  const float dec = roundtrip(x, w.zp[m], w.scale[m], u, w.levels);
  return w.hat ? __fadd_rn(h, dec) : dec;
}

// Replaces repro/kernels/mixing_matvec.py:circulant_mix_matvec with comm=
// (_mix_fused_body) where no column stripe fits
// (circulant_mix_stripe_comm_kernel below): n > 14,528 rows.
// Bound: bytes, by about 2x.  The work is one read of y (and hat), one
// write of out (and, with EF, the payload), plus per payload element one
// hash (two murmur3 finalizers and the row/column/seed mix, ~20 integer
// ops) and ~10 f32 ops (divide, floor, clamp, decode): against 8-16 bytes
// per element, the int32 lanes need about half the HBM time.
// Design: circulant_mix_kernel's layout, one thread per output element.
// Each thread recomputes its k neighbors' decoded values (k hashes) rather
// than reading a materialized payload: recomputing costs integer work
// that overlaps the loads, a materialized payload would cost a second
// pass over HBM.  With EF the thread also writes its own row's payload.
// On a bucket's job axis each element decodes with its job's seed and
// metadata (`decoded`), as the job's solo send does.
__global__ void circulant_mix_comm_unstaged_kernel(
    const float* __restrict__ y, float* __restrict__ out,
    float* __restrict__ pay, int n, int d, Circ c, Wire w, int laplacian,
    const __grid_constant__ JobAxis ja) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= d) return;
  for (int i = blockIdx.y; i < n; i += gridDim.y) {
    const size_t at = (size_t)i * d + j;
    const float yi = y[at];
    float acc = __fmul_rn(c.w_self, yi);
    for (int t = 0; t < c.k; ++t) {
      int src = i + __ldg(c.off + t);
      if (src >= n) src -= n;
      acc = term(acc, __ldg(c.w + t), decoded(y, w, ja, src, j, d));
    }
    if (laplacian) acc = __fsub_rn(yi, acc);
    out[at] = acc;
    if (pay) pay[at] = decoded(y, w, ja, i, j, d);
  }
}

// Replaces repro/kernels/mixing_matvec.py:sparse_mix_matvec with comm=
// (_sparse_fused_body) where no column stripe fits
// (sparse_mix_stripe_comm_kernel below): n > 14,528 rows.
// Bound: as circulant_mix_comm_unstaged_kernel.  Each gathered row is
// decoded with its own source row's zp/scale, as the wire carries it.
// Design: sparse_mix_unstaged_kernel's layout; as in the circulant kernel
// each thread recomputes its k neighbors' decoded values, so the kernel
// does k hashes per element where the work needs one: at ER's k = 13
// that integer work, not the bytes, sets its time.
__global__ void sparse_mix_comm_unstaged_kernel(
    const float* __restrict__ y, float* __restrict__ out,
    float* __restrict__ pay, const float* __restrict__ w_self,
    const int* __restrict__ nbr, const float* __restrict__ wts, int n, int d,
    int k, Wire w, int laplacian, const __grid_constant__ JobAxis ja) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= d) return;
  for (int i = blockIdx.y; i < n; i += gridDim.y) {
    const size_t at = (size_t)i * d + j;
    const float yi = y[at];
    float acc = __fmul_rn(w_self[i], yi);
    const int* ni = nbr + (size_t)i * k;
    const float* wi = wts + (size_t)i * k;
    for (int t = 0; t < k; ++t) {
      acc = term(acc, wi[t], decoded(y, w, ja, ni[t], j, d));
    }
    if (laplacian) acc = __fsub_rn(yi, acc);
    out[at] = acc;
    if (pay) pay[at] = decoded(y, w, ja, i, j, d);
  }
}

// Replaces repro/kernels/mixing_matvec.py:circulant_neumann_step with comm=
// (_neumann_fused_body; no EF, as repro).
// Bound: bytes (reads h, hvp_h and p, writes h+) with the quantizer's
// ~30 operations per element on top of the plain step's.
// Design: circulant_neumann_kernel with the neighbor terms of W.h decoded
// from the quantized wire; the self, D, HVP and p terms stay exact.
__global__ void circulant_neumann_comm_kernel(
    const float* __restrict__ h, const float* __restrict__ hvp,
    const float* __restrict__ p, const float* __restrict__ dsc,
    float* __restrict__ out, int n, int d, Circ c, Wire w, float beta,
    const __grid_constant__ JobAxis ja) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= d) return;
  const int job = ja.job(j);
  const float bj = ja.beta(job, beta);
  for (int i = blockIdx.y; i < n; i += gridDim.y) {
    const size_t at = (size_t)i * d + j;
    const float hi = h[at];
    float mix = __fmul_rn(c.w_self, hi);
    for (int t = 0; t < c.k; ++t) {
      int src = i + __ldg(c.off + t);
      if (src >= n) src -= n;
      mix = term(mix, __ldg(c.w + t), decoded(h, w, ja, src, j, d));
    }
    const float di = dsc[(size_t)i * ja.jobs + job];
    out[at] = neumann_update(hi, mix, hvp[at], p[at], di, bj);
  }
}

// ---------------------------------------------------------------------------
// Row-tiled halo kernels
// ---------------------------------------------------------------------------
//
// The kernels above give one block a row i and 256 columns, and read each
// neighbor row straight from device memory.  Their halo twins tile the
// agent axis too: grid (n/bn, ceil(d/kHaloBd)), block (bi, bj) owns the
// output rows [bi*bn, (bi+1)*bn) and the columns [bj*128, bj*128 + 128).
// The circulant twin stages the extended tile, rows [row0 - h_lo,
// row0 + bn + h_hi) mod n, in dynamic shared memory (the counterpart of
// repro's three _ext_copy DMAs) and reads every neighbor from there at
// row h_lo + r + s for the signed offset s; the sparse twin stages its own
// (bn, 128) rows (repro's `own` DMA) and gathers the neighbor rows from
// device memory.  The wrapper (repro_torch/kernels/mixing_matvec.py) picks
// bn with bn | n and h_lo, h_hi <= bn, so a staged row wraps at most once,
// and passes the dynamic shared memory it sized with the same function
// the tile planner uses; the entry points below recompute it and refuse
// a launch whose size disagrees.  Accumulation is in the full-operand
// kernels' order through the same `term`, so for any bn the plain
// outputs, the fused payloads and the fused outputs are bitwise equal to
// the full-operand kernels' (and to the plain versions').  Columns past d are masked; a column-tile
// loop covers d beyond 65535 * 128.

constexpr int kHaloBd = 128;
constexpr int kHaloThreads = 256;
constexpr int kSmemOptIn = 232448;  // dynamic shared memory a block may use

__device__ __forceinline__ int wrap_row(int r, int n) {
  return r < 0 ? r + n : (r >= n ? r - n : r);
}

// Vector helpers of the redesigned halo kernels.  A row piece of N values
// of T (4, 8 or 16 bytes) moves as one access; values are widened to f32
// exactly (a bf16 is the high half of its f32) and narrowed with
// store_f32's rounding (round to nearest even).
template <int V>
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           bool in) {
  if constexpr (V == 16) {
    cp_async16(dst, src, in);
  } else if constexpr (V == 8) {
    cp_async8(dst, src, in);
  } else if constexpr (V == 4) {
    cp_async4(dst, src, in);
  } else {  // 2 bytes, a bf16 row with an odd stride: no cp.async this size
    *static_cast<unsigned short*>(dst) =
        in ? *static_cast<const unsigned short*>(src) : (unsigned short)0;
  }
}

// N values of T at p (shared memory, aligned to their N * sizeof(T)
// bytes), widened to f32.
template <typename T, int N>
__device__ __forceinline__ void lds_vec(const T* p, float* v) {
  constexpr int B = N * (int)sizeof(T);
  static_assert(B == 4 || B == 8 || B == 16, "one 4-, 8- or 16-byte load");
  uint32_t w[B / 4];
  if constexpr (B == 16) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    w[0] = x.x, w[1] = x.y, w[2] = x.z, w[3] = x.w;
  } else if constexpr (B == 8) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    w[0] = x.x, w[1] = x.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < B / 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      v[i] = __uint_as_float(w[i]);
    } else {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
}

// N values (narrowed to T) stored at dst in pieces of V bytes; a piece
// whose first column is at or past `valid` is not stored (the ragged
// edge: every piece lies wholly inside or outside the row when V divides
// the row's bytes).
template <typename T, int N, int V>
__device__ __forceinline__ void stg_vec(T* dst, const float* o, int valid) {
  constexpr int B = N * (int)sizeof(T), E = V / (int)sizeof(T);
  static_assert(V <= B && B % V == 0 && E >= 1, "pieces of the vector");
  uint32_t w[B / 4];
#pragma unroll
  for (int i = 0; i < B / 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      w[i] = __float_as_uint(o[i]);
    } else {
      w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16(o[2 * i])) |
             (uint32_t)__bfloat16_as_ushort(__float2bfloat16(o[2 * i + 1]))
                 << 16;
    }
  }
  char* at = reinterpret_cast<char*>(dst);
#pragma unroll
  for (int p = 0; p < B / V; ++p) {
    if (p * E >= valid) break;
    if constexpr (V == 16) {
      *reinterpret_cast<uint4*>(at + 16 * p) =
          make_uint4(w[4 * p], w[4 * p + 1], w[4 * p + 2], w[4 * p + 3]);
    } else if constexpr (V == 8) {
      *reinterpret_cast<uint2*>(at + 8 * p) =
          make_uint2(w[2 * p], w[2 * p + 1]);
    } else if constexpr (V == 4) {
      *reinterpret_cast<uint32_t*>(at + 4 * p) = w[p];
    } else {
      *reinterpret_cast<unsigned short*>(at + 2 * p) =
          (unsigned short)(w[p / 2] >> (16 * (p % 2)));
    }
  }
}

// The widest access of at most `max` bytes (16, 8, 4 or 2) that every row
// of a (rows, d) operand of `itemsize`-byte values at `a` (and `b`)
// starts on.
int vec_bytes(const void* a, const void* b, int d, int itemsize, int max) {
  const uintptr_t bits =
      (uintptr_t)a | (uintptr_t)b | (uintptr_t)((size_t)d * itemsize);
  int v = max;
  while (v > itemsize && bits % v) v /= 2;
  return v;
}

// Wait until at most `pending` of this thread's commit groups (0, 1 or 2)
// are in flight.
__device__ __forceinline__ void cp_async_wait_upto(int pending) {
  if (pending <= 0) {
    cp_async_wait<0>();
  } else if (pending == 1) {
    cp_async_wait<1>();
  } else {
    cp_async_wait<2>();
  }
}

constexpr int kHaloStages = 3;  // the ring's stages at the planner's bn

// `nrows` rows of y from `src_row` on, columns [col0, col0 + kHaloBd),
// into consecutive kHaloBd-wide rows of shared memory, V bytes per copy;
// columns past d are zero-filled.
template <typename T, int V, int NT = kHaloThreads>
__device__ __forceinline__ void halo_copy_rows(T* dst,
                                               const T* __restrict__ y,
                                               int src_row, int nrows, int d,
                                               int col0) {
  constexpr int E = V / (int)sizeof(T);  // values per copy
  constexpr int CPR = kHaloBd / E;       // copies per staged row
  for (int e = threadIdx.x; e < nrows * CPR; e += NT) {
    const int r = e / CPR, c = (e % CPR) * E, j = col0 + c;
    const bool in = j < d;
    copy_async<V>(dst + (size_t)r * kHaloBd + c,
                  y + (size_t)(src_row + r) * d + (in ? j : 0), in);
  }
}

// The circulant ring: a walk of `stages` (h_lo + bn + h_hi + E::kTiles*bn,
// 128) tiles in shared memory, shared by the plain circulant mix (at the
// planner's bn on the halo tier and at bn = n on the full one) and the
// DIHGP Neumann step.  Block (bi, by) owns the rows [bi*bn, bi*bn + bn)
// and walks the column tiles by, by + gridDim.y, ...; the launch sizes
// gridDim.y so that the blocks just fill the card.  While tile t is
// mixed, tiles t+1 .. t+stages-1 are in flight as cp.async copies of V
// bytes (16 where d, the pointers and the tile allow, else 8, 4, or
// 2-byte loads for a bf16 row of odd d); the low halo, the body and the
// high halo are three copies of contiguous rows, as repro's three
// _ext_copy DMAs (each wraps mod n as a whole: h_lo, h_hi <= bn and
// bn | n), and the epilogue E stages its own (bn, 128) operand tiles
// (E::kTiles of them) behind them on the same stage.  A thread mixes a
// 16-byte vector of the tile (4 f32 or 8 bf16 columns) for R rows at a
// time, so each offset and weight is read once per R * VW outputs;
// accumulation is `term` in offset order, w_self*y_i first.  E::finish
// turns each row's accumulator into its output, which leaves in V-byte
// stores, masked past d.
template <typename T, int V, typename E>
__device__ __forceinline__ void circulant_ring_body(
    const T* __restrict__ y, T* __restrict__ out, int n, int d, int bn,
    int h_lo, int h_hi, float w_self, int k, const int* __restrict__ soff,
    const float* __restrict__ wts, int stages, const E& epi) {
  constexpr int VW = 16 / (int)sizeof(T);   // columns a thread mixes
  constexpr int TPR = kHaloBd / VW;         // threads per tile row
  constexpr int RP = kHaloThreads / TPR;    // rows mixed side by side
  constexpr int R = 4;                      // rows per thread and pass
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int ext = h_lo + bn + h_hi;         // the extended tile's rows
  const size_t tile = (size_t)(ext + E::kTiles * bn) * kHaloBd;
  const int row0 = blockIdx.x * bn;
  const int ncol = (d + kHaloBd - 1) / kHaloBd;
  const int ntile = (int)blockIdx.y < ncol
                        ? (ncol - 1 - (int)blockIdx.y) / (int)gridDim.y + 1
                        : 0;
  const int lo_src = row0 >= h_lo ? row0 - h_lo : row0 - h_lo + n;
  const int hi_src = row0 + bn < n ? row0 + bn : row0 + bn - n;
  auto load = [&](int t) {  // tile t of this block, one commit group
    if (t < ntile) {
      T* st = ring + (size_t)(t % stages) * tile;
      const int col0 = ((int)blockIdx.y + t * (int)gridDim.y) * kHaloBd;
      halo_copy_rows<T, V>(st, y, lo_src, h_lo, d, col0);
      halo_copy_rows<T, V>(st + (size_t)h_lo * kHaloBd, y, row0, bn, d,
                           col0);
      halo_copy_rows<T, V>(st + (size_t)(h_lo + bn) * kHaloBd, y, hi_src,
                           h_hi, d, col0);
      epi.stage(st + (size_t)ext * kHaloBd, row0, bn, d, col0);
    }
    cp_async_commit();
  };
  for (int t = 0; t + 1 < stages; ++t) load(t);
  const int cg = threadIdx.x % TPR, rl = threadIdx.x / TPR;
  for (int t = 0; t < ntile; ++t) {
    __syncthreads();  // tile t - 1 (the stage refilled below) is mixed
    load(t + stages - 1);
    cp_async_wait_upto(stages - 1);  // this thread's copies of tile t landed
    __syncthreads();                 // and every thread's
    const T* st = ring + (size_t)(t % stages) * tile;
    const int col0 = ((int)blockIdx.y + t * (int)gridDim.y) * kHaloBd;
    const int c = cg * VW, j0 = col0 + c;
    if (j0 >= d) continue;
    for (int r0 = rl; r0 < bn; r0 += RP * R) {
      float acc[R][VW];
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const int r = r0 + rr * RP;
        if (r < bn) {
          lds_vec<T, VW>(st + (size_t)(h_lo + r) * kHaloBd + c, acc[rr]);
#pragma unroll
          for (int v = 0; v < VW; ++v) {
            acc[rr][v] = __fmul_rn(w_self, acc[rr][v]);
          }
        }
      }
      for (int q = 0; q < k; ++q) {
        const int s = __ldg(soff + q);
        const float wq = __ldg(wts + q);
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
          const int r = r0 + rr * RP;
          if (r < bn) {
            float x[VW];
            lds_vec<T, VW>(st + (size_t)(h_lo + r + s) * kHaloBd + c, x);
#pragma unroll
            for (int v = 0; v < VW; ++v) {
              acc[rr][v] = term(acc[rr][v], wq, x[v]);
            }
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const int r = r0 + rr * RP;
        if (r < bn) {
          epi.template finish<VW>(
              acc[rr], st + (size_t)(h_lo + r) * kHaloBd + c,
              st + (size_t)(ext + r) * kHaloBd + c, bn, row0 + r, j0, d);
          stg_vec<T, VW, V>(out + (size_t)(row0 + r) * d + j0, acc[rr],
                            d - j0);
        }
      }
    }
  }
}

// The plain mix's epilogue: y_i - acc for the Laplacian.
template <typename T, int V>
struct RingMix {
  static constexpr int kTiles = 0;
  int laplacian;
  __device__ __forceinline__ void stage(T*, int, int, int, int) const {}
  template <int VW>
  __device__ __forceinline__ void finish(float* acc, const T* self,
                                         const T*, int, int, int,
                                         int) const {
    if (laplacian) {
      float yi[VW];
      lds_vec<T, VW>(self, yi);
#pragma unroll
      for (int v = 0; v < VW; ++v) acc[v] = __fsub_rn(yi[v], acc[v]);
    }
  }
};

// The Neumann step's epilogue: hvp_h and p staged as two (bn, 128) tiles
// behind the extended tile of h, and D~[i] read once per row and tile (a
// broadcast: the threads of a tile row share it); the update is
// `neumann_update` on h_i from the stage.  On a bucket's job axis (ja,
// the kernel's parameter) each column takes its job's D~ and beta.
template <typename T, int V>
struct RingNeumann {
  static constexpr int kTiles = 2;
  const T* __restrict__ hvp;
  const T* __restrict__ p;
  const float* __restrict__ dsc;
  float beta;
  const JobAxis* ja;
  __device__ __forceinline__ void stage(T* dst, int row0, int bn, int d,
                                        int col0) const {
    halo_copy_rows<T, V>(dst, hvp, row0, bn, d, col0);
    halo_copy_rows<T, V>(dst + (size_t)bn * kHaloBd, p, row0, bn, d, col0);
  }
  template <int VW>
  __device__ __forceinline__ void finish(float* acc, const T* self,
                                         const T* extra, int bn, int row,
                                         int j0, int d) const {
    float hi[VW], hv[VW], pv[VW];
    lds_vec<T, VW>(self, hi);
    lds_vec<T, VW>(extra, hv);
    lds_vec<T, VW>(extra + (size_t)bn * kHaloBd, pv);
    if (ja->jobs == 1) {
      const float di = __ldg(dsc + row);
#pragma unroll
      for (int v = 0; v < VW; ++v) {
        acc[v] = neumann_update(hi[v], acc[v], hv[v], pv[v], di,
                                ja->beta(0, beta));
      }
      return;
    }
#pragma unroll
    for (int v = 0; v < VW; ++v) {
      // columns past d are computed and never stored: any job will do
      const int job = ja->job(j0 + v < d ? j0 + v : j0);
      const float di = __ldg(dsc + (size_t)row * ja->jobs + job);
      acc[v] = neumann_update(hi[v], acc[v], hv[v], pv[v], di,
                              ja->beta(job, beta));
    }
  }
};

// Replaces repro/kernels/mixing_matvec.py:circulant_mix_matvec_halo (plain
// path, _circ_halo_body), and, at bn = n, circulant_mix_matvec (plain
// path, _mix_body) wherever the (h_lo + n + h_hi)-row tile fits.
// Bound: bytes: one read of Y plus the halo rows (h_lo + h_hi of every
// bn, 2/128 on the ring at bn = 128) and one write; 1.54 ms at (4096,
// 157000) f32 at 3.35 TB/s.
// Design: circulant_ring_body with the plain epilogue (3 stages at the
// planner's bn).  Accumulation is `term` in offset order, w_self*y_i
// first and y_i - acc for the Laplacian: the output is bitwise
// circulant_mix_kernel's for every bn.
template <typename T, int V>
__global__ void __launch_bounds__(kHaloThreads)
    circulant_mix_halo_kernel(const T* __restrict__ y, T* __restrict__ out,
                              int n, int d, int bn, int h_lo, int h_hi,
                              float w_self, int k,
                              const int* __restrict__ soff,
                              const float* __restrict__ wts, int laplacian,
                              int stages) {
  circulant_ring_body<T, V>(y, out, n, d, bn, h_lo, h_hi, w_self, k, soff,
                            wts, stages, RingMix<T, V>{laplacian});
}

// Replaces repro/kernels/mixing_matvec.py:circulant_neumann_step (plain
// path, _neumann_body) wherever the planner gives a row tile
// (neumann_ring_plan in mixing_matvec.py).
// Bound: bytes: reads h (and its halo rows), hvp_h and p once and writes
// h+, 16 bytes per f32 element: 39.3 us at (4096, 2010), 3.07 ms at
// (4096, 157000), at 3.35 TB/s.
// Design: circulant_ring_body with the Neumann epilogue: each stage holds
// h's extended tile and the (bn, 128) tiles of hvp_h and p, all three
// in flight as cp.async copies while the tile before is mixed; the mix
// stays in registers and `neumann_update` runs on it in the plain
// version's order.  The output is bitwise circulant_neumann_kernel's for
// every bn.
template <typename T, int V>
__global__ void __launch_bounds__(kHaloThreads)
    circulant_neumann_ring_kernel(const T* __restrict__ h,
                                  const T* __restrict__ hvp,
                                  const T* __restrict__ p,
                                  const float* __restrict__ dsc,
                                  T* __restrict__ out, int n, int d, int bn,
                                  int h_lo, int h_hi, float w_self, int k,
                                  const int* __restrict__ soff,
                                  const float* __restrict__ wts, float beta,
                                  int stages,
                                  const __grid_constant__ JobAxis ja) {
  circulant_ring_body<T, V>(h, out, n, d, bn, h_lo, h_hi, w_self, k, soff,
                            wts, stages,
                            RingNeumann<T, V>{hvp, p, dsc, beta, &ja});
}

// Replaces repro/kernels/mixing_matvec.py:circulant_mix_matvec_halo with
// comm= (_circ_halo_body, fused; repro's `pscr`).
// Bound: bytes, as the full-operand fused kernels (one read of y, and hat
// under EF, one write of out, and the payload under EF): 1.54 ms at (4096,
// 157000) f32, 3.07 ms under EF, at 3.35 TB/s.  Besides, one hash per
// staged element (~20 integer operations; (h_lo + bn + h_hi) / bn = 1.03
// per output on the ring at bn = 64) and ~10 f32 operations, the divide,
// the floor and the int-to-float convert on the slower units: on the
// H100 this work takes about as long as the copies, and the ring
// overlaps the two.
// Design: circulant_mix_halo_kernel's ring.  Block (bi, by) owns the rows
// [bi*bn, bi*bn + bn) and walks the column tiles by, by + gridDim.y, ...
// (gridDim.y sized to fill the card); while tile t is quantized and mixed
// the raw y tiles (h_lo + bn + h_hi, 128) of tiles t+1 .. t+stages-1, and
// their hat tiles under EF, are in flight as cp.async copies of V bytes,
// the low halo, the body and the high halo three copies of contiguous
// rows.  (1) One pass quantizes the landed tile into one decoded tile
// buffer: a thread takes 4 columns of a staged row, reads the row's zp and
// scale once for them, and decodes each element once (hat +
// roundtrip(y - hat) under EF), `decoded`'s arithmetic, so the payloads
// agree bit for bit with the full-operand kernel's.  (2) The mix is the
// plain kernel's: a thread mixes a 16-byte vector (4 columns) for R = 2
// rows at a time (the block's 32 x 2 rows are the planner's bn = 64),
// each offset and weight read once per R * 4 outputs, the
// neighbors read from the decoded tile with 16-byte loads and the self
// term and the Laplacian's y_i from the raw stage (y is read from device
// memory once); accumulation is `term` in offset order, w_self*y_i first,
// so the output is bitwise the full-operand fused kernels'.  The output,
// and under EF the payload (the decoded body rows), leave in V-byte stores,
// masked past d.  Shared memory: `stages` raw tiles (twice that under EF)
// and the decoded tile, within repro's plan of 4 live buffers (6 under
// EF): 3 stages without EF and 2 with at the planner's bn
// (halo_comm_stages in mixing_matvec.py).
// On a bucket's job axis (ja) the decode pass takes each column's job:
// one division for a thread's 4 columns, then a step to the next job
// where the vector straddles one (djob need not be a multiple of 4), the
// job's zp/scale from the (n, jobs) tables, its seed mix and the in-job
// column for the hash, `decoded`'s arithmetic; the mix and the EF
// write-back cover the whole operand as they are.  jobs == 1 is the solo
// launch, on its own decode loop, the row's metadata read once for the
// 4 columns.
constexpr int kHaloCommEfStages = 2;
// 32 warps: the shared memory at the planner's bn leaves room for one
// block per SM, and the quantize pass, bound by instruction throughput and
// latency, needs every warp it can get (fewer threads measured slower on
// the H100).
constexpr int kHaloCommThreads = 1024;

template <int V>
__global__ void __launch_bounds__(kHaloCommThreads)
    circulant_mix_halo_comm_kernel(const float* __restrict__ y,
                                   float* __restrict__ out,
                                   float* __restrict__ pay, int n, int d,
                                   int bn, int h_lo, int h_hi, float w_self,
                                   int k, const int* __restrict__ soff,
                                   const float* __restrict__ wts, Wire w,
                                   int laplacian, int stages,
                                   const __grid_constant__ JobAxis ja) {
  constexpr int VW = 4;                       // columns a thread takes
  constexpr int TPR = kHaloBd / VW;           // threads per tile row
  constexpr int RP = kHaloCommThreads / TPR;  // rows side by side
  constexpr int R = RP < 64 ? 64 / RP : 1;    // rows per thread and pass
  extern __shared__ __align__(16) float smem_f[];
  const bool ef = w.hat != nullptr;
  const int ex = h_lo + bn + h_hi;
  const size_t tile = (size_t)ex * kHaloBd;
  float* ring_y = smem_f;                              // stages x tile
  float* ring_h = ring_y + (size_t)stages * tile;      // stages x tile (EF)
  float* dec = ring_h + (ef ? (size_t)stages * tile : 0);  // one tile
  const int row0 = blockIdx.x * bn;
  const int ncol = (d + kHaloBd - 1) / kHaloBd;
  const int ntile = (int)blockIdx.y < ncol
                        ? (ncol - 1 - (int)blockIdx.y) / (int)gridDim.y + 1
                        : 0;
  const int lo_src = row0 >= h_lo ? row0 - h_lo : row0 - h_lo + n;
  const int hi_src = row0 + bn < n ? row0 + bn : row0 + bn - n;
  auto copy_tile = [&](float* st, const float* __restrict__ src, int col0) {
    constexpr int NT = kHaloCommThreads;
    halo_copy_rows<float, V, NT>(st, src, lo_src, h_lo, d, col0);
    halo_copy_rows<float, V, NT>(st + (size_t)h_lo * kHaloBd, src, row0, bn,
                                 d, col0);
    halo_copy_rows<float, V, NT>(st + (size_t)(h_lo + bn) * kHaloBd, src,
                                 hi_src, h_hi, d, col0);
  };
  auto load = [&](int t) {  // tile t of this block, one commit group
    if (t < ntile) {
      const size_t at = (size_t)(t % stages) * tile;
      const int col0 = ((int)blockIdx.y + t * (int)gridDim.y) * kHaloBd;
      copy_tile(ring_y + at, y, col0);
      if (ef) copy_tile(ring_h + at, w.hat, col0);
    }
    cp_async_commit();
  };
  for (int t = 0; t + 1 < stages; ++t) load(t);
  const int cg = threadIdx.x % TPR, rl = threadIdx.x / TPR;
  const int c = cg * VW;
  for (int t = 0; t < ntile; ++t) {
    __syncthreads();  // tile t - 1 is mixed: its stage and `dec` are free
    load(t + stages - 1);
    cp_async_wait_upto(stages - 1);  // this thread's copies of tile t landed
    __syncthreads();                 // and every thread's
    const size_t at = (size_t)(t % stages) * tile;
    const float* sy = ring_y + at;
    const int col0 = ((int)blockIdx.y + t * (int)gridDim.y) * kHaloBd;
    const int j0 = col0 + c;
    // (1) the decoded tile, one hash per staged element (columns past d
    // are zero-filled and decoded too, never stored).  The solo pass and
    // the job axis's are two loops, so that the solo one keeps its
    // registers: the 1024-thread block allows 64 a thread.
    const auto decode_row = [&](int r, auto jobs) {
      const int g = wrap_row(row0 - h_lo + r, n);
      float x[VW], h[VW], q[VW];
      lds_vec<float, VW>(sy + (size_t)r * kHaloBd + c, x);
      if (ef) lds_vec<float, VW>(ring_h + at + (size_t)r * kHaloBd + c, h);
      if constexpr (!decltype(jobs)::value) {
        const float zp = __ldg(w.zp + g), sc = __ldg(w.scale + g);
#pragma unroll
        for (int v = 0; v < VW; ++v) {
          const float u = hash_uniform(ja.smix[0], g, j0 + v);
          const float dv = roundtrip(ef ? __fsub_rn(x[v], h[v]) : x[v], zp,
                                     sc, u, w.levels);
          q[v] = ef ? __fadd_rn(h[v], dv) : dv;
        }
      } else {
        // the first column's job by one division, then a step to the
        // next job where the vector straddles one (a column past d
        // takes the last column's job: decoded, never stored)
        int job = ja.job(j0 < d ? j0 : d - 1), base = job * ja.djob;
#pragma unroll
        for (int v = 0; v < VW; ++v) {
          const int jc = j0 + v < d ? j0 + v : d - 1;
          while (jc - base >= ja.djob) {
            ++job;
            base += ja.djob;
          }
          const size_t m = (size_t)g * ja.jobs + job;
          const float u = hash_uniform(ja.smix[job], g, j0 + v - base);
          const float dv = roundtrip(ef ? __fsub_rn(x[v], h[v]) : x[v],
                                     __ldg(w.zp + m), __ldg(w.scale + m), u,
                                     w.levels);
          q[v] = ef ? __fadd_rn(h[v], dv) : dv;
        }
      }
      *reinterpret_cast<float4*>(dec + (size_t)r * kHaloBd + c) =
          make_float4(q[0], q[1], q[2], q[3]);
    };
    if (ja.jobs == 1) {
      for (int r = rl; r < ex; r += RP) decode_row(r, Flag<false>{});
    } else {
      for (int r = rl; r < ex; r += RP) decode_row(r, Flag<true>{});
    }
    __syncthreads();  // the decoded tile is whole
    if (j0 >= d) continue;
    // (2) the mix
    for (int r0 = rl; r0 < bn; r0 += RP * R) {
      float yi[R][VW], acc[R][VW];
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const int r = r0 + rr * RP;
        if (r < bn) {
          lds_vec<float, VW>(sy + (size_t)(h_lo + r) * kHaloBd + c, yi[rr]);
#pragma unroll
          for (int v = 0; v < VW; ++v) {
            acc[rr][v] = __fmul_rn(w_self, yi[rr][v]);
          }
        }
      }
      for (int q = 0; q < k; ++q) {
        const int s = __ldg(soff + q);
        const float wq = __ldg(wts + q);
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
          const int r = r0 + rr * RP;
          if (r < bn) {
            float x[VW];
            lds_vec<float, VW>(dec + (size_t)(h_lo + r + s) * kHaloBd + c, x);
#pragma unroll
            for (int v = 0; v < VW; ++v) {
              acc[rr][v] = term(acc[rr][v], wq, x[v]);
            }
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const int r = r0 + rr * RP;
        if (r < bn) {
          if (laplacian) {
#pragma unroll
            for (int v = 0; v < VW; ++v) {
              acc[rr][v] = __fsub_rn(yi[rr][v], acc[rr][v]);
            }
          }
          const size_t o = (size_t)(row0 + r) * d + j0;
          stg_vec<float, VW, V>(out + o, acc[rr], d - j0);
          if (pay) {
            float p[VW];
            lds_vec<float, VW>(dec + (size_t)(h_lo + r) * kHaloBd + c, p);
            stg_vec<float, VW, V>(pay + o, p, d - j0);
          }
        }
      }
    }
  }
}

// Replaces repro/kernels/mixing_matvec.py:sparse_mix_matvec_halo (plain
// path, _sparse_halo_body).
// Bound: bytes, as sparse_mix_unstaged_kernel.
// Design: the block stages its own (bn, 128) rows in shared memory (all
// of them in flight at once), then each thread gathers its element's k
// neighbor rows from device memory in table order, a warp reading 32
// consecutive columns of one neighbor row; the padded tables' slots that
// point at the row itself add 0, as in sparse_mix_unstaged_kernel.
template <typename T>
__global__ void sparse_mix_halo_kernel(const T* __restrict__ y,
                                       T* __restrict__ out,
                                       const float* __restrict__ w_self,
                                       const int* __restrict__ nbr,
                                       const float* __restrict__ wts, int n,
                                       int d, int k, int bn, int laplacian) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* own = reinterpret_cast<T*>(smem_raw);
  const int row0 = blockIdx.x * bn;
  const int ncol = (d + kHaloBd - 1) / kHaloBd;
  for (int ct = blockIdx.y; ct < ncol; ct += gridDim.y) {
    const int col0 = ct * kHaloBd;
    for (int t = threadIdx.x; t < bn * kHaloBd; t += blockDim.x) {
      const int j = col0 + t % kHaloBd;
      if (j < d) own[t] = y[(size_t)(row0 + t / kHaloBd) * d + j];
    }
    __syncthreads();
    for (int t = threadIdx.x; t < bn * kHaloBd; t += blockDim.x) {
      const int i = row0 + t / kHaloBd, j = col0 + t % kHaloBd;
      if (j >= d) continue;
      const float yi = load_f32(own, t);
      float acc = __fmul_rn(w_self[i], yi);
      const int* ni = nbr + (size_t)i * k;
      const float* wi = wts + (size_t)i * k;
      for (int q = 0; q < k; ++q) {
        acc = term(acc, wi[q], load_f32(y, (size_t)ni[q] * d + j));
      }
      if (laplacian) acc = __fsub_rn(yi, acc);
      store_f32(out, (size_t)i * d + j, acc);
    }
    __syncthreads();
  }
}

// Replaces repro/kernels/mixing_matvec.py:sparse_mix_matvec_halo with
// comm= (_sparse_halo_body, fused; no EF, as repro), where no column slab
// fits (sparse_mix_slab_comm_kernel below): n > 33,536 in f32.
// Bound: as sparse_mix_comm_unstaged_kernel.
// Design: sparse_mix_halo_kernel with each neighbor's value decoded from
// (seed, row, column) as `decoded` does, k hashes per element as repro's
// per-neighbor _quantize.  On a bucket's job axis (ja) an element's job,
// in-job column and seed mix are found once, before its k neighbors,
// and each neighbor row's zp/scale are read at [row, job]; the solo
// launch (jobs == 1) keeps its own loop.
__global__ void sparse_mix_halo_comm_kernel(
    const float* __restrict__ y, float* __restrict__ out,
    const float* __restrict__ w_self, const int* __restrict__ nbr,
    const float* __restrict__ wts, int n, int d, int k, int bn, Wire w,
    int laplacian, const __grid_constant__ JobAxis ja) {
  extern __shared__ __align__(16) float own_f[];
  const int row0 = blockIdx.x * bn;
  const int ncol = (d + kHaloBd - 1) / kHaloBd;
  for (int ct = blockIdx.y; ct < ncol; ct += gridDim.y) {
    const int col0 = ct * kHaloBd;
    for (int t = threadIdx.x; t < bn * kHaloBd; t += blockDim.x) {
      const int j = col0 + t % kHaloBd;
      if (j < d) own_f[t] = y[(size_t)(row0 + t / kHaloBd) * d + j];
    }
    __syncthreads();
    for (int t = threadIdx.x; t < bn * kHaloBd; t += blockDim.x) {
      const int i = row0 + t / kHaloBd, j = col0 + t % kHaloBd;
      if (j >= d) continue;
      const float yi = own_f[t];
      float acc = __fmul_rn(w_self[i], yi);
      const int* ni = nbr + (size_t)i * k;
      const float* wi = wts + (size_t)i * k;
      if (ja.jobs == 1) {
        for (int q = 0; q < k; ++q) {
          const int r = ni[q];
          acc = term(acc, wi[q],
                     roundtrip(y[(size_t)r * d + j], w.zp[r], w.scale[r],
                               hash_uniform(ja.smix[0], r, j), w.levels));
        }
      } else {
        const int job = ja.job(j), jin = j - job * ja.djob;
        const uint32_t smix = ja.smix[job];
        for (int q = 0; q < k; ++q) {
          const int r = ni[q];
          const size_t m = (size_t)r * ja.jobs + job;
          acc = term(acc, wi[q],
                     roundtrip(y[(size_t)r * d + j], w.zp[m], w.scale[m],
                               hash_uniform(smix, r, jin), w.levels));
        }
      }
      if (laplacian) acc = __fsub_rn(yi, acc);
      out[(size_t)i * d + j] = acc;
    }
    __syncthreads();
  }
}

// Replaces repro/kernels/mixing_matvec.py:sparse_mix_matvec_halo with
// comm= (_sparse_halo_body, fused; no EF, as repro): the compressed gossip
// on Erdos-Renyi graphs at n = 4096.
// Bound: bytes, 1.54 ms at (4096, 157000) f32 (y read once, out written
// once, 3.35 TB/s).  What the work needs besides is one hash per element
// (~20 integer ops) and k neighbor terms per element, which gather the
// k decoded values: 23e9 gathers at k = 36, more than the bytes when each
// comes from device memory or L2.
// Design: a column slab resident in shared memory.  Block s owns the
// columns [s*C, s*C + C) of all n rows.  (1) It copies its (n, C) slab of
// y into shared memory with cp.async (16-byte chunks where d % 4 == 0),
// then decodes it in place, one hash per element: `roundtrip` is
// `decoded`'s quantizer, so every value is the payload the wire carries,
// NaN codes included.  (2) Each warp then takes 32 / LPR output rows, LPR
// lanes per row, each lane VW = min(C, 4) columns held in registers, and
// walks (pass of rows, chunk of kSlabKC neighbor slots) in order: the next
// chunk's indices and weights are copied into the warp's other stage
// buffer with cp.async while this chunk gathers every neighbor's C values
// from the slab, one 16-byte read per lane at C = 8 (the two halves of a
// row lie in neighboring banks, so a quarter-warp's eight reads conflict
// only where two random rows share a bank group), and the next pass's
// self-term y loads during its last chunk.  The self term is the exact y
// from device memory (L2, just read in (1)), and the output is written
// once.  Accumulation is `term` in table order, w_self*y_i, then the k
// neighbor terms, then y_i - acc for the Laplacian: the output is bitwise
// the full-operand kernel's and the plain version's.  So device memory is
// read and written once, one hash per element (the row-tiled kernel above
// did k), and nothing but the output is written.  The planner
// (plan_slab_cols in mixing_matvec.py) picks C, the largest of 8, 4, 2, 1
// whose slab fits beside the stage buffers: C = 8 (212,992 bytes, one
// 32-byte sector per row) at n = 4096.
constexpr int kSlabThreads = 512;
constexpr int kSlabWarps = kSlabThreads / 32;

// Output rows a warp takes per pass: 16 at C = 8 (two lanes per row),
// else 32; and the neighbor slots per stage buffer, 16 or 8.
__host__ __device__ constexpr int slab_rows_per_warp(int cols) {
  return cols == 8 ? 16 : 32;
}
__host__ __device__ constexpr int slab_slots(int cols) {
  return cols == 8 ? 16 : 8;
}
// The table stage: per warp two buffers of rows x (slots + 4) indices and
// as many weights (rows of whole 16-byte chunks, for 16-byte copies).
__host__ __device__ constexpr int slab_stage_bytes(int cols) {
  return kSlabWarps * 2 * slab_rows_per_warp(cols) * (slab_slots(cols) + 4) *
         8;
}

// The slab's floats, rounded up to whole 16-byte chunks: the table stage
// after it takes 16-byte cp.async copies, whatever n and C.
__host__ __device__ inline size_t slab_floats(int n, int cols) {
  return ((size_t)n * cols + 3) / 4 * 4;
}

// The same in bytes, for a slab row of `row_bytes` (either dtype).
__host__ __device__ inline size_t slab_bytes(int n, int row_bytes) {
  return ((size_t)n * row_bytes + 15) / 16 * 16;
}

// Shared memory of a slab launch: the (n, cols) slab of `itemsize`-byte
// values and the table stage of the f32 slab as wide in bytes (the plain
// slab's bf16 rows of 2*cols bytes take the f32 geometry of cols/2).
int slab_smem_bytes(int n, int cols, int itemsize = 4) {
  const long long b = (long long)slab_bytes(n, cols * itemsize) +
                      slab_stage_bytes(cols * itemsize / 4);
  return b > kSmemOptIn ? -1 : (int)b;
}

template <int C>
__global__ void __launch_bounds__(kSlabThreads)
    sparse_mix_slab_comm_kernel(const float* __restrict__ y,
                                float* __restrict__ out,
                                const float* __restrict__ w_self,
                                const int* __restrict__ nbr,
                                const float* __restrict__ wts, int n, int d,
                                int k, Wire w, int laplacian,
                                const __grid_constant__ JobAxis ja) {
  constexpr int VW = C < 4 ? C : 4;  // columns per lane
  constexpr int LPR = C / VW;        // lanes per row
  constexpr int RPW = slab_rows_per_warp(C);
  constexpr int KC = slab_slots(C), KS = KC + 4;
  constexpr int M = RPW * KC / 32;   // stage entries per lane and buffer
  constexpr int P4 = KC / 4;         // 16-byte pieces per staged row
  constexpr int M4 = RPW * P4 / 32;  // pieces per lane and buffer
  static_assert(RPW * LPR == 32 && M * 32 == RPW * KC && M4 * 32 == RPW * P4,
                "warp geometry");
  static_assert(kSlabThreads % C == 0, "a thread decodes one slab column");
  extern __shared__ __align__(16) float smem_f[];
  const int nslab = (d + C - 1) / C;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  float* slab = smem_f;  // (n, C)
  int* tab_s = reinterpret_cast<int*>(slab + slab_floats(n, C));
  int* nb_s = tab_s + warp * 2 * RPW * KS;         // 2 x (RPW, KS)
  float* wt_s = reinterpret_cast<float*>(tab_s + kSlabWarps * 2 * RPW * KS) +
                warp * 2 * RPW * KS;               // 2 x (RPW, KS)
  const int rsub = lane / LPR;             // this lane's row in the pass
  const int cl = (lane % LPR) * VW;        // its first column in the slab
  // 16-byte chunks of every row in device memory
  const bool vec = C >= 4 && d % 4 == 0 && ((size_t)y & 15) == 0;
  // the warp's walk: passes of RPW rows, kSlabWarps * RPW apart, each in
  // chunks of KC neighbor slots
  const int nch = k > 0 ? (k + KC - 1) / KC : 1;
  const int row_step = kSlabWarps * RPW;
  const int npass =
      n > warp * RPW ? (n - warp * RPW + row_step - 1) / row_step : 0;
  // this lane's stage entries: slot lane % KC of rows lane / KC + m * 32/KC,
  // or, in 16-byte pieces where k % 4 == 0 and the tables are aligned,
  // piece lane % P4 of rows lane / P4 + m * 32/P4
  const int sq = lane % KC, sr = lane / KC;
  const int sq4 = lane % P4, sr4 = lane / P4;
  const bool vec_tab = k % 4 == 0 && ((size_t)nbr & 15) == 0 &&
                       ((size_t)wts & 15) == 0;

  for (int s = blockIdx.x; s < nslab; s += gridDim.x) {
    const int c0 = s * C;
    // (1) stage the (n, C) slab of y, then decode it in place
    if (vec) {
      for (int e = tid; e < n * (C / 4); e += kSlabThreads) {
        const int r = e / (C / 4), j = c0 + (e % (C / 4)) * 4;
        cp_async16(slab + (size_t)e * 4,
                   y + (size_t)r * d + (j < d ? j : 0), j < d);
      }
    } else {
      for (int e = tid; e < n * C; e += kSlabThreads) {
        const int r = e / C, j = c0 + e % C;
        cp_async4(slab + e, y + (size_t)r * d + (j < d ? j : 0), j < d);
      }
    }
    cp_async_wait_all();
    __syncthreads();
    {
      // kSlabThreads is a multiple of C: a thread decodes one column of
      // the slab, so its job is found once per slab, per column (a slab
      // may straddle two jobs)
      const int j = c0 + tid % C;
      const int job = ja.job(j < d ? j : d - 1), jin = j - job * ja.djob;
      const uint32_t smix = ja.smix[job];
      if (j < d) {
#pragma unroll 4
        for (int e = tid; e < n * C; e += kSlabThreads) {
          const int r = e / C;
          const size_t m = (size_t)r * ja.jobs + job;
          slab[e] = roundtrip(slab[e], w.zp[m], w.scale[m],
                              hash_uniform(smix, r, jin), w.levels);
        }
      }
    }
    __syncthreads();

    // (2) the mix
    auto stage = [&](int p, int ch, int buf) {  // async copy of one chunk
      const int i0 = warp * RPW + p * row_step;
      int* nb = nb_s + buf * RPW * KS;
      float* wt = wt_s + buf * RPW * KS;
      if (vec_tab) {
        const int r0 = i0 + sr4, q = ch * KC + 4 * sq4;
        const size_t at = (size_t)r0 * k + q, step = (size_t)(32 / P4) * k;
#pragma unroll
        for (int m = 0; m < M4; ++m) {
          const bool in = r0 + m * (32 / P4) < n && q < k;
          const int e = (sr4 + m * (32 / P4)) * KS + 4 * sq4;
          cp_async16(nb + e, in ? nbr + at + m * step : nbr, in);
          cp_async16(wt + e, in ? wts + at + m * step : wts, in);
        }
      } else {
        const int r0 = i0 + sr, q = ch * KC + sq;
        const size_t at = (size_t)r0 * k + q, step = (size_t)(32 / KC) * k;
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const bool in = r0 + m * (32 / KC) < n && q < k;
          const int e = (sr + m * (32 / KC)) * KS + sq;
          cp_async4(nb + e, in ? nbr + at + m * step : nbr, in);
          cp_async4(wt + e, in ? wts + at + m * step : wts, in);
        }
      }
      cp_async_commit();
    };
    // whole 16-byte row pieces of y and out where d % 4 == 0
    const bool vec_row = VW == 4 && vec && c0 + cl + 4 <= d &&
                         ((size_t)out & 15) == 0;
    float yn[VW], wsn = 0.f;  // the next pass's self term, loaded early
    auto load_self = [&](int p) {
      const int i = warp * RPW + p * row_step + rsub;
      wsn = i < n ? w_self[i] : 0.f;
      if constexpr (VW == 4) {
        if (vec_row && i < n) {
          const float4 x =
              *reinterpret_cast<const float4*>(y + (size_t)i * d + c0 + cl);
          yn[0] = x.x, yn[1] = x.y, yn[2] = x.z, yn[3] = x.w;
          return;
        }
      }
#pragma unroll
      for (int v = 0; v < VW; ++v) {
        const int j = c0 + cl + v;
        yn[v] = i < n && j < d ? y[(size_t)i * d + j] : 0.f;
      }
    };
    float yi[VW], acc[VW];
    if (npass > 0) {
      load_self(0);
      stage(0, 0, 0);
    }
    int buf = 0;
    for (int p = 0; p < npass; ++p) {
      const int i = warp * RPW + p * row_step + rsub;
#pragma unroll
      for (int v = 0; v < VW; ++v) {
        yi[v] = yn[v];
        acc[v] = __fmul_rn(wsn, yi[v]);
      }
      for (int ch = 0; ch < nch; ++ch, buf ^= 1) {
        const bool last = ch == nch - 1;
        if (last && p + 1 < npass) load_self(p + 1);
        if (!last || p + 1 < npass) {  // the next chunk loads meanwhile
          stage(last ? p + 1 : p, last ? 0 : ch + 1, buf ^ 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncwarp();
        const int kc = min(KC, k - ch * KC);
        const int* nb = nb_s + buf * RPW * KS + rsub * KS;
        const float* wt = wt_s + buf * RPW * KS + rsub * KS;
        // every slot is gathered, with no branch, so that the loads of a
        // chunk issue together; a slot past k (index 0, weight 0 in the
        // stage) takes weight -0 and value +0, whose term adds exactly
        // nothing (x + -0 = x for every x, NaN and -0 included)
#pragma unroll
        for (int qq = 0; qq < KC; ++qq) {
          const bool in = qq < kc;
          const float wq = in ? wt[qq] : -0.0f;
          const float* src = slab + nb[qq] * C + cl;
          float v[VW];
          if constexpr (VW == 4) {
            const float4 x = *reinterpret_cast<const float4*>(src);
            v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
          } else if constexpr (VW == 2) {
            const float2 x = *reinterpret_cast<const float2*>(src);
            v[0] = x.x, v[1] = x.y;
          } else {
            v[0] = src[0];
          }
#pragma unroll
          for (int c = 0; c < VW; ++c) {
            acc[c] = term(acc[c], wq, in ? v[c] : 0.0f);
          }
        }
        __syncwarp();  // this buffer is read before it is refilled
      }
      if (i < n) {
        float o[VW];
#pragma unroll
        for (int v = 0; v < VW; ++v) {
          o[v] = laplacian ? __fsub_rn(yi[v], acc[v]) : acc[v];
        }
        if constexpr (VW == 4) {
          if (vec_row) {
            *reinterpret_cast<float4*>(out + (size_t)i * d + c0 + cl) =
                make_float4(o[0], o[1], o[2], o[3]);
            continue;
          }
        }
#pragma unroll
        for (int v = 0; v < VW; ++v) {
          const int j = c0 + cl + v;
          if (j < d) out[(size_t)i * d + j] = o[v];
        }
      }
    }
    __syncthreads();  // the slab is consumed before the next is staged
  }
}

// Replaces repro/kernels/mixing_matvec.py:sparse_mix_matvec_halo (plain
// path, _sparse_halo_body): the identity gossip on Erdos-Renyi graphs at
// n = 4096, f32 and bf16.
// Bound: bytes, 1.54 ms at (4096, 157000) f32 (y read once, out written
// once, 3.35 TB/s).  The work gathers, per element, the row's real
// neighbors (nnz / n = 18.3 on average at r = 0.004) out of k = 36 padded
// slots.
// Design: sparse_mix_slab_comm_kernel's column slab without the decode,
// and with padded slots served from registers.  (1) Block s copies the
// (n, C) slab of y, columns [s*C, s*C + C) of every row (32 bytes of a
// row at the planner's C = 8 f32 or C = 16 bf16), into shared memory with
// cp.async of cw bytes (16 where d and the pointer allow; 8, 4, or 2-byte
// loads for a bf16 row of odd d), zero past d.  (2) Each warp takes RPW
// output rows per pass, LPR lanes per row and VW columns per lane, and
// walks the rows in the row plan's order: rows sorted by their real
// degree, so the rows of a pass need about as many slots each.  The warp
// gathers its rows' first slots up to the most real slots among them
// (deg, rounded up to a group of four), chunk by chunk of KC table slots
// (20 at C*sizeof(T) = 32 bytes: most passes of the Erdos-Renyi graph
// need one chunk), each chunk's indices and weights copied into the
// warp's other stage buffer by cp.async while this chunk gathers, four
// slots at a time: one 16-byte read of indices and one of weights, and
// per slot one read of VW values from the slab.  A padded slot of row i
// holds (index i, weight +0.0) after the row's real slots
// (topology/structure.py), so inside that range it is gathered as the
// table says, and past it, where its term is term(acc, +0.0f, y_i) with
// y_i already in the lane's registers, the k - done padded terms are
// applied with no load.  Same values in the same order: the output is
// bitwise the full-operand kernel's and the plain version's for every
// input, NaN, +-inf and -0 included.  Without a plan (order, deg null)
// the rows go in natural order and every slot is gathered.  The self term
// y_i is read from the slab; the output is written once, sw bytes per
// store, masked past d.  What bounds it at (4096, 157000): shared-memory
// wavefronts, about 8 per 16-byte slab read of a warp (4 random 32-byte
// rows per quarter-warp share 4 bank groups) and 2 per slot for the
// table, over the ~20 slots a pass gathers.
template <typename T, int RB, int CW, int NT = kSlabThreads>
__device__ __forceinline__ void stage_slab(T* slab, const T* __restrict__ y,
                                           int n, int d, int c0,
                                           int nt = NT) {
  constexpr int CPR = RB / CW;              // copies per slab row
  constexpr int E = CW / (int)sizeof(T);    // values per copy
  for (int e = threadIdx.x; e < n * CPR; e += nt) {
    const int r = e / CPR, j = c0 + (e % CPR) * E;
    copy_async<CW>(reinterpret_cast<char*>(slab) + (size_t)e * CW,
                   y + (size_t)r * d + (j < d ? j : 0), j < d);
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(kSlabThreads)
    sparse_mix_slab_kernel(const T* __restrict__ y, T* __restrict__ out,
                           const float* __restrict__ w_self,
                           const int* __restrict__ nbr,
                           const float* __restrict__ wts,
                           const int* __restrict__ order,
                           const int* __restrict__ deg, int n, int d, int k,
                           int cw, int sw, int laplacian) {
  constexpr int RB = C * (int)sizeof(T);    // bytes of a slab row
  constexpr int FC = RB / 4;                // the f32 slab width of RB
  constexpr int VB = RB < 16 ? RB : 16;     // bytes a lane reads per row
  constexpr int VW = VB / (int)sizeof(T);   // columns per lane
  constexpr int LPR = RB / VB;              // lanes per row
  constexpr int RPW = slab_rows_per_warp(FC);
  // the comm slab's stage buffers, every column a slot: a chunk of KC
  // slots per staged row (20 for 32-byte slab rows, else 12)
  constexpr int KS = slab_slots(FC) + 4, KC = KS;
  constexpr int P4 = KC / 4;                // 16-byte pieces per staged row
  constexpr int NP = RPW * P4;              // pieces per buffer
  constexpr int NE = RPW * KC;              // 4-byte entries per buffer
  static_assert(RPW * LPR == 32 && KC % 4 == 0 && NE % 32 == 0,
                "warp geometry");
  constexpr unsigned kAll = 0xFFFFFFFFu;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* slab = reinterpret_cast<T*>(smem_raw);  // (n, C)
  int* tab_s = reinterpret_cast<int*>(smem_raw + slab_bytes(n, RB));
  const int nslab = (d + C - 1) / C;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int* nb_s = tab_s + warp * 2 * RPW * KS;  // 2 x (RPW, KS)
  float* wt_s = reinterpret_cast<float*>(tab_s + kSlabWarps * 2 * RPW * KS) +
                warp * 2 * RPW * KS;        // 2 x (RPW, KS)
  const int rsub = lane / LPR;              // this lane's row in the pass
  const int cl = (lane % LPR) * VW;         // its first column in the slab
  const int row_step = kSlabWarps * RPW;
  const int npass =
      n > warp * RPW ? (n - warp * RPW + row_step - 1) / row_step : 0;
  const bool vec_tab = k % 4 == 0 && ((size_t)nbr & 15) == 0 &&
                       ((size_t)wts & 15) == 0;

  // A pass's rows: lane l holds walk position warp*RPW + p*row_step +
  // l % RPW, its row (-1 past n), the row's real slots and its diagonal.
  // The warp gathers to the most real slots of its rows: a row with fewer
  // takes its padded slots in that range from the table, as the
  // full-operand kernel does, and the rest from registers.
  struct PassRow {
    int row, deg;
    float ws;
  };
  auto pass_row = [&](int p) {
    const int pos = warp * RPW + p * row_step + lane % RPW;
    PassRow pr{-1, 0, 0.f};
    if (pos < n) {
      pr.row = order ? order[pos] : pos;
      pr.deg = deg ? deg[pr.row] : k;
      pr.ws = w_self[pr.row];
    }
    return pr;
  };
  // async copy of chunk ch of a pass's table rows into stage buffer buf
  auto stage = [&](const PassRow& pr, int ch, int buf) {
    int* nb = nb_s + buf * RPW * KS;
    float* wt = wt_s + buf * RPW * KS;
    if (vec_tab) {  // piece e: slots 4*(e % P4).. of staged row e / P4
#pragma unroll
      for (int m = 0; m < (NP + 31) / 32; ++m) {
        const int e = lane + 32 * m, rs = min(e / P4, RPW - 1);
        const int r = __shfl_sync(kAll, pr.row, rs);
        const int q = ch * KC + 4 * (e % P4);
        const bool in = e < NP && r >= 0 && q < k;
        const size_t at = in ? (size_t)r * k + q : 0;
        if (e < NP) {
          cp_async16(nb + rs * KS + 4 * (e % P4), nbr + at, in);
          cp_async16(wt + rs * KS + 4 * (e % P4), wts + at, in);
        }
      }
    } else {  // entry e: slot e % KC of staged row e / KC
#pragma unroll
      for (int m = 0; m < NE / 32; ++m) {
        const int e = lane + 32 * m, rs = e / KC;
        const int r = __shfl_sync(kAll, pr.row, rs);
        const int q = ch * KC + e % KC;
        const bool in = r >= 0 && q < k;
        const size_t at = in ? (size_t)r * k + q : 0;
        cp_async4(nb + rs * KS + e % KC, nbr + at, in);
        cp_async4(wt + rs * KS + e % KC, wts + at, in);
      }
    }
    cp_async_commit();
  };

  for (int s = blockIdx.x; s < nslab; s += gridDim.x) {
    const int c0 = s * C;
    // (1) stage the (n, C) slab of y
    if (cw == 16) {
      if constexpr (RB >= 16) stage_slab<T, RB, 16>(slab, y, n, d, c0);
    } else if (cw == 8) {
      if constexpr (RB >= 8) stage_slab<T, RB, 8>(slab, y, n, d, c0);
    } else if (cw == 4) {
      stage_slab<T, RB, 4>(slab, y, n, d, c0);
    } else {
      if constexpr (sizeof(T) == 2) stage_slab<T, RB, 2>(slab, y, n, d, c0);
    }
    cp_async_wait_all();
    __syncthreads();

    // (2) the mix, pass by pass of the walk
    PassRow cur{-1, 0, 0.f}, nxt{-1, 0, 0.f};
    if (npass > 0) {
      cur = pass_row(0);
      if (npass > 1) nxt = pass_row(1);
      stage(cur, 0, 0);
    }
    int buf = 0;
    for (int p = 0; p < npass; ++p) {
      const int i = __shfl_sync(kAll, cur.row, rsub);
      const float wsi = __shfl_sync(kAll, cur.ws, rsub);
      const int gmax = __reduce_max_sync(kAll, cur.deg);
      const int nch = gmax > 0 ? (gmax + KC - 1) / KC : 1;
      float yi[VW], acc[VW];
      if (i >= 0) {
        lds_vec<T, VW>(slab + (size_t)i * C + cl, yi);
      } else {
#pragma unroll
        for (int v = 0; v < VW; ++v) yi[v] = 0.f;
      }
#pragma unroll
      for (int v = 0; v < VW; ++v) acc[v] = __fmul_rn(wsi, yi[v]);
      int done = 0;  // slots gathered, the same for every lane
      for (int ch = 0; ch < nch; ++ch, buf ^= 1) {
        if (ch + 1 < nch) {  // the next chunk's tables load meanwhile
          stage(cur, ch + 1, buf ^ 1);
          cp_async_wait<1>();
        } else if (p + 1 < npass) {  // or the next pass's first
          stage(nxt, 0, buf ^ 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncwarp();
        const int* nb = nb_s + buf * RPW * KS + rsub * KS;
        const float* wt = wt_s + buf * RPW * KS + rsub * KS;
        // the warp's slots of this chunk, in groups of four, each the
        // table's term in table order (a padded slot's staged index is
        // the row itself); a slot past k (zero-filled) adds nothing
        const int q0 = ch * KC, ng = (min(KC, gmax - q0) + 3) / 4;
        for (int g = 0; g < ng; ++g) {
          const int4 ix = *reinterpret_cast<const int4*>(nb + 4 * g);
          const float4 wv = *reinterpret_cast<const float4*>(wt + 4 * g);
          const int idx[4] = {ix.x, ix.y, ix.z, ix.w};
          const float wq[4] = {wv.x, wv.y, wv.z, wv.w};
          float x[4][VW];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            lds_vec<T, VW>(slab + (size_t)idx[e] * C + cl, x[e]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (q0 + 4 * g + e < k) {
#pragma unroll
              for (int v = 0; v < VW; ++v) {
                acc[v] = term(acc[v], wq[e], x[e][v]);
              }
            }
          }
        }
        done = min(k, q0 + 4 * ng);
        __syncwarp();  // this buffer is read before it is refilled
      }
      if (i >= 0) {
        // the remaining padded slots, from registers: (index i, +0.0)
        for (int t = done; t < k; ++t) {
#pragma unroll
          for (int v = 0; v < VW; ++v) acc[v] = term(acc[v], 0.0f, yi[v]);
        }
        if (laplacian) {
#pragma unroll
          for (int v = 0; v < VW; ++v) acc[v] = __fsub_rn(yi[v], acc[v]);
        }
        const int j0 = c0 + cl;
        T* o = out + (size_t)i * d + j0;
        if (j0 < d) {
          if (sw >= VB) {
            stg_vec<T, VW, VB>(o, acc, d - j0);
          } else if (sw == 8) {
            if constexpr (VB > 8) stg_vec<T, VW, 8>(o, acc, d - j0);
          } else if (sw == 4) {
            if constexpr (VB > 4) stg_vec<T, VW, 4>(o, acc, d - j0);
          } else {
            if constexpr (sizeof(T) == 2) stg_vec<T, VW, 2>(o, acc, d - j0);
          }
        }
      }
      cur = nxt;
      if (p + 2 < npass) nxt = pass_row(p + 2);
    }
    __syncthreads();  // the slab is consumed before the next is staged
  }
}

// ---------------------------------------------------------------------------
// The full-operand sparse gather on a column stripe
// ---------------------------------------------------------------------------

// Replaces repro/kernels/mixing_matvec.py:sparse_mix_matvec (plain path,
// _sparse_body, which holds an (n, 128) column stripe in VMEM and gathers
// every neighbor row from it), f32 and bf16, up to n = 14,528 rows.
// Bound: bytes, one read of Y and one write of the output: 0.048 ms at
// (128, 157000) f32 at 3.35 TB/s.  The gather reads k + 1 values of the
// stripe per output element, 6.4 GB of shared memory at (128, 157000)
// with k = 78: about 0.2 ms at the card's ~33 TB/s of shared-memory
// bandwidth, which is what bounds it there.
// Design: block s stages the columns [s*bc, s*bc + bc) of all n rows, RB
// = bc * sizeof(T) bytes a row (512 down to 16: plan_stripe_cols in
// mixing_matvec.py), in dynamic shared memory with cp.async of cw bytes
// (16 where d and the pointer allow, else 8 or 4; 2-byte loads for a bf16
// row of odd d), zero past d, so Y leaves device memory once.  After one
// barrier each warp walks rows, RB / 16 lanes a row, each lane a 16-byte
// vector of VW columns (4 f32, 8 bf16): w_self[i]*y_i with y_i from the
// stripe, then the row's k table slots in order, four at a time (indices
// and weights are broadcast loads, one address per row; 16-byte ones
// where k % 4 == 0), each neighbor's vector one 16-byte shared-memory
// read (at RB = 512 a warp reads one 512-byte row: 4 wavefronts, no bank
// conflict), then y_i - acc for the Laplacian; the row leaves in sw-byte
// stores, masked past d.  The terms are the plain version's in its order,
// so the output is bitwise sparse_mix_padded_ref's and
// sparse_mix_unstaged_kernel's.
constexpr int kStripeThreads = 256;

template <typename T, int RB>
__global__ void __launch_bounds__(kStripeThreads)
    sparse_mix_stripe_kernel(const T* __restrict__ y, T* __restrict__ out,
                             const float* __restrict__ w_self,
                             const int* __restrict__ nbr,
                             const float* __restrict__ wts, int n, int d,
                             int k, int cw, int sw, int laplacian) {
  constexpr int BC = RB / (int)sizeof(T);   // stripe columns
  constexpr int VW = 16 / (int)sizeof(T);   // columns per lane
  constexpr int LPR = RB / 16;              // lanes per row
  constexpr int RPW = 32 / LPR;             // rows per warp and pass
  constexpr int STEP = kStripeThreads / 32 * RPW;  // rows per block pass
  static_assert(RB >= 16 && RB <= 512 && RB % 16 == 0, "a stripe row");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stripe = reinterpret_cast<T*>(smem_raw);  // (n, BC)
  const int c0 = blockIdx.x * BC;
  // (1) stage the (n, BC) stripe of y
  if (cw == 16) {
    stage_slab<T, RB, 16, kStripeThreads>(stripe, y, n, d, c0);
  } else if (cw == 8) {
    stage_slab<T, RB, 8, kStripeThreads>(stripe, y, n, d, c0);
  } else if (cw == 4) {
    stage_slab<T, RB, 4, kStripeThreads>(stripe, y, n, d, c0);
  } else {
    if constexpr (sizeof(T) == 2) {
      stage_slab<T, RB, 2, kStripeThreads>(stripe, y, n, d, c0);
    }
  }
  cp_async_wait_all();
  __syncthreads();
  // (2) the mix, row by row; a lane past the ragged edge has nothing to do
  const int lane = threadIdx.x % 32;
  const int cl = (lane % LPR) * VW, j0 = c0 + cl;
  if (j0 >= d) return;
  const bool vec_tab = k % 4 == 0 && ((size_t)nbr & 15) == 0 &&
                       ((size_t)wts & 15) == 0;
  for (int i = threadIdx.x / 32 * RPW + lane / LPR; i < n; i += STEP) {
    float yi[VW], acc[VW];
    lds_vec<T, VW>(stripe + (size_t)i * BC + cl, yi);
    const float ws = __ldg(w_self + i);
#pragma unroll
    for (int v = 0; v < VW; ++v) acc[v] = __fmul_rn(ws, yi[v]);
    const int* ni = nbr + (size_t)i * k;
    const float* wi = wts + (size_t)i * k;
    int t = 0;
    for (; t + 4 <= k; t += 4) {
      int idx[4];
      float wq[4];
      if (vec_tab) {
        const int4 a = __ldg(reinterpret_cast<const int4*>(ni + t));
        const float4 b = __ldg(reinterpret_cast<const float4*>(wi + t));
        idx[0] = a.x, idx[1] = a.y, idx[2] = a.z, idx[3] = a.w;
        wq[0] = b.x, wq[1] = b.y, wq[2] = b.z, wq[3] = b.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          idx[e] = __ldg(ni + t + e);
          wq[e] = __ldg(wi + t + e);
        }
      }
      float x[4][VW];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        lds_vec<T, VW>(stripe + (size_t)idx[e] * BC + cl, x[e]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int v = 0; v < VW; ++v) acc[v] = term(acc[v], wq[e], x[e][v]);
      }
    }
    for (; t < k; ++t) {
      float x[VW];
      lds_vec<T, VW>(stripe + (size_t)__ldg(ni + t) * BC + cl, x);
      const float wq = __ldg(wi + t);
#pragma unroll
      for (int v = 0; v < VW; ++v) acc[v] = term(acc[v], wq, x[v]);
    }
    if (laplacian) {
#pragma unroll
      for (int v = 0; v < VW; ++v) acc[v] = __fsub_rn(yi[v], acc[v]);
    }
    T* o = out + (size_t)i * d + j0;
    if (sw >= 16) {
      stg_vec<T, VW, 16>(o, acc, d - j0);
    } else if (sw == 8) {
      stg_vec<T, VW, 8>(o, acc, d - j0);
    } else if (sw == 4) {
      stg_vec<T, VW, 4>(o, acc, d - j0);
    } else {
      if constexpr (sizeof(T) == 2) stg_vec<T, VW, 2>(o, acc, d - j0);
    }
  }
}

// ---------------------------------------------------------------------------
// The comm-fused full-operand gossips on a decoded column stripe
// ---------------------------------------------------------------------------

// 4 f32 values of a row in device memory at p, in pieces of vb bytes (16,
// 8 or 4: what the row's alignment allows, vec_bytes); a piece at or past
// `valid` columns reads as 0.
__device__ __forceinline__ void ldg_f32x4(const float* p, int vb, int valid,
                                          float* v) {
  if (vb == 16) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else if (vb == 8) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float2 x = 2 * q < valid
                           ? __ldg(reinterpret_cast<const float2*>(p) + q)
                           : make_float2(0.f, 0.f);
      v[2 * q] = x.x, v[2 * q + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = e < valid ? __ldg(p + e) : 0.f;
  }
}

// 4 f32 values stored at p in pieces of vb bytes, masked past `valid`.
__device__ __forceinline__ void stg_f32x4(float* p, int vb, const float* v,
                                          int valid) {
  if (vb == 16) {
    stg_vec<float, 4, 16>(p, v, valid);
  } else if (vb == 8) {
    stg_vec<float, 4, 8>(p, v, valid);
  } else {
    stg_vec<float, 4, 4>(p, v, valid);
  }
}

// A row's neighbors in the stripe kernels below: its diagonal weight, and
// from slot t on, four slots' (or one slot's) rows and weights.  Every
// lane of a row asks for the same slots at once, so each table entry is
// one broadcast load.  TableSlots reads the padded (n, k) tables (16-byte
// loads where k % 4 == 0 and the tables are aligned); OffsetSlots the
// circulant tables, slot t of row i being row (i + off[t]) mod n.
struct TableSlots {
  const float* w_self;
  const int* nbr;
  const float* wts;
  int k;
  bool vec;
  __device__ int slots() const { return k; }
  __device__ float self(int i) const { return __ldg(w_self + i); }
  __device__ void four(int i, int t, int* idx, float* wq) const {
    const size_t at = (size_t)i * k + t;
    if (vec) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(nbr + at));
      const float4 b = __ldg(reinterpret_cast<const float4*>(wts + at));
      idx[0] = a.x, idx[1] = a.y, idx[2] = a.z, idx[3] = a.w;
      wq[0] = b.x, wq[1] = b.y, wq[2] = b.z, wq[3] = b.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        idx[e] = __ldg(nbr + at + e);
        wq[e] = __ldg(wts + at + e);
      }
    }
  }
  __device__ void one(int i, int t, int* idx, float* wq) const {
    *idx = __ldg(nbr + (size_t)i * k + t);
    *wq = __ldg(wts + (size_t)i * k + t);
  }
};

struct OffsetSlots {
  Circ c;
  int n;
  __device__ int slots() const { return c.k; }
  __device__ float self(int) const { return c.w_self; }
  __device__ void one(int i, int t, int* idx, float* wq) const {
    const int src = i + __ldg(c.off + t);
    *idx = src >= n ? src - n : src;
    *wq = __ldg(c.w + t);
  }
  __device__ void four(int i, int t, int* idx, float* wq) const {
#pragma unroll
    for (int e = 0; e < 4; ++e) one(i, t + e, idx + e, wq + e);
  }
};

// Replaces repro/kernels/mixing_matvec.py:sparse_mix_matvec with comm=
// (_sparse_fused_body: the resident (n, bd) stripe quantized once into
// VMEM scratch, every neighbor row gathered from there) and
// circulant_mix_matvec with comm= (_mix_fused_body), up to n = 14,528
// rows; the unstaged kernels above take larger n.
// Bound: bytes, one read of y (and hat) and one write of out (and the
// payload): 0.012 ms at (16, 157000) under EF, 0.096 ms at (128, 157000),
// at 3.35 TB/s.  Besides, one hash per element (~20 integer operations)
// and ~10 f32 operations of the quantizer, and the mix's k shared-memory
// reads per element: at (128, 157000) with k = 78, 6.4 GB of them, about
// 0.2 ms at the card's ~33 TB/s of shared-memory bandwidth, as the plain
// stripe (sparse_mix_stripe_kernel); at (454, 157000) with k = 260, 74
// GB, which set the kernel's time there.
// Design: sparse_mix_stripe_kernel's stripe, decoded once.  Block s owns the
// columns [s*bc, s*bc + bc) of all n rows, RB = 4*bc bytes a row (512 down to
// 16: plan_comm_stripe_cols in mixing_matvec.py).  (1) It stages the (n, bc)
// stripe of y with cp.async of cw bytes (16 where d and the pointer allow),
// zero past d.  (2) After one barrier, a thread takes a 16-byte vector (4
// columns) of a staged row at a time and decodes it in place, one hash per
// element: `roundtrip(x, zp[r], scale[r], hash_uniform(smix, r, j), levels)`
// with x = y - hat and hat + the result under EF, `decoded`'s arithmetic, so
// the stripe holds exactly the payload the wire carries (NaN codes, +-inf and
// -0 included). Under EF it reads hat in hw-byte pieces from device memory and
// writes the payload's row piece from the same registers, so the payload leaves
// once, coalesced, in the pass that makes it (repro's `pay_ref[...] = pay`).
// Each thread reads hat one vector, and y_i one row, ahead of its use, the
// first of each while the stripe is staged, so at d2's 16 rows neither read
// waits after a barrier.  (3) After one more barrier each warp walks rows as
// the plain stripe does, RB / 16 lanes a row, each lane 4 columns: w_self*y_i
// with y_i exact from device memory (L2: the block staged those bytes), then
// the row's k slots in order, four at a time, each neighbor's vector one
// 16-byte shared-memory read of the decoded stripe, then the epilogue
// (StripeMix: y_i - acc for the Laplacian; StripeNeumann: the Neumann
// update of circulant_neumann_stripe_comm_kernel below); the row leaves in
// sw-byte stores, masked past d.  The terms are
// the plain version's in its order, so output and payload are bitwise
// sparse_mix_fused_ref's and circulant_mix_fused_ref's, and the unstaged
// kernels'.  The block's threads are sized for the decode pass
// (stripe_comm_threads): the fewest of 256, 512 and 1024 that put 1024 threads
// on each SM beside the stripe's shared memory, since the hash chains starve
// with fewer warps (the fused circulant halo's finding).
constexpr int kStripeCommMaxThreads = 1024;

// The mixes' epilogue: y_i - acc for the Laplacian.
struct StripeMix {
  int laplacian;
  struct Ahead {};
  __device__ __forceinline__ void load(int, int, int, Ahead&,
                                       const JobAxis&) const {}
  __device__ __forceinline__ void finish(float* acc, const float* yi,
                                         const Ahead&,
                                         const JobAxis&) const {
    if (laplacian) {
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[v] = __fsub_rn(yi[v], acc[v]);
    }
  }
};

// The DIHGP Neumann step's epilogue: `neumann_update` on the exact h_i,
// with the row's hvp_h and p vectors (ew-byte loads) and D~ read one row
// ahead of their use, as y_i is: D~[i] once per row, or on a bucket's
// job axis the D~ of each column's job (and its beta).
struct StripeNeumann {
  const float* __restrict__ hvp;
  const float* __restrict__ p;
  const float* __restrict__ dsc;
  float beta;
  int n, d, ew;
  struct Ahead {
    float hv[4], pv[4], di[4], b[4];
  };
  __device__ __forceinline__ void load(int i, int j0, int, Ahead& a,
                                       const JobAxis& ja) const {
    if (i < n && j0 < d) {
      ldg_f32x4(hvp + (size_t)i * d + j0, ew, d - j0, a.hv);
      ldg_f32x4(p + (size_t)i * d + j0, ew, d - j0, a.pv);
      if (ja.jobs == 1) {
        a.di[0] = a.di[1] = a.di[2] = a.di[3] = __ldg(dsc + i);
        a.b[0] = a.b[1] = a.b[2] = a.b[3] = ja.beta(0, beta);
      } else {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          // columns past d are computed and never stored
          const int job = ja.job(j0 + v < d ? j0 + v : j0);
          a.di[v] = __ldg(dsc + (size_t)i * ja.jobs + job);
          a.b[v] = ja.beta(job, beta);
        }
      }
    }
  }
  __device__ __forceinline__ void finish(float* acc, const float* hi,
                                         const Ahead& a,
                                         const JobAxis&) const {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      acc[v] = neumann_update(hi[v], acc[v], a.hv[v], a.pv[v], a.di[v],
                              a.b[v]);
    }
  }
};

template <int RB, typename Slots, typename Epi>
__device__ __forceinline__ void stripe_comm_body(
    const float* __restrict__ y, float* __restrict__ out,
    float* __restrict__ pay, int n, int d, const Slots& sl, const Wire& w,
    const Epi& ep, int cw, int hw, int sw, const JobAxis& ja) {
  constexpr int BC = RB / 4;    // stripe columns
  constexpr int LPR = RB / 16;  // lanes (4-column vectors) per row
  constexpr int RPW = 32 / LPR;  // rows per warp and pass
  static_assert(RB >= 16 && RB <= 512 && RB % 16 == 0, "a stripe row");
  extern __shared__ __align__(16) float smem_f[];
  float* stripe = smem_f;  // (n, BC), decoded in place
  const int nt = blockDim.x;
  const int c0 = blockIdx.x * BC;
  const bool ef = w.hat != nullptr;
  const int nv = n * LPR;  // 16-byte vectors of the stripe
  // Device-memory reads one step ahead of their use: hat for the decode
  // pass's next vector, y_i for the mix's next row; the first of each
  // while the stripe is staged.
  const auto load_hat = [&](int e, float* h) {
    const int j = c0 + (e % LPR) * 4;
    if (ef && e < nv && j < d) {
      ldg_f32x4(w.hat + (size_t)(e / LPR) * d + j, hw, d - j, h);
    }
  };
  const int lane = threadIdx.x % 32;
  const int cl = (lane % LPR) * 4, j0 = c0 + cl;
  const int step = nt / 32 * RPW;  // rows per block pass of the mix
  const int i0 = threadIdx.x / 32 * RPW + lane / LPR;  // this lane's first
  const auto load_y = [&](int i, float* v) {
    if (i < n && j0 < d) ldg_f32x4(y + (size_t)i * d + j0, cw, d - j0, v);
  };
  float hn[4] = {0.f, 0.f, 0.f, 0.f}, yn[4] = {0.f, 0.f, 0.f, 0.f};
  typename Epi::Ahead en{};
  // (1) stage the (n, BC) stripe of y
  if (cw == 16) {
    stage_slab<float, RB, 16>(stripe, y, n, d, c0, nt);
  } else if (cw == 8) {
    stage_slab<float, RB, 8>(stripe, y, n, d, c0, nt);
  } else {
    stage_slab<float, RB, 4>(stripe, y, n, d, c0, nt);
  }
  load_hat(threadIdx.x, hn);
  load_y(i0, yn);
  ep.load(i0, j0, d, en, ja);
  cp_async_wait_all();
  __syncthreads();
  // (2) decode it in place, one hash per element; under EF the payload
  // leaves from here
  for (int e = threadIdx.x; e < nv; e += nt) {
    float x[4], h[4], q[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) h[v] = hn[v];
    load_hat(e + nt, hn);
    const int r = e / LPR, j = c0 + (e % LPR) * 4;
    if (j >= d) continue;  // zero past d, never stored
    float* s = stripe + (size_t)e * 4;
    lds_vec<float, 4>(s, x);
    if (ja.jobs == 1) {
      const float zp = __ldg(w.zp + r), sc = __ldg(w.scale + r);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float u = hash_uniform(ja.smix[0], r, j + v);
        const float dv = roundtrip(ef ? __fsub_rn(x[v], h[v]) : x[v], zp,
                                   sc, u, w.levels);
        q[v] = ef ? __fadd_rn(h[v], dv) : dv;
      }
    } else {
      // a bucket's job axis: each element with its job's seed, in-job
      // column and metadata (columns past d decode junk, never stored)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int job = ja.job(j + v < d ? j + v : j);
        const size_t m = (size_t)r * ja.jobs + job;
        const float u =
            hash_uniform(ja.smix[job], r, j + v - job * ja.djob);
        const float dv = roundtrip(ef ? __fsub_rn(x[v], h[v]) : x[v],
                                   __ldg(w.zp + m), __ldg(w.scale + m), u,
                                   w.levels);
        q[v] = ef ? __fadd_rn(h[v], dv) : dv;
      }
    }
    *reinterpret_cast<float4*>(s) = make_float4(q[0], q[1], q[2], q[3]);
    if (ef) stg_f32x4(pay + (size_t)r * d + j, sw, q, d - j);
  }
  __syncthreads();
  // (3) the mix, row by row; a lane past the ragged edge has nothing to do
  if (j0 >= d) return;
  const int k = sl.slots();
  for (int i = i0; i < n; i += step) {
    const size_t at = (size_t)i * d + j0;
    float yi[4], acc[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) yi[v] = yn[v];
    const typename Epi::Ahead ea = en;
    load_y(i + step, yn);
    ep.load(i + step, j0, d, en, ja);
    const float ws = sl.self(i);
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[v] = __fmul_rn(ws, yi[v]);
    int t = 0;
    for (; t + 4 <= k; t += 4) {
      int idx[4];
      float wq[4], x[4][4];
      sl.four(i, t, idx, wq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        lds_vec<float, 4>(stripe + (size_t)idx[e] * BC + cl, x[e]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[v] = term(acc[v], wq[e], x[e][v]);
      }
    }
    for (; t < k; ++t) {
      int idx;
      float wq, x[4];
      sl.one(i, t, &idx, &wq);
      lds_vec<float, 4>(stripe + (size_t)idx * BC + cl, x);
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[v] = term(acc[v], wq, x[v]);
    }
    ep.finish(acc, yi, ea, ja);
    stg_f32x4(out + at, sw, acc, d - j0);
  }
}

template <int RB>
__global__ void __launch_bounds__(kStripeCommMaxThreads)
    sparse_mix_stripe_comm_kernel(const float* __restrict__ y,
                                  float* __restrict__ out,
                                  float* __restrict__ pay,
                                  const float* __restrict__ w_self,
                                  const int* __restrict__ nbr,
                                  const float* __restrict__ wts, int n,
                                  int d, int k, Wire w, int laplacian,
                                  const __grid_constant__ JobAxis ja,
                                  int cw, int hw, int sw) {
  const bool vec = k % 4 == 0 && ((size_t)nbr & 15) == 0 &&
                   ((size_t)wts & 15) == 0;
  stripe_comm_body<RB>(y, out, pay, n, d,
                       TableSlots{w_self, nbr, wts, k, vec}, w,
                       StripeMix{laplacian}, cw, hw, sw, ja);
}

template <int RB>
__global__ void __launch_bounds__(kStripeCommMaxThreads)
    circulant_mix_stripe_comm_kernel(const float* __restrict__ y,
                                     float* __restrict__ out,
                                     float* __restrict__ pay, int n, int d,
                                     Circ c, Wire w, int laplacian,
                                     const __grid_constant__ JobAxis ja,
                                     int cw, int hw, int sw) {
  stripe_comm_body<RB>(y, out, pay, n, d, OffsetSlots{c, n}, w,
                       StripeMix{laplacian}, cw, hw, sw, ja);
}

// Replaces repro/kernels/mixing_matvec.py:circulant_neumann_step with comm=
// (_neumann_fused_body: the resident (n, bd) stripe of h quantized once,
// the neighbor rows of W.h mixed from it; no EF, as repro) wherever
// plan_neumann_comm_stripe_cols in mixing_matvec.py gives a stripe;
// circulant_neumann_comm_kernel above takes the rest.
// Bound: bytes, one read of h, hvp_h and p and one write of h+: 0.096 ms
// at (128, 157000) at 3.35 TB/s; besides, one hash per element and the
// quantizer's ~10 f32 operations, the mix's k shared-memory reads and the
// update's 6 operations per element.
// Design: circulant_mix_stripe_comm_kernel's decoded stripe
// (stripe_comm_body: h's (n, bc) stripe staged and decoded in place, one
// hash per element, where circulant_neumann_comm_kernel decodes each
// neighbor value where it is gathered, k hashes per element), with the
// Neumann epilogue in place of the Laplacian: w_self*h_i with the exact
// h_i from device memory, the k decoded neighbors in offset order
// (`term`), then `neumann_update(h_i, mix, hvp, p, D~_i, beta)`, whose
// hvp_h and p vectors and D~_i are read one row ahead of their use, as
// h_i is.  The order of terms is the plain version's, so the output is
// bitwise neumann_step_fused_ref's and circulant_neumann_comm_kernel's.
template <int RB>
__global__ void __launch_bounds__(kStripeCommMaxThreads)
    circulant_neumann_stripe_comm_kernel(
        const float* __restrict__ h, const float* __restrict__ hvp,
        const float* __restrict__ p, const float* __restrict__ dsc,
        float* __restrict__ out, int n, int d, Circ c, Wire w, float beta,
        int ew, const __grid_constant__ JobAxis ja, int cw, int hw, int sw) {
  stripe_comm_body<RB>(h, out, nullptr, n, d, OffsetSlots{c, n}, w,
                       StripeNeumann{hvp, p, dsc, beta, n, d, ew}, cw, hw,
                       sw, ja);
}

// Dynamic shared memory of a halo launch: `buffers` tiles of `rows`
// staged rows of kHaloBd elements of `itemsize` bytes (the Python
// planner's halo_smem_bytes with blocks = buffers).
long long halo_smem_bytes(int rows, int itemsize, int buffers = 1) {
  return (long long)buffers * rows * kHaloBd * itemsize;
}

// The launch geometry of a halo kernel, or false when the wrapper's tile
// or shared-memory size (`buffers` tiles of h_lo + bn + h_hi rows, and
// `tiles` more (bn, 128) operand tiles in each) is not one the kernel
// takes.
bool halo_launch(int n, int d, int bn, int h_lo, int h_hi, int itemsize,
                 int buffers, int smem_bytes, dim3* grid, int tiles = 0) {
  if (bn < 1 || n % bn || h_lo < 0 || h_hi < 0 || h_lo > bn || h_hi > bn ||
      buffers < 1 || smem_bytes > kSmemOptIn ||
      smem_bytes != halo_smem_bytes(h_lo + (1 + tiles) * bn + h_hi,
                                    itemsize, buffers)) {
    return false;
  }
  const int ncol = (d + kHaloBd - 1) / kHaloBd;
  *grid = dim3(n / bn, ncol < kMaxGridRows ? ncol : kMaxGridRows);
  return true;
}

// Lets `kernel` take `bytes` of dynamic shared memory (above 48 KB a block
// must opt in).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// Opts `kernel` into `smem_bytes` of dynamic shared memory and cuts
// grid->y to the column tiles that, beside the grid's grid->x row tiles,
// fill the card once (each block then walks several tiles).
template <typename Kernel>
cudaError_t fill_card(Kernel kernel, int threads, int smem_bytes,
                      dim3* grid) {
  cudaError_t err = allow_smem(kernel, smem_bytes);
  int dev = 0, sms = 0, per_sm = 0;
  if (err != cudaSuccess || (err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem_bytes)) != cudaSuccess) {
    return err;
  }
  const int fill = sms * (per_sm > 0 ? per_sm : 1) / (int)grid->x;
  grid->y = fill < 1 ? 1 : (fill < (int)grid->y ? fill : grid->y);
  return cudaSuccess;
}

dim3 grid_for(int n, int d) {
  return dim3((d + kThreads - 1) / kThreads, n < kMaxGridRows ? n : kMaxGridRows);
}

// A launch's job axis from the host: `jobs` jobs of djob columns each
// (jobs * djob == d), betas a device table (or nullptr) and seeds a
// host array of the jobs' send seeds (or nullptr where there is no
// wire); false when the axis does not fit the operand or kMaxJobs.
bool job_axis(int jobs, int djob, int d, const float* betas,
              const unsigned int* seeds, JobAxis* ja) {
  if (jobs < 1 || jobs > kMaxJobs || djob < 1 ||
      (long long)jobs * djob != d) {
    return false;
  }
  *ja = JobAxis{};
  ja->jobs = jobs;
  ja->djob = djob;
  ja->betas = betas;
  for (int b = 0; b < jobs; ++b) {
    ja->smix[b] = seeds ? seeds[b] * 0xC2B2AE3Du : 0u;
  }
  return true;
}

// The job axis of a solo launch: one job, the launch's scalar beta.
JobAxis solo_axis(int d, unsigned int seed) {
  JobAxis ja{};
  job_axis(1, d, d, nullptr, &seed, &ja);
  return ja;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  offsets (k,) int32 and weights (k,)
// f32 are device pointers; every offset must lie in [0, n).
extern "C" int circulant_mix(const void* y, void* out, int n, int d,
                             int dtype, float w_self, int k,
                             const int* offsets, const float* weights,
                             int laplacian, void* stream) {
  const Circ c{w_self, k, offsets, weights};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    circulant_mix_kernel<float><<<grid_for(n, d), kThreads, 0, s>>>(
        (const float*)y, (float*)out, n, d, c, laplacian);
  } else if (dtype == 1) {
    circulant_mix_kernel<__nv_bfloat16><<<grid_for(n, d), kThreads, 0, s>>>(
        (const __nv_bfloat16*)y, (__nv_bfloat16*)out, n, d, c, laplacian);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T, int RB>
int launch_stripe(const void* y, void* out, const float* w_self,
                  const int* nbr, const float* wts, int n, int d, int k,
                  int laplacian, int smem_bytes, cudaStream_t s) {
  const auto kernel = sparse_mix_stripe_kernel<T, RB>;
  const cudaError_t err = allow_smem(kernel, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  constexpr int BC = RB / (int)sizeof(T);
  const int cw = vec_bytes(y, y, d, (int)sizeof(T), 16);
  const int sw = vec_bytes(out, out, d, (int)sizeof(T), 16);
  kernel<<<(d + BC - 1) / BC, kStripeThreads, smem_bytes, s>>>(
      (const T*)y, (T*)out, w_self, nbr, wts, n, d, k, cw, sw, laplacian);
  return (int)cudaGetLastError();
}

// Neighbor indices must lie in [0, n).  stripe_cols: the column stripe's
// width bc (128, 64, 32, 16, 8, 4 for f32; 256 .. 8 for bf16) and
// smem_bytes n * bc * itemsize for sparse_mix_stripe_kernel; 0 (and 0
// bytes) for sparse_mix_unstaged_kernel.
extern "C" int sparse_mix(const void* y, void* out, const float* w_self,
                          const int* nbr, const float* wts, int n, int d,
                          int k, int dtype, int laplacian, int stripe_cols,
                          int smem_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (stripe_cols == 0) {
    if (smem_bytes != 0) return (int)cudaErrorInvalidValue;
    if (dtype == 0) {
      sparse_mix_unstaged_kernel<float><<<grid_for(n, d), kThreads, 0, s>>>(
          (const float*)y, (float*)out, w_self, nbr, wts, n, d, k,
          laplacian);
    } else {
      sparse_mix_unstaged_kernel<__nv_bfloat16>
          <<<grid_for(n, d), kThreads, 0, s>>>(
              (const __nv_bfloat16*)y, (__nv_bfloat16*)out, w_self, nbr,
              wts, n, d, k, laplacian);
    }
    return (int)cudaGetLastError();
  }
  const long long rb = (long long)stripe_cols * (dtype == 0 ? 4 : 2);
  if (smem_bytes > kSmemOptIn || smem_bytes != (long long)n * rb) {
    return (int)cudaErrorInvalidValue;
  }
  const auto args = [&](auto launch) {
    return launch(y, out, w_self, nbr, wts, n, d, k, laplacian, smem_bytes,
                  s);
  };
  if (dtype == 0) {
    switch (rb) {
      case 512: return args(launch_stripe<float, 512>);
      case 256: return args(launch_stripe<float, 256>);
      case 128: return args(launch_stripe<float, 128>);
      case 64: return args(launch_stripe<float, 64>);
      case 32: return args(launch_stripe<float, 32>);
      case 16: return args(launch_stripe<float, 16>);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (rb) {
    case 512: return args(launch_stripe<__nv_bfloat16, 512>);
    case 256: return args(launch_stripe<__nv_bfloat16, 256>);
    case 128: return args(launch_stripe<__nv_bfloat16, 128>);
    case 64: return args(launch_stripe<__nv_bfloat16, 64>);
    case 32: return args(launch_stripe<__nv_bfloat16, 32>);
    case 16: return args(launch_stripe<__nv_bfloat16, 16>);
    default: return (int)cudaErrorInvalidValue;
  }
}

static int neumann_unstaged(const void* h, const void* hvp, const void* p,
                            const float* dsc, void* out, int n, int d,
                            int dtype, float w_self, int k,
                            const int* offsets, const float* weights,
                            float beta, const JobAxis& ja, void* stream) {
  const Circ c{w_self, k, offsets, weights};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    circulant_neumann_kernel<float><<<grid_for(n, d), kThreads, 0, s>>>(
        (const float*)h, (const float*)hvp, (const float*)p, dsc,
        (float*)out, n, d, c, beta, ja);
  } else if (dtype == 1) {
    circulant_neumann_kernel<__nv_bfloat16>
        <<<grid_for(n, d), kThreads, 0, s>>>(
            (const __nv_bfloat16*)h, (const __nv_bfloat16*)hvp,
            (const __nv_bfloat16*)p, dsc, (__nv_bfloat16*)out, n, d, c,
            beta, ja);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int circulant_neumann(const void* h, const void* hvp,
                                 const void* p, const float* dsc, void* out,
                                 int n, int d, int dtype, float w_self, int k,
                                 const int* offsets, const float* weights,
                                 float beta, void* stream) {
  return neumann_unstaged(h, hvp, p, dsc, out, n, d, dtype, w_self, k,
                          offsets, weights, beta, solo_axis(d, 0), stream);
}

// The same step on a serve bucket's job axis: dsc (n, jobs), betas a
// (jobs,) device table, d = jobs * djob.
extern "C" int circulant_neumann_jobs(const void* h, const void* hvp,
                                      const void* p, const float* dsc,
                                      void* out, int n, int d, int dtype,
                                      float w_self, int k, const int* offsets,
                                      const float* weights,
                                      const float* betas, int jobs, int djob,
                                      void* stream) {
  JobAxis ja;
  if (betas == nullptr || !job_axis(jobs, djob, d, betas, nullptr, &ja)) {
    return (int)cudaErrorInvalidValue;
  }
  return neumann_unstaged(h, hvp, p, dsc, out, n, d, dtype, w_self, k,
                          offsets, weights, 0.0f, ja, stream);
}

// Comm-fused entry points, f32 only.  zp/scale: (n,) per-row metadata;
// hat/pay: the EF replica and the payload output, both nullptr without EF;
// seed: the send's seed, as an unsigned 32-bit value; levels = 2^bits - 1.
static Wire make_wire(const float* zp, const float* scale, const float* hat,
                      unsigned int seed, float levels) {
  return Wire{zp, scale, hat, seed * 0xC2B2AE3Du, levels};
}

// The threads of a decoded-stripe block with `smem_bytes` of shared
// memory: the fewest of 256, 512 and 1024 that put 1024 threads on each
// SM (256 at n = 16, 512 at n = 128, 1024 where the stripe leaves one
// block per SM).
template <typename Kernel>
cudaError_t stripe_comm_threads(Kernel kernel, int smem_bytes,
                                int* threads) {
  for (*threads = 256; *threads < kStripeCommMaxThreads; *threads *= 2) {
    int per_sm = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, *threads, smem_bytes);
    if (err != cudaSuccess) return err;
    if (per_sm * *threads >= 1024) break;
  }
  return cudaSuccess;
}

// Launches a decoded-stripe kernel over the ceil(d / bc) stripes of bc
// columns; `args` are its arguments before the copy, hat and store
// widths, which are picked here from the pointers.
template <typename Kernel, typename... Args>
int launch_stripe_comm(Kernel kernel, const float* y, const float* out,
                       const float* pay, const float* hat, int d, int bc,
                       int smem_bytes, cudaStream_t s, Args... args) {
  int threads = 0;
  cudaError_t err = allow_smem(kernel, smem_bytes);
  if (err != cudaSuccess ||
      (err = stripe_comm_threads(kernel, smem_bytes, &threads)) !=
          cudaSuccess) {
    return (int)err;
  }
  const int cw = vec_bytes(y, y, d, 4, 16);
  const int hw = hat ? vec_bytes(hat, hat, d, 4, 16) : 16;
  const int sw = vec_bytes(out, pay ? pay : out, d, 4, 16);
  kernel<<<(d + bc - 1) / bc, threads, smem_bytes, s>>>(
      args..., cw, hw, sw);
  return (int)cudaGetLastError();
}

// The decoded stripe's row bytes RB for a launch of stripe_cols columns
// at n rows and smem_bytes of shared memory, or 0 when the size is not
// one the kernels take (stripe_cols 128, 64, 32, 16, 8 or 4 and
// smem_bytes n * stripe_cols * 4, within what a block may use).
static int stripe_comm_row_bytes(int n, int stripe_cols, int smem_bytes) {
  const long long rb = 4LL * stripe_cols;
  if (rb < 16 || rb > 512 || (rb & (rb - 1)) || smem_bytes > kSmemOptIn ||
      smem_bytes != (long long)n * rb) {
    return 0;
  }
  return (int)rb;
}

// stripe_cols: the decoded stripe's width bc and smem_bytes n * bc * 4
// for the stripe kernels; 0 (and 0 bytes) for the unstaged kernels.
static int mix_comm_circ(const float* y, float* out, float* pay,
                         const float* hat, const float* zp,
                         const float* scale, const JobAxis& ja,
                         float levels, int n, int d, float w_self, int k,
                         const int* offsets, const float* weights,
                         int laplacian, int stripe_cols, int smem_bytes,
                         void* stream) {
  if ((hat == nullptr) != (pay == nullptr)) return (int)cudaErrorInvalidValue;
  const Circ c{w_self, k, offsets, weights};
  const Wire w = make_wire(zp, scale, hat, 0u, levels);
  cudaStream_t s = (cudaStream_t)stream;
  if (stripe_cols == 0) {
    if (smem_bytes != 0) return (int)cudaErrorInvalidValue;
    circulant_mix_comm_unstaged_kernel<<<grid_for(n, d), kThreads, 0, s>>>(
        y, out, pay, n, d, c, w, laplacian, ja);
    return (int)cudaGetLastError();
  }
  const auto go = [&](auto kernel) {
    return launch_stripe_comm(kernel, y, out, pay, hat, d, stripe_cols,
                              smem_bytes, s, y, out, pay, n, d, c, w,
                              laplacian, ja);
  };
  switch (stripe_comm_row_bytes(n, stripe_cols, smem_bytes)) {
    case 512: return go(circulant_mix_stripe_comm_kernel<512>);
    case 256: return go(circulant_mix_stripe_comm_kernel<256>);
    case 128: return go(circulant_mix_stripe_comm_kernel<128>);
    case 64: return go(circulant_mix_stripe_comm_kernel<64>);
    case 32: return go(circulant_mix_stripe_comm_kernel<32>);
    case 16: return go(circulant_mix_stripe_comm_kernel<16>);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int circulant_mix_comm(const float* y, float* out, float* pay,
                                  const float* hat, const float* zp,
                                  const float* scale, unsigned int seed,
                                  float levels, int n, int d, float w_self,
                                  int k, const int* offsets,
                                  const float* weights, int laplacian,
                                  int stripe_cols, int smem_bytes,
                                  void* stream) {
  return mix_comm_circ(y, out, pay, hat, zp, scale, solo_axis(d, seed),
                       levels, n, d, w_self, k, offsets, weights, laplacian,
                       stripe_cols, smem_bytes, stream);
}

// The comm-fused entry points on a serve bucket's job axis: zp/scale
// (n, jobs) tables, seeds a host array of the jobs' send seeds, d = jobs
// * djob; otherwise as their solo twins.
extern "C" int circulant_mix_comm_jobs(
    const float* y, float* out, float* pay, const float* hat,
    const float* zp, const float* scale, const unsigned int* seeds,
    int jobs, int djob, float levels, int n, int d, float w_self, int k,
    const int* offsets, const float* weights, int laplacian,
    int stripe_cols, int smem_bytes, void* stream) {
  JobAxis ja;
  if (seeds == nullptr || !job_axis(jobs, djob, d, nullptr, seeds, &ja)) {
    return (int)cudaErrorInvalidValue;
  }
  return mix_comm_circ(y, out, pay, hat, zp, scale, ja, levels, n, d,
                       w_self, k, offsets, weights, laplacian, stripe_cols,
                       smem_bytes, stream);
}

static int mix_comm_sparse(const float* y, float* out, float* pay,
                           const float* hat, const float* zp,
                           const float* scale, const JobAxis& ja,
                           float levels, const float* w_self,
                           const int* nbr, const float* wts, int n, int d,
                           int k, int laplacian, int stripe_cols,
                           int smem_bytes, void* stream) {
  if ((hat == nullptr) != (pay == nullptr)) return (int)cudaErrorInvalidValue;
  const Wire w = make_wire(zp, scale, hat, 0u, levels);
  cudaStream_t s = (cudaStream_t)stream;
  if (stripe_cols == 0) {
    if (smem_bytes != 0) return (int)cudaErrorInvalidValue;
    sparse_mix_comm_unstaged_kernel<<<grid_for(n, d), kThreads, 0, s>>>(
        y, out, pay, w_self, nbr, wts, n, d, k, w, laplacian, ja);
    return (int)cudaGetLastError();
  }
  const auto go = [&](auto kernel) {
    return launch_stripe_comm(kernel, y, out, pay, hat, d, stripe_cols,
                              smem_bytes, s, y, out, pay, w_self, nbr, wts,
                              n, d, k, w, laplacian, ja);
  };
  switch (stripe_comm_row_bytes(n, stripe_cols, smem_bytes)) {
    case 512: return go(sparse_mix_stripe_comm_kernel<512>);
    case 256: return go(sparse_mix_stripe_comm_kernel<256>);
    case 128: return go(sparse_mix_stripe_comm_kernel<128>);
    case 64: return go(sparse_mix_stripe_comm_kernel<64>);
    case 32: return go(sparse_mix_stripe_comm_kernel<32>);
    case 16: return go(sparse_mix_stripe_comm_kernel<16>);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int sparse_mix_comm(const float* y, float* out, float* pay,
                               const float* hat, const float* zp,
                               const float* scale, unsigned int seed,
                               float levels, const float* w_self,
                               const int* nbr, const float* wts, int n,
                               int d, int k, int laplacian, int stripe_cols,
                               int smem_bytes, void* stream) {
  return mix_comm_sparse(y, out, pay, hat, zp, scale, solo_axis(d, seed),
                         levels, w_self, nbr, wts, n, d, k, laplacian,
                         stripe_cols, smem_bytes, stream);
}

extern "C" int sparse_mix_comm_jobs(
    const float* y, float* out, float* pay, const float* hat,
    const float* zp, const float* scale, const unsigned int* seeds,
    int jobs, int djob, float levels, const float* w_self, const int* nbr,
    const float* wts, int n, int d, int k, int laplacian, int stripe_cols,
    int smem_bytes, void* stream) {
  JobAxis ja;
  if (seeds == nullptr || !job_axis(jobs, djob, d, nullptr, seeds, &ja)) {
    return (int)cudaErrorInvalidValue;
  }
  return mix_comm_sparse(y, out, pay, hat, zp, scale, ja, levels, w_self,
                         nbr, wts, n, d, k, laplacian, stripe_cols,
                         smem_bytes, stream);
}

// stripe_cols, smem_bytes: the decoded stripe's width bc and n * bc * 4
// bytes (circulant_neumann_stripe_comm_kernel), or 0 and 0 for the
// unstaged kernel (circulant_neumann_comm_kernel).
static int neumann_comm(const float* h, const float* hvp, const float* p,
                        const float* dsc, float* out, const float* zp,
                        const float* scale, const JobAxis& ja, float levels,
                        int n, int d, float w_self, int k,
                        const int* offsets, const float* weights,
                        float beta, int stripe_cols, int smem_bytes,
                        void* stream) {
  const Circ c{w_self, k, offsets, weights};
  const Wire w = make_wire(zp, scale, nullptr, 0u, levels);
  cudaStream_t s = (cudaStream_t)stream;
  if (stripe_cols == 0) {
    if (smem_bytes != 0) return (int)cudaErrorInvalidValue;
    circulant_neumann_comm_kernel<<<grid_for(n, d), kThreads, 0, s>>>(
        h, hvp, p, dsc, out, n, d, c, w, beta, ja);
    return (int)cudaGetLastError();
  }
  const int ew = vec_bytes(hvp, p, d, 4, 16);
  const auto go = [&](auto kernel) {
    return launch_stripe_comm(kernel, h, out, nullptr, nullptr, d,
                              stripe_cols, smem_bytes, s, h, hvp, p, dsc,
                              out, n, d, c, w, beta, ew, ja);
  };
  switch (stripe_comm_row_bytes(n, stripe_cols, smem_bytes)) {
    case 512: return go(circulant_neumann_stripe_comm_kernel<512>);
    case 256: return go(circulant_neumann_stripe_comm_kernel<256>);
    case 128: return go(circulant_neumann_stripe_comm_kernel<128>);
    case 64: return go(circulant_neumann_stripe_comm_kernel<64>);
    case 32: return go(circulant_neumann_stripe_comm_kernel<32>);
    case 16: return go(circulant_neumann_stripe_comm_kernel<16>);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int circulant_neumann_comm(const float* h, const float* hvp,
                                      const float* p, const float* dsc,
                                      float* out, const float* zp,
                                      const float* scale, unsigned int seed,
                                      float levels, int n, int d,
                                      float w_self, int k,
                                      const int* offsets,
                                      const float* weights, float beta,
                                      int stripe_cols, int smem_bytes,
                                      void* stream) {
  return neumann_comm(h, hvp, p, dsc, out, zp, scale, solo_axis(d, seed),
                      levels, n, d, w_self, k, offsets, weights, beta,
                      stripe_cols, smem_bytes, stream);
}

// dsc (n, jobs), betas a (jobs,) device table, zp/scale (n, jobs),
// seeds a host array of the jobs' send seeds.
extern "C" int circulant_neumann_comm_jobs(
    const float* h, const float* hvp, const float* p, const float* dsc,
    float* out, const float* zp, const float* scale,
    const unsigned int* seeds, int jobs, int djob, float levels, int n,
    int d, float w_self, int k, const int* offsets, const float* weights,
    const float* betas, int stripe_cols, int smem_bytes, void* stream) {
  JobAxis ja;
  if (seeds == nullptr || betas == nullptr ||
      !job_axis(jobs, djob, d, betas, seeds, &ja)) {
    return (int)cudaErrorInvalidValue;
  }
  return neumann_comm(h, hvp, p, dsc, out, zp, scale, ja, levels, n, d,
                      w_self, k, offsets, weights, 0.0f, stripe_cols,
                      smem_bytes, stream);
}

// Halo entry points.  soff: (k,) int32 signed offsets, each in
// [-h_lo, h_hi]; weights (k,) f32; bn | n; smem_bytes as halo_smem_bytes
// for the rows the kernel stages (the extended tile on the circulant, the
// own rows on the sparse gather).
// The staged circulant kernel for (T, V): its shared memory opted in, and
// gridDim.y cut to the column tiles that, beside the grid's n/bn row
// tiles, fill the card once (each block then walks several tiles).
template <typename T, int V>
int launch_circ_halo(const void* y, void* out, int n, int d, float w_self,
                     int k, const int* soff, const float* weights,
                     int laplacian, int bn, int h_lo, int h_hi, int stages,
                     int smem_bytes, dim3 grid, cudaStream_t s) {
  const auto kernel = circulant_mix_halo_kernel<T, V>;
  const cudaError_t err = fill_card(kernel, kHaloThreads, smem_bytes, &grid);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kHaloThreads, smem_bytes, s>>>(
      (const T*)y, (T*)out, n, d, bn, h_lo, h_hi, w_self, k, soff, weights,
      laplacian, stages);
  return (int)cudaGetLastError();
}

extern "C" int circulant_mix_halo(const void* y, void* out, int n, int d,
                                  int dtype, float w_self, int k,
                                  const int* soff, const float* weights,
                                  int laplacian, int bn, int h_lo, int h_hi,
                                  int stages, int smem_bytes, void* stream) {
  dim3 grid;
  if ((dtype != 0 && dtype != 1) || stages < 1 || stages > kHaloStages ||
      !halo_launch(n, d, bn, h_lo, h_hi, dtype == 0 ? 4 : 2, stages,
                   smem_bytes, &grid)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const auto args = [&](auto launch) {
    return launch(y, out, n, d, w_self, k, soff, weights, laplacian, bn,
                  h_lo, h_hi, stages, smem_bytes, grid, s);
  };
  if (dtype == 0) {
    switch (vec_bytes(y, out, d, 4, 16)) {
      case 16: return args(launch_circ_halo<float, 16>);
      case 8: return args(launch_circ_halo<float, 8>);
      default: return args(launch_circ_halo<float, 4>);
    }
  }
  switch (vec_bytes(y, out, d, 2, 16)) {
    case 16: return args(launch_circ_halo<__nv_bfloat16, 16>);
    case 8: return args(launch_circ_halo<__nv_bfloat16, 8>);
    case 4: return args(launch_circ_halo<__nv_bfloat16, 4>);
    default: return args(launch_circ_halo<__nv_bfloat16, 2>);
  }
}

// The staged Neumann kernel for (T, V), sized as launch_circ_halo.
template <typename T, int V>
int launch_neumann_ring(const void* h, const void* hvp, const void* p,
                        const float* dsc, void* out, int n, int d,
                        float w_self, int k, const int* soff,
                        const float* weights, float beta, int bn, int h_lo,
                        int h_hi, int stages, int smem_bytes, dim3 grid,
                        cudaStream_t s, const JobAxis& ja) {
  const auto kernel = circulant_neumann_ring_kernel<T, V>;
  const cudaError_t err = fill_card(kernel, kHaloThreads, smem_bytes, &grid);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kHaloThreads, smem_bytes, s>>>(
      (const T*)h, (const T*)hvp, (const T*)p, dsc, (T*)out, n, d, bn, h_lo,
      h_hi, w_self, k, soff, weights, beta, stages, ja);
  return (int)cudaGetLastError();
}

// The Neumann step on the circulant ring: soff/weights the signed (k,)
// device tables of the halo kernels; bn | n, h_lo, h_hi <= bn; stages in
// [1, kHaloStages] and smem_bytes = stages * (h_lo + 3 bn + h_hi) * 128 *
// itemsize, as neumann_ring_plan sizes them (refused otherwise).
static int neumann_ring(const void* h, const void* hvp, const void* p,
                        const float* dsc, void* out, int n, int d, int dtype,
                        float w_self, int k, const int* soff,
                        const float* weights, float beta, int bn, int h_lo,
                        int h_hi, int stages, int smem_bytes,
                        const JobAxis& ja, void* stream) {
  dim3 grid;
  if ((dtype != 0 && dtype != 1) || stages < 1 || stages > kHaloStages ||
      !halo_launch(n, d, bn, h_lo, h_hi, dtype == 0 ? 4 : 2, stages,
                   smem_bytes, &grid, 2)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const auto args = [&](auto launch) {
    return launch(h, hvp, p, dsc, out, n, d, w_self, k, soff, weights, beta,
                  bn, h_lo, h_hi, stages, smem_bytes, grid, s, ja);
  };
  if (dtype == 0) {
    switch (vec_bytes(h, out, d, 4, vec_bytes(hvp, p, d, 4, 16))) {
      case 16: return args(launch_neumann_ring<float, 16>);
      case 8: return args(launch_neumann_ring<float, 8>);
      default: return args(launch_neumann_ring<float, 4>);
    }
  }
  switch (vec_bytes(h, out, d, 2, vec_bytes(hvp, p, d, 2, 16))) {
    case 16: return args(launch_neumann_ring<__nv_bfloat16, 16>);
    case 8: return args(launch_neumann_ring<__nv_bfloat16, 8>);
    case 4: return args(launch_neumann_ring<__nv_bfloat16, 4>);
    default: return args(launch_neumann_ring<__nv_bfloat16, 2>);
  }
}

extern "C" int circulant_neumann_ring(const void* h, const void* hvp,
                                      const void* p, const float* dsc,
                                      void* out, int n, int d, int dtype,
                                      float w_self, int k, const int* soff,
                                      const float* weights, float beta,
                                      int bn, int h_lo, int h_hi, int stages,
                                      int smem_bytes, void* stream) {
  return neumann_ring(h, hvp, p, dsc, out, n, d, dtype, w_self, k, soff,
                      weights, beta, bn, h_lo, h_hi, stages, smem_bytes,
                      solo_axis(d, 0), stream);
}

// The ring's step on a serve bucket's job axis: dsc (n, jobs), betas a
// (jobs,) device table, d = jobs * djob.
extern "C" int circulant_neumann_ring_jobs(
    const void* h, const void* hvp, const void* p, const float* dsc,
    void* out, int n, int d, int dtype, float w_self, int k,
    const int* soff, const float* weights, const float* betas, int jobs,
    int djob, int bn, int h_lo, int h_hi, int stages, int smem_bytes,
    void* stream) {
  JobAxis ja;
  if (betas == nullptr || !job_axis(jobs, djob, d, betas, nullptr, &ja)) {
    return (int)cudaErrorInvalidValue;
  }
  return neumann_ring(h, hvp, p, dsc, out, n, d, dtype, w_self, k, soff,
                      weights, 0.0f, bn, h_lo, h_hi, stages, smem_bytes, ja,
                      stream);
}

template <int V>
int launch_circ_halo_comm(const float* y, float* out, float* pay, int n,
                          int d, float w_self, int k, const int* soff,
                          const float* weights, Wire w, int laplacian,
                          int bn, int h_lo, int h_hi, int stages,
                          int smem_bytes, dim3 grid, cudaStream_t s,
                          const JobAxis& ja) {
  const auto kernel = circulant_mix_halo_comm_kernel<V>;
  const cudaError_t err =
      fill_card(kernel, kHaloCommThreads, smem_bytes, &grid);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kHaloCommThreads, smem_bytes, s>>>(
      y, out, pay, n, d, bn, h_lo, h_hi, w_self, k, soff, weights, w,
      laplacian, stages, ja);
  return (int)cudaGetLastError();
}

static int mix_halo_comm_circ(const float* y, float* out, float* pay,
                              const float* hat, const float* zp,
                              const float* scale, const JobAxis& ja,
                              float levels, int n, int d, float w_self,
                              int k, const int* soff, const float* weights,
                              int laplacian, int bn, int h_lo, int h_hi,
                              int stages, int smem_bytes, void* stream) {
  const bool ef = hat != nullptr;
  dim3 grid;
  if ((hat == nullptr) != (pay == nullptr) || stages < 1 ||
      stages > (ef ? kHaloCommEfStages : kHaloStages) ||
      !halo_launch(n, d, bn, h_lo, h_hi, 4, stages * (1 + ef) + 1,
                   smem_bytes, &grid)) {
    return (int)cudaErrorInvalidValue;
  }
  const auto args = [&](auto launch) {
    return launch(y, out, pay, n, d, w_self, k, soff, weights,
                  make_wire(zp, scale, hat, 0u, levels), laplacian, bn,
                  h_lo, h_hi, stages, smem_bytes, grid,
                  (cudaStream_t)stream, ja);
  };
  const int v = vec_bytes(y, out, d, 4, 16);
  const int v_ef = ef ? vec_bytes(hat, pay, d, 4, 16) : 16;
  switch (v < v_ef ? v : v_ef) {
    case 16: return args(launch_circ_halo_comm<16>);
    case 8: return args(launch_circ_halo_comm<8>);
    default: return args(launch_circ_halo_comm<4>);
  }
}

// stages: the ring's raw stages, 1..3 without EF, 1..2 with; smem_bytes
// the stages' tiles (two per stage under EF) and the decoded tile.
extern "C" int circulant_mix_halo_comm(
    const float* y, float* out, float* pay, const float* hat,
    const float* zp, const float* scale, unsigned int seed, float levels,
    int n, int d, float w_self, int k, const int* soff,
    const float* weights, int laplacian, int bn, int h_lo, int h_hi,
    int stages, int smem_bytes, void* stream) {
  return mix_halo_comm_circ(y, out, pay, hat, zp, scale,
                            solo_axis(d, seed), levels, n, d, w_self, k,
                            soff, weights, laplacian, bn, h_lo, h_hi,
                            stages, smem_bytes, stream);
}

// The fused halo gossips on a serve bucket's job axis: zp/scale (n, jobs)
// tables, seeds a host array of the jobs' send seeds, d = jobs * djob;
// otherwise as their solo twins.
extern "C" int circulant_mix_halo_comm_jobs(
    const float* y, float* out, float* pay, const float* hat,
    const float* zp, const float* scale, const unsigned int* seeds,
    int jobs, int djob, float levels, int n, int d, float w_self, int k,
    const int* soff, const float* weights, int laplacian, int bn, int h_lo,
    int h_hi, int stages, int smem_bytes, void* stream) {
  JobAxis ja;
  if (seeds == nullptr || !job_axis(jobs, djob, d, nullptr, seeds, &ja)) {
    return (int)cudaErrorInvalidValue;
  }
  return mix_halo_comm_circ(y, out, pay, hat, zp, scale, ja, levels, n, d,
                            w_self, k, soff, weights, laplacian, bn, h_lo,
                            h_hi, stages, smem_bytes, stream);
}

template <typename T, int C>
int launch_plain_slab(const void* y, void* out, const float* w_self,
                      const int* nbr, const float* wts, const int* order,
                      const int* deg, int n, int d, int k, int laplacian,
                      int smem_bytes, cudaStream_t s) {
  const auto kernel = sparse_mix_slab_kernel<T, C>;
  const cudaError_t err = allow_smem(kernel, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  constexpr int RB = C * (int)sizeof(T), VB = RB < 16 ? RB : 16;
  const int cw = vec_bytes(y, y, d, (int)sizeof(T), VB);
  const int sw = vec_bytes(out, out, d, (int)sizeof(T), VB);
  const int nslab = (d + C - 1) / C;
  kernel<<<nslab, kSlabThreads, smem_bytes, s>>>(
      (const T*)y, (T*)out, w_self, nbr, wts, order, deg, n, d, k, cw, sw,
      laplacian);
  return (int)cudaGetLastError();
}

// slab_cols: the plain slab's width C (1, 2, 4, 8 for f32; 2, 4, 8, 16
// for bf16) and smem_bytes slab_smem_bytes(n, C, itemsize) for
// sparse_mix_slab_kernel, with the row plan (order, deg: (n,) int32 on
// the device, or both null for the natural order and deg = k); 0 for the
// row-tiled kernel, with smem_bytes for its (bn, 128) tile (no plan).
// bn | n either way (the wrapper keeps repro's checks).
extern "C" int sparse_mix_halo(const void* y, void* out, const float* w_self,
                               const int* nbr, const float* wts,
                               const int* order, const int* deg, int n,
                               int d, int k, int dtype, int laplacian,
                               int bn, int slab_cols, int smem_bytes,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int itemsize = dtype == 0 ? 4 : 2;
  if ((dtype != 0 && dtype != 1) || (order == nullptr) != (deg == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (slab_cols != 0) {
    if (bn < 1 || n % bn ||
        smem_bytes != slab_smem_bytes(n, slab_cols, itemsize)) {
      return (int)cudaErrorInvalidValue;
    }
    const auto args = [&](auto launch) {
      return launch(y, out, w_self, nbr, wts, order, deg, n, d, k,
                    laplacian, smem_bytes, s);
    };
    if (dtype == 0) {
      switch (slab_cols) {
        case 8: return args(launch_plain_slab<float, 8>);
        case 4: return args(launch_plain_slab<float, 4>);
        case 2: return args(launch_plain_slab<float, 2>);
        case 1: return args(launch_plain_slab<float, 1>);
        default: return (int)cudaErrorInvalidValue;
      }
    }
    switch (slab_cols) {
      case 16: return args(launch_plain_slab<__nv_bfloat16, 16>);
      case 8: return args(launch_plain_slab<__nv_bfloat16, 8>);
      case 4: return args(launch_plain_slab<__nv_bfloat16, 4>);
      case 2: return args(launch_plain_slab<__nv_bfloat16, 2>);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  dim3 grid;
  if (order != nullptr ||
      !halo_launch(n, d, bn, 0, 0, itemsize, 1, smem_bytes, &grid)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err;
  if (dtype == 0) {
    err = allow_smem(sparse_mix_halo_kernel<float>, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    sparse_mix_halo_kernel<float><<<grid, kHaloThreads, smem_bytes, s>>>(
        (const float*)y, (float*)out, w_self, nbr, wts, n, d, k, bn,
        laplacian);
  } else {
    err = allow_smem(sparse_mix_halo_kernel<__nv_bfloat16>, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    sparse_mix_halo_kernel<__nv_bfloat16>
        <<<grid, kHaloThreads, smem_bytes, s>>>(
            (const __nv_bfloat16*)y, (__nv_bfloat16*)out, w_self, nbr, wts,
            n, d, k, bn, laplacian);
  }
  return (int)cudaGetLastError();
}

template <int C>
int launch_slab(const float* y, float* out, const float* w_self,
                const int* nbr, const float* wts, int n, int d, int k,
                Wire w, int laplacian, int smem_bytes, cudaStream_t s,
                const JobAxis& ja) {
  const cudaError_t err =
      allow_smem(sparse_mix_slab_comm_kernel<C>, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int nslab = (d + C - 1) / C;
  sparse_mix_slab_comm_kernel<C><<<nslab, kSlabThreads, smem_bytes, s>>>(
      y, out, w_self, nbr, wts, n, d, k, w, laplacian, ja);
  return (int)cudaGetLastError();
}

static int mix_halo_comm_sparse(const float* y, float* out,
                                const float* zp, const float* scale,
                                const JobAxis& ja, float levels,
                                const float* w_self, const int* nbr,
                                const float* wts, int n, int d, int k,
                                int laplacian, int bn, int slab_cols,
                                int smem_bytes, void* stream) {
  const Wire w = make_wire(zp, scale, nullptr, 0u, levels);
  cudaStream_t s = (cudaStream_t)stream;
  if (slab_cols != 0) {
    if (bn < 1 || n % bn || smem_bytes != slab_smem_bytes(n, slab_cols)) {
      return (int)cudaErrorInvalidValue;
    }
    const auto args = [&](auto launch) {
      return launch(y, out, w_self, nbr, wts, n, d, k, w, laplacian,
                    smem_bytes, s, ja);
    };
    switch (slab_cols) {
      case 8: return args(launch_slab<8>);
      case 4: return args(launch_slab<4>);
      case 2: return args(launch_slab<2>);
      case 1: return args(launch_slab<1>);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  dim3 grid;
  if (!halo_launch(n, d, bn, 0, 0, 4, 1, smem_bytes, &grid)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = allow_smem(sparse_mix_halo_comm_kernel,
                                     smem_bytes);
  if (err != cudaSuccess) return (int)err;
  sparse_mix_halo_comm_kernel<<<grid, kHaloThreads, smem_bytes, s>>>(
      y, out, w_self, nbr, wts, n, d, k, bn, w, laplacian, ja);
  return (int)cudaGetLastError();
}

// slab_cols: the column slab's width C in {1, 2, 4, 8} and smem_bytes
// slab_smem_bytes(n, C) for sparse_mix_slab_comm_kernel; 0 for the
// row-tiled kernel, with smem_bytes for its (bn, 128) tile.  bn | n either
// way (the wrapper keeps repro's checks).
extern "C" int sparse_mix_halo_comm(const float* y, float* out,
                                    const float* zp, const float* scale,
                                    unsigned int seed, float levels,
                                    const float* w_self, const int* nbr,
                                    const float* wts, int n, int d, int k,
                                    int laplacian, int bn, int slab_cols,
                                    int smem_bytes, void* stream) {
  return mix_halo_comm_sparse(y, out, zp, scale, solo_axis(d, seed),
                              levels, w_self, nbr, wts, n, d, k, laplacian,
                              bn, slab_cols, smem_bytes, stream);
}

extern "C" int sparse_mix_halo_comm_jobs(
    const float* y, float* out, const float* zp, const float* scale,
    const unsigned int* seeds, int jobs, int djob, float levels,
    const float* w_self, const int* nbr, const float* wts, int n, int d,
    int k, int laplacian, int bn, int slab_cols, int smem_bytes,
    void* stream) {
  JobAxis ja;
  if (seeds == nullptr || !job_axis(jobs, djob, d, nullptr, seeds, &ja)) {
    return (int)cudaErrorInvalidValue;
  }
  return mix_halo_comm_sparse(y, out, zp, scale, ja, levels, w_self, nbr,
                              wts, n, d, k, laplacian, bn, slab_cols,
                              smem_bytes, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
