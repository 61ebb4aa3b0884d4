// Gossip mat-vecs on stacked per-agent state Y (n agents x d features),
// the only cross-agent operations of DAGM (Algorithm 2):
//
//   circulant_mix      W.Y or (I-W).Y for shift-invariant W (ring, circulant)
//   sparse_mix         W.Y or (I-W).Y for any W from padded (n, k) tables
//   circulant_neumann  one DIHGP Neumann iteration (Eq. 14) fused with W.h
//
// and their comm-fused twins, which gossip an int8/int4 stochastically
// quantized payload instead of Y (compressed gossip, comm="int8|int4[+ef]"):
//
//   circulant_mix_comm, sparse_mix_comm   (+ EF: also write the payload)
//   circulant_neumann_comm                (no EF)
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

// Replaces repro/kernels/mixing_matvec.py:circulant_mix_matvec (plain
// path, _mix_body).
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
// _sparse_body).
// Bound: bytes, as circulant_mix (2(k+1) FLOP per element; the (n, k)
// tables are a few hundred bytes next to Y).
// Design: the same thread layout.  A block works on one row i, so all
// its threads read the same k indices and weights (one broadcast each)
// and then k coalesced neighbor-row segments.  Padded slots point at
// row i with weight 0 and add 0, as in repro's padded reference.
template <typename T>
__global__ void sparse_mix_kernel(const T* __restrict__ y,
                                  T* __restrict__ out,
                                  const float* __restrict__ w_self,
                                  const int* __restrict__ nbr,
                                  const float* __restrict__ wts, int n,
                                  int d, int k, int laplacian) {
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
// path, _neumann_body).
// Bound: bytes: reads h, hvp_h and p once and writes h+, with
// 2(k+1) + 6 FLOP per element.
// Design: circulant_mix's layout; the mix stays in a register and the
// Eq. 14 update (D*h - (h - mix) - beta*hvp - p) / D is applied in the
// same thread (`neumann_update`), dividing as repro does.  beta is a
// runtime scalar.
template <typename T>
__global__ void circulant_neumann_kernel(const T* __restrict__ h,
                                         const T* __restrict__ hvp,
                                         const T* __restrict__ p,
                                         const float* __restrict__ dsc,
                                         T* __restrict__ out, int n, int d,
                                         Circ c, float beta) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= d) return;
  for (int i = blockIdx.y; i < n; i += gridDim.y) {
    const size_t at = (size_t)i * d + j;
    const float hi = load_f32(h, at);
    float mix = __fmul_rn(c.w_self, hi);
    for (int t = 0; t < c.k; ++t) {
      int src = i + __ldg(c.off + t);
      if (src >= n) src -= n;
      mix = term(mix, __ldg(c.w + t), load_f32(h, (size_t)src * d + j));
    }
    const float di = dsc[i];
    store_f32(out, at, neumann_update(hi, mix, load_f32(hvp, at),
                                      load_f32(p, at), di, beta));
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

// The decoded broadcast of element (r, j) of y (n x d, f32).
__device__ __forceinline__ float decoded(const float* __restrict__ y,
                                         const Wire& w, int r, int j,
                                         int d) {
  const size_t at = (size_t)r * d + j;
  const float u = hash_uniform(w.smix, r, j);
  const float h = w.hat ? w.hat[at] : 0.0f;
  const float x = w.hat ? __fsub_rn(y[at], h) : y[at];
  const float dec = roundtrip(x, w.zp[r], w.scale[r], u, w.levels);
  return w.hat ? __fadd_rn(h, dec) : dec;
}

// Replaces repro/kernels/mixing_matvec.py:circulant_mix_matvec with comm=
// (_mix_fused_body).
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
__global__ void circulant_mix_comm_kernel(const float* __restrict__ y,
                                          float* __restrict__ out,
                                          float* __restrict__ pay, int n,
                                          int d, Circ c, Wire w,
                                          int laplacian) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= d) return;
  for (int i = blockIdx.y; i < n; i += gridDim.y) {
    const size_t at = (size_t)i * d + j;
    const float yi = y[at];
    float acc = __fmul_rn(c.w_self, yi);
    for (int t = 0; t < c.k; ++t) {
      int src = i + __ldg(c.off + t);
      if (src >= n) src -= n;
      acc = term(acc, __ldg(c.w + t), decoded(y, w, src, j, d));
    }
    if (laplacian) acc = __fsub_rn(yi, acc);
    out[at] = acc;
    if (pay) pay[at] = decoded(y, w, i, j, d);
  }
}

// Replaces repro/kernels/mixing_matvec.py:sparse_mix_matvec with comm=
// (_sparse_fused_body).
// Bound: as circulant_mix_comm_kernel.  Each gathered row is decoded with
// its own source row's zp/scale, as the wire carries it.
// Design: sparse_mix_kernel's layout; as in the circulant kernel each
// thread recomputes its k neighbors' decoded values, so the kernel does k
// hashes per element where the work needs one: at ER's k = 13 that
// integer work, not the bytes, sets its time.
__global__ void sparse_mix_comm_kernel(const float* __restrict__ y,
                                       float* __restrict__ out,
                                       float* __restrict__ pay,
                                       const float* __restrict__ w_self,
                                       const int* __restrict__ nbr,
                                       const float* __restrict__ wts, int n,
                                       int d, int k, Wire w, int laplacian) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= d) return;
  for (int i = blockIdx.y; i < n; i += gridDim.y) {
    const size_t at = (size_t)i * d + j;
    const float yi = y[at];
    float acc = __fmul_rn(w_self[i], yi);
    const int* ni = nbr + (size_t)i * k;
    const float* wi = wts + (size_t)i * k;
    for (int t = 0; t < k; ++t) {
      acc = term(acc, wi[t], decoded(y, w, ni[t], j, d));
    }
    if (laplacian) acc = __fsub_rn(yi, acc);
    out[at] = acc;
    if (pay) pay[at] = decoded(y, w, i, j, d);
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
    float* __restrict__ out, int n, int d, Circ c, Wire w, float beta) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= d) return;
  for (int i = blockIdx.y; i < n; i += gridDim.y) {
    const size_t at = (size_t)i * d + j;
    const float hi = h[at];
    float mix = __fmul_rn(c.w_self, hi);
    for (int t = 0; t < c.k; ++t) {
      int src = i + __ldg(c.off + t);
      if (src >= n) src -= n;
      mix = term(mix, __ldg(c.w + t), decoded(h, w, src, j, d));
    }
    const float di = dsc[i];
    out[at] = neumann_update(hi, mix, hvp[at], p[at], di, beta);
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

// Replaces repro/kernels/mixing_matvec.py:circulant_mix_matvec_halo (plain
// path, _circ_halo_body).
// Bound: bytes, as circulant_mix_kernel: one read of Y plus the halo rows
// (h_lo + h_hi of every bn, 2/128 on the ring at bn = 128) and one write.
// Design: the block stages its (h_lo + bn + h_hi, 128) tile in shared
// memory with coalesced row reads, synchronizes, and every thread mixes
// output elements from the tile: each staged element is read from device
// memory once however many neighbors use it, where the full-operand
// kernel reads it k + 1 times (through L2).
template <typename T>
__global__ void circulant_mix_halo_kernel(const T* __restrict__ y,
                                          T* __restrict__ out, int n, int d,
                                          int bn, int h_lo, int h_hi,
                                          float w_self, int k,
                                          const int* __restrict__ soff,
                                          const float* __restrict__ wts,
                                          int laplacian) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ext = reinterpret_cast<T*>(smem_raw);
  const int row0 = blockIdx.x * bn;
  const int ex = h_lo + bn + h_hi;
  const int ncol = (d + kHaloBd - 1) / kHaloBd;
  for (int ct = blockIdx.y; ct < ncol; ct += gridDim.y) {
    const int col0 = ct * kHaloBd;
    for (int t = threadIdx.x; t < ex * kHaloBd; t += blockDim.x) {
      const int j = col0 + t % kHaloBd;
      const int r = wrap_row(row0 - h_lo + t / kHaloBd, n);
      if (j < d) ext[t] = y[(size_t)r * d + j];
    }
    __syncthreads();
    for (int t = threadIdx.x; t < bn * kHaloBd; t += blockDim.x) {
      const int r = t / kHaloBd, c = t % kHaloBd, j = col0 + c;
      if (j >= d) continue;
      const float yi = load_f32(ext, (size_t)(h_lo + r) * kHaloBd + c);
      float acc = __fmul_rn(w_self, yi);
      for (int q = 0; q < k; ++q) {
        const int e = h_lo + r + __ldg(soff + q);
        acc = term(acc, __ldg(wts + q), load_f32(ext, (size_t)e * kHaloBd + c));
      }
      if (laplacian) acc = __fsub_rn(yi, acc);
      store_f32(out, (size_t)(row0 + r) * d + j, acc);
    }
    __syncthreads();
  }
}

// Replaces repro/kernels/mixing_matvec.py:circulant_mix_matvec_halo with
// comm= (_circ_halo_body, fused; repro's `pscr`).
// Bound: bytes, as circulant_mix_comm_kernel (one read of y, and hat under
// EF, one write of out, and the payload under EF), with the quantizer's
// ~30 operations per element.
// Design: the block quantizes its extended tile once into a shared
// payload buffer, one hash per staged element: (h_lo + bn + h_hi) / bn
// hashes per output element, 1.03 on the ring at bn = 64, where
// circulant_mix_comm_kernel recomputes k hashes per element (+1 under EF
// for the payload write): 2 on the ring, 3 with EF.  The mix then reads
// its neighbors from that buffer; the self term reads the exact y from
// device memory, and under EF the block writes its own rows' payload.
// `decoded` is the full-operand kernels' quantizer, so payloads agree bit
// for bit.
__global__ void circulant_mix_halo_comm_kernel(
    const float* __restrict__ y, float* __restrict__ out,
    float* __restrict__ pay, int n, int d, int bn, int h_lo, int h_hi,
    float w_self, int k, const int* __restrict__ soff,
    const float* __restrict__ wts, Wire w, int laplacian) {
  extern __shared__ __align__(16) float pext[];
  const int row0 = blockIdx.x * bn;
  const int ex = h_lo + bn + h_hi;
  const int ncol = (d + kHaloBd - 1) / kHaloBd;
  for (int ct = blockIdx.y; ct < ncol; ct += gridDim.y) {
    const int col0 = ct * kHaloBd;
    for (int t = threadIdx.x; t < ex * kHaloBd; t += blockDim.x) {
      const int j = col0 + t % kHaloBd;
      const int r = wrap_row(row0 - h_lo + t / kHaloBd, n);
      if (j < d) pext[t] = decoded(y, w, r, j, d);
    }
    __syncthreads();
    for (int t = threadIdx.x; t < bn * kHaloBd; t += blockDim.x) {
      const int r = t / kHaloBd, c = t % kHaloBd, j = col0 + c;
      if (j >= d) continue;
      const size_t at = (size_t)(row0 + r) * d + j;
      const float yi = y[at];
      float acc = __fmul_rn(w_self, yi);
      for (int q = 0; q < k; ++q) {
        const int e = h_lo + r + __ldg(soff + q);
        acc = term(acc, __ldg(wts + q), pext[e * kHaloBd + c]);
      }
      if (laplacian) acc = __fsub_rn(yi, acc);
      out[at] = acc;
      if (pay) pay[at] = pext[(h_lo + r) * kHaloBd + c];
    }
    __syncthreads();
  }
}

// Replaces repro/kernels/mixing_matvec.py:sparse_mix_matvec_halo (plain
// path, _sparse_halo_body).
// Bound: bytes, as sparse_mix_kernel.
// Design: the block stages its own (bn, 128) rows in shared memory (all
// of them in flight at once), then each thread gathers its element's k
// neighbor rows from device memory in table order, a warp reading 32
// consecutive columns of one neighbor row; the padded tables' slots that
// point at the row itself add 0, as in sparse_mix_kernel.
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
// Bound: as sparse_mix_comm_kernel.
// Design: sparse_mix_halo_kernel with each neighbor's value decoded from
// (seed, row, column) by `decoded`, k hashes per element as repro's
// per-neighbor _quantize.
__global__ void sparse_mix_halo_comm_kernel(
    const float* __restrict__ y, float* __restrict__ out,
    const float* __restrict__ w_self, const int* __restrict__ nbr,
    const float* __restrict__ wts, int n, int d, int k, int bn, Wire w,
    int laplacian) {
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
      for (int q = 0; q < k; ++q) {
        acc = term(acc, wi[q], decoded(y, w, ni[q], j, d));
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

int slab_smem_bytes(int n, int cols) {
  const long long b = (long long)slab_floats(n, cols) * 4 +
                      slab_stage_bytes(cols);
  return b > kSmemOptIn ? -1 : (int)b;
}

template <int C>
__global__ void __launch_bounds__(kSlabThreads)
    sparse_mix_slab_comm_kernel(const float* __restrict__ y,
                                float* __restrict__ out,
                                const float* __restrict__ w_self,
                                const int* __restrict__ nbr,
                                const float* __restrict__ wts, int n, int d,
                                int k, Wire w, int laplacian) {
  constexpr int VW = C < 4 ? C : 4;  // columns per lane
  constexpr int LPR = C / VW;        // lanes per row
  constexpr int RPW = slab_rows_per_warp(C);
  constexpr int KC = slab_slots(C), KS = KC + 4;
  constexpr int M = RPW * KC / 32;   // stage entries per lane and buffer
  constexpr int P4 = KC / 4;         // 16-byte pieces per staged row
  constexpr int M4 = RPW * P4 / 32;  // pieces per lane and buffer
  static_assert(RPW * LPR == 32 && M * 32 == RPW * KC && M4 * 32 == RPW * P4,
                "warp geometry");
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
#pragma unroll 4
    for (int e = tid; e < n * C; e += kSlabThreads) {
      const int r = e / C, j = c0 + e % C;
      if (j < d) {
        slab[e] = roundtrip(slab[e], w.zp[r], w.scale[r],
                            hash_uniform(w.smix, r, j), w.levels);
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

// Dynamic shared memory of a halo launch: `rows` staged rows of kHaloBd
// elements of `itemsize` bytes (the Python planner's halo_smem_bytes).
int halo_smem_bytes(int rows, int itemsize) {
  return rows * kHaloBd * itemsize;
}

// The launch geometry of a halo kernel, or false when the wrapper's tile
// or shared-memory size is not one the kernel takes.
bool halo_launch(int n, int d, int bn, int h_lo, int h_hi, int itemsize,
                 int smem_bytes, dim3* grid) {
  if (bn < 1 || n % bn || h_lo < 0 || h_hi < 0 || h_lo > bn || h_hi > bn ||
      smem_bytes > kSmemOptIn ||
      smem_bytes != halo_smem_bytes(h_lo + bn + h_hi, itemsize)) {
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

dim3 grid_for(int n, int d) {
  return dim3((d + kThreads - 1) / kThreads, n < kMaxGridRows ? n : kMaxGridRows);
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

// Neighbor indices must lie in [0, n).
extern "C" int sparse_mix(const void* y, void* out, const float* w_self,
                          const int* nbr, const float* wts, int n, int d,
                          int k, int dtype, int laplacian, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    sparse_mix_kernel<float><<<grid_for(n, d), kThreads, 0, s>>>(
        (const float*)y, (float*)out, w_self, nbr, wts, n, d, k, laplacian);
  } else if (dtype == 1) {
    sparse_mix_kernel<__nv_bfloat16><<<grid_for(n, d), kThreads, 0, s>>>(
        (const __nv_bfloat16*)y, (__nv_bfloat16*)out, w_self, nbr, wts, n,
        d, k, laplacian);
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
  const Circ c{w_self, k, offsets, weights};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    circulant_neumann_kernel<float><<<grid_for(n, d), kThreads, 0, s>>>(
        (const float*)h, (const float*)hvp, (const float*)p, dsc,
        (float*)out, n, d, c, beta);
  } else if (dtype == 1) {
    circulant_neumann_kernel<__nv_bfloat16>
        <<<grid_for(n, d), kThreads, 0, s>>>(
            (const __nv_bfloat16*)h, (const __nv_bfloat16*)hvp,
            (const __nv_bfloat16*)p, dsc, (__nv_bfloat16*)out, n, d, c,
            beta);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Comm-fused entry points, f32 only.  zp/scale: (n,) per-row metadata;
// hat/pay: the EF replica and the payload output, both nullptr without EF;
// seed: the send's seed, as an unsigned 32-bit value; levels = 2^bits - 1.
static Wire make_wire(const float* zp, const float* scale, const float* hat,
                      unsigned int seed, float levels) {
  return Wire{zp, scale, hat, seed * 0xC2B2AE3Du, levels};
}

extern "C" int circulant_mix_comm(const float* y, float* out, float* pay,
                                  const float* hat, const float* zp,
                                  const float* scale, unsigned int seed,
                                  float levels, int n, int d, float w_self,
                                  int k, const int* offsets,
                                  const float* weights, int laplacian,
                                  void* stream) {
  if ((hat == nullptr) != (pay == nullptr)) return (int)cudaErrorInvalidValue;
  const Circ c{w_self, k, offsets, weights};
  circulant_mix_comm_kernel<<<grid_for(n, d), kThreads, 0,
                              (cudaStream_t)stream>>>(
      y, out, pay, n, d, c, make_wire(zp, scale, hat, seed, levels),
      laplacian);
  return (int)cudaGetLastError();
}

extern "C" int sparse_mix_comm(const float* y, float* out, float* pay,
                               const float* hat, const float* zp,
                               const float* scale, unsigned int seed,
                               float levels, const float* w_self,
                               const int* nbr, const float* wts, int n,
                               int d, int k, int laplacian, void* stream) {
  if ((hat == nullptr) != (pay == nullptr)) return (int)cudaErrorInvalidValue;
  sparse_mix_comm_kernel<<<grid_for(n, d), kThreads, 0,
                           (cudaStream_t)stream>>>(
      y, out, pay, w_self, nbr, wts, n, d, k,
      make_wire(zp, scale, hat, seed, levels), laplacian);
  return (int)cudaGetLastError();
}

extern "C" int circulant_neumann_comm(const float* h, const float* hvp,
                                      const float* p, const float* dsc,
                                      float* out, const float* zp,
                                      const float* scale, unsigned int seed,
                                      float levels, int n, int d,
                                      float w_self, int k,
                                      const int* offsets,
                                      const float* weights, float beta,
                                      void* stream) {
  const Circ c{w_self, k, offsets, weights};
  circulant_neumann_comm_kernel<<<grid_for(n, d), kThreads, 0,
                                  (cudaStream_t)stream>>>(
      h, hvp, p, dsc, out, n, d, c,
      make_wire(zp, scale, nullptr, seed, levels), beta);
  return (int)cudaGetLastError();
}

// Halo entry points.  soff: (k,) int32 signed offsets, each in
// [-h_lo, h_hi]; weights (k,) f32; bn | n; smem_bytes as halo_smem_bytes
// for the rows the kernel stages (the extended tile on the circulant, the
// own rows on the sparse gather).
extern "C" int circulant_mix_halo(const void* y, void* out, int n, int d,
                                  int dtype, float w_self, int k,
                                  const int* soff, const float* weights,
                                  int laplacian, int bn, int h_lo, int h_hi,
                                  int smem_bytes, void* stream) {
  dim3 grid;
  if ((dtype != 0 && dtype != 1) ||
      !halo_launch(n, d, bn, h_lo, h_hi, dtype == 0 ? 4 : 2, smem_bytes,
                   &grid)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (dtype == 0) {
    err = allow_smem(circulant_mix_halo_kernel<float>, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    circulant_mix_halo_kernel<float><<<grid, kHaloThreads, smem_bytes, s>>>(
        (const float*)y, (float*)out, n, d, bn, h_lo, h_hi, w_self, k, soff,
        weights, laplacian);
  } else {
    err = allow_smem(circulant_mix_halo_kernel<__nv_bfloat16>, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    circulant_mix_halo_kernel<__nv_bfloat16>
        <<<grid, kHaloThreads, smem_bytes, s>>>(
            (const __nv_bfloat16*)y, (__nv_bfloat16*)out, n, d, bn, h_lo,
            h_hi, w_self, k, soff, weights, laplacian);
  }
  return (int)cudaGetLastError();
}

extern "C" int circulant_mix_halo_comm(
    const float* y, float* out, float* pay, const float* hat,
    const float* zp, const float* scale, unsigned int seed, float levels,
    int n, int d, float w_self, int k, const int* soff,
    const float* weights, int laplacian, int bn, int h_lo, int h_hi,
    int smem_bytes, void* stream) {
  dim3 grid;
  if ((hat == nullptr) != (pay == nullptr) ||
      !halo_launch(n, d, bn, h_lo, h_hi, 4, smem_bytes, &grid)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = allow_smem(circulant_mix_halo_comm_kernel,
                                     smem_bytes);
  if (err != cudaSuccess) return (int)err;
  circulant_mix_halo_comm_kernel<<<grid, kHaloThreads, smem_bytes,
                                   (cudaStream_t)stream>>>(
      y, out, pay, n, d, bn, h_lo, h_hi, w_self, k, soff, weights,
      make_wire(zp, scale, hat, seed, levels), laplacian);
  return (int)cudaGetLastError();
}

extern "C" int sparse_mix_halo(const void* y, void* out, const float* w_self,
                               const int* nbr, const float* wts, int n,
                               int d, int k, int dtype, int laplacian,
                               int bn, int smem_bytes, void* stream) {
  dim3 grid;
  if ((dtype != 0 && dtype != 1) ||
      !halo_launch(n, d, bn, 0, 0, dtype == 0 ? 4 : 2, smem_bytes, &grid)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
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
                Wire w, int laplacian, int smem_bytes, cudaStream_t s) {
  const cudaError_t err =
      allow_smem(sparse_mix_slab_comm_kernel<C>, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int nslab = (d + C - 1) / C;
  sparse_mix_slab_comm_kernel<C><<<nslab, kSlabThreads, smem_bytes, s>>>(
      y, out, w_self, nbr, wts, n, d, k, w, laplacian);
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
  const Wire w = make_wire(zp, scale, nullptr, seed, levels);
  cudaStream_t s = (cudaStream_t)stream;
  if (slab_cols != 0) {
    if (bn < 1 || n % bn || smem_bytes != slab_smem_bytes(n, slab_cols)) {
      return (int)cudaErrorInvalidValue;
    }
    switch (slab_cols) {
      case 8:
        return launch_slab<8>(y, out, w_self, nbr, wts, n, d, k, w,
                              laplacian, smem_bytes, s);
      case 4:
        return launch_slab<4>(y, out, w_self, nbr, wts, n, d, k, w,
                              laplacian, smem_bytes, s);
      case 2:
        return launch_slab<2>(y, out, w_self, nbr, wts, n, d, k, w,
                              laplacian, smem_bytes, s);
      case 1:
        return launch_slab<1>(y, out, w_self, nbr, wts, n, d, k, w,
                              laplacian, smem_bytes, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  dim3 grid;
  if (!halo_launch(n, d, bn, 0, 0, 4, smem_bytes, &grid)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = allow_smem(sparse_mix_halo_comm_kernel,
                                     smem_bytes);
  if (err != cudaSuccess) return (int)err;
  sparse_mix_halo_comm_kernel<<<grid, kHaloThreads, smem_bytes, s>>>(
      y, out, w_self, nbr, wts, n, d, k, bn, w, laplacian);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
