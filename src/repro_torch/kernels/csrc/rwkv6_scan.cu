// The RWKV6 WKV recurrence on (B, T, H, hd) r, k, v, logw and (H, hd) u,
// from a zero (hd x hd) state per (batch, head), output f32 (B, T, H, hd)
// and, where asked for, the final state S_T (B, H, hd, hd) f32 (a model's
// prefill hands it to decode):
//
//   out_t = r_t (S + diag(u) k_t^T v_t),   S <- diag(exp(logw_t)) S + k_t^T v_t
//
// Replaces the Pallas TPU kernel `rwkv6_scan` of
// src/repro/kernels/rwkv6_scan.py, which carries S in VMEM scratch across
// a sequential grid of time chunks; here one block owns one (batch, head)
// and a tile of S's value columns, and walks all T steps itself, since
// blocks run in no order.
//
// Bound: bytes.  r, k, v, logw read once and out written once: 1.342 GB,
// 0.401 ms at rwkv6-7b train_4k (4, 4096, 64, 64) f32 at 3.35 TB/s; the
// work, ~4 hd^2 FLOP per step and head (17 GFLOP there), would need ~0.26
// ms of the f32 lanes.  The kernel this one replaced walked the T steps
// as one dependent chain per (batch, head), with its inputs staged one
// step at a time (each step's four global loads needed at once by a
// shuffle reduction) and four warps per SM to hide them: bound by
// latency, 2.37 ms at rwkv6-7b.
//
// Design: a chunked scan.  Within a chunk of L = 16 steps from t0, with
// a_t = sum_{t0 <= tau <= t} logw_tau per row i (a_{t0-1} = 0) and S0 the
// state entering the chunk,
//
//   o_t   = (r_t . e^{a_{t-1}}) S0                              (inter)
//         + sum_{s<t} [sum_i r_ti k_si e^{a_{t-1,i} - a_si}] v_s (intra)
//         + (sum_i r_ti u_i k_ti) v_t
//   S_end = diag(e^{a_{L-1}}) S0 + sum_s diag(e^{a_{L-1} - a_s}) k_s^T v_s
//
// so a chunk is L rows of independent work (the (L x hd)(hd x CV) inter
// product, the L x L scores, the state update K^T V), and the dependent
// chain is T / L state updates long.
//
// f32 range.  No exponent is factored across the chunk (e^{-a_s}
// overflows f32 after 12 steps of logw = -e^2).  The scores factor only
// over the chunk's quarters of 4 steps: for s in quarter sb and t in a
// later one, e^{a_{t-1} - a_s} = e^{a_{t-1} - a_{4sb+3}} e^{a_{4sb+3} -
// a_s}; within a quarter each (t, s, i) takes its own exponential.  Every
// exponent is a difference a_{t'} - a_s with t' >= s of one running sum
// per row, which never increases where logw <= 0 (each quarter starts
// from the previous quarter's last sum), so every exponent is <= 0.
// Exponentials are ex2.approx of sums kept in log2 units.
//
// Precision.  The inter product, the state update and the intra term run
// on the tensor cores as 3xTF32 mma.sync (m16n8k8; each operand split
// into a TF32 high and low part, three mma per product, as
// flash_attention.cu's f32 route); the scores are f32 FFMA.  The scan is
// held to (1e-4, 1e-4) of the step-by-step plain version at T = 4096.
//
// Layout.  Block (b, h, ct) owns S's columns [ct*CV, ct*CV + CV) for all
// hd rows, CV = 64, 32 or 16 (plan_wkv_cols in rwkv6_scan.py: the widest
// that gives the card a block per SM, capped near hd), the state tile in
// shared memory (or, where it does not fit, in a device-memory scratch
// the wrapper allocates).  The rows go by row tiles of 64, so any hd >= 1
// runs: a work unit is (chunk, row tile), and a ring of three units' r,
// k, logw (and, at a chunk's first row tile, v's CV columns) is in flight
// while a unit computes, so no step waits on its own loads: one TMA
// tensor copy per operand from one thread where every row is 16-byte
// aligned (what lies past hd or T arrives as zeros), else cp.async from
// every thread (16, 8 or 4 bytes, or 2-byte loads for a bf16 row of odd
// hd).  TMA against 16-byte cp.async of the same aligned rows (device
// ms, chip_smoke.py's ops phase, one H100 at 700 W): 1.419 against 1.570
// at rwkv6-7b f32, 1.337 against 1.420 with bf16 inputs, 0.632 against
// 0.781 at hd 96.  Per unit, with 256 threads (8 warps):
//   (1) each row's running sum a over the chunk (4 threads a row, one
//       quarter each, chained in order), then into shared memory
//       r~ = r e^{a_{t-1}}, k^ = k e^{a_{L-1} - a_s}, e^{a_{L-1}}, and
//       the score factors: k_s e^{a_{4sb+3} - a_s}, r_t e^{a_{t-1} -
//       a_{4sb+3}} for each earlier quarter sb, and the in-quarter
//       products r_t k_s e^{a_{t-1} - a_s} (s < t) and r_t u k_t;
//   (2) warps 0-2 accumulate the 96 cross-quarter scores (lane: a (t, sb)
//       group and a row quarter, four FFMA a row), warps 3-7 the 40
//       in-quarter ones (lane: a slot and a row quarter);
//   (3) warp (m, q) holds the state's columns 16m..16m+15 for its rows of
//       the tile as mma accumulators (S^T, M = the columns), which serve as
//       the A fragments of o^T += S^T r~^T as they lie (the k-index
//       relabelled, as flash_attention.cu's p.v), then S^T = S^T
//       e^{a_{L-1}} + v^T k^;
// and at a chunk's last row tile (4) the scores are reduced into shared
// memory, two warps of each column tile add o^T += v^T A^T, the warps'
// partial outputs are summed and stored for t < T and columns < hd.
//
// Plain C entry point at the bottom, loaded with ctypes by
// repro_torch/kernels/rwkv6_scan.py: launches on the caller's stream,
// allocates nothing, returns cudaGetLastError().
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/_build.py).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kMaxGrid = 2147483647;
constexpr int kSmemOptIn = 232448;  // dynamic shared memory a block may use
constexpr int kL = 16;              // steps of a chunk
constexpr int kRT = 64;             // rows of a row tile
constexpr int kNT = 256;            // threads of a block
constexpr int kStages = 3;          // units on the cp.async ring
constexpr int kLP = kL + 4;         // row stride of the derived arrays
constexpr int kRTP = kRT + 8;       // step stride of r~ ([kL][kRTP])
constexpr int kWarps = kNT / 32;
// a row's score factors (step (1)): Kf, 16; Rf, 3 x 16 (as [quarter][t],
// t < 4 quarter + 4 zero); the in-quarter products, 40; padding
constexpr int kFS = 108;
constexpr int kKf = 0, kRf = 16, kWq = 64;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kRT * 4 == kNT, "step (1): four threads a row");

struct Strides {
  long long b, t, h;
};

struct Operand {
  const void* p;
  Strides s;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// One copy of W bytes into shared memory, zero-filled where !in (the
// source must still be a valid address); 2 bytes, a bf16 value, has no
// cp.async of its size and is copied by the thread.
template <int W>
__device__ __forceinline__ void copy_vec(void* dst, const void* src,
                                         bool in) {
  if constexpr (W == 16) {
    cp_async16(dst, src, in);
  } else if constexpr (W == 8) {
    cp_async8(dst, src, in);
  } else if constexpr (W == 4) {
    cp_async4(dst, src, in);
  } else {
    *static_cast<unsigned short*>(dst) =
        in ? *static_cast<const unsigned short*>(src) : (unsigned short)0;
  }
}

// Stage steps [t0, t0 + kL) x columns [c0, c0 + WIDTH) of operand o at
// (b, h) into dst ([kL][WIDTH] values of T), in copies of W bytes; values
// at t >= T_len or c >= lim are zero.
template <typename T, int WIDTH, int W>
__device__ __forceinline__ void stage_rows(T* dst, const Operand& o, int b,
                                           int h, int t0, int c0, int T_len,
                                           int lim) {
  constexpr int E = W / (int)sizeof(T);  // values per copy
  constexpr int VPR = WIDTH / E;         // copies per step
  static_assert(E >= 1 && WIDTH % E == 0, "copy width");
  const T* base = static_cast<const T*>(o.p);
  for (int e = threadIdx.x; e < kL * VPR; e += kNT) {
    const int t = e / VPR, c = (e % VPR) * E;
    const bool in = t0 + t < T_len && c0 + c < lim;
    const T* src = in ? base + (b * o.s.b + (long long)(t0 + t) * o.s.t +
                                h * o.s.h + c0 + c)
                      : base;
    copy_vec<W>(dst + t * WIDTH + c, src, in);
  }
}

// The TMA route of the stage: one bulk copy per staged row, completing
// on the stage's mbarrier.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
      smem_addr(bar)));
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}
// A (box, 1, kL, 1) box of a (hd, H, T, B) operand at (c0, h, t0, b) into
// [kL][box] values at dst; what lies past hd or T arrives as zeros.
__device__ __forceinline__ void tensor_copy(void* dst, const CUtensorMap* tm,
                                            int c0, int h, int t0, int b,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(tm), "r"(c0), "r"(h), "r"(t0), "r"(b), "r"(smem_addr(bar))
      : "memory");
}

struct Maps {
  CUtensorMap m[4];  // r, k, v, logw
};

template <typename T, int WIDTH>
__device__ __forceinline__ void stage_any(T* dst, const Operand& o, int b,
                                          int h, int t0, int c0, int T_len,
                                          int lim, int cw) {
  if (cw == 16 && WIDTH * (int)sizeof(T) >= 16) {
    if constexpr (WIDTH * sizeof(T) >= 16) {
      stage_rows<T, WIDTH, 16>(dst, o, b, h, t0, c0, T_len, lim);
    }
  } else if (cw >= 8 && WIDTH * (int)sizeof(T) >= 8) {
    if constexpr (WIDTH * sizeof(T) >= 8) {
      stage_rows<T, WIDTH, 8>(dst, o, b, h, t0, c0, T_len, lim);
    }
  } else if (cw >= 4) {
    stage_rows<T, WIDTH, 4>(dst, o, b, h, t0, c0, T_len, lim);
  } else if constexpr (sizeof(T) == 2) {
    stage_rows<T, WIDTH, 2>(dst, o, b, h, t0, c0, T_len, lim);
  }
}

// Values of T in one ring stage: r, k, logw as [kL][kRT] and v as
// [kL][CV].
template <int CV>
__host__ __device__ constexpr int stage_values() {
  return 3 * kL * kRT + kL * CV;
}

// f32 values of the derived arrays (r~ as [kL][kRTP], k^ as [kRT][kLP],
// the score factors as [kRT][kFS] and e^{a_{L-1}} per row), which the
// chunk's partial outputs [8 / (CV / 16)][kL][CV] reuse, and of the
// [kL][kLP] scores.
constexpr int kDerived = kL * kRTP + kRT * kLP + kRT * kFS + kRT;
constexpr int kScores = kL * kLP;
static_assert(kDerived >= kWarps * kL * 16, "the partial outputs fit");

// c (16x8 f32) += a (16x8 tf32, row) . b (8x8 tf32, col)
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, "
      "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x = hi + lo in TF32: hi = tf32(x) rounded to nearest, lo = x - hi (exact
// in f32) cut to TF32 by clearing its low 13 bits (flash_attention.cu's
// split)
template <int N>
__device__ __forceinline__ void split_tf32(const float* x, uint32_t* hi,
                                           uint32_t* lo) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hi[i] = to_tf32(x[i]);
    lo[i] = __float_as_uint(x[i] - __uint_as_float(hi[i])) & 0xffffe000u;
  }
}
// 2^x, subnormal results flushed to 0 (they add < 2^-126 to a sum)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// c += a . b in 3xTF32: the a_lo b_hi and a_hi b_lo terms, then a_hi b_hi
__device__ __forceinline__ void mma3(float* c, const uint32_t* ah,
                                     const uint32_t* al, const float* b) {
  uint32_t bh[2], bl[2];
  split_tf32<2>(b, bh, bl);
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// The rows of a column of the state tile: every row tile's 64, plus 4 so
// that neighboring columns start in other banks.
__host__ __device__ __forceinline__ int state_rows(int hd) {
  return (hd + kRT - 1) / kRT * kRT + 4;
}

// Dynamic shared memory of a launch: the ring, the derived arrays, the
// scores and, unless it lives in device memory, the state tile.
long long smem_bytes(int hd, int cv, int itemsize, bool state_shared) {
  const long long stage = (3LL * kL * kRT + (long long)kL * cv) * itemsize;
  return kStages * stage + 4LL * (kDerived + kScores) +
         (state_shared ? 4LL * cv * state_rows(hd) : 0);
}

template <typename T, int CV>
__global__ void __launch_bounds__(kNT, 2)
    rwkv6_scan_kernel(Operand r, Operand k, Operand v, Operand w,
                      const __grid_constant__ Maps maps,
                      const float* __restrict__ u, float* __restrict__ out,
                      float* __restrict__ s_dev, float* __restrict__ s_out,
                      int T_len, int H, int hd, int cw, int cwv, int tma) {
  constexpr int MT = CV / 16;     // 16-column m-tiles of the state tile
  constexpr int GQ = kWarps / MT;  // warps sharing an m-tile
  constexpr int NTW = kRT / 8 / GQ;  // 8-row n-tiles of a warp, per unit
  constexpr int SV = stage_values<CV>();
  static_assert(MT >= 1 && kWarps % MT == 0 && GQ >= 2, "geometry");
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* der = reinterpret_cast<float*>(smem + sizeof(T) * kStages * SV);
  float* Rt = der;               // r~ = r e^{a_{t-1}}          [kL][kRTP]
  float* Kh = Rt + kL * kRTP;    // k^ = k e^{a_{L-1} - a_s}    [kRT][kLP]
  float* Fs = Kh + kRT * kLP;    // score factors               [kRT][kFS]
  float* DEC = Fs + kRT * kFS;   // e^{a_{L-1}}                 [kRT]
  float* red = der;              // partial outputs at a chunk's end
  float* Asc = der + kDerived;   // scores                      [kL][kLP]
  const int srows = state_rows(hd);
  const int tid = threadIdx.x;
  const int nct = (hd + CV - 1) / CV;
  const int bh = blockIdx.x / nct, ct = blockIdx.x % nct;
  const int b = bh / H, h = bh % H, jc = ct * CV;
  float* S = s_dev ? s_dev + (size_t)blockIdx.x * CV * srows
                   : Asc + kScores;  // [CV][srows]
  for (int e = tid; e < CV * srows; e += kNT) S[e] = 0.f;
  for (int e = tid; e < kScores; e += kNT) Asc[e] = 0.f;

  // step (2): warps 0-2 take the 24 (t, sb) groups of the scores with s in
  // quarter sb and t in a later one, lane (group, part) the four sums
  // sum_i Rf[i][sb][t] Kf[i][4sb + s'] over rows part, part + 4, ...;
  // warps 3-7 sum the 40 in-quarter products, lane (slot, part) likewise
  int gt = 0, gsb = 0;
  {
    int grp = tid / 4;  // warps 0-2: 24 groups, sb 0 (t 4-15), 1, 2
    gsb = grp < 12 ? 0 : grp < 20 ? 1 : 2;
    gt = grp - (gsb == 0 ? 0 : gsb == 1 ? 12 : 20) + 4 * gsb + 4;
  }
  // step (3): this warp's m-tile and rows; the lane's place in a fragment
  const int warp = tid / 32, lane = tid % 32;
  const int mt = warp / GQ, wq = warp % GQ;
  const int fg = lane / 4, ft = lane % 4;
  const int jl = mt * 16 + fg;  // the fragment rows' columns jl, jl + 8

  const int nrt = (hd + kRT - 1) / kRT;
  const int nunits = (T_len + kL - 1) / kL * nrt;
  // tma: the Tensor Memory Accelerator stages each operand's box with one
  // instruction from one thread (the host built the tensor maps: every
  // row 16-byte aligned), else cp.async from every thread
  __shared__ __align__(8) uint64_t bars[kStages];
  if (tma && tid == 0) {
    for (int q = 0; q < kStages; ++q) mbar_init(bars + q);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const auto stage_unit = [&](int un) {
    T* dst = ring + (size_t)(un % kStages) * SV;
    const int t0 = un / nrt * kL, rt = un % nrt;
    if (tma) {
      if (tid != 0) return;
      uint64_t* bar = bars + un % kStages;
      mbar_expect(bar, (3 * kL * kRT + (rt == 0 ? kL * CV : 0)) *
                           (int)sizeof(T));
      tensor_copy(dst, maps.m + 0, rt * kRT, h, t0, b, bar);
      tensor_copy(dst + kL * kRT, maps.m + 1, rt * kRT, h, t0, b, bar);
      tensor_copy(dst + 2 * kL * kRT, maps.m + 3, rt * kRT, h, t0, b, bar);
      if (rt == 0) tensor_copy(dst + 3 * kL * kRT, maps.m + 2, jc, h, t0, b, bar);
      return;
    }
    stage_any<T, kRT>(dst, r, b, h, t0, rt * kRT, T_len, hd, cw);
    stage_any<T, kRT>(dst + kL * kRT, k, b, h, t0, rt * kRT, T_len, hd, cw);
    stage_any<T, kRT>(dst + 2 * kL * kRT, w, b, h, t0, rt * kRT, T_len, hd,
                      cw);
    if (rt == 0) {
      stage_any<T, CV>(dst + 3 * kL * kRT, v, b, h, t0, jc, T_len, hd, cwv);
    }
  };
  for (int q = 0; q < kStages - 1; ++q) {
    if (q < nunits) stage_unit(q);
    cp_async_commit();
  }

  // the warp's partial outputs o^T (its 16 columns x 16 steps, two C
  // fragments) and v^T's A fragments (two 8-step k-steps, hi and lo)
  float of[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  uint32_t vh[2][4], vl[2][4];
  float sc[4] = {0.f, 0.f, 0.f, 0.f};
  float u_row = (tid >> 2) < hd ? __ldg(u + (size_t)h * hd + (tid >> 2)) : 0.f;

  for (int un = 0; un < nunits; ++un) {
    if (tma) {
      mbar_wait(bars + un % kStages, (un / kStages) & 1);
    } else {
      cp_async_wait<kStages - 2>();
    }
    __syncthreads();  // unit un staged; the previous unit fully consumed
    if (un + kStages - 1 < nunits) stage_unit(un + kStages - 1);
    cp_async_commit();
    const int c = un / nrt, rt = un % nrt;
    const T* stg = ring + (size_t)(un % kStages) * SV;

    // (1) running sums and the derived arrays, 4 threads a row
    {
      const int pi = tid >> 2, pq = tid & 3;
      const float ui = u_row;
      if (nrt > 1) {  // the next unit's row of u
        const int row = (rt + 1 == nrt ? 0 : rt + 1) * kRT + pi;
        u_row = row < hd ? __ldg(u + (size_t)h * hd + row) : 0.f;
      }
      float rr[4], kk[4], cs[4];
      const bool row_in = rt * kRT + pi < hd;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int at = (4 * pq + e) * kRT + pi;
        const bool in = row_in && c * kL + 4 * pq + e < T_len;
        rr[e] = in ? to_f32(stg[at]) : 0.f;
        kk[e] = in ? to_f32(stg[kL * kRT + at]) : 0.f;
        const float lw = in ? to_f32(stg[2 * kL * kRT + at]) * kLog2e : 0.f;
        cs[e] = e ? cs[e - 1] + lw : lw;
      }
      // the quarters in order: quarter q starts from quarter q-1's last
      // running sum, so the sums never increase where logw <= 0
      float p = 0.f, last = cs[3];
#pragma unroll
      for (int q = 1; q < 4; ++q) {
        const float prev = __shfl_up_sync(0xffffffffu, last, 1, 4);
        if (pq == q) {
          p = prev;
          last = p + cs[3];
        }
      }
      float a2[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) a2[e] = pq ? p + cs[e] : cs[e];
      // the running sum at the end of each quarter
      float qend[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        qend[q] = __shfl_sync(0xffffffffu, a2[3], (threadIdx.x & 31 & ~3) | q);
      }
      const float alast = qend[3];
      float* F = Fs + pi * kFS;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = 4 * pq + e;
        const float before = e ? a2[e - 1] : p;  // a_{t-1}, 0 at t0
        Rt[t * kRTP + pi] = rr[e] * ex2(before);
        Kh[pi * kLP + t] = kk[e] * ex2(alast - a2[e]);
        F[kKf + t] = kk[e] * ex2(a2[3] - a2[e]);
        // Rf[t][sb] = r_t e^{a_{t-1} - a_{4sb+3}} for the earlier quarters
#pragma unroll
        for (int sb = 0; sb < 3; ++sb) {
          if (sb < pq) {
            F[kRf + 16 * sb + t] = rr[e] * ex2(before - qend[sb]);
          } else {
            F[kRf + 16 * sb + t] = 0.f;
          }
        }
        // in-quarter pairs s <= t: r_t k_s e^{a_{t-1} - a_s}, r_t u k_t
        float* W = F + kWq + 10 * pq + e * (e + 1) / 2;
#pragma unroll
        for (int e2 = 0; e2 < e; ++e2) {
          W[e2] = rr[e] * kk[e2] * ex2(before - a2[e2]);
        }
        W[e] = rr[e] * ui * kk[e];
      }
      if (pq == 0) DEC[pi] = ex2(alast);
    }
    __syncthreads();

    // (2) the scores over this unit's rows
    if (warp < 3) {
      const float* f = Fs + (tid % 4) * kFS;
#pragma unroll 4
      for (int m = 0; m < kRT / 4; ++m) {
        const float* fr = f + 4 * m * kFS;
        const float a = fr[kRf + 16 * gsb + gt];
        const float4 k4 = *reinterpret_cast<const float4*>(fr + kKf + 4 * gsb);
        sc[0] = fmaf(a, k4.x, sc[0]);
        sc[1] = fmaf(a, k4.y, sc[1]);
        sc[2] = fmaf(a, k4.z, sc[2]);
        sc[3] = fmaf(a, k4.w, sc[3]);
      }
    } else {
      const int task = (warp - 3) * 32 + lane, slot = task / 4;
      const float* f = Fs + (task % 4) * kFS + kWq + slot;
      float x = 0.f;
#pragma unroll 4
      for (int m = 0; m < kRT / 4; ++m) x += f[4 * m * kFS];
      sc[0] += x;
    }
    if (rt == nrt - 1) {  // the chunk's scores, read after (3)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        sc[x] += __shfl_xor_sync(0xffffffffu, sc[x], 1);
        sc[x] += __shfl_xor_sync(0xffffffffu, sc[x], 2);
      }
      if (tid % 4 == 0) {
        if (warp < 3) {
#pragma unroll
          for (int x = 0; x < 4; ++x) Asc[gt * kLP + 4 * gsb + x] = sc[x];
        } else {
          // slot = 10 q + e (e + 1) / 2 + e2: t = 4q + e, s = 4q + e2
          const int slot = ((warp - 3) * 32 + lane) / 4;
          const int q = slot / 10, r10 = slot % 10;
          const int e = r10 >= 6 ? 3 : r10 >= 3 ? 2 : r10 >= 1 ? 1 : 0;
          Asc[(4 * q + e) * kLP + 4 * q + r10 - e * (e + 1) / 2] = sc[0];
        }
      }
#pragma unroll
      for (int x = 0; x < 4; ++x) sc[x] = 0.f;
    }

    // (3) the inter-chunk product and the state update on the tensor
    // cores: with M = the state's columns j, the state S^T (j x i) is the
    // warp's C fragments, which serve as the A fragments of o^T += S^T r~^T
    // as they lie (k-index ft is row 2ft of an 8-row block, ft + 4 row
    // 2ft + 1); then S^T = S^T e^{a_{L-1}} + v^T k^
    if (rt == 0) {
      const T* vs = stg + 3 * kL * kRT;
      const auto vat = [&](int s, int j) {
        return c * kL + s < T_len && jc + j < hd ? to_f32(vs[s * CV + j])
                                                 : 0.f;
      };
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const float a[4] = {vat(8 * kk + ft, jl), vat(8 * kk + ft, jl + 8),
                            vat(8 * kk + ft + 4, jl),
                            vat(8 * kk + ft + 4, jl + 8)};
        split_tf32<4>(a, vh[kk], vl[kk]);
      }
    }
    {
      float sf[NTW][4];
      float* s0 = S + (size_t)jl * srows + rt * kRT;
      float* s8 = s0 + (size_t)8 * srows;
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        const int i = (wq * NTW + nt) * 8 + 2 * ft;
        const float2 x = *reinterpret_cast<const float2*>(s0 + i);
        const float2 y = *reinterpret_cast<const float2*>(s8 + i);
        sf[nt][0] = x.x, sf[nt][1] = x.y, sf[nt][2] = y.x, sf[nt][3] = y.y;
      }
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        const int i = (wq * NTW + nt) * 8 + 2 * ft;
        const float a[4] = {sf[nt][0], sf[nt][2], sf[nt][1], sf[nt][3]};
        uint32_t ah[4], al[4];
        split_tf32<4>(a, ah, al);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const float2 b = *reinterpret_cast<const float2*>(
              Rt + (8 * n + fg) * kRTP + i);
          const float bb[2] = {b.x, b.y};
          mma3(of[n], ah, al, bb);
        }
        const float d0 = DEC[i], d1 = DEC[i + 1];
        sf[nt][0] *= d0, sf[nt][1] *= d1, sf[nt][2] *= d0, sf[nt][3] *= d1;
        const float* kb = Kh + ((wq * NTW + nt) * 8 + fg) * kLP + ft;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const float bb[2] = {kb[8 * kk], kb[8 * kk + 4]};
          mma3(sf[nt], vh[kk], vl[kk], bb);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        const int i = (wq * NTW + nt) * 8 + 2 * ft;
        *reinterpret_cast<float2*>(s0 + i) = make_float2(sf[nt][0], sf[nt][1]);
        *reinterpret_cast<float2*>(s8 + i) = make_float2(sf[nt][2], sf[nt][3]);
      }
    }
    if (rt != nrt - 1) continue;

    // (4) the chunk's outputs: the intra term o^T += v^T A^T (warp wq of an m-tile takes steps 8wq..8wq+7,
    // wq < 2), the partials summed and stored
    __syncthreads();  // scores written; every read of the derived arrays done
    if (wq < 2) {
      // B = A^T: b0 = A[t = 8wq + fg][s = 8kk + ft], b1 at s + 4 (0 where
      // s > t)
      const float* ab = Asc + (8 * wq + fg) * kLP + ft;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const float bb[2] = {ab[8 * kk], ab[8 * kk + 4]};
        mma3(of[wq], vh[kk], vl[kk], bb);
      }
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int t = 8 * n + 2 * ft;
      float* rb = red + (wq * kL + t) * CV + jl;
      rb[0] = of[n][0];
      rb[CV] = of[n][1];
      rb[8] = of[n][2];
      rb[CV + 8] = of[n][3];
#pragma unroll
      for (int e = 0; e < 4; ++e) of[n][e] = 0.f;
    }
    __syncthreads();
    const int t0 = c * kL;
    for (int e = tid; e < kL * CV; e += kNT) {
      const int t = e / CV, jj = e % CV;
      float o = 0.f;
#pragma unroll
      for (int q = 0; q < GQ; ++q) o += red[(q * kL + t) * CV + jj];
      if (t0 + t < T_len && jc + jj < hd) {
        out[(((size_t)b * T_len + t0 + t) * H + h) * hd + jc + jj] = o;
      }
    }
  }
  cp_async_wait_all();
  // the final state S_T, where asked for: the tile's columns of every
  // row, written once after the last chunk (rows of s_out are i, its
  // columns j)
  if (s_out != nullptr) {
    __syncthreads();
    float* so = s_out + (size_t)bh * hd * hd;
    for (int e = tid; e < hd * CV; e += kNT) {
      const int i = e / CV, jj = e % CV;
      if (jc + jj < hd) so[(size_t)i * hd + jc + jj] = S[(size_t)jj * srows + i];
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no link
// against libcuda), or nullptr.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess) {
      return (EncodeTiled) nullptr;
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The tensor maps of the four operands, (hd, H, T, B) with boxes of
// (64 or CV, 1, kL, 1) values, or false where one cannot be made.
bool make_maps(Maps* maps, const Operand* ops, int B, int T_len, int H,
               int hd, int cv, int itemsize) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  for (int q = 0; q < 4; ++q) {
    const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H,
                                (cuuint64_t)T_len, (cuuint64_t)B};
    const long long st[3] = {ops[q].s.h, ops[q].s.t, ops[q].s.b};
    cuuint64_t strides[3];
    for (int x = 0; x < 3; ++x) strides[x] = (cuuint64_t)(st[x] * itemsize);
    const cuuint32_t box[4] = {(cuuint32_t)(q == 2 ? cv : kRT), 1, kL, 1};
    const cuuint32_t ones[4] = {1, 1, 1, 1};
    if (enc(maps->m + q,
            itemsize == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            4, const_cast<void*>(ops[q].p), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
      return false;
    }
  }
  return true;
}

template <typename T, int CV>
int launch(const Operand* ops, const float* u, float* out, float* s_dev,
           float* s_out, int B, int T_len, int H, int hd, int cw,
           int itemsize, cudaStream_t stream) {
  const long long blocks = (long long)B * H * ((hd + CV - 1) / CV);
  const long long bytes = smem_bytes(hd, CV, itemsize, s_dev == nullptr);
  if (blocks > kMaxGrid || bytes > kSmemOptIn) {
    return (int)cudaErrorInvalidValue;
  }
  const auto kernel = rwkv6_scan_kernel<T, CV>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int cwv = cw < CV * itemsize ? cw : CV * itemsize;
  // the TMA route wherever every row is 16-byte aligned and no stride is
  // 0 (a broadcast operand takes cp.async)
  bool tma = cw == 16;
  for (int q = 0; q < 4; ++q) {
    tma = tma && ops[q].s.b > 0 && ops[q].s.t > 0 && ops[q].s.h > 0;
  }
  Maps maps;
  if (tma && !make_maps(&maps, ops, B, T_len, H, hd, CV, itemsize)) {
    return (int)cudaErrorNotSupported;
  }
  kernel<<<(unsigned)blocks, kNT, (size_t)bytes, stream>>>(
      ops[0], ops[1], ops[2], ops[3], maps, u, out, s_dev, s_out, T_len, H,
      hd, cw, cwv, (int)tma);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_cols(int cols, const Operand* ops, const float* u, float* out,
                  float* s_dev, float* s_out, int B, int T_len, int H, int hd,
                  int cw, cudaStream_t s) {
  constexpr int it = (int)sizeof(T);
  switch (cols) {
    case 64: return launch<T, 64>(ops, u, out, s_dev, s_out, B, T_len, H, hd, cw, it, s);
    case 32: return launch<T, 32>(ops, u, out, s_dev, s_out, B, T_len, H, hd, cw, it, s);
    case 16: return launch<T, 16>(ops, u, out, s_dev, s_out, B, T_len, H, hd, cw, it, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The widest copy (16, 8, 4, or the element's size) that every staged
// row of the four operands allows: their pointers, strides and hd rows.
int copy_bytes(const Operand* ops, int hd, int itemsize) {
  uintptr_t bits = (uintptr_t)((long long)hd * itemsize);
  for (int q = 0; q < 4; ++q) {
    bits |= (uintptr_t)ops[q].p;
    bits |= (uintptr_t)(ops[q].s.b * itemsize) |
            (uintptr_t)(ops[q].s.t * itemsize) |
            (uintptr_t)(ops[q].s.h * itemsize);
  }
  int cw = 16;
  while (cw > itemsize && bits % cw) cw /= 2;
  return cw;
}

}  // namespace

// r, k, v, logw: (B, T, H, hd) with element strides (sb, st, sh) each and
// last stride 1; u: (H, hd) f32 contiguous; out: (B, T, H, hd) f32
// contiguous.  dtype (of r, k, v, logw): 0 = float32, 1 = bfloat16.
// hd >= 1.  cols: the state tile's columns per block (64, 32 or 16).
// s_dev: nullptr to hold the state tile in shared memory, else a device
// scratch of B * H * ceil(hd / cols) * cols * (ceil(hd / 64) * 64 + 4)
// f32 values.  s_out: nullptr, or the final state S_T, (B, H, hd, hd) f32
// contiguous (S_T[b, h, i, j] multiplies r_i into output column j).
extern "C" int rwkv6_scan(const void* r, const void* k, const void* v,
                          const void* logw, const float* u, float* out,
                          float* s_dev, float* s_out, int B, int T_len,
                          int H, int hd,
                          int dtype, int cols, long long r_sb,
                          long long r_st, long long r_sh, long long k_sb,
                          long long k_st, long long k_sh, long long v_sb,
                          long long v_st, long long v_sh, long long w_sb,
                          long long w_st, long long w_sh, void* stream) {
  if (B < 1 || T_len < 1 || H < 1 || hd < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const Operand ops[4] = {{r, {r_sb, r_st, r_sh}},
                          {k, {k_sb, k_st, k_sh}},
                          {v, {v_sb, v_st, v_sh}},
                          {logw, {w_sb, w_st, w_sh}}};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return dispatch_cols<float>(cols, ops, u, out, s_dev, s_out, B, T_len,
                                H, hd, copy_bytes(ops, hd, 4), s);
  }
  if (dtype == 1) {
    return dispatch_cols<__nv_bfloat16>(cols, ops, u, out, s_dev, s_out, B,
                                        T_len, H, hd, copy_bytes(ops, hd, 2),
                                        s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
