// Online-softmax attention on (B, S, H, hd) q, k, v with the same head
// count (grouped-query heads are broadcast by the caller), f32 or bf16 in,
// f32 accumulation, output in the input's type.
//
// Replaces the Pallas TPU kernel `flash_attention` of
// src/repro/kernels/flash_attention.py and computes the same function:
// s = q.k^T / sqrt(hd); the causal mask (k <= q) and the window mask
// (q - k < window) apply independently, so the window holds without
// causal too; masked scores count as -1e30, i.e. weight 0; the output is
// acc / max(l, 1e-30).  The TPU kernel runs every kv block and lets the
// rescale exp(m_prev - m_new) erase wholly masked leading blocks; this one
// skips kv tiles that its masks wholly exclude and gives masked scores
// weight exactly 0, which is the same function (every row keeps key = q).
//
// Bound: operations, 4 hd FLOP per unmasked (q, k) pair against the
// tensor cores' 989 TFLOP/s for bf16 and, for f32, the fastest rate that
// keeps f32 accuracy: 3xTF32, three TF32 mma per product at 495 TFLOP/s,
// i.e. 165 TFLOP/s of f32 work (the CUDA cores' 67 would be slower); the
// bytes (q, k, v read once, o written once) are a tenth of that time at
// S = 4096.
//
// Design.  One block of four warps per (q tile of kBQ = 64 rows,
// batch * head); each warp owns 16 q rows.  Both products run on the
// tensor cores with mma.sync:
//  * bf16: q.k^T is m16n8k16 with bf16 inputs and an f32 accumulator, fed
//    by ldmatrix from shared memory; a product of two bf16 values is exact
//    in f32.  p.v splits the probabilities p (f32) into three bf16 parts
//    p_hi + p_mid + p_lo, which carry p to f32 precision, and issues three
//    mma per product (ldmatrix.trans feeds V): rounding p to one bf16 part
//    would leave an error of ~2^-9 of sum |p||v|, far above one bf16
//    rounding of the outputs near 0.  So the kernel does 2x the tensor-core
//    work of a plain bf16 kernel.
//  * f32: both products are m16n8k8 TF32 in 3xTF32: x = x_hi + x_lo with
//    x_hi = cvt.rna.tf32(x) and x_lo = x - x_hi cut to TF32, and
//    a.b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi, which holds f32 inputs to
//    ~2^-21 per product.  The instruction is explicit, so torch's TF32
//    flags do not reach it.
// K and V tiles of kBK keys are staged in the input's type, double-
// buffered with 16-byte cp.async (the next tile loads while one is
// computed) where the operands allow 16-byte chunks (hd a multiple of
// 16 bytes / itemsize, aligned pointers and strides); other operands load
// the same tiles element by element.  hd is padded up to HDP, the next
// multiple of 16, with zero columns in shared memory: in q.k^T they add
// exact zeros, and the padded output columns of p.v are never stored, so
// every hd from 1 to 256 runs with no copy of the operands.  Rows are
// padded by 16 bytes (bf16, conflict-free ldmatrix) or 4 floats (f32,
// conflict-free fragment loads).  The online softmax runs on the score
// fragments in registers, the row max and sum taken with quad shuffles;
// the p fragments are re-packed in registers as the A operand of p.v
// (for TF32 the keys of an 8-key step are relabelled so that no shuffle
// is needed), with no round trip through shared memory.  Wholly masked
// kv tiles are skipped (kt_lo / kt_hi) and tiles that no mask touches
// skip the masking; heavy causal tiles start first.
//
// Plain C entry point at the bottom, loaded with ctypes by
// repro_torch/kernels/flash_attention.py: launches on the caller's
// stream, allocates nothing, returns cudaGetLastError().
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/_build.py).  No fast math:
//        expf stays the accurate one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kBQ = 64;  // q rows per block, 16 per warp
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;
constexpr int kMaxGridY = 65535;
constexpr int kMaxHeadDim = 256;

template <typename T, int HDP>
struct Geo {
  static constexpr bool kBf16 = sizeof(T) == 2;
  // keys per staged tile: two stages of K and V and the Q tile fit the
  // shared-memory opt-in at HDP = 256
  static constexpr int BK = kBf16 && HDP <= 128 ? 64 : 32;
  // row stride in elements: 16 bytes of padding (bf16) or 4 floats
  static constexpr int ST = kBf16 ? HDP + 8 : HDP + 4;
  static constexpr int CH = 16 / sizeof(T);  // elements per 16-byte chunk
  static constexpr int kSmemBytes = (kBQ + 4 * BK) * ST * (int)sizeof(T);
  static_assert(HDP % 16 == 0 && HDP <= kMaxHeadDim, "head dim");
  static_assert(BK % 16 == 0, "kv tile");
};

// Element strides of a (B, S, H, hd) operand whose last stride is 1.
struct Strides {
  long long b, s, h;
};

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

// Stage rows [row0, row0 + rows) of a (S, hd) operand slice (row stride
// ss) as `rows` rows of HDP elements, stride ST: zero past S and past hd.
template <typename T, int HDP>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long ss,
                                          int row0, int rows, int S, int hd,
                                          bool vec) {
  using Gm = Geo<T, HDP>;
  constexpr int CH = Gm::CH, CPR = HDP / CH;
  if (vec) {
    for (int e = threadIdx.x; e < rows * CPR; e += kThreads) {
      const int r = e / CPR, c = (e % CPR) * CH;
      const bool in = row0 + r < S && c < hd;
      cp_async16(dst + r * Gm::ST + c,
                 in ? src + (long long)(row0 + r) * ss + c : src, in);
    }
  } else {
    for (int e = threadIdx.x; e < rows * HDP; e += kThreads) {
      const int r = e / HDP, c = e % HDP;
      dst[r * Gm::ST + c] = row0 + r < S && c < hd
                                ? src[(long long)(row0 + r) * ss + c]
                                : zero<T>();
    }
  }
}

// -- tensor-core fragments ------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// c (16x8 f32) += a (16x16 bf16, row) . b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
      "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
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
// in f32, |lo| <= 2^-11 |x|) cut to TF32 by clearing its low 13 bits,
// which errs by < 2^-21 |x|: one cvt per split instead of two
template <int N>
__device__ __forceinline__ void split_tf32(const float* x, uint32_t* hi,
                                           uint32_t* lo) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hi[i] = to_tf32(x[i]);
    lo[i] = __float_as_uint(x[i] - __uint_as_float(hi[i])) & 0xffffe000u;
  }
}
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
// (x0, x1) = hi + mid + lo in bf16 pairs, x0 in the low half of each
__device__ __forceinline__ void split_bf16x3(float x0, float x1,
                                             uint32_t& hi, uint32_t& mid,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  hi = as_u32(h);
  mid = as_u32(m);
  lo = as_u32(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));
}

// s (16 x BK scores of this warp, NT fragments) = q rows . k^T
template <typename T, int HDP>
__device__ __forceinline__ void qk_bf16(float (*s)[4], const T* Qw,
                                        const T* Ks, int lane) {
  using Gm = Geo<T, HDP>;
  constexpr int ST = Gm::ST, NT = Gm::BK / 8;
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, Qw + (lane % 16) * ST + kk * 16 + (lane / 16) * 8);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      ldsm_x4(b, Ks + (j * 8 + (lane / 16) * 8 + lane % 8) * ST + kk * 16 +
                     ((lane / 8) % 2) * 8);
      mma_bf16(s[j], a, b[0], b[1]);
      mma_bf16(s[j + 1], a, b[2], b[3]);
    }
  }
}

template <typename T, int HDP>
__device__ __forceinline__ void qk_tf32(float (*s)[4], const T* Qw,
                                        const T* Ks, int g, int t) {
  using Gm = Geo<T, HDP>;
  constexpr int ST = Gm::ST, NT = Gm::BK / 8;
#pragma unroll 4
  for (int kk = 0; kk < HDP / 8; ++kk) {
    const float* qa = Qw + g * ST + kk * 8 + t;
    const float a[4] = {qa[0], qa[8 * ST], qa[4], qa[8 * ST + 4]};
    uint32_t ah[4], al[4];
    split_tf32<4>(a, ah, al);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* kb = Ks + (j * 8 + g) * ST + kk * 8 + t;
      const float b[2] = {kb[0], kb[4]};
      uint32_t bh[2], bl[2];
      split_tf32<2>(b, bh, bl);
      mma_tf32(s[j], al, bh);
      mma_tf32(s[j], ah, bl);
      mma_tf32(s[j], ah, bh);
    }
  }
}

// acc (16 x HDP of this warp, HDP/8 fragments) += p . v
template <typename T, int HDP>
__device__ __forceinline__ void pv_bf16(float (*acc)[4], float (*p)[4],
                                        const T* Vs, int lane) {
  using Gm = Geo<T, HDP>;
  constexpr int ST = Gm::ST;
#pragma unroll
  for (int kk = 0; kk < Gm::BK / 16; ++kk) {
    // A fragments of keys 16kk..16kk+15: score fragments 2kk and 2kk+1
    uint32_t ph[4], pm[4], pl[4];
    split_bf16x3(p[2 * kk][0], p[2 * kk][1], ph[0], pm[0], pl[0]);
    split_bf16x3(p[2 * kk][2], p[2 * kk][3], ph[1], pm[1], pl[1]);
    split_bf16x3(p[2 * kk + 1][0], p[2 * kk + 1][1], ph[2], pm[2], pl[2]);
    split_bf16x3(p[2 * kk + 1][2], p[2 * kk + 1][3], ph[3], pm[3], pl[3]);
#pragma unroll
    for (int n = 0; n < HDP / 8; n += 2) {
      uint32_t b[4];
      ldsm_x4_trans(b, Vs + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * ST +
                           n * 8 + (lane / 16) * 8);
      mma_bf16(acc[n], pl, b[0], b[1]);
      mma_bf16(acc[n], pm, b[0], b[1]);
      mma_bf16(acc[n], ph, b[0], b[1]);
      mma_bf16(acc[n + 1], pl, b[2], b[3]);
      mma_bf16(acc[n + 1], pm, b[2], b[3]);
      mma_bf16(acc[n + 1], ph, b[2], b[3]);
    }
  }
}

template <typename T, int HDP>
__device__ __forceinline__ void pv_tf32(float (*acc)[4], float (*p)[4],
                                        const T* Vs, int g, int t) {
  using Gm = Geo<T, HDP>;
  constexpr int ST = Gm::ST;
#pragma unroll
  for (int j = 0; j < Gm::BK / 8; ++j) {
    // keys 8j..8j+7 relabelled: k-index t is key 8j + 2t and t + 4 is
    // key 8j + 2t + 1, so the score fragment is the A fragment as it lies
    const float a[4] = {p[j][0], p[j][2], p[j][1], p[j][3]};
    uint32_t ah[4], al[4];
    split_tf32<4>(a, ah, al);
    const float* vr = Vs + (j * 8 + 2 * t) * ST + g;
#pragma unroll
    for (int n = 0; n < HDP / 8; ++n) {
      const float b[2] = {vr[n * 8], vr[n * 8 + ST]};
      uint32_t bh[2], bl[2];
      split_tf32<2>(b, bh, bl);
      mma_tf32(acc[n], al, bh);
      mma_tf32(acc[n], ah, bl);
      mma_tf32(acc[n], ah, bh);
    }
  }
}

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int S,
                           int H, int BH, int hd, Strides qs, Strides ks,
                           Strides vs, float scale, int causal, int window,
                           int vec) {
  using Gm = Geo<T, HDP>;
  constexpr int BK = Gm::BK, ST = Gm::ST, NT = BK / 8, NO = HDP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // (kBQ, ST)
  T* KV = Qs + kBQ * ST;                   // per stage: K (BK, ST), V

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  // heavy causal tiles (late q) first: they start before the light ones
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int q_last = q0 + kBQ - 1;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const T* Qw = Qs + warp * 16 * ST;

  // the kv tiles the masks do not wholly exclude
  int kt_lo = 0, kt_hi = (S - 1) / BK;
  if (causal) kt_hi = min(kt_hi, q_last / BK);
  if (window > 0 && q0 - window + 1 > 0) kt_lo = (q0 - window + 1) / BK;

  for (int bh = blockIdx.y; bh < BH; bh += gridDim.y) {
    const int b = bh / H, h = bh % H;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* kb = k + b * ks.b + h * ks.h;
    const T* vb = v + b * vs.b + h * vs.h;

    float acc[NO][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NO; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    }

    load_tile<T, HDP>(Qs, qb, qs.s, q0, kBQ, S, hd, vec);
    load_tile<T, HDP>(KV, kb, ks.s, kt_lo * BK, BK, S, hd, vec);
    load_tile<T, HDP>(KV + BK * ST, vb, vs.s, kt_lo * BK, BK, S, hd, vec);
    cp_async_commit();

    for (int kt = kt_lo; kt <= kt_hi; ++kt) {
      T* Ks = KV + ((kt - kt_lo) & 1) * 2 * BK * ST;
      const T* Vs = Ks + BK * ST;
      if (kt < kt_hi) {  // the next tile loads while this one computes
        T* Kn = KV + ((kt + 1 - kt_lo) & 1) * 2 * BK * ST;
        load_tile<T, HDP>(Kn, kb, ks.s, (kt + 1) * BK, BK, S, hd, vec);
        load_tile<T, HDP>(Kn + BK * ST, vb, vs.s, (kt + 1) * BK, BK, S, hd,
                          vec);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();

      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      }
      if constexpr (Gm::kBf16) {
        qk_bf16<T, HDP>(s, Qw, Ks, lane);
      } else {
        qk_tf32<T, HDP>(s, Qw, Ks, g, t);
      }

      // scale and mask; no mask inside this tile when every key <= every
      // row (causal), every row - key < window, and every key in range
      const int k0 = kt * BK;
      const bool full = (!causal || k0 + BK - 1 <= q0) &&
                        (window <= 0 || q_last - k0 < window) &&
                        k0 + BK <= S;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale;
          if (!full) {
            const int key = k0 + j * 8 + 2 * t + (e & 1), r = row[e >> 1];
            if (key >= S || (causal && key > r) ||
                (window > 0 && r - key >= window)) {
              x = kNegInf;
            }
          }
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      // online softmax: row max over the quad, masked keys weigh exactly 0
      float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = expf(m[r] - mx[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[j][e];
          const float p = x == kNegInf ? 0.f : expf(x - mx[e >> 1]);
          s[j][e] = p;
          psum[e >> 1] += p;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + psum[r];
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }

      if constexpr (Gm::kBf16) {
        pv_bf16<T, HDP>(acc, s, Vs, lane);
      } else {
        pv_tf32<T, HDP>(acc, s, Vs, g, t);
      }
      __syncthreads();  // this stage is consumed before it is refilled
    }

    // each quad holds a row's partial sums: total them, then store the
    // real columns of (B, S, H, hd), contiguous
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = fmaxf(l[r], 1e-30f);
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row[e >> 1], d = n * 8 + 2 * t + (e & 1);
        if (r < S && d < hd) {
          store(o + ((long long)(b * (long long)S + r) * H + h) * hd + d,
                acc[n][e] / l[e >> 1]);
        }
      }
    }
  }
}

template <typename T, int HDP>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int hd, Strides qs, Strides ks, Strides vs,
           float scale, int causal, int window, int vec,
           cudaStream_t stream) {
  using Gm = Geo<T, HDP>;
  auto kernel = flash_attention_kernel<T, HDP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Gm::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int BH = B * H;
  const dim3 grid((S + kBQ - 1) / kBQ, BH < kMaxGridY ? BH : kMaxGridY);
  kernel<<<grid, kThreads, Gm::kSmemBytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, H, BH, hd, qs, ks, vs,
      scale, causal, window, vec);
  return (int)cudaGetLastError();
}

// The template for HDP = hd rounded up to a multiple of 16.
template <typename T, int HDP = 16>
int dispatch_hd(int hdp, const void* q, const void* k, const void* v,
                void* o, int B, int S, int H, int hd, Strides qs, Strides ks,
                Strides vs, float scale, int causal, int window, int vec,
                cudaStream_t stream) {
  if constexpr (HDP > kMaxHeadDim) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (hdp == HDP) {
      return launch<T, HDP>(q, k, v, o, B, S, H, hd, qs, ks, vs, scale,
                            causal, window, vec, stream);
    }
    return dispatch_hd<T, HDP + 16>(hdp, q, k, v, o, B, S, H, hd, qs, ks, vs,
                                    scale, causal, window, vec, stream);
  }
}

// 16-byte chunks: hd a whole number of them, every base pointer aligned
// and every stride a whole number of chunks.
bool chunked(int hd, int chunk, const void* const* ptrs,
             const Strides* strides) {
  if (hd % chunk) return false;
  for (int i = 0; i < 3; ++i) {
    if ((uintptr_t)ptrs[i] % 16 || strides[i].b % chunk ||
        strides[i].s % chunk || strides[i].h % chunk) {
      return false;
    }
  }
  return true;
}

}  // namespace

// q, k, v: (B, S, H, hd) with element strides (sb, ss, sh) each and last
// stride 1; o: (B, S, H, hd) contiguous.  dtype: 0 = float32, 1 =
// bfloat16.  1 <= hd <= 256; window <= 0 means none.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int S, int H, int hd,
                               int dtype, long long q_sb, long long q_ss,
                               long long q_sh, long long k_sb, long long k_ss,
                               long long k_sh, long long v_sb, long long v_ss,
                               long long v_sh, float scale, int causal,
                               int window, void* stream) {
  if (B < 1 || S < 1 || H < 1 || hd < 1 || hd > kMaxHeadDim) {
    return (int)cudaErrorInvalidValue;
  }
  const Strides st[3] = {{q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh},
                         {v_sb, v_ss, v_sh}};
  const void* ptrs[3] = {q, k, v};
  const int hdp = (hd + 15) / 16 * 16;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return dispatch_hd<float>(hdp, q, k, v, o, B, S, H, hd, st[0], st[1],
                              st[2], scale, causal, window,
                              chunked(hd, 4, ptrs, st), s);
  }
  if (dtype == 1) {
    return dispatch_hd<__nv_bfloat16>(hdp, q, k, v, o, B, S, H, hd, st[0],
                                      st[1], st[2], scale, causal, window,
                                      chunked(hd, 8, ptrs, st), s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
