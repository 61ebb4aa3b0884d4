// Online-softmax attention on (B, S, H, hd) q, k, v with the same head
// count (grouped-query heads are broadcast by the caller), f32 or bf16 in,
// f32 arithmetic, output in the input's type.
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
// Design.  One block per (q tile of kBQ = 64 rows, batch * head).  K and
// V tiles of kBK = 64 keys are staged in shared memory as f32 (64 KB at
// hd = 128, above the 48 KB default: the launch opts in).  kG = hd / 32
// threads share a q row, each holding 32 of its dims of q and of the f32
// accumulator in registers, for kR = 2 rows, so every K or V value read
// from shared memory feeds 2 FMAs; a row's dot products are summed across
// its kG threads with xor shuffles.  The online softmax runs per chunk of
// kKC = 16 keys: one rescale of the accumulator per chunk.  q.k^T and p.V
// are CUDA-core FMAs in f32 (no tensor cores yet), so the kernel is bound
// by f32 operations: ~4 hd FLOP per unmasked (q, k) pair, against 67
// TFLOP/s, where the bf16 bound of the same work is 989 TFLOP/s.
//
// Plain C entry point at the bottom, loaded with ctypes by
// repro_torch/kernels/flash_attention.py: launches on the caller's
// stream, allocates nothing, returns cudaGetLastError().
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;   // q rows per block
constexpr int kBK = 64;   // keys per staged K/V tile
constexpr int kR = 2;     // q rows per thread
constexpr int kKC = 16;   // keys per online-softmax chunk
constexpr float kNegInf = -1e30f;
constexpr int kMaxGridY = 65535;

template <int HD>
struct Geo {
  static constexpr int G = HD >= 32 ? HD / 32 : 1;  // threads per q row
  static constexpr int D = HD / G;                  // dims per thread
  static constexpr int NV = D / 4;                  // float4s per thread
  static constexpr int kThreads = kBQ / kR * G;
  static constexpr int kSmemBytes = 2 * kBK * HD * 4;
  static_assert(HD % 4 == 0 && D % 4 == 0, "head dim");
};

// Element strides of a (B, S, H, hd) operand whose last stride is 1.
struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

template <typename T, int HD>
__global__ void __launch_bounds__(Geo<HD>::kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int S,
                           int H, int BH, Strides qs, Strides ks, Strides vs,
                           float scale, int causal, int window) {
  using Gm = Geo<HD>;
  constexpr int G = Gm::G, NV = Gm::NV;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // (kBK, HD)
  float* Vs = Ks + kBK * HD;                    // (kBK, HD)

  const int tid = threadIdx.x;
  const int g = tid % G;
  const int row0 = (tid / G) * kR;  // first of this thread's kR rows
  // heavy causal tiles (late q) first: they start before the light ones
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;

  for (int bh = blockIdx.y; bh < BH; bh += gridDim.y) {
    const int b = bh / H, h = bh % H;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* kb = k + b * ks.b + h * ks.h;
    const T* vb = v + b * vs.b + h * vs.h;

    // this thread's dims of its rows: float4 f = i*G + g, dims 4f..4f+3
    float qr[kR][4 * NV], acc[kR][4 * NV], m[kR], l[kR];
    int row[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      row[r] = q0 + row0 + r;
      m[r] = kNegInf;
      l[r] = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int d = 4 * (i * G + g) + c;
          qr[r][4 * i + c] =
              row[r] < S ? to_f32(qb[row[r] * qs.s + d]) : 0.f;
          acc[r][4 * i + c] = 0.f;
        }
      }
    }

    // the kv tiles the masks do not wholly exclude
    const int q_last = q0 + kBQ - 1;
    int kt_lo = 0, kt_hi = (S - 1) / kBK;
    if (causal) kt_hi = min(kt_hi, q_last / kBK);
    if (window > 0 && q0 - window + 1 > 0) kt_lo = (q0 - window + 1) / kBK;

    for (int kt = kt_lo; kt <= kt_hi; ++kt) {
      const int k0 = kt * kBK;
      __syncthreads();  // the previous tile is consumed
      for (int idx = tid; idx < kBK * HD; idx += Gm::kThreads) {
        const int j = idx / HD, d = idx % HD;
        const bool in = k0 + j < S;
        Ks[idx] = in ? to_f32(kb[(k0 + j) * ks.s + d]) : 0.f;
        Vs[idx] = in ? to_f32(vb[(k0 + j) * vs.s + d]) : 0.f;
      }
      __syncthreads();
      // no mask inside this tile: every key <= every row (causal), every
      // row - key < window, and every key in range
      const bool full = (!causal || k0 + kBK - 1 <= q0) &&
                        (window <= 0 || q_last - k0 < window) &&
                        k0 + kBK <= S;

      for (int jc = 0; jc < kBK; jc += kKC) {
        float s[kR][kKC];
#pragma unroll
        for (int jj = 0; jj < kKC; ++jj) {
          const float4* kr =
              reinterpret_cast<const float4*>(Ks + (jc + jj) * HD);
#pragma unroll
          for (int r = 0; r < kR; ++r) s[r][jj] = 0.f;
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            const float4 kv = kr[i * G + g];
#pragma unroll
            for (int r = 0; r < kR; ++r) {
              s[r][jj] += qr[r][4 * i] * kv.x + qr[r][4 * i + 1] * kv.y +
                          qr[r][4 * i + 2] * kv.z + qr[r][4 * i + 3] * kv.w;
            }
          }
        }
        // sum each dot product over the row's G threads, scale, mask
#pragma unroll
        for (int r = 0; r < kR; ++r) {
#pragma unroll
          for (int jj = 0; jj < kKC; ++jj) {
            float x = s[r][jj];
#pragma unroll
            for (int off = G / 2; off > 0; off >>= 1) {
              x += __shfl_xor_sync(0xffffffffu, x, off);
            }
            x *= scale;
            if (!full) {
              const int key = k0 + jc + jj;
              if (key >= S || (causal && key > row[r]) ||
                  (window > 0 && row[r] - key >= window)) {
                x = kNegInf;
              }
            }
            s[r][jj] = x;
          }
        }
        // online softmax over the chunk; masked keys weigh exactly 0
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          float mc = m[r];
#pragma unroll
          for (int jj = 0; jj < kKC; ++jj) mc = fmaxf(mc, s[r][jj]);
          const float corr = expf(m[r] - mc);
          float psum = 0.f;
#pragma unroll
          for (int jj = 0; jj < kKC; ++jj) {
            const float p = s[r][jj] == kNegInf ? 0.f : expf(s[r][jj] - mc);
            s[r][jj] = p;
            psum += p;
          }
          l[r] = l[r] * corr + psum;
          m[r] = mc;
#pragma unroll
          for (int d = 0; d < 4 * NV; ++d) acc[r][d] *= corr;
        }
#pragma unroll
        for (int jj = 0; jj < kKC; ++jj) {
          const float4* vr =
              reinterpret_cast<const float4*>(Vs + (jc + jj) * HD);
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            const float4 vv = vr[i * G + g];
#pragma unroll
            for (int r = 0; r < kR; ++r) {
              acc[r][4 * i] += s[r][jj] * vv.x;
              acc[r][4 * i + 1] += s[r][jj] * vv.y;
              acc[r][4 * i + 2] += s[r][jj] * vv.z;
              acc[r][4 * i + 3] += s[r][jj] * vv.w;
            }
          }
        }
      }
    }

    // output (B, S, H, hd), contiguous
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (row[r] >= S) continue;
      const float den = fmaxf(l[r], 1e-30f);
      T* orow = o + ((long long)(b * S + row[r]) * H + h) * HD;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          store(orow + 4 * (i * G + g) + c, acc[r][4 * i + c] / den);
        }
      }
    }
    __syncthreads();  // K/V tiles of this (b, h) are consumed
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, Strides qs, Strides ks, Strides vs, float scale,
           int causal, int window, cudaStream_t stream) {
  using Gm = Geo<HD>;
  auto kernel = flash_attention_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Gm::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int BH = B * H;
  const dim3 grid((S + kBQ - 1) / kBQ, BH < kMaxGridY ? BH : kMaxGridY);
  kernel<<<grid, Gm::kThreads, Gm::kSmemBytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, H, BH, qs, ks, vs,
      scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                int B, int S, int H, Strides qs, Strides ks, Strides vs,
                float scale, int causal, int window, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, S, H, qs, ks, vs, scale, causal,
                           window, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, S, H, qs, ks, vs, scale, causal,
                           window, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, S, H, qs, ks, vs, scale, causal,
                           window, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, S, H, qs, ks, vs, scale, causal,
                            window, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, S, H, qs, ks, vs, scale, causal,
                            window, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v: (B, S, H, hd) with element strides (sb, ss, sh) each and last
// stride 1; o: (B, S, H, hd) contiguous.  dtype: 0 = float32, 1 =
// bfloat16.  hd in {16, 32, 64, 128, 256}; window <= 0 means none.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int S, int H, int hd,
                               int dtype, long long q_sb, long long q_ss,
                               long long q_sh, long long k_sb, long long k_ss,
                               long long k_sh, long long v_sb, long long v_ss,
                               long long v_sh, float scale, int causal,
                               int window, void* stream) {
  if (B < 1 || S < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return dispatch_hd<float>(hd, q, k, v, o, B, S, H, qs, ks, vs, scale,
                              causal, window, s);
  }
  if (dtype == 1) {
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, S, H, qs, ks, vs,
                                      scale, causal, window, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
