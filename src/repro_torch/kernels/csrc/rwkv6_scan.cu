// The RWKV6 WKV recurrence on (B, T, H, hd) r, k, v, logw and (H, hd) u,
// from a zero (hd x hd) state per (batch, head), output f32 (B, T, H, hd):
//
//   out_t = r_t (S + diag(u) k_t^T v_t),   S <- diag(exp(logw_t)) S + k_t^T v_t
//
// Replaces the Pallas TPU kernel `rwkv6_scan` of
// src/repro/kernels/rwkv6_scan.py, which carries S in VMEM scratch across
// a sequential grid of time chunks; here one block owns one (batch, head)
// and walks all T steps itself, since blocks run in no order.
//
// Design.  Thread j keeps column j of S (the rows i < hd, in f32) in
// registers for the whole scan.  Per chunk of kCH steps the block stages
// r_t, k_t, exp(logw_t) and v_t in shared memory (coalesced loads of hd
// contiguous values per step) and c_t = sum_i r_t,i u_i k_t,i, reduced
// with warp shuffles; then each step is, for thread j,
//
//   out_j = sum_i r_i S_ij + v_j c_t,   S_ij <- exp(logw_i) S_ij + k_i v_j
//
// (`repro`'s r (S + u k^T v) with the u term summed first).  Any hd up to
// 256: the templates take HDP = 16, 32, 64, 128 or 256 rows of S; where
// hd < HDP the rows past hd are masked (their r, k, logw are 0 and never
// loaded, so their S stays 0 and adds nothing) and the columns past hd
// are never stored.  hd == HDP takes an instantiation without masks, so
// the power-of-two head widths run with no masking in the loop.  Above 128 the columns of S split
// over ceil(hd / 128) blocks per (batch, head), since each column's
// recurrence is independent of the others', and two threads share a
// column, each holding half its rows (a shuffle adds the two halves of
// out_j).  The scan is a chain of T dependent steps with only B*H blocks
// (64 blocks at B = 1 for rwkv6-7b on 132 SMs), so it is bound by the
// latency of one step, not by the bytes it moves (r, k, v, logw read
// once, out written once) nor by its ~5 hd^2 FLOP per step.  Four partial
// sums break the dependent chain of the out_j reduction.
//
// Plain C entry point at the bottom, loaded with ctypes by
// repro_torch/kernels/rwkv6_scan.py: launches on the caller's stream,
// allocates nothing, returns cudaGetLastError().
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxGrid = 2147483647;

template <int HDP>
struct Geo {
  static constexpr int G = HDP > 128 ? 2 : 1;      // threads per column
  static constexpr int RPT = HDP / G;              // rows of S per thread
  static constexpr int CB = HDP < 128 ? HDP : 128; // columns per block
  static constexpr int NB = HDP / CB;              // blocks per (b, h)
  static constexpr int kThreads = CB * G;          // = min(HDP, 256)
  // steps staged per chunk: the four staged arrays stay within the 48 KB
  // of static shared memory
  static constexpr int kCH = HDP <= 64 ? 32 : (HDP <= 128 ? 16 : 8);
  static constexpr int kWarps = (kThreads + 31) / 32;
  static_assert(kThreads == HDP || (G == 2 && kThreads == 256), "geometry");
};

struct Strides {
  long long b, t, h;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// MASKED: hd < HDP, so the rows and columns past hd are masked; false
// when hd == HDP, where every mask is a compile-time constant.
template <typename T, int HDP, bool MASKED>
__global__ void __launch_bounds__(Geo<HDP>::kThreads)
    rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ logw,
                      const float* __restrict__ u, float* __restrict__ out,
                      int T_len, int H, int hd, Strides rs, Strides ks,
                      Strides vs, Strides ws) {
  using Gm = Geo<HDP>;
  constexpr int CH = Gm::kCH, G = Gm::G, RPT = Gm::RPT, CB = Gm::CB;
  __shared__ __align__(16) float r_s[CH][HDP];
  __shared__ __align__(16) float k_s[CH][HDP];
  __shared__ __align__(16) float w_s[CH][HDP];
  __shared__ float v_s[CH][CB];
  __shared__ float part[CH][Gm::kWarps];
  __shared__ float c_s[CH];

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int bh = blockIdx.x / Gm::NB, jb = blockIdx.x % Gm::NB;
  const int b = bh / H, h = bh % H;
  // staging: thread tid loads row index i = tid of r, k, logw (and u),
  // and column jb * CB + tid of v for tid < CB.  The rows past hd are
  // zeroed once here and never written again, so the staging loop has no
  // masking beyond skipping those lanes; the columns past hd are never
  // stored, so their v may hold anything.
  const bool row_in = !MASKED || tid < hd;
  const T* rb = r + b * rs.b + h * rs.h + tid;
  const T* kb = k + b * ks.b + h * ks.h + tid;
  const T* wb = logw + b * ws.b + h * ws.h + tid;
  const float ui = row_in ? u[h * hd + tid] : 0.f;
  const int jv = jb * CB + tid;
  const bool v_in = (G == 1 || tid < CB) && (!MASKED || jv < hd);
  const T* vb = v + b * vs.b + h * vs.h + jv;
  if (!row_in) {
    for (int tt = 0; tt < CH; ++tt) {
      r_s[tt][tid] = 0.f;
      k_s[tt][tid] = 0.f;
      w_s[tt][tid] = 0.f;
    }
  }
  // compute: thread (jl, g) owns column jb * CB + jl, rows g*RPT..+RPT
  const int jl = tid / G, g = tid % G;
  const int j = jb * CB + jl;
  float* ob = out + ((long long)b * T_len * H + h) * hd + j;
  constexpr int kRed = Gm::kThreads < 32 ? Gm::kThreads : 32;
  const unsigned mask =
      kRed == 32 ? 0xffffffffu : (1u << Gm::kThreads) - 1u;

  float Sc[RPT];  // rows g*RPT + i of column j of S
#pragma unroll
  for (int i = 0; i < RPT; ++i) Sc[i] = 0.f;

  for (int t0 = 0; t0 < T_len; t0 += CH) {
    const int n = min(CH, T_len - t0);
    for (int tt = 0; tt < n; ++tt) {
      const long long t = t0 + tt;
      float x = 0.f;
      if (row_in) {
        const float ri = to_f32(rb[t * rs.t]);
        const float ki = to_f32(kb[t * ks.t]);
        r_s[tt][tid] = ri;
        k_s[tt][tid] = ki;
        w_s[tt][tid] = expf(to_f32(wb[t * ws.t]));
        x = ri * ui * ki;
      }
      if (v_in) v_s[tt][tid] = to_f32(vb[t * vs.t]);
#pragma unroll
      for (int off = kRed / 2; off > 0; off >>= 1) {
        x += __shfl_xor_sync(mask, x, off);
      }
      if (lane == 0) part[tt][warp] = x;
    }
    __syncthreads();
    for (int tt = tid; tt < n; tt += Gm::kThreads) {
      float c = 0.f;
#pragma unroll
      for (int wi = 0; wi < Gm::kWarps; ++wi) c += part[tt][wi];
      c_s[tt] = c;
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float vj = v_s[tt][jl];
      const float4* r4 = reinterpret_cast<const float4*>(r_s[tt] + g * RPT);
      const float4* k4 = reinterpret_cast<const float4*>(k_s[tt] + g * RPT);
      const float4* w4 = reinterpret_cast<const float4*>(w_s[tt] + g * RPT);
      float o0 = 0.f, o1 = 0.f, o2 = 0.f, o3 = 0.f;
#pragma unroll
      for (int i4 = 0; i4 < RPT / 4; ++i4) {
        const float4 ri = r4[i4], ki = k4[i4], wi = w4[i4];
        const int i = 4 * i4;
        o0 += ri.x * Sc[i];
        o1 += ri.y * Sc[i + 1];
        o2 += ri.z * Sc[i + 2];
        o3 += ri.w * Sc[i + 3];
        Sc[i] = wi.x * Sc[i] + ki.x * vj;
        Sc[i + 1] = wi.y * Sc[i + 1] + ki.y * vj;
        Sc[i + 2] = wi.z * Sc[i + 2] + ki.z * vj;
        Sc[i + 3] = wi.w * Sc[i + 3] + ki.w * vj;
      }
      float o = (o0 + o1) + (o2 + o3);
      if (G == 2) o += __shfl_xor_sync(0xffffffffu, o, 1);
      if (g == 0 && (!MASKED || j < hd)) {
        ob[(long long)(t0 + tt) * H * hd] = o + vj * c_s[tt];
      }
    }
    __syncthreads();  // the chunk is consumed before the next is staged
  }
}

template <typename T, int HDP, bool MASKED>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const float* u, float* out, int B, int T_len, int H, int hd,
           Strides rs, Strides ks, Strides vs, Strides ws,
           cudaStream_t stream) {
  using Gm = Geo<HDP>;
  const long long blocks = (long long)B * H * Gm::NB;
  if (blocks > kMaxGrid) return (int)cudaErrorInvalidValue;
  rwkv6_scan_kernel<T, HDP, MASKED>
      <<<(unsigned)blocks, Gm::kThreads, 0, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const T*)logw, u, out, T_len, H,
      hd, rs, ks, vs, ws);
  return (int)cudaGetLastError();
}

template <typename T, int HDP>
int launch_hd(const void* r, const void* k, const void* v, const void* logw,
              const float* u, float* out, int B, int T_len, int H, int hd,
              Strides rs, Strides ks, Strides vs, Strides ws,
              cudaStream_t s) {
  if (hd == HDP) {
    return launch<T, HDP, false>(r, k, v, logw, u, out, B, T_len, H, hd, rs,
                                 ks, vs, ws, s);
  }
  return launch<T, HDP, true>(r, k, v, logw, u, out, B, T_len, H, hd, rs, ks,
                              vs, ws, s);
}

template <typename T>
int dispatch_hd(int hd, const void* r, const void* k, const void* v,
                const void* logw, const float* u, float* out, int B, int T_len,
                int H, Strides rs, Strides ks, Strides vs, Strides ws,
                cudaStream_t s) {
  if (hd < 1) return (int)cudaErrorInvalidValue;
  if (hd <= 16) {
    return launch_hd<T, 16>(r, k, v, logw, u, out, B, T_len, H, hd, rs, ks,
                            vs, ws, s);
  }
  if (hd <= 32) {
    return launch_hd<T, 32>(r, k, v, logw, u, out, B, T_len, H, hd, rs, ks,
                            vs, ws, s);
  }
  if (hd <= 64) {
    return launch_hd<T, 64>(r, k, v, logw, u, out, B, T_len, H, hd, rs, ks,
                            vs, ws, s);
  }
  if (hd <= 128) {
    return launch_hd<T, 128>(r, k, v, logw, u, out, B, T_len, H, hd, rs, ks,
                             vs, ws, s);
  }
  if (hd <= 256) {
    return launch_hd<T, 256>(r, k, v, logw, u, out, B, T_len, H, hd, rs, ks,
                             vs, ws, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// r, k, v, logw: (B, T, H, hd) with element strides (sb, st, sh) each and
// last stride 1; u: (H, hd) f32 contiguous; out: (B, T, H, hd) f32
// contiguous.  dtype (of r, k, v, logw): 0 = float32, 1 = bfloat16.
// 1 <= hd <= 256.
extern "C" int rwkv6_scan(const void* r, const void* k, const void* v,
                          const void* logw, const float* u, float* out, int B,
                          int T_len, int H, int hd, int dtype, long long r_sb,
                          long long r_st, long long r_sh, long long k_sb,
                          long long k_st, long long k_sh, long long v_sb,
                          long long v_st, long long v_sh, long long w_sb,
                          long long w_st, long long w_sh, void* stream) {
  if (B < 1 || T_len < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const Strides rs{r_sb, r_st, r_sh}, ks{k_sb, k_st, k_sh},
      vs{v_sb, v_st, v_sh}, ws{w_sb, w_st, w_sh};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return dispatch_hd<float>(hd, r, k, v, logw, u, out, B, T_len, H, rs, ks,
                              vs, ws, s);
  }
  if (dtype == 1) {
    return dispatch_hd<__nv_bfloat16>(hd, r, k, v, logw, u, out, B, T_len, H,
                                      rs, ks, vs, ws, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
