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
// Design.  hd threads per block; thread j keeps column j of S (hd f32) in
// registers for the whole scan.  Per chunk of kCH steps the block stages
// r_t, k_t, exp(logw_t) and v_t in shared memory (coalesced loads of hd
// contiguous values per step) and c_t = sum_i r_t,i u_i k_t,i, reduced
// with warp shuffles; then each step is, for thread j,
//
//   out_j = sum_i r_i S_ij + v_j c_t,   S_ij <- exp(logw_i) S_ij + k_i v_j
//
// (`repro`'s r (S + u k^T v) with the u term summed first).  The scan is a
// chain of T dependent steps with only B*H blocks of hd threads (64 blocks
// at B = 1 for rwkv6-7b on 132 SMs), so it is bound by the latency of one
// step, not by the bytes it moves (r, k, v, logw read once, out written
// once) nor by its ~5 hd^2 FLOP per step.  Four partial sums break the
// dependent chain of the out_j reduction.
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

template <int HD>
struct Geo {
  // steps staged per chunk: the four (kCH, HD) f32 arrays stay within the
  // 48 KB of static shared memory
  static constexpr int kCH = HD <= 64 ? 32 : 16;
  static constexpr int kWarps = (HD + 31) / 32;
  static_assert(HD % 4 == 0 && (HD <= 32 || HD % 32 == 0), "head dim");
};

struct Strides {
  long long b, t, h;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
    rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ logw,
                      const float* __restrict__ u, float* __restrict__ out,
                      int T_len, int H, Strides rs, Strides ks, Strides vs,
                      Strides ws) {
  using Gm = Geo<HD>;
  constexpr int CH = Gm::kCH;
  __shared__ __align__(16) float r_s[CH][HD];
  __shared__ __align__(16) float k_s[CH][HD];
  __shared__ __align__(16) float w_s[CH][HD];
  __shared__ float v_s[CH][HD];
  __shared__ float part[CH][Gm::kWarps];
  __shared__ float c_s[CH];

  const int j = threadIdx.x;
  const int lane = j % 32, warp = j / 32;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const T* rb = r + b * rs.b + h * rs.h + j;
  const T* kb = k + b * ks.b + h * ks.h + j;
  const T* vb = v + b * vs.b + h * vs.h + j;
  const T* wb = logw + b * ws.b + h * ws.h + j;
  float* ob = out + ((long long)b * T_len * H + h) * HD + j;
  const float uj = u[h * HD + j];
  const unsigned mask = HD >= 32 ? 0xffffffffu : (1u << HD) - 1u;

  float Sc[HD];  // column j of S: Sc[i] = S_ij
#pragma unroll
  for (int i = 0; i < HD; ++i) Sc[i] = 0.f;

  for (int t0 = 0; t0 < T_len; t0 += CH) {
    const int n = min(CH, T_len - t0);
    for (int tt = 0; tt < n; ++tt) {
      const long long t = t0 + tt;
      const float rj = to_f32(rb[t * rs.t]);
      const float kj = to_f32(kb[t * ks.t]);
      r_s[tt][j] = rj;
      k_s[tt][j] = kj;
      w_s[tt][j] = expf(to_f32(wb[t * ws.t]));
      v_s[tt][j] = to_f32(vb[t * vs.t]);
      float x = rj * uj * kj;
#pragma unroll
      for (int off = (HD < 32 ? HD : 32) / 2; off > 0; off >>= 1) {
        x += __shfl_xor_sync(mask, x, off);
      }
      if (lane == 0) part[tt][warp] = x;
    }
    __syncthreads();
    for (int tt = j; tt < n; tt += HD) {
      float c = 0.f;
#pragma unroll
      for (int w = 0; w < Gm::kWarps; ++w) c += part[tt][w];
      c_s[tt] = c;
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float vj = v_s[tt][j];
      const float4* r4 = reinterpret_cast<const float4*>(r_s[tt]);
      const float4* k4 = reinterpret_cast<const float4*>(k_s[tt]);
      const float4* w4 = reinterpret_cast<const float4*>(w_s[tt]);
      float o0 = 0.f, o1 = 0.f, o2 = 0.f, o3 = 0.f;
#pragma unroll
      for (int i4 = 0; i4 < HD / 4; ++i4) {
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
      ob[(long long)(t0 + tt) * H * HD] = (o0 + o1) + (o2 + o3) + vj * c_s[tt];
    }
    __syncthreads();  // the chunk is consumed before the next is staged
  }
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const float* u, float* out, int B, int T_len, int H, Strides rs,
           Strides ks, Strides vs, Strides ws, cudaStream_t stream) {
  const long long blocks = (long long)B * H;
  if (blocks > kMaxGrid) return (int)cudaErrorInvalidValue;
  rwkv6_scan_kernel<T, HD><<<(unsigned)blocks, HD, 0, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const T*)logw, u, out, T_len, H,
      rs, ks, vs, ws);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* r, const void* k, const void* v,
                const void* logw, const float* u, float* out, int B, int T_len,
                int H, Strides rs, Strides ks, Strides vs, Strides ws,
                cudaStream_t s) {
  switch (hd) {
    case 16:
      return launch<T, 16>(r, k, v, logw, u, out, B, T_len, H, rs, ks, vs, ws,
                           s);
    case 32:
      return launch<T, 32>(r, k, v, logw, u, out, B, T_len, H, rs, ks, vs, ws,
                           s);
    case 64:
      return launch<T, 64>(r, k, v, logw, u, out, B, T_len, H, rs, ks, vs, ws,
                           s);
    case 128:
      return launch<T, 128>(r, k, v, logw, u, out, B, T_len, H, rs, ks, vs,
                            ws, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v, logw: (B, T, H, hd) with element strides (sb, st, sh) each and
// last stride 1; u: (H, hd) f32 contiguous; out: (B, T, H, hd) f32
// contiguous.  dtype (of r, k, v, logw): 0 = float32, 1 = bfloat16.
// hd in {16, 32, 64, 128}.
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
