// Gossip mat-vecs on stacked per-agent state Y (n agents x d features),
// the only cross-agent operations of DAGM (Algorithm 2):
//
//   circulant_mix      W.Y or (I-W).Y for shift-invariant W (ring, circulant)
//   sparse_mix         W.Y or (I-W).Y for any W from padded (n, k) tables
//   circulant_neumann  one DIHGP Neumann iteration (Eq. 14) fused with W.h
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

// Replaces repro/kernels/mixing_matvec.py:circulant_mix_matvec (plain
// path, _mix_body).
// Bound: bytes.  Each output element needs its own input plus k neighbor
// rows and 2(k+1) FLOP, so per byte moved (one read of Y, one write of
// out) the work is < 1 FLOP/B, far below the H100's ~20 FLOP/B f32 ridge.
// Design: one thread per output element (i, j), threads along the
// feature axis j, so every neighbor-row read of a warp is one coalesced
// segment; the k re-reads of a row by other agents' blocks hit L2.
// f32 accumulation in repro's order: w_self*y_i, then + c_t*y_{(i+o_t)%n}
// in offset order, then y_i - acc for the Laplacian.  The ragged edge
// j >= d is masked, so any d works.
template <typename T>
__global__ void circulant_mix_kernel(const T* __restrict__ y,
                                     T* __restrict__ out, int n, int d,
                                     Circ c, int laplacian) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= d) return;
  for (int i = blockIdx.y; i < n; i += gridDim.y) {
    const size_t at = (size_t)i * d + j;
    const float yi = load_f32(y, at);
    float acc = c.w_self * yi;
    for (int t = 0; t < c.k; ++t) {
      int src = i + __ldg(c.off + t);
      if (src >= n) src -= n;
      acc = acc + __ldg(c.w + t) * load_f32(y, (size_t)src * d + j);
    }
    if (laplacian) acc = yi - acc;
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
    float acc = w_self[i] * yi;
    const int* ni = nbr + (size_t)i * k;
    const float* wi = wts + (size_t)i * k;
    for (int t = 0; t < k; ++t) {
      acc = acc + wi[t] * load_f32(y, (size_t)ni[t] * d + j);
    }
    if (laplacian) acc = yi - acc;
    store_f32(out, at, acc);
  }
}

// Replaces repro/kernels/mixing_matvec.py:circulant_neumann_step (plain
// path, _neumann_body).
// Bound: bytes: reads h, hvp_h and p once and writes h+, with
// 2(k+1) + 6 FLOP per element.
// Design: circulant_mix's layout; the mix stays in a register and the
// Eq. 14 update (D*h - (h - mix) - beta*hvp - p) / D is applied in the
// same thread, dividing as repro does.  beta is a runtime scalar.
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
    float mix = c.w_self * hi;
    for (int t = 0; t < c.k; ++t) {
      int src = i + __ldg(c.off + t);
      if (src >= n) src -= n;
      mix = mix + __ldg(c.w + t) * load_f32(h, (size_t)src * d + j);
    }
    const float di = dsc[i];
    const float num =
        di * hi - (hi - mix) - beta * load_f32(hvp, at) - load_f32(p, at);
    store_f32(out, at, num / di);
  }
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

extern "C" const char* mixing_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
