// Shared device helpers for the flat-layout kernels (hidden width 64).
//
// Work split used by every kernel here: one warp owns whole 64-wide rows;
// lane l holds features 2l and 2l+1 of each row as a float2. A row of the
// flat (rows, B*64) layout for batch element b is 64 contiguous floats at
// column b*64, so each row load or store is 256 contiguous bytes.
// Matrix products x @ w (w stored (in, out) row-major, as the parameters
// are) stage the warp's input rows in shared memory and read each input
// value as a broadcast: every lane accumulates its two output columns over
// all inputs (`nlt_mm64`). LayerNorm statistics are fp32 warp-shuffle sums.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define NLT_H 64

// X(K) for each slot count the K-templated kernels are instantiated for.
#define NLT_FOR_K(X) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8)

constexpr float NLT_LN_EPS = 1e-5f;

__device__ __forceinline__ float nlt_silu(float x) {
  return x / (1.0f + expf(-x));
}

__device__ __forceinline__ float2 nlt_silu2(float2 v) {
  return make_float2(nlt_silu(v.x), nlt_silu(v.y));
}

__device__ __forceinline__ float2 nlt_add2(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float nlt_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Row load/store of this lane's two features of a 64-wide row.
__device__ __forceinline__ float2 nlt_ld2(const float* __restrict__ row,
                                          int lane) {
  return reinterpret_cast<const float2*>(row)[lane];
}

__device__ __forceinline__ void nlt_st2(float* row, int lane, float2 v) {
  reinterpret_cast<float2*>(row)[lane] = v;
}

// Storage types: float, or __nv_bfloat16 for the bf16 instances, which
// convert to fp32 on load, compute in fp32 and round to nearest even on
// store.
template <typename T>
struct Io;

template <>
struct Io<float> {
  // two consecutive values at p (8-byte aligned)
  static __device__ __forceinline__ float2 ld2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ void st2(float* p, float2 v) {
    *reinterpret_cast<float2*>(p) = v;
  }
  static __device__ __forceinline__ float ld(const float* p) { return *p; }
  static __device__ __forceinline__ void st(float* p, float v) { *p = v; }
};

template <>
struct Io<__nv_bfloat16> {
  // two consecutive values at p (4-byte aligned)
  static __device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  static __device__ __forceinline__ void st2(__nv_bfloat16* p, float2 v) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
  }
  static __device__ __forceinline__ float ld(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

// Row load/store of this lane's two features of a 64-wide row of T.
template <typename T>
__device__ __forceinline__ float2 nlt_ld2t(const T* __restrict__ row,
                                           int lane) {
  return Io<T>::ld2(row + 2 * lane);
}

template <typename T>
__device__ __forceinline__ void nlt_st2t(T* row, int lane, float2 v) {
  Io<T>::st2(row + 2 * lane, v);
}

// acc[r] += xs[r*ldx + k] * w[k, 2*lane .. 2*lane+1] for k < nk.
// xs: R staged input rows in shared memory; w: (nk, 64) row-major, shared.
template <int R>
__device__ __forceinline__ void nlt_mm64(const float* __restrict__ xs,
                                         int ldx,
                                         const float* __restrict__ w, int nk,
                                         int lane, float2 (&acc)[R]) {
  const float2* wl = reinterpret_cast<const float2*>(w) + lane;
#pragma unroll 4
  for (int k = 0; k < nk; ++k) {
    const float2 wv = wl[k * (NLT_H / 2)];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float xv = xs[r * ldx + k];
      acc[r].x = fmaf(xv, wv.x, acc[r].x);
      acc[r].y = fmaf(xv, wv.y, acc[r].y);
    }
  }
}

template <int R>
__device__ __forceinline__ void nlt_fill(float2 (&acc)[R], float2 v) {
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = v;
}

// LayerNorm of one 64-wide row held as a float2 per lane; fp32 statistics.
__device__ __forceinline__ float2 nlt_layer_norm(float2 y, float2 scale,
                                                 float2 bias) {
  const float mean = nlt_warp_sum(y.x + y.y) * (1.0f / NLT_H);
  const float cx = y.x - mean, cy = y.y - mean;
  const float var = nlt_warp_sum(cx * cx + cy * cy) * (1.0f / NLT_H);
  const float inv = rsqrtf(var + NLT_LN_EPS);
  return make_float2(cx * inv * scale.x + bias.x, cy * inv * scale.y + bias.y);
}

// Copy n floats from device memory into shared memory, whole block.
__device__ __forceinline__ void nlt_load_params(float* dst,
                                                const float* __restrict__ src,
                                                int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// Raises the dynamic shared-memory limit of `kernel` when a block needs
// more than the default 48 KB.
template <typename Kernel>
static cudaError_t nlt_allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The current device's SM count and the blocks of `kernel` that can be
// resident on one SM. Raises the shared-memory limit too.
template <typename Kernel>
static cudaError_t nlt_occupancy(Kernel kernel, int threads, size_t smem,
                                 int* sms, int* per_sm) {
  cudaError_t err = nlt_allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  return *per_sm < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// Grid size for a grid-stride kernel: enough blocks for `blocks_needed`,
// capped at what can be resident at once, so each block loads its
// parameters into shared memory once. Raises the shared-memory limit too.
template <typename Kernel>
static cudaError_t nlt_launch_config(Kernel kernel, int threads, size_t smem,
                                     long long blocks_needed, int* grid) {
  int sms = 0, per_sm = 0;
  cudaError_t err = nlt_occupancy(kernel, threads, smem, &sms, &per_sm);
  if (err != cudaSuccess) return err;
  const long long cap = (long long)sms * per_sm;
  long long g = blocks_needed < cap ? blocks_needed : cap;
  *grid = (int)(g < 1 ? 1 : g);
  return cudaSuccess;
}

extern "C" const char* nlt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
