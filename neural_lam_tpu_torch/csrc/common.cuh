// Shared device helpers for the flat-layout kernels (hidden width NLT_H).
//
// NLT_H is the hidden width a library is compiled for (`-DNLT_H=<h>`, one
// library a width: ops/_build.py); 64 when the compiler is given none.
// Every source, forward and backward, is built at each width.
//
// Work split of the width-H row helpers (`Cols`): one warp owns whole
// H-wide rows; lane l holds the NLT_C = H/32 consecutive features NLT_C*l
// .. of each row. A row of the flat (rows, B*H) layout for batch element
// b is H contiguous floats at column b*H, so each row load or store is one
// coalesced access. Matrix products x @ w (w stored (in, out) row-major,
// as the parameters are) stage the warp's input rows in shared memory and
// read each input value as a broadcast: every lane accumulates its NLT_C
// output columns over all inputs (`cols_mm`). LayerNorm statistics are
// fp32 warp-shuffle sums.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#ifndef NLT_H
#define NLT_H 64
#endif
static_assert(NLT_H == 32 || NLT_H == 64 || NLT_H == 128,
              "the hidden widths a library is built for: 32, 64, 128");

// X(K) for each slot count the K-templated kernels are instantiated for.
#define NLT_FOR_K(X) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8)

constexpr float NLT_LN_EPS = 1e-5f;

__device__ __forceinline__ float nlt_silu(float x) {
  return x / (1.0f + expf(-x));
}

__device__ __forceinline__ float2 nlt_add2(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float nlt_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// This lane's float2 at index 2*lane of a row (a fragment's two columns
// where `lane` is a quad index).
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

// ---------------------------------------------------- width-H rows ----
//
// Lane l holds the NLT_C = H/32 consecutive features NLT_C*l .. of a row:
// a float at width 32, a float2 at 64, a float4 at 128, so a row load or
// store is one coalesced access.

constexpr int NLT_C = NLT_H / 32;

struct Cols {
  float v[NLT_C];
};

__device__ __forceinline__ Cols cols_fill(float x) {
  Cols c;
#pragma unroll
  for (int i = 0; i < NLT_C; ++i) c.v[i] = x;
  return c;
}

// This lane's features of the fp32 row at p (shared or device memory).
__device__ __forceinline__ Cols cols_ld(const float* p, int lane) {
  Cols c;
  p += NLT_C * lane;
  if constexpr (NLT_C == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    c.v[0] = v.x, c.v[1] = v.y, c.v[2] = v.z, c.v[3] = v.w;
  } else if constexpr (NLT_C == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    c.v[0] = v.x, c.v[1] = v.y;
  } else {
    c.v[0] = *p;
  }
  return c;
}

__device__ __forceinline__ void cols_st(float* p, int lane, const Cols& c) {
  p += NLT_C * lane;
  if constexpr (NLT_C == 4)
    *reinterpret_cast<float4*>(p) = make_float4(c.v[0], c.v[1], c.v[2],
                                                c.v[3]);
  else if constexpr (NLT_C == 2)
    *reinterpret_cast<float2*>(p) = make_float2(c.v[0], c.v[1]);
  else
    *p = c.v[0];
}

// The same for a row of T (float, or bf16 converted to fp32).
template <typename T>
__device__ __forceinline__ Cols cols_ldt(const T* __restrict__ row,
                                         int lane) {
  if constexpr (sizeof(T) == sizeof(float)) {
    return cols_ld(reinterpret_cast<const float*>(row), lane);
  } else {
    Cols c;
    const T* p = row + NLT_C * lane;
    if constexpr (NLT_C == 1) {
      c.v[0] = Io<T>::ld(p);
    } else {
#pragma unroll
      for (int i = 0; i < NLT_C; i += 2) {
        const float2 v = Io<T>::ld2(p + i);
        c.v[i] = v.x, c.v[i + 1] = v.y;
      }
    }
    return c;
  }
}

// This lane's features stored into the row of T at `row` (a bf16 value
// rounded once, to nearest even).
template <typename T>
__device__ __forceinline__ void cols_stt(T* row, int lane, const Cols& c) {
  if constexpr (sizeof(T) == sizeof(float)) {
    cols_st(reinterpret_cast<float*>(row), lane, c);
  } else {
    T* p = row + NLT_C * lane;
    if constexpr (NLT_C == 1) {
      Io<T>::st(p, c.v[0]);
    } else {
#pragma unroll
      for (int i = 0; i < NLT_C; i += 2)
        Io<T>::st2(p + i, make_float2(c.v[i], c.v[i + 1]));
    }
  }
}

// This lane's features of the fp32 row at p, stored streaming (evict
// first): scratch rows that a later pass reads once.
__device__ __forceinline__ void cols_stcs(float* p, int lane, const Cols& c) {
  p += NLT_C * lane;
  if constexpr (NLT_C == 4)
    __stcs(reinterpret_cast<float4*>(p),
           make_float4(c.v[0], c.v[1], c.v[2], c.v[3]));
  else if constexpr (NLT_C == 2)
    __stcs(reinterpret_cast<float2*>(p), make_float2(c.v[0], c.v[1]));
  else
    __stcs(p, c.v[0]);
}

__device__ __forceinline__ Cols cols_add(const Cols& a, const Cols& b) {
  Cols c;
#pragma unroll
  for (int i = 0; i < NLT_C; ++i) c.v[i] = a.v[i] + b.v[i];
  return c;
}

__device__ __forceinline__ Cols cols_silu(const Cols& a) {
  Cols c;
#pragma unroll
  for (int i = 0; i < NLT_C; ++i) c.v[i] = nlt_silu(a.v[i]);
  return c;
}

// acc[r] += xs[r*ldx + k] * w[k, NLT_C*lane ..] for k < nk.
// xs: R staged input rows in shared memory; w: (nk, H) row-major, shared.
template <int R>
__device__ __forceinline__ void cols_mm(const float* __restrict__ xs,
                                        int ldx,
                                        const float* __restrict__ w, int nk,
                                        int lane, Cols (&acc)[R]) {
#pragma unroll 4
  for (int k = 0; k < nk; ++k) {
    const Cols wv = cols_ld(w + k * NLT_H, lane);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float xv = xs[r * ldx + k];
#pragma unroll
      for (int i = 0; i < NLT_C; ++i)
        acc[r].v[i] = fmaf(xv, wv.v[i], acc[r].v[i]);
    }
  }
}

template <int R>
__device__ __forceinline__ void cols_fill(Cols (&acc)[R], const Cols& v) {
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = v;
}

// LayerNorm of one H-wide row held as Cols per lane; fp32 statistics.
__device__ __forceinline__ Cols cols_layer_norm(const Cols& y,
                                                const Cols& scale,
                                                const Cols& bias) {
  float s = y.v[0];
#pragma unroll
  for (int i = 1; i < NLT_C; ++i) s += y.v[i];
  const float mean = nlt_warp_sum(s) * (1.0f / NLT_H);
  Cols c;
#pragma unroll
  for (int i = 0; i < NLT_C; ++i) c.v[i] = y.v[i] - mean;
  float var = c.v[0] * c.v[0];
#pragma unroll
  for (int i = 1; i < NLT_C; ++i) var += c.v[i] * c.v[i];
  const float inv = rsqrtf(nlt_warp_sum(var) * (1.0f / NLT_H) + NLT_LN_EPS);
#pragma unroll
  for (int i = 0; i < NLT_C; ++i)
    c.v[i] = c.v[i] * inv * scale.v[i] + bias.v[i];
  return c;
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
