// Shared device helpers for the kernels that run their products on tensor
// cores in 3xTF32 and stage their tiles with cp.async: the weight-gradient
// pass (csrc/weight_grad.cu), the flat edge kernels (K2 and K3,
// csrc/edge_flat.cu) and the grid embedder and its backward (K1 and B1,
// csrc/embed.cu and csrc/embed_bwd.cu), whose 16-row tiles share the
// swizzled staging and the product below.
//
// 3xTF32: `mma.sync` m16n8k8 TF32 with fp32 accumulators; each operand is
// split into big = tf32(x) and small = tf32(x - big), and big*big +
// big*small + small*big summed keeps fp32 accuracy (one TF32 product keeps
// ~3 decimal digits). Fragments of m16n8k8 (g = lane/4, t = lane%4):
//   A (16x8, row-major): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B (8x8, k x n):      b0 (t, g), b1 (t+4, g)
//   C (16x8):            c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t),
//                        c3 (g+8, 2t+1)
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"

// 16 bytes from global to shared memory, bypassing L1; zeros when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;  // 0: zero-fill
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

// 4 bytes from global to shared memory; zero when !valid.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = big + small, both TF32 (round to nearest, ties away from zero).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n"
      : "=r"(small)
      : "f"(x - __uint_as_float(big)));
}

// c += a b for a 16x8 TF32 A fragment, an 8x8 B fragment, fp32 C.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// silu with the fast exponential and division: within a few ulp of
// nlt_silu2, and far fewer instructions on each warp's chain of dependent
// steps.
__device__ __forceinline__ float2 silu_fast(float2 v) {
  return make_float2(__fdividef(v.x, 1.0f + __expf(-v.x)),
                     __fdividef(v.y, 1.0f + __expf(-v.y)));
}

// ------------------------------------------- 16-row tiles (K1, B1) ----

constexpr int kTcRows = 16;  // rows of a warp's tile: the m16 of m16n8k8

// Column c of row r of a staged matrix (ld columns) lies at r*ld +
// (c ^ swz(r)). The xor moves bits 2-4 of c only, so float2 and float4
// groups stay whole and a row stays within its 32-column groups. Reads of
// (row g.., column t..) and of (row t.., column g..) across a warp (g =
// lane/4, t = lane%4) both hit 32 distinct banks.
__device__ __forceinline__ int at(int r, int c, int ld) {
  return r * ld + (c ^ (((r & 3) << 3) | (r & 4)));
}

// Column c of row r of a staged tile of bf16 values (ld columns, ld a
// multiple of 32) lies at r*ld + (c ^ ((r & 7) << 3)) when ld is a
// multiple of 64, else (ld = 32, K1's narrow tile at width 32) at r*ld +
// (c ^ (((r >> 1) & 3) << 3)), which stays inside the row's 32 columns:
// the xor moves whole 8-value (16-byte) groups, so a cp.async copy stays
// whole, and reads of (row g.., column t..) across a warp hit 16 distinct
// words, two lanes a word (a 32-value row is 16 words: rows g and g + 2
// differ in the group the xor gives them).
__device__ __forceinline__ int at_bf16(int r, int c, int ld) {
  return ld % 64 == 0 ? r * ld + (c ^ ((r & 7) << 3))
                      : r * ld + (c ^ (((r >> 1) & 3) << 3));
}

// Value (r, c) of a staged tile of T (float: `at`; bf16: `at_bf16`), the
// tile held in the float buffer m.
template <typename T>
__device__ __forceinline__ T* staged_at(float* m, int r, int c, int ld) {
  if constexpr (sizeof(T) == sizeof(float))
    return m + at(r, c, ld);
  else
    return reinterpret_cast<T*>(m) + at_bf16(r, c, ld);
}

template <typename T>
__device__ __forceinline__ const T* staged_at(const float* m, int r, int c,
                                              int ld) {
  return staged_at<T>(const_cast<float*>(m), r, c, ld);
}

__device__ __forceinline__ float2 ld2s(const float* m, int r, int c, int ld) {
  return *reinterpret_cast<const float2*>(m + at(r, c, ld));
}

__device__ __forceinline__ void st2s(float* m, int r, int c, int ld,
                                     float2 v) {
  *reinterpret_cast<float2*>(m + at(r, c, ld)) = v;
}

// x = big + small as TF32 operands, as split_tf32 but by integer rounding
// and masks: big rounds x's mantissa to 10 bits (half away from zero),
// small = x - big (exact in fp32) cut to 10 bits. A few ALU operations
// where two cvt.rna cost more: with them B1 took 25% longer
// (probes/torch_b1_parts.py). The sum keeps about 21 bits.
__device__ __forceinline__ void split_fast(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) & 0xffffe000u;
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 8-column tiles (and 8-row k steps) of an H-wide row or weight.
constexpr int NLT_NQ = NLT_H / 8;

template <int NQ>
__device__ __forceinline__ void zero(float (&acc)[NQ][4]) {
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
}

// {big(b0), big(b1), small(b0), small(b1)}: a B fragment pair, split by
// split_fast.
__device__ __forceinline__ uint4 split_pair(float b0, float b1) {
  uint4 f;
  split_fast(b0, f.x, f.z);
  split_fast(b1, f.y, f.w);
  return f;
}

// Readers of the B operand for tile_mma: wb(c, n, ks, q, lane) gives the
// split fragment pair of b0 = B(c, n), b1 = B(c + 4, n), with c = 8ks + t
// and n = 8(q0 + q) + g. SmemW reads the swizzled (rows, 64) matrix w in
// shared memory, B(k, n) = w[k, n] or, kTrans, w[n, k], and splits at
// each use; FragW reads fragments split once into fragment order
// (split_frags); FragF32 reads fp32 pairs in fragment order (frags_f32)
// and splits at each use: half FragW's shared memory, where a width-128
// weight's split fragments (128 KB) do not fit beside the warps'
// buffers.
template <bool kTrans>
struct SmemW {
  const float* w;
  __device__ __forceinline__ uint4 operator()(int c, int n, int, int,
                                              int) const {
    return kTrans ? split_pair(w[at(n, c, NLT_H)], w[at(n, c + 4, NLT_H)])
                  : split_pair(w[at(c, n, NLT_H)], w[at(c + 4, n, NLT_H)]);
  }
};

struct FragW {
  const uint4* f;
  __device__ __forceinline__ uint4 operator()(int, int, int ks, int q,
                                              int lane) const {
    return f[(ks * NLT_NQ + q) * 32 + lane];
  }
};

struct FragF32 {
  const float2* f;
  __device__ __forceinline__ uint4 operator()(int, int, int ks, int q,
                                              int lane) const {
    const float2 b = f[(ks * NLT_NQ + q) * 32 + lane];
    return split_pair(b.x, b.y);
  }
};

// The B fragments of W (rows x H, (in, out) row-major; zero from row
// `rows` on) for k steps ks < nks in fragment order: frag[(ks*H/8 + q)*32
// + lane] = {big(b0), big(b1), small(b0), small(b1)}, b0 = W[8ks + t, 8q
// + g], b1 = W[8ks + t + 4, 8q + g], split by split_tf32. Whole block.
__device__ __forceinline__ void split_frags(uint4* frag,
                                            const float* __restrict__ w,
                                            int rows, int nks) {
  for (int i = threadIdx.x; i < nks * NLT_NQ * 32; i += blockDim.x) {
    const unsigned i5 = (unsigned)i >> 5;  // shifts for a power-of-two
    const int ln = i & 31, k = 8 * (i5 / NLT_NQ) + (ln & 3);
    const int n = 8 * (i5 % NLT_NQ) + (ln >> 2);
    uint32_t bb0, bs0, bb1, bs1;
    split_tf32(k < rows ? w[k * NLT_H + n] : 0.f, bb0, bs0);
    split_tf32(k + 4 < rows ? w[(k + 4) * NLT_H + n] : 0.f, bb1, bs1);
    frag[i] = make_uint4(bb0, bb1, bs0, bs1);
  }
}

// The same pairs {b0, b1} unsplit, for FragF32. Whole block.
__device__ __forceinline__ void frags_f32(float2* frag,
                                          const float* __restrict__ w,
                                          int rows, int nks) {
  for (int i = threadIdx.x; i < nks * NLT_NQ * 32; i += blockDim.x) {
    const unsigned i5 = (unsigned)i >> 5;  // shifts for a power-of-two
    const int ln = i & 31, k = 8 * (i5 / NLT_NQ) + (ln & 3);
    const int n = 8 * (i5 % NLT_NQ) + (ln >> 2);
    frag[i] = make_float2(k < rows ? w[k * NLT_H + n] : 0.f,
                          k + 4 < rows ? w[(k + 4) * NLT_H + n] : 0.f);
  }
}

// B(k, n) = W[k, n] of an (rows, H) weight in device memory (L2 holds it),
// zero from row `rows` on, split at each use: the reader of a weight that
// does not fit in shared memory beside the warps' buffers.
struct GlobalW {
  const float* w;
  int rows;
  __device__ __forceinline__ float ld(int k, int n) const {
    return k < rows ? __ldg(w + k * NLT_H + n) : 0.f;
  }
  __device__ __forceinline__ uint4 operator()(int c, int n, int, int,
                                              int) const {
    return split_pair(ld(c, n), ld(c + 4, n));
  }
};

// B(k, n) = W[n, k] of an (rows, H) weight in device memory: its
// transpose, zero from W's row `rows` on, split at each use.
struct GlobalWT {
  const float* w;
  int rows;
  __device__ __forceinline__ float ld(int k, int n) const {
    return n < rows ? __ldg(w + n * NLT_H + k) : 0.f;
  }
  __device__ __forceinline__ uint4 operator()(int c, int n, int, int,
                                              int) const {
    return split_pair(ld(c, n), ld(c + 4, n));
  }
};

// A staged value of T as a TF32 operand: float by split_fast; a bf16
// value is its own big half (8 mantissa bits), its small half zero.
__device__ __forceinline__ void split_a(float x, uint32_t& big,
                                        uint32_t& small) {
  split_fast(x, big, small);
}
__device__ __forceinline__ void split_a(__nv_bfloat16 x, uint32_t& big,
                                        uint32_t& small) {
  big = (uint32_t)__bfloat16_as_ushort(x) << 16;
  small = 0;
}

// acc[q] += A @ B over k steps ks < nks, in 3xTF32: A the 16-row tile `a`
// of TA (ld columns, swizzled: `staged_at`) at columns 8ks.., split at
// each use (`split_a`; a bf16 A has no small half, so two products a
// term); B from the reader wb (SmemW, FragW, FragF32, GlobalW or
// GlobalWT) at the
// 8-column tiles q0 + q, q < NQ.
template <typename TA = float, class WB, int NQ>
__device__ __forceinline__ void tile_mma(const float* a, int ld, int nks,
                                         WB wb, int q0, int lane,
                                         float (&acc)[NQ][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int ks = 0; ks < nks; ++ks) {
    const int c = 8 * ks + t;
    uint32_t ab[4], as[4];
    split_a(*staged_at<TA>(a, g, c, ld), ab[0], as[0]);
    split_a(*staged_at<TA>(a, g + 8, c, ld), ab[1], as[1]);
    split_a(*staged_at<TA>(a, g, c + 4, ld), ab[2], as[2]);
    split_a(*staged_at<TA>(a, g + 8, c + 4, ld), ab[3], as[3]);
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const uint4 w = wb(c, 8 * (q0 + q) + g, ks, q, lane);
      if constexpr (sizeof(TA) == sizeof(float))
        mma_tf32(acc[q], as, w.x, w.y);
      mma_tf32(acc[q], ab, w.z, w.w);
      mma_tf32(acc[q], ab, w.x, w.y);
    }
  }
}

// Whether rows of x (ldx values of T a row) can be staged by 16-byte
// copies: ldx a multiple of a copy's values and x 16-byte aligned.
template <typename T>
__device__ __forceinline__ bool rows16(const T* x, int ldx) {
  return ldx % (16 / (int)sizeof(T)) == 0 &&
         reinterpret_cast<size_t>(x) % 16 == 0;
}

// Stage rows r0 .. r0+15, columns c0 .. c0+nc-1, of x (ldx columns a row,
// float or bf16) raw into the swizzled tile xs of T (XC columns,
// `staged_at`), zero-padded to a multiple of 8 columns and past n_rows:
// 16-byte cp.async copies when x16 (`rows16`; c0 a multiple of a copy's
// values), else one value at a time (4-byte cp.async copies for float;
// loads and stores for bf16, which has no 2-byte copy). Commits nothing.
template <int XC, typename T>
__device__ __forceinline__ void stage_x(float* xs, const T* __restrict__ x,
                                        long long r0, long long n_rows,
                                        int ldx, int c0, int nc, bool x16,
                                        int lane) {
  constexpr int kPer = 16 / sizeof(T);  // values a copy: 4 or 8
  const int nc8 = (nc + 7) & ~7;
  if (x16) {
    const int n = nc8 / kPer;
    for (int i = lane; i < kTcRows * n; i += 32) {
      const int r = i / n, c = kPer * (i - r * n);
      const bool ok = r0 + r < n_rows && c < nc;
      cp_async16(staged_at<T>(xs, r, c, XC),
                 x + (ok ? (r0 + r) * ldx + c0 + c : 0), ok);
    }
  } else {
    for (int i = lane; i < kTcRows * nc8; i += 32) {
      const int r = i / nc8, c = i - r * nc8;
      const bool ok = r0 + r < n_rows && c < nc;
      const T* src = x + (ok ? (r0 + r) * ldx + c0 + c : 0);
      if constexpr (sizeof(T) == sizeof(float))
        cp_async4(staged_at<T>(xs, r, c, XC), src, ok);
      else
        *staged_at<T>(xs, r, c, XC) = ok ? *src : __float2bfloat16_rn(0.f);
    }
  }
}
