// Shared device helpers for the kernels that run their products on tensor
// cores in 3xTF32 and stage their tiles with cp.async: the weight-gradient
// pass (csrc/weight_grad.cu) and the processor edge layer (K3,
// csrc/edge_flat.cu).
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

// 16 bytes from global to shared memory, bypassing L1; zeros when !valid.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
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
