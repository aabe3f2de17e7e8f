// Shared device helpers for the backward kernels (hidden width NLT_H).
//
// Work split, as in the forward kernels: one warp owns whole H-wide rows,
// lane l holds features NLT_C*l .. NLT_C*l + NLT_C - 1 of each row as a
// `Cols` (common.cuh).
//
// LayerNorm backward is taken directly in fp32 from the row's mean and
// rstd: with chat = (y - mean) * rstd and g = dout * scale,
//   dy = rstd * (g - mean(g) - chat * mean(g * chat)).
//
// Weight gradients dW = X^T dY sum over every row a kernel visits. Blocks
// run in no order, so no sum is carried from one block to the next. Two
// ways to take them:
// - in the kernel (B1): a block keeps the rows of one step (X and dY) in
//   shared memory, and each warp sums its strips of dW over them on tensor
//   cores, in registers over the block's whole row range (or, where they
//   do not fit in registers, step by step into the block's own row of the
//   scratch); at the end each block has written its partial sums to its
//   own row of a (blocks, params) scratch;
// - in a second pass (B2, B3/B4, B5/B6): the kernel writes the (X, dY) row
//   pairs to a scratch in device memory (or names rows it already has,
//   as B3's dW_e pair (edge_rep, d_x0)), and csrc/weight_grad.cu
//   (`xtd_sum`) sums X^T dY over all of them in one launch, each block
//   writing one partial matrix, so the first kernel needs no block-wide
//   step per row and keeps its shared memory for its weights.
// Either way the caller sums the partials in a fixed order: no float
// atomics, so a run repeats itself bit for bit.
//
// Each backward library exports two C entries: nlt_<name>_grid(sizes,
// device, &grid) gives the number of blocks, which is the number of rows
// of the scratch the caller allocates, and nlt_<name>(..., partial, sizes,
// grid, device, stream) launches that many.
#pragma once

#include "common.cuh"

__device__ __forceinline__ float nlt_silu_grad(float x) {
  const float s = 1.0f / (1.0f + expf(-x));
  return s * (1.0f + x * (1.0f - s));
}

// d * silu'(x), feature by feature.
__device__ __forceinline__ Cols cols_mul_silu_grad(const Cols& d,
                                                   const Cols& x) {
  Cols c;
#pragma unroll
  for (int i = 0; i < NLT_C; ++i) c.v[i] = d.v[i] * nlt_silu_grad(x.v[i]);
  return c;
}

__device__ __forceinline__ void cols_acc(Cols& acc, const Cols& v) {
#pragma unroll
  for (int i = 0; i < NLT_C; ++i) acc.v[i] += v.v[i];
}

// acc += m * v, feature by feature.
__device__ __forceinline__ void cols_fma(Cols& acc, float m, const Cols& v) {
#pragma unroll
  for (int i = 0; i < NLT_C; ++i) acc.v[i] = fmaf(m, v.v[i], acc.v[i]);
}

__device__ __forceinline__ Cols cols_scale(float m, const Cols& v) {
  Cols c;
#pragma unroll
  for (int i = 0; i < NLT_C; ++i) c.v[i] = m * v.v[i];
  return c;
}

// LayerNorm statistics of one H-wide row: normalised row and rstd.
struct NltLn {
  Cols chat;
  float inv;
};

__device__ __forceinline__ NltLn nlt_ln_stats(const Cols& y) {
  float s = y.v[0];
#pragma unroll
  for (int i = 1; i < NLT_C; ++i) s += y.v[i];
  const float mean = nlt_warp_sum(s) * (1.0f / NLT_H);
  NltLn r;
#pragma unroll
  for (int i = 0; i < NLT_C; ++i) r.chat.v[i] = y.v[i] - mean;
  float var = r.chat.v[0] * r.chat.v[0];
#pragma unroll
  for (int i = 1; i < NLT_C; ++i) var += r.chat.v[i] * r.chat.v[i];
  r.inv = rsqrtf(nlt_warp_sum(var) * (1.0f / NLT_H) + NLT_LN_EPS);
#pragma unroll
  for (int i = 0; i < NLT_C; ++i) r.chat.v[i] *= r.inv;
  return r;
}

__device__ __forceinline__ Cols nlt_ln_apply(const NltLn& s,
                                             const Cols& scale,
                                             const Cols& bias) {
  Cols c;
#pragma unroll
  for (int i = 0; i < NLT_C; ++i)
    c.v[i] = s.chat.v[i] * scale.v[i] + bias.v[i];
  return c;
}

// Gradient wrt the LayerNorm input from the gradient `dout` of its output;
// adds the scale and bias gradients of this row to d_ls and d_lb.
__device__ __forceinline__ Cols nlt_ln_grad(const NltLn& s, const Cols& scale,
                                            const Cols& dout, Cols& d_ls,
                                            Cols& d_lb) {
  Cols g;
#pragma unroll
  for (int i = 0; i < NLT_C; ++i) {
    d_ls.v[i] = fmaf(dout.v[i], s.chat.v[i], d_ls.v[i]);
    d_lb.v[i] += dout.v[i];
    g.v[i] = dout.v[i] * scale.v[i];
  }
  float sg = g.v[0], sgc = g.v[0] * s.chat.v[0];
#pragma unroll
  for (int i = 1; i < NLT_C; ++i) {
    sg += g.v[i];
    sgc = fmaf(g.v[i], s.chat.v[i], sgc);
  }
  const float mg = nlt_warp_sum(sg) * (1.0f / NLT_H);
  const float mgc = nlt_warp_sum(sgc) * (1.0f / NLT_H);
#pragma unroll
  for (int i = 0; i < NLT_C; ++i)
    g.v[i] = s.inv * (g.v[i] - mg - s.chat.v[i] * mgc);
  return g;
}

// Column of feature j of lane `lane`'s share of a row: the Cols split.
struct ColsOf {
  __device__ __forceinline__ int operator()(int lane, int j) const {
    return NLT_C * lane + j;
  }
};

// Per-block sums of per-lane vector gradients: vals[i] is this lane's
// share of vector i (H wide) in this warp, its feature j at column
// col_of(lane, j). `red` holds n_warps * NV * H floats of shared memory;
// out[i*H + c] receives the sum over the block's warps, in warp order.
// Whole block; ends synced.
template <int NV, class ColOf = ColsOf>
__device__ __forceinline__ void nlt_block_vec_sums(float* red,
                                                   const Cols (&vals)[NV],
                                                   int n_warps, float* out,
                                                   ColOf col_of = {}) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int j = 0; j < NLT_C; ++j)
      red[(warp * NV + i) * NLT_H + col_of(lane, j)] = vals[i].v[j];
  __syncthreads();
  for (int idx = threadIdx.x; idx < NV * NLT_H; idx += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < n_warps; ++w) s += red[w * NV * NLT_H + idx];
    out[idx] = s;
  }
  __syncthreads();
}

// dst[j*H + k] = src[k*H + j]: a transposed H x H copy, whole block.
__device__ __forceinline__ void nlt_load_transposed(float* dst,
                                                    const float* src) {
  for (int i = threadIdx.x; i < NLT_H * NLT_H; i += blockDim.x)
    dst[(i % NLT_H) * NLT_H + i / NLT_H] = src[i];
}
