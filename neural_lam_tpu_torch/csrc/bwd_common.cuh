// Shared device helpers for the backward kernels (hidden width 64).
//
// Work split, as in the forward kernels: one warp owns whole 64-wide rows,
// lane l holds features 2l and 2l+1 of each row as a float2.
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
//   cores, in registers over the block's whole row range; at the end each
//   block writes its partial sums to its own row of a (blocks, params)
//   scratch;
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

__device__ __forceinline__ float2 nlt_mul_silu_grad(float2 d, float2 x) {
  return make_float2(d.x * nlt_silu_grad(x.x), d.y * nlt_silu_grad(x.y));
}

__device__ __forceinline__ void nlt_acc2(float2& acc, float2 v) {
  acc.x += v.x;
  acc.y += v.y;
}

// LayerNorm statistics of one 64-wide row: normalised row and rstd.
struct NltLn {
  float2 chat;
  float inv;
};

__device__ __forceinline__ NltLn nlt_ln_stats(float2 y) {
  const float mean = nlt_warp_sum(y.x + y.y) * (1.0f / NLT_H);
  const float cx = y.x - mean, cy = y.y - mean;
  const float var = nlt_warp_sum(cx * cx + cy * cy) * (1.0f / NLT_H);
  const float inv = rsqrtf(var + NLT_LN_EPS);
  return {make_float2(cx * inv, cy * inv), inv};
}

__device__ __forceinline__ float2 nlt_ln_apply(NltLn s, float2 scale,
                                               float2 bias) {
  return make_float2(s.chat.x * scale.x + bias.x, s.chat.y * scale.y + bias.y);
}

// Gradient wrt the LayerNorm input from the gradient `dout` of its output;
// adds the scale and bias gradients of this row to d_ls and d_lb.
__device__ __forceinline__ float2 nlt_ln_grad(NltLn s, float2 scale,
                                              float2 dout, float2& d_ls,
                                              float2& d_lb) {
  d_ls.x = fmaf(dout.x, s.chat.x, d_ls.x);
  d_ls.y = fmaf(dout.y, s.chat.y, d_ls.y);
  nlt_acc2(d_lb, dout);
  const float gx = dout.x * scale.x, gy = dout.y * scale.y;
  const float mg = nlt_warp_sum(gx + gy) * (1.0f / NLT_H);
  const float mgc =
      nlt_warp_sum(gx * s.chat.x + gy * s.chat.y) * (1.0f / NLT_H);
  return make_float2(s.inv * (gx - mg - s.chat.x * mgc),
                     s.inv * (gy - mg - s.chat.y * mgc));
}

// Per-block sums of per-lane vector gradients: vals[i] is this lane's
// float2 share of vector i (64 wide) in this warp. `red` holds
// n_warps * n_vec * 64 floats of shared memory; out[i*64 + c] receives the
// sum over the block's warps, in warp order. Whole block; ends synced.
template <int NV>
__device__ __forceinline__ void nlt_block_vec_sums(float* red,
                                                   const float2 (&vals)[NV],
                                                   int n_warps, float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < NV; ++i)
    nlt_st2(red + (warp * NV + i) * NLT_H, lane, vals[i]);
  __syncthreads();
  for (int idx = threadIdx.x; idx < NV * NLT_H; idx += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < n_warps; ++w) s += red[w * NV * NLT_H + idx];
    out[idx] = s;
  }
  __syncthreads();
}

// dst[j*64 + k] = src[k*64 + j]: a transposed 64x64 copy, whole block.
__device__ __forceinline__ void nlt_load_transposed(float* dst,
                                                    const float* src) {
  for (int i = threadIdx.x; i < NLT_H * NLT_H; i += blockDim.x)
    dst[(i & (NLT_H - 1)) * NLT_H + (i >> 6)] = src[i];
}
