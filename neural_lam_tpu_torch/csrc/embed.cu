// Grid-feature embedder (kernel K1).
//
// Replaces _embed_fwd_kernel (embed_grid_flat) of
// neural_lam_tpu/ops/pallas_embed.py. Per row i = (node n, batch b) of the
// flat input x (N, B*d_in) == (N*B, d_in):
//   out[i] = LayerNorm(silu(x[i] @ W0 + b0) @ W1 + b1)
// out (N, B*64) == (N*B, 64). The TPU kernel's zero-padding of d_in to a
// lane multiple and its kron-widened weights are not needed here.
//
// One warp computes kRows consecutive rows, so each weight read from
// shared memory feeds kRows rows. Bound (fp32 CUDA cores, bench shapes):
// operations -- 2*(d_in + 64)*64 FLOP per row against (d_in + 64)*4 bytes.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 4;  // rows per warp and step

// Parameter blob (floats): w0[d_in*64] | w1[64*64] | b0 | b1 | ls | lb
__host__ __device__ inline int n_params(int d_in) {
  return d_in * NLT_H + NLT_H * NLT_H + 4 * NLT_H;
}

__host__ __device__ inline int x_stride(int d_in) {
  return nlt_round4(d_in > NLT_H ? d_in : NLT_H);
}

__global__ void __launch_bounds__(kWarps * 32)
    embed_kernel(const float* __restrict__ x, const float* __restrict__ params,
                 float* __restrict__ out, long long n_rows, int d_in) {
  extern __shared__ float smem[];
  const int n_par = n_params(d_in);
  nlt_load_params(smem, params, n_par);
  __syncthreads();
  const float* w0 = smem;
  const float* w1 = w0 + d_in * NLT_H;
  const float* b0 = w1 + NLT_H * NLT_H;
  const float* b1 = b0 + NLT_H;
  const float* ls = b1 + NLT_H;
  const float* lb = ls + NLT_H;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ldx = x_stride(d_in);
  float* xs = smem + nlt_round4(n_par) + warp * kRows * ldx;
  const float2 b0v = nlt_ld2(b0, lane), b1v = nlt_ld2(b1, lane),
               lsv = nlt_ld2(ls, lane), lbv = nlt_ld2(lb, lane);
  const long long n_groups = (n_rows + kRows - 1) / kRows;

  for (long long grp = (long long)blockIdx.x * kWarps + warp; grp < n_groups;
       grp += (long long)gridDim.x * kWarps) {
    const long long r0 = grp * kRows;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const bool ok = r0 + r < n_rows;
      for (int c = lane; c < d_in; c += 32)
        xs[r * ldx + c] = ok ? x[(r0 + r) * d_in + c] : 0.f;
    }
    __syncwarp();
    float2 t[kRows];
    nlt_fill(t, b0v);
    nlt_mm64<kRows>(xs, ldx, w0, d_in, lane, t);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kRows; ++r) nlt_st2(xs + r * ldx, lane, nlt_silu2(t[r]));
    __syncwarp();
    float2 y[kRows];
    nlt_fill(y, b1v);
    nlt_mm64<kRows>(xs, ldx, w1, NLT_H, lane, y);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float2 o = nlt_layer_norm(y[r], lsv, lbv);
      if (r0 + r < n_rows) nlt_st2(out + (r0 + r) * NLT_H, lane, o);
    }
  }
}

}  // namespace

// K1. x (n_rows, d_in) -> out (n_rows, 64), n_rows = N*B.
extern "C" int nlt_embed(const float* x, const float* params, float* out,
                         long long n_rows, int d_in, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_rows == 0) return 0;
  const size_t smem = sizeof(float) * (nlt_round4(n_params(d_in)) +
                                       kWarps * kRows * x_stride(d_in));
  const long long groups = (n_rows + kRows - 1) / kRows;
  int grid = 0;
  err = nlt_launch_config(embed_kernel, kWarps * 32, smem,
                          (groups + kWarps - 1) / kWarps, &grid);
  if (err != cudaSuccess) return (int)err;
  embed_kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      x, params, out, n_rows, d_in);
  return (int)cudaGetLastError();
}
