// Backward of the grid-feature embedder (kernel B1).
//
// Replaces _embed_bwd_kernel (:111, via _embed_bwd :268, the custom VJP of
// embed_grid_flat) of neural_lam_tpu/ops/pallas_embed.py. Per row i =
// (node n, batch b) of the flat input x (N*B, d_in), recomputing the
// forward of csrc/embed.cu:
//   t0 = x @ W0 + b0,  t = silu(t0),  y = t @ W1 + b1,  out = LN(y)
// and, from d_out (N*B, 64):
//   dy  = LN backward (fp32, from the row's mean and rstd)
//   dt0 = (dy @ W1^T) * silu'(t0),  dx = dt0 @ W0^T   (only when asked)
//   dW1 = sum t^T dy, dW0 = sum x^T dt0, db1 = sum dy, db0 = sum dt0,
//   dLN scale = sum d_out * chat, dLN bias = sum d_out.
//
// One warp takes kRows rows per step, so each weight read from shared
// memory feeds kRows rows; W1 and W0 are also held transposed, so that the
// backward products read them as the forward does. A block's 32 rows of
// (x, t, dy, dt0) are staged in shared memory and each thread adds their
// products into its 4x4 tiles of dW1 and dW0, kept in registers and
// written once per block to its row of the partial-sum scratch (same
// layout as the parameter blob); the caller sums the rows in a fixed
// order. Bound (fp32 CUDA cores, bench shapes): operations -- about three
// times the forward's 2*(d_in + 64)*64 FLOP per row against
// (2*d_in + 64)*4 bytes.
#include "bwd_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 4;  // rows per warp and step
constexpr int kChunk = kWarps * kRows;
constexpr int kMaxDin = 128;  // two dW0 tiles per thread

// Parameter blob (floats): w0[d_in*64] | w1[64*64] | b0 | b1 | ls | lb
__host__ __device__ inline int n_params(int d_in) {
  return d_in * NLT_H + NLT_H * NLT_H + 4 * NLT_H;
}

__host__ __device__ inline int x_stride(int d_in) {
  return nlt_round4(d_in > NLT_H ? d_in : NLT_H);
}

__host__ __device__ inline int n_col_blocks(int d_in) {
  return (d_in + NLT_H - 1) / NLT_H;
}

__host__ __device__ inline size_t smem_floats(int d_in) {
  return (size_t)nlt_round4(n_params(d_in)) + NLT_H * NLT_H +
         (size_t)n_col_blocks(d_in) * NLT_H * NLT_H +
         (size_t)kChunk * (x_stride(d_in) + 3 * NLT_H);
}

__global__ void __launch_bounds__(kWarps * 32)
    embed_bwd_kernel(const float* __restrict__ x,
                     const float* __restrict__ dout,
                     const float* __restrict__ params, float* __restrict__ dx,
                     float* __restrict__ partial, long long n_rows,
                     int d_in) {
  extern __shared__ __align__(16) float smem[];
  const int n_par = n_params(d_in);
  nlt_load_params(smem, params, n_par);
  const float* w0 = smem;
  const float* w1 = w0 + d_in * NLT_H;
  const float* vec = w1 + NLT_H * NLT_H;  // b0 | b1 | ls | lb
  float* w1t = smem + nlt_round4(n_par);
  float* w0t = w1t + NLT_H * NLT_H;  // (64, 64) blocks of W0^T columns
  const int n_cb = n_col_blocks(d_in);
  const int ldx = x_stride(d_in);
  float* xs = w0t + n_cb * NLT_H * NLT_H;  // (kChunk, ldx)
  float* ts = xs + kChunk * ldx;           // (kChunk, 64) each
  float* dys = ts + kChunk * NLT_H;
  float* d0s = dys + kChunk * NLT_H;
  nlt_load_transposed(w1t, params + d_in * NLT_H);
  for (int i = threadIdx.x; i < n_cb * NLT_H * NLT_H; i += blockDim.x) {
    const int q = i / (NLT_H * NLT_H), rem = i % (NLT_H * NLT_H);
    const int k = rem / NLT_H, c = q * NLT_H + rem % NLT_H;
    w0t[i] = c < d_in ? params[c * NLT_H + k] : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tid = threadIdx.x, ti = tid >> 4, tj = tid & 15;
  const float2 b0v = nlt_ld2(vec, lane), b1v = nlt_ld2(vec + NLT_H, lane),
               lsv = nlt_ld2(vec + 2 * NLT_H, lane);
  float2 vsum[4];  // db0, db1, dls, dlb
  nlt_fill(vsum, make_float2(0.f, 0.f));
  float a1[16] = {}, a0[2][16] = {};
  float* xw = xs + warp * kRows * ldx;
  float* tw = ts + warp * kRows * NLT_H;
  float* dyw = dys + warp * kRows * NLT_H;
  float* d0w = d0s + warp * kRows * NLT_H;
  const long long n_chunks = (n_rows + kChunk - 1) / kChunk;

  for (long long chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
    const long long r0 = chunk * kChunk + warp * kRows;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const bool ok = r0 + r < n_rows;
      for (int c = lane; c < ldx; c += 32)
        xw[r * ldx + c] = (ok && c < d_in) ? x[(r0 + r) * d_in + c] : 0.f;
    }
    __syncwarp();
    float2 t0[kRows];
    nlt_fill(t0, b0v);
    nlt_mm64<kRows>(xw, ldx, w0, d_in, lane, t0);
#pragma unroll
    for (int r = 0; r < kRows; ++r) nlt_st2(tw + r * NLT_H, lane, nlt_silu2(t0[r]));
    __syncwarp();
    float2 y[kRows];
    nlt_fill(y, b1v);
    nlt_mm64<kRows>(tw, NLT_H, w1, NLT_H, lane, y);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float2 g = r0 + r < n_rows ? nlt_ld2(dout + (r0 + r) * NLT_H, lane)
                                       : make_float2(0.f, 0.f);
      const float2 dy = nlt_ln_grad(nlt_ln_stats(y[r]), lsv, g, vsum[2],
                                    vsum[3]);
      nlt_acc2(vsum[1], dy);
      nlt_st2(dyw + r * NLT_H, lane, dy);
    }
    __syncwarp();
    float2 dt[kRows];
    nlt_fill(dt, make_float2(0.f, 0.f));
    nlt_mm64<kRows>(dyw, NLT_H, w1t, NLT_H, lane, dt);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float2 d0 = nlt_mul_silu_grad(dt[r], t0[r]);
      nlt_acc2(vsum[0], d0);
      nlt_st2(d0w + r * NLT_H, lane, d0);
    }
    __syncwarp();
    if (dx != nullptr) {
      for (int q = 0; q < n_cb; ++q) {
        float2 o[kRows];
        nlt_fill(o, make_float2(0.f, 0.f));
        nlt_mm64<kRows>(d0w, NLT_H, w0t + q * NLT_H * NLT_H, NLT_H, lane, o);
        const int c = q * NLT_H + 2 * lane;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r0 + r >= n_rows) continue;
          float* row = dx + (r0 + r) * d_in;
          if (c < d_in) row[c] = o[r].x;
          if (c + 1 < d_in) row[c + 1] = o[r].y;
        }
      }
    }
    __syncthreads();
    nlt_tile_acc(ts, NLT_H, dys, NLT_H, kChunk, ti, tj, a1);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int ti0 = (tid + u * kWarps * 32) >> 4;
      if (4 * ti0 < d_in)
        nlt_tile_acc(xs, ldx, d0s, NLT_H, kChunk, ti0, tj, a0[u]);
    }
    __syncthreads();
  }

  float* part = partial + (size_t)blockIdx.x * n_par;
  nlt_tile_store(part + d_in * NLT_H, NLT_H, NLT_H, ti, tj, a1);
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int ti0 = (tid + u * kWarps * 32) >> 4;
    if (4 * ti0 < d_in) nlt_tile_store(part, d_in, NLT_H, ti0, tj, a0[u]);
  }
  nlt_block_vec_sums<4>(ts, vsum, kWarps,
                        part + d_in * NLT_H + NLT_H * NLT_H);
}

}  // namespace

// Blocks of nlt_embed_bwd for these sizes: the rows of its `partial`.
extern "C" int nlt_embed_bwd_grid(long long n_rows, int d_in, int device,
                                  int* grid) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d_in < 1 || d_in > kMaxDin) return (int)cudaErrorInvalidValue;
  return (int)nlt_launch_config(embed_bwd_kernel, kWarps * 32,
                                sizeof(float) * smem_floats(d_in),
                                (n_rows + kChunk - 1) / kChunk, grid);
}

// B1. x (n_rows, d_in), dout (n_rows, 64) -> dx (n_rows, d_in) when dx is
// not null, and partial (grid, n_params) per-block parameter-gradient sums
// in the parameter blob's layout, with grid from nlt_embed_bwd_grid.
extern "C" int nlt_embed_bwd(const float* x, const float* dout,
                             const float* params, float* dx, float* partial,
                             long long n_rows, int d_in, int grid,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d_in < 1 || d_in > kMaxDin || grid < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * smem_floats(d_in);
  if ((err = nlt_allow_smem(embed_bwd_kernel, smem)) != cudaSuccess)
    return (int)err;
  embed_bwd_kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      x, dout, params, dx, partial, n_rows, d_in);
  return (int)cudaGetLastError();
}
