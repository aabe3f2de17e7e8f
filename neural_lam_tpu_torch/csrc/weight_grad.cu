// Weight gradients as X^T D for a list of (X, D) pairs, in one launch.
//
// X is (n, 64) and D (n, d) with d <= 64, both row-major in device memory;
// each pair's result is the (64, d) sum over its rows of x^T d. Written for
// the backward kernels whose weight gradients are such sums: the decoder
// backward (B5/B6, csrc/grid_update_bwd.cu) writes its nine activation /
// gradient pairs to device memory, the processor edge layer's (B3/B4,
// csrc/edge_flat_bwd.cu) its dW2 pair, and this pass sums them. It takes
// the place of the weight-gradient sums inside
// neural_lam_tpu/ops/pallas_grid_update.py::_grid_update_bwd_kernel :752
// and ::_grid_update_win_bwd_kernel :767, and
// neural_lam_tpu/ops/pallas_edge_flat.py::_layer_bwd_kernel :846 and
// ::_layer_bwd_win_kernel :1093.
//
// Design. The pairs' rows are cut into runs of `rows_per_block` rows; one
// block of 256 threads sums one run of one pair (the pair of a block is
// looked up in `first`, the prefix count of blocks per pair, so a pair of
// 4x the rows gets 4x the blocks). It stages 32 rows of X and D in shared
// memory with 16-byte loads (D narrower than 64 by single loads, padded
// with zeros), and each thread adds their products into the 4x4 tile of
// the 64x64 result it owns, in registers, across the whole run
// (`nlt_tile_acc`). Each block writes its (64, d) partial matrix once; the
// caller sums each pair's partials in a fixed order (no float atomics).
// Bound (fp32 CUDA cores, the decoder's pairs at bench shapes): bytes --
// every row of X and D is read once, ~1.5 GB, against ~24 GFLOP.
#include "bwd_common.cuh"

namespace {

constexpr int kMaxPairs = 16;
constexpr int kThreads = 256;
constexpr int kTile = 32;  // rows staged per step
constexpr int HH = NLT_H * NLT_H;

struct Pairs {
  const float* x[kMaxPairs];
  const float* d[kMaxPairs];
  long long n[kMaxPairs];  // rows of pair p
  int dw[kMaxPairs];       // D's width
  int first[kMaxPairs + 1];  // blocks of pair p: first[p] .. first[p+1]-1
  int n_pairs;
  long long rows_per_block;
};

__global__ void __launch_bounds__(kThreads)
    xtd_sum_kernel(const Pairs pp, float* __restrict__ partial) {
  __shared__ __align__(16) float xs[kTile * NLT_H];
  __shared__ __align__(16) float ds[kTile * NLT_H];
  int p = 0;
  while (p + 1 < pp.n_pairs && (int)blockIdx.x >= pp.first[p + 1]) ++p;
  const int tid = threadIdx.x, ti = tid >> 4, tj = tid & 15;
  const int dw = pp.dw[p];
  const float* __restrict__ X = pp.x[p];
  const float* __restrict__ D = pp.d[p];
  const long long r0 =
      (long long)(blockIdx.x - pp.first[p]) * pp.rows_per_block;
  const long long r1 =
      r0 + pp.rows_per_block < pp.n[p] ? r0 + pp.rows_per_block : pp.n[p];
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  float acc[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0.f;

  for (long long r = r0; r < r1; r += kTile) {
    const int rows = (int)(r1 - r < kTile ? r1 - r : kTile);
    // 16 float4 per 64-wide row: thread i stages float4 (i & 15) of row i/16
    for (int i = tid; i < kTile * NLT_H / 4; i += kThreads) {
      const int rr = i >> 4, c = 4 * (i & 15);
      float4 xv = zero4, dv = zero4;
      if (rr < rows) {
        const long long row = r + rr;
        xv = __ldcs(reinterpret_cast<const float4*>(X + row * NLT_H + c));
        if (dw == NLT_H) {
          dv = __ldcs(reinterpret_cast<const float4*>(D + row * NLT_H + c));
        } else {
          const float* drow = D + row * dw;
          dv.x = c < dw ? drow[c] : 0.f;
          dv.y = c + 1 < dw ? drow[c + 1] : 0.f;
          dv.z = c + 2 < dw ? drow[c + 2] : 0.f;
          dv.w = c + 3 < dw ? drow[c + 3] : 0.f;
        }
      }
      *reinterpret_cast<float4*>(xs + rr * NLT_H + c) = xv;
      *reinterpret_cast<float4*>(ds + rr * NLT_H + c) = dv;
    }
    __syncthreads();
    nlt_tile_acc(xs, NLT_H, ds, NLT_H, rows, ti, tj, acc);
    __syncthreads();
  }
  nlt_tile_store(partial + (size_t)blockIdx.x * HH, NLT_H, dw, ti, tj, acc);
}

}  // namespace

// X^T D for n_pairs pairs: xs[p], ds[p] device pointers (16-byte aligned),
// ns[p] rows, dws[p] in 1..64 the width of D; first[0..n_pairs] the prefix
// count of blocks per pair (pair p's rows cut into runs of rows_per_block,
// a multiple of 32). partial: (first[n_pairs], 64*64); block i writes its
// (64, d) partial matrix row-major at the start of row i.
extern "C" int nlt_xtd_sum(const long long* xs, const long long* ds,
                           const long long* ns, const int* dws,
                           const int* first, int n_pairs,
                           long long rows_per_block, float* partial,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_pairs < 1 || n_pairs > kMaxPairs || rows_per_block < kTile ||
      rows_per_block % kTile != 0 || first[0] != 0)
    return (int)cudaErrorInvalidValue;
  Pairs pp;
  pp.n_pairs = n_pairs;
  pp.rows_per_block = rows_per_block;
  pp.first[0] = 0;
  for (int p = 0; p < n_pairs; ++p) {
    const long long blocks = (ns[p] + rows_per_block - 1) / rows_per_block;
    if (ns[p] < 0 || dws[p] < 1 || dws[p] > NLT_H ||
        first[p + 1] - first[p] != (blocks > 1 ? blocks : 1) ||
        (xs[p] & 15) != 0 || (ds[p] & 15) != 0)
      return (int)cudaErrorInvalidValue;
    pp.x[p] = reinterpret_cast<const float*>(xs[p]);
    pp.d[p] = reinterpret_cast<const float*>(ds[p]);
    pp.n[p] = ns[p];
    pp.dw[p] = dws[p];
    pp.first[p + 1] = first[p + 1];
  }
  xtd_sum_kernel<<<first[n_pairs], kThreads, 0, (cudaStream_t)stream>>>(
      pp, partial);
  return (int)cudaGetLastError();
}
