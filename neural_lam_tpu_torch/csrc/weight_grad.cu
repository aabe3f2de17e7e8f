// Weight gradients as X^T D for a list of (X, D) pairs, in two launches.
//
// X is (n, H) and D (n, d) with d <= H, both row-major in device memory;
// each pair's result is the (H, d) sum over its rows of x^T d (a wider D
// comes as column chunks, each a pair: ops/weight_grad.py). Written for
// the backward kernels whose weight gradients are such sums: the decoder
// backward (B5/B6, csrc/grid_update_bwd.cu) writes its nine activation /
// gradient pairs to device memory, the processor edge layer's (B3/B4,
// csrc/edge_flat_bwd.cu) and the g2m edge tail's (B2, same file) their dW2
// pair, and this pass sums them. It takes the place of the weight-gradient
// sums inside
// neural_lam_tpu/ops/pallas_grid_update.py::_grid_update_bwd_kernel :752
// and ::_grid_update_win_bwd_kernel :767, and
// neural_lam_tpu/ops/pallas_edge_flat.py::_layer_bwd_kernel :846,
// ::_layer_bwd_win_kernel :1093 and ::_tail_bwd_kernel :526.
//
// Bound (the decoder's pairs at bench shapes): bytes -- every row of X and
// D is read once, ~1.4 GB, against ~24 GFLOP. On CUDA cores the FMAs alone
// would take 0.35 ms at the H100's fp32 peak, near the bytes' time, so the
// products run on tensor cores; what is left is the rate at which the
// blocks stream their rows (chip_smoke.py times a plain read of the same
// tensors beside the kernel).
//
// Design.
// - Even split. A persistent grid of (SMs x resident blocks) blocks; the
//   pairs' rows, laid end to end, are cut into one even, contiguous share
//   per block. A share that crosses a pair boundary is cut into segments,
//   one per (block, pair); the caller builds the segment list
//   (ops/weight_grad.py::segments) and each segment writes one (H, d)
//   partial matrix.
// - Async ring. A block stages kTile rows of X and D at a time in a ring of
//   kStages shared-memory stages filled with cp.async (16-byte copies that
//   bypass L1; 4-byte copies for a D row that is not a multiple of 16
//   bytes), so the loads of the next stages overlap the products of this
//   one. Rows past a segment's end are filled with zeros.
// - Products on tensor cores in 3xTF32: `mma.sync` m16n8k8 TF32 with fp32
//   accumulators, each operand split into big = tf32(x) and small =
//   tf32(x - big), and big*big + big*small + small*big summed, which keeps
//   fp32 accuracy (one TF32 product keeps ~3 digits; the helpers are in
//   tc_common.cuh). The result is A^T B
//   with A(i, r) = X[r, i] read column-wise from the staged X: each warp
//   owns a 32x32 block of the HxH result (`kQuads` of them) over one of
//   `kKg` row groups of each staged tile, so that each split fragment
//   feeds four (A) or two (B) products, and skips the 8-column tiles at or
//   past d; the warps of a block add their sums once per segment, in a
//   fixed order. At width 64, 8 warps: 4 blocks x 2 row groups of 16 rows
//   of a 32-row tile. At 32, 8 warps: 1 block x 8 row groups of 8 rows of
//   a 64-row tile. At 128, 16 warps: 16 blocks x 1 row group, one block an
//   SM. The staged rows are padded to H + 8 floats, so the fragment reads
//   (lane g = lane/4, t = lane%4 at row t, column g) hit 32 distinct
//   banks. A tile's products are summed in fresh accumulators and added to
//   the segment's sums in fp32 (see xtd_sum_kernel). With 64 accumulators
//   a lane the kernel takes 128 registers: two blocks, 16 warps, per SM at
//   widths 32 and 64.
// - A second kernel sums each pair's partials in segment order (no float
//   atomics: the same inputs give bit-identical outputs).
// - bf16 X (the bf16 training path: B3's dW_e pair reads the bf16 edge
//   state, B5/B6's enc_w0 pair the bf16 grid embeddings), per pair in the
//   same launch: the pair's rows are staged raw by the same cp.async ring
//   (8 values a 16-byte copy, rows of kLd bf16 values, so the fragment
//   reads still hit distinct banks) and converted where the product reads
//   them. A bf16 value is exact in TF32, its small half zero, so such a
//   pair takes two TF32 products a term, not three. D is always fp32 (the
//   chains' deltas, or a cotangent the caller widened): the JAX kernels
//   sum their weight gradients from fp32 values in the kernel.
#include "common.cuh"
#include "tc_common.cuh"

namespace {

constexpr int kMaxPairs = 16;
constexpr int kNq = 4;           // 8-column tiles of a warp's 32 columns
constexpr int kSide = NLT_H / 32;        // 32x32 blocks a side
constexpr int kQuads = kSide * kSide;    // 32x32 blocks of the result
constexpr int kWarps = NLT_H > 64 ? 16 : 8;
constexpr int kKg = kWarps / kQuads;     // row groups of a staged tile
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = NLT_H < 64 ? 64 : 32;  // rows per stage
constexpr int kGroupRows = kTile / kKg;  // rows of a row group
constexpr int kStages = 4;       // ring depth
constexpr int kLd = NLT_H + 8;   // padded row stride of a staged tile
constexpr int kStage = 2 * kTile * kLd;  // floats per stage (X, then D)
constexpr int HH = NLT_H * NLT_H;
constexpr size_t kSmem = sizeof(float) * kStages * kStage;
static_assert(kKg >= 1 && kGroupRows % 8 == 0, "row groups of 8k rows");
static_assert((kKg - 1) * (2 * kNq * 4 * 32) * kQuads <= kStages * kStage,
              "the row groups' sums fit in the ring");

struct Pairs {
  const void* x[kMaxPairs];  // float, or bf16 where xbf's bit p is set
  const float* d[kMaxPairs];
  int dw[kMaxPairs];  // D's width
  unsigned xbf;       // bit p: pair p's X is bf16
};

// Stage rows [r, r + kTile) of X and D (rows at or past r1 as zeros); a
// bf16 X raw, kLd bf16 values a row.
__device__ __forceinline__ void load_tile(float* st, const void* X, bool xb,
                                          const float* D, int dw,
                                          long long r, long long r1) {
  const int tid = threadIdx.x;
  float* xs = st;
  float* ds = st + kTile * kLd;
  if (xb) {
    __nv_bfloat16* xh = reinterpret_cast<__nv_bfloat16*>(xs);
    const __nv_bfloat16* Xh = static_cast<const __nv_bfloat16*>(X);
    for (int i = tid; i < kTile * NLT_H / 8; i += kThreads) {
      const int rr = i / (NLT_H / 8), c = 8 * (i % (NLT_H / 8));
      const bool ok = r + rr < r1;
      const long long row = ok ? r + rr : r;
      cp_async16(xh + rr * kLd + c, Xh + row * NLT_H + c, ok);
    }
  } else {
    const float* Xf = static_cast<const float*>(X);
#pragma unroll
    for (int i = tid; i < kTile * NLT_H / 4; i += kThreads) {
      const int rr = i / (NLT_H / 4), c = 4 * (i % (NLT_H / 4));
      const bool ok = r + rr < r1;
      const long long row = ok ? r + rr : r;
      cp_async16(xs + rr * kLd + c, Xf + row * NLT_H + c, ok);
    }
  }
  if ((dw & 3) == 0) {
    const int q = dw >> 2;  // 16-byte chunks per D row
    for (int i = tid; i < kTile * q; i += kThreads) {
      const int rr = i / q, c = 4 * (i - rr * q);
      const bool ok = r + rr < r1;
      const long long row = ok ? r + rr : r;
      cp_async16(ds + rr * kLd + c, D + row * dw + c, ok);
    }
  } else {
    for (int i = tid; i < kTile * dw; i += kThreads) {
      const int rr = i / dw, c = i - rr * dw;
      const bool ok = r + rr < r1;
      const long long row = ok ? r + rr : r;
      cp_async4(ds + rr * kLd + c, D + row * dw + c, ok);
    }
  }
}

// An X value staged as float (split in two TF32 halves) or bf16 (its own
// big half, its small half zero).
__device__ __forceinline__ void split_x(float x, uint32_t& big,
                                        uint32_t& small) {
  split_tf32(x, big, small);
}
__device__ __forceinline__ void split_x(__nv_bfloat16 x, uint32_t& big,
                                        uint32_t& small) {
  big = (uint32_t)__bfloat16_as_ushort(x) << 16;
  small = 0;
}

// c[m][q] += the 16x8 tile (32*mi + 16*m .., 32*ni + 8*q ..) of X^T D over
// rows kk0 .. kk0+kGroupRows-1 of the staged tile, m < 2, q < NQ, in
// 3xTF32 (two
// TF32 products a term for a bf16 X, TX); a template on NQ so that the
// products are straight-line code that the compiler can interleave (each
// term's products go to 2*NQ independent accumulators). Fragments (g =
// lane/4, t = lane%4): A (16x8, A(i, r) = X[r, i0 + i]): a0 (g, t), a1
// (g+8, t), a2 (g, t+4), a3 (g+8, t+4); B (8x8, B(r, j) = D[r, j0 + j]):
// b0 (t, g), b1 (t+4, g); C: c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3
// (g+8, 2t+1).
template <int NQ, typename TX>
__device__ __forceinline__ void tile_mma(const float* st, int mi, int ni,
                                         int kk0, int lane,
                                         float (&c)[2][kNq][4]) {
  const int g = lane >> 2, t = lane & 3;
  const TX* xs = reinterpret_cast<const TX*>(st) + (kk0 + t) * kLd +
                 32 * mi + g;
  const float* ds = st + kTile * kLd + (kk0 + t) * kLd + 32 * ni + g;
#pragma unroll
  for (int kk = 0; kk < kGroupRows; kk += 8) {
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const TX* x0 = xs + kk * kLd + 16 * m;
      const TX* x1 = x0 + 4 * kLd;
      split_x(x0[0], ab[m][0], as[m][0]);
      split_x(x0[8], ab[m][1], as[m][1]);
      split_x(x1[0], ab[m][2], as[m][2]);
      split_x(x1[8], ab[m][3], as[m][3]);
    }
    const float* d0 = ds + kk * kLd;
    const float* d1 = d0 + 4 * kLd;
    uint32_t bb[NQ][2], bs[NQ][2];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      split_tf32(d0[8 * q], bb[q][0], bs[q][0]);
      split_tf32(d1[8 * q], bb[q][1], bs[q][1]);
    }
    if constexpr (sizeof(TX) == sizeof(float)) {
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          mma_tf32(c[m][q], as[m], bb[q][0], bb[q][1]);
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int q = 0; q < NQ; ++q)
        mma_tf32(c[m][q], ab[m], bs[q][0], bs[q][1]);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int q = 0; q < NQ; ++q)
        mma_tf32(c[m][q], ab[m], bb[q][0], bb[q][1]);
  }
}

// seg: (n_seg, 3) int64 rows (pair, first row, end row); block b sums the
// segments block_first[b] .. block_first[b+1]-1 and writes segment s's
// (H, d) partial row-major at partial + s*HH. Warp w owns the 32x32 block
// (w % kQuads) / kSide, (w % kQuads) % kSide of the result over rows
// kGroupRows * (w / kQuads) .. of each staged tile; the warps of a block
// add their sums at the end of a segment, in row-group order.
__global__ void __launch_bounds__(kThreads, NLT_H > 64 ? 1 : 2)
    xtd_sum_kernel(const Pairs pp, const long long* __restrict__ seg,
                   const int* __restrict__ block_first,
                   float* __restrict__ partial) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int quad = warp % kQuads, kg = warp / kQuads;
  const int mi = quad / kSide, ni = quad % kSide;
  const int s_end = block_first[blockIdx.x + 1];
  for (int s = block_first[blockIdx.x]; s < s_end; ++s) {
    const int p = (int)seg[3 * s];
    const long long r0 = seg[3 * s + 1], r1 = seg[3 * s + 2];
    const void* X = pp.x[p];
    const bool xb = (pp.xbf >> p) & 1u;
    const float* __restrict__ D = pp.d[p];
    const int dw = pp.dw[p];
    const int n_tiles = (int)((r1 - r0 + kTile - 1) / kTile);
    // this warp's 8-column tiles that hold columns < dw
    const int nq = min(kNq, max(0, (dw + 7) / 8 - kNq * ni));
    float acc[2][kNq][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int q = 0; q < kNq; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][q][e] = 0.f;

#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) {
      if (t < n_tiles)
        load_tile(smem + t * kStage, X, xb, D, dw, r0 + (long long)t * kTile,
                  r1);
      cp_async_commit();
    }
    for (int t = 0; t < n_tiles; ++t) {
      cp_async_wait<kStages - 2>();  // tile t has landed (this thread's part)
      __syncthreads();  // ... everyone's; and tile t-1's stage is free
      const int nt = t + kStages - 1;
      if (nt < n_tiles)
        load_tile(smem + (nt % kStages) * kStage, X, xb, D, dw,
                  r0 + (long long)nt * kTile, r1);
      cp_async_commit();
      // The tile's products go to fresh tensor-core accumulators, added to
      // acc in fp32: summed in the tensor cores' accumulators over a whole
      // segment, the products of the decoder's pairs drifted past phase
      // 4's limit (chip_smoke.py).
      float c[2][kNq][4] = {};
      const float* st = smem + (t % kStages) * kStage;
      const int kk0 = kg * kGroupRows;
      using bf16 = __nv_bfloat16;
      switch (xb ? nq + 4 : nq) {
        case 4: tile_mma<4, float>(st, mi, ni, kk0, lane, c); break;
        case 3: tile_mma<3, float>(st, mi, ni, kk0, lane, c); break;
        case 2: tile_mma<2, float>(st, mi, ni, kk0, lane, c); break;
        case 1: tile_mma<1, float>(st, mi, ni, kk0, lane, c); break;
        case 8: tile_mma<4, bf16>(st, mi, ni, kk0, lane, c); break;
        case 7: tile_mma<3, bf16>(st, mi, ni, kk0, lane, c); break;
        case 6: tile_mma<2, bf16>(st, mi, ni, kk0, lane, c); break;
        case 5: tile_mma<1, bf16>(st, mi, ni, kk0, lane, c); break;
        default: break;
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int q = 0; q < kNq; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][q][e] += c[m][q][e];
    }
    cp_async_wait<0>();
    __syncthreads();  // the stages are free: they take the groups' sums
    // row group j >= 1 of quad q writes slot (j - 1) * kQuads + q
    constexpr int kSlot = 2 * kNq * 4 * 32;
    if (kg > 0) {
      float* red = smem + ((kg - 1) * kQuads + quad) * kSlot + lane;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int q = 0; q < kNq; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) red[((m * kNq + q) * 4 + e) * 32] =
              acc[m][q][e];
    }
    __syncthreads();
    if (kg == 0) {
      for (int j = 1; j < kKg; ++j) {
        const float* red = smem + ((j - 1) * kQuads + quad) * kSlot + lane;
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int q = 0; q < kNq; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[m][q][e] += red[((m * kNq + q) * 4 + e) * 32];
      }
      float* dst = partial + (size_t)s * HH;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int i = 32 * mi + 16 * m + (lane >> 2);
#pragma unroll
        for (int q = 0; q < kNq; ++q) {
          const int j = 32 * ni + 8 * q + 2 * (lane & 3);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int jj = j + (e & 1);
            if (jj < dw) dst[(i + 8 * (e >> 1)) * dw + jj] = acc[m][q][e];
          }
        }
      }
    }
    __syncthreads();  // the next segment's loads overwrite the stages
  }
}

struct Reduce {
  int first[kMaxPairs + 1];  // pair p's segments: first[p] .. first[p+1]-1
  int off[kMaxPairs];        // pair p's (H, d) result at out + off[p]
  int dw[kMaxPairs];
};

// out[off[p] + e] = sum over pair p's segments s, in order, of
// partial[s*HH + e], for e < H*d. Grid (HH / 256, n_pairs).
__global__ void __launch_bounds__(256)
    xtd_reduce_kernel(const Reduce rr, const float* __restrict__ partial,
                      float* __restrict__ out) {
  const int p = blockIdx.y;
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= NLT_H * rr.dw[p]) return;
  float acc = 0.f;
  for (int s = rr.first[p]; s < rr.first[p + 1]; ++s)
    acc += partial[(size_t)s * HH + e];
  out[rr.off[p] + e] = acc;
}

}  // namespace

// Resident blocks of xtd_sum_kernel per SM, and the SM count.
extern "C" int nlt_xtd_sum_occupancy(int device, int* sms, int* per_sm) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)nlt_occupancy(xtd_sum_kernel, kThreads, kSmem, sms, per_sm);
}

// X^T D partial sums for n_pairs pairs: xs[p], ds[p] device pointers (X
// 16-byte aligned, float or, where bit p of xbf is set, bf16; D fp32,
// 16-byte aligned when d % 4 == 0, else 4-byte), dws[p] in 1..H the width
// of D; seg (n_seg, 3) and block_first (n_blocks + 1) device arrays from
// ops/weight_grad.py::segments. partial: (n_seg, H*H).
extern "C" int nlt_xtd_sum(const long long* xs, const long long* ds,
                           const int* dws, int n_pairs, int xbf,
                           const long long* seg, const int* block_first,
                           int n_blocks, float* partial, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_pairs < 1 || n_pairs > kMaxPairs || n_blocks < 1)
    return (int)cudaErrorInvalidValue;
  Pairs pp;
  for (int p = 0; p < n_pairs; ++p) {
    const int align = dws[p] % 4 == 0 ? 15 : 3;
    if (dws[p] < 1 || dws[p] > NLT_H || (xs[p] & 15) != 0 ||
        (ds[p] & align) != 0)
      return (int)cudaErrorInvalidValue;
    pp.x[p] = reinterpret_cast<const void*>(xs[p]);
    pp.d[p] = reinterpret_cast<const float*>(ds[p]);
    pp.dw[p] = dws[p];
  }
  pp.xbf = (unsigned)xbf;
  if ((err = nlt_allow_smem(xtd_sum_kernel, kSmem)) != cudaSuccess)
    return (int)err;
  xtd_sum_kernel<<<n_blocks, kThreads, kSmem, (cudaStream_t)stream>>>(
      pp, seg, block_first, partial);
  return (int)cudaGetLastError();
}

// Each pair's sum of its segments' partials: first[0..n_pairs] the prefix
// count of segments per pair (host array), dws[p] D's width; out holds the
// (H, dws[p]) results one after another, row-major.
extern "C" int nlt_xtd_reduce(const float* partial, const int* first,
                              const int* dws, int n_pairs, float* out,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_pairs < 1 || n_pairs > kMaxPairs || first[0] != 0)
    return (int)cudaErrorInvalidValue;
  Reduce rr;
  int off = 0;
  rr.first[0] = 0;
  for (int p = 0; p < n_pairs; ++p) {
    if (dws[p] < 1 || dws[p] > NLT_H || first[p + 1] < first[p])
      return (int)cudaErrorInvalidValue;
    rr.first[p + 1] = first[p + 1];
    rr.off[p] = off;
    rr.dw[p] = dws[p];
    off += NLT_H * dws[p];
  }
  xtd_reduce_kernel<<<dim3(HH / 256, n_pairs), 256, 0,
                      (cudaStream_t)stream>>>(rr, partial, out);
  return (int)cudaGetLastError();
}
