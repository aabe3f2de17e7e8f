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
// Bound (bench shapes, d_in 56, no dx): about 9.9 GFLOP of products
// against 122 MB of x and d_out, so operations on CUDA cores (0.148 ms at
// the fp32 peak); the products run on tensor cores in 3xTF32 (helpers and
// fragment layouts in tc_common.cuh), where three TF32 products a term
// put the bound near 0.06 ms.
//
// Design.
// - A warp takes 16-row tiles: x rows (d_in zero-padded to 64 or 128
//   columns) and d_out rows are staged by cp.async into the warp's
//   buffers, and the chain t0 = x W0, y = t W1, dt = dy W1^T (and dx =
//   dt0 W0^T) runs as mma.sync m16n8k8 in 3xTF32, with the LayerNorm and
//   its backward in the C fragments (a row's 64 columns lie in a lane
//   quad: statistics by quad shuffles). Between products a tile goes from
//   the C layout back to the A layout through the warp's shared memory:
//   t and dy into their buffers, t0 (for silu') and then dt0 into a third.
// - The weights stay fp32 in shared memory, each once, and every use
//   splits its fragments; W1^T and W0^T are read from W1 and W0 by their
//   transposed index. So a block of 12 warps fits at d_in <= 64 (8 above),
//   one block a SM. The chain is held by each warp's chain of dependent
//   steps, not by its tensor cores, and warps hide it: ALU work on that
//   chain is what costs (split_fast and silu_fast, tc_common.cuh).
// - Every staged matrix is stored with column c of row r at c ^ swz(r),
//   so that the fragment reads of both orientations, the C layout's
//   float2 stores and the 16-byte copies all hit distinct banks.
// - db0, db1 and the two LayerNorm sums: each tile's column sums are
//   reduce-scattered over the warp's row lanes, so that lane l keeps
//   columns 2l and 2l+1 (nlt_block_vec_sums' layout).
// - Weight gradients on tensor cores in the same pass: a block step is
//   kWarps tiles, whose x, t, dy and dt0 stay in the warps' buffers; after
//   a barrier each warp sums its 16 x 64 strips of dW1 = t^T dy and dW0 =
//   x^T dt0 over the step's rows (the row as the k dimension), keeping
//   them in registers over the block's whole row range (step_wgrad). Each
//   block writes its sums once to its row of the partial-sum scratch (the
//   parameter blob's layout); the caller sums the rows in a fixed order.
//
// bf16 instance (`embed_bwd_kernel<kWide, __nv_bfloat16>`, entry
// nlt_embed_bwd_bf16; the bf16 training path): x and d_out are read in
// bf16 and dx stored in bf16 (rounded once from its fp32 value); the
// weight and vector gradients stay fp32, as the JAX kernel computes them.
// x is staged raw by the same cp.async copies into a swizzled bf16 tile
// (stage_x, `at_bf16`) and converted at the A-fragment reads of t0 = x W0
// and of dW0 = x^T dt0, each of which takes two TF32 products a term (a
// bf16 value has no small half). d_out is staged raw by cp.async into the
// second half of the warp's dy buffer, and widened in place to the fp32
// layout once it has landed (rows 8-15 held in registers while rows 0-7
// are written), so the LayerNorm backward reads it as in fp32.
#include "bwd_common.cuh"
#include "tc_common.cuh"

namespace {

constexpr int kRows = kTcRows;  // rows of a warp's tile
constexpr int kMaxDin = 128;  // x staged at 128 columns
constexpr int HH = NLT_H * NLT_H;

// Parameter blob (floats): w0[d_in*64] | w1[64*64] | b0 | b1 | ls | lb
__host__ __device__ inline int n_params(int d_in) {
  return d_in * NLT_H + HH + 4 * NLT_H;
}

// Warps a block, one block a SM: as many as the shared memory holds.
template <bool kWide>
__host__ __device__ constexpr int n_warps() {
  return kWide ? 8 : 12;
}

// Staged columns of an x row: 64, or 128 when d_in is above 64.
template <bool kWide>
__host__ __device__ constexpr int x_cols() {
  return kWide ? 2 * NLT_H : NLT_H;
}

// A warp's buffers: x (16 x x_cols), t, dy, t0 then dt0 (16 x 64 each).
template <bool kWide>
__host__ __device__ constexpr int warp_floats() {
  return kRows * (x_cols<kWide>() + 3 * NLT_H);
}

// W0 (x_cols x 64), W1, b0 | b1 | ls | lb, and the warps' buffers.
template <bool kWide>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)x_cols<kWide>() * NLT_H + HH + 4 * NLT_H +
                          (size_t)n_warps<kWide>() * warp_floats<kWide>());
}
static_assert(smem_bytes<true>() <= 232448 && smem_bytes<false>() <= 232448,
              "shared memory of a block");

// The gradient of silu with the fast exponential and division: within
// a few ulp of nlt_mul_silu_grad (silu_fast is in tc_common.cuh).
__device__ __forceinline__ float2 mul_silu_grad_fast(float2 d, float2 v) {
  const float sx = __fdividef(1.0f, 1.0f + __expf(-v.x));
  const float sy = __fdividef(1.0f, 1.0f + __expf(-v.y));
  return make_float2(d.x * sx * (1.0f + v.x * (1.0f - sx)),
                     d.y * sy * (1.0f + v.y * (1.0f - sy)));
}

// Sums over the warp's 16 rows of a C-layout tile's columns, given per
// lane as v[q][e] = rows g and g+8 of column 8q + 2t + e already added:
// reduce-scattered over the 8 lanes of a column (xor 16, 8, 4), so that
// lane l returns columns 2l and 2l+1. Fixed order.
__device__ __forceinline__ float2 col_sums(const float (&v)[8][2], int lane) {
  float a[4][2], b[2][2];
  const bool h2 = lane & 16, h1 = lane & 8, h0 = lane & 4;
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float send = h2 ? v[q][e] : v[q + 4][e];
      a[q][e] = (h2 ? v[q + 4][e] : v[q][e]) +
                __shfl_xor_sync(0xffffffffu, send, 16);
    }
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float send = h1 ? a[q][e] : a[q + 2][e];
      b[q][e] = (h1 ? a[q + 2][e] : a[q][e]) +
                __shfl_xor_sync(0xffffffffu, send, 8);
    }
  float2 r;
  const float s0 = h0 ? b[0][0] : b[1][0], s1 = h0 ? b[0][1] : b[1][1];
  r.x = (h0 ? b[1][0] : b[0][0]) + __shfl_xor_sync(0xffffffffu, s0, 4);
  r.y = (h0 ? b[1][1] : b[0][1]) + __shfl_xor_sync(0xffffffffu, s1, 4);
  return r;
}

// Where a bf16 d_out tile is staged: the second half of the warp's dy
// buffer, in the swizzled bf16 layout (`staged_at`, 64 values a row).
constexpr int kDoutBf16At = kRows * NLT_H / 2;

// Stage rows r0 .. r0+15 of x (d_in columns, zero-padded to a multiple
// of 8 by stage_x; the columns past that are never written) into xs and
// of d_out into dys (rows past n_rows as zeros), as two cp.async groups:
// x, then d_out, which the chain waits for only at its LayerNorm. 16-byte
// copies where the rows allow them. A bf16 d_out goes raw to dys +
// kDoutBf16At (`widen_dout` makes it fp32), one value at a time by plain
// loads where its rows are not 16-byte aligned (bf16 has no 2-byte
// cp.async).
template <int XC, typename T>
__device__ __forceinline__ void stage_tile(float* xs, float* dys,
                                           const T* __restrict__ x,
                                           const T* __restrict__ dout,
                                           long long r0, long long n_rows,
                                           int d_in, bool x16, bool d16,
                                           int lane) {
  stage_x<XC>(xs, x, r0, n_rows, d_in, 0, d_in, x16, lane);
  cp_async_commit();
  if constexpr (sizeof(T) != sizeof(float)) {
    float* dh = dys + kDoutBf16At;
    if (d16) {
      for (int i = lane; i < kRows * NLT_H / 8; i += 32) {
        const int r = i >> 3, c = 8 * (i & 7);
        const bool ok = r0 + r < n_rows;
        cp_async16(staged_at<T>(dh, r, c, NLT_H),
                   dout + (ok ? r0 + r : 0) * NLT_H + c, ok);
      }
    } else {
      for (int i = lane; i < kRows * NLT_H; i += 32) {
        const int r = i >> 6, c = i & (NLT_H - 1);
        const bool ok = r0 + r < n_rows;
        *staged_at<T>(dh, r, c, NLT_H) =
            ok ? dout[(r0 + r) * NLT_H + c] : __float2bfloat16_rn(0.f);
      }
    }
  } else if (d16) {
    for (int i = lane; i < kRows * NLT_H / 4; i += 32) {
      const int r = i >> 4, c = 4 * (i & 15);
      const bool ok = r0 + r < n_rows;
      cp_async16(dys + at(r, c, NLT_H), dout + (ok ? r0 + r : 0) * NLT_H + c,
                 ok);
    }
  } else {
    for (int i = lane; i < kRows * NLT_H; i += 32) {
      const int r = i >> 6, c = i & (NLT_H - 1);
      const bool ok = r0 + r < n_rows;
      cp_async4(dys + at(r, c, NLT_H),
                dout + (ok ? (r0 + r) * NLT_H + c : 0), ok);
    }
  }
  cp_async_commit();
}

// A bf16 d_out tile staged at dys + kDoutBf16At, widened in place to the
// fp32 tile at dys (`at` layout). Rows 0-7 of the fp32 tile lie below the
// bf16 tile, rows 8-15 over it: so rows 8-15 are read into registers
// first, rows 0-7 written, and then rows 8-15. Lane l takes columns 2l and
// 2l+1 of every row. Whole warp, after the tile has landed.
__device__ __forceinline__ void widen_dout(float* dys, int lane) {
  const float* dh = dys + kDoutBf16At;
  __nv_bfloat162 hi[kRows / 2];
#pragma unroll
  for (int r = 0; r < kRows / 2; ++r)
    hi[r] = *reinterpret_cast<const __nv_bfloat162*>(
        staged_at<__nv_bfloat16>(dh, r + kRows / 2, 2 * lane, NLT_H));
#pragma unroll
  for (int r = 0; r < kRows / 2; ++r)
    st2s(dys, r, 2 * lane, NLT_H,
         __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
             staged_at<__nv_bfloat16>(dh, r, 2 * lane, NLT_H))));
  __syncwarp();
#pragma unroll
  for (int r = 0; r < kRows / 2; ++r)
    st2s(dys, r + kRows / 2, 2 * lane, NLT_H, __bfloat1622float2(hi[r]));
}

// The chain of one staged tile (rows r0..) of x in T: writes t to ts, dy
// to dys (over d_out), dt0 to d0s, dx when asked; adds the tile's column
// sums of dt0, dy, d_out * chat and d_out to vsum.
template <int XC, typename T>
__device__ __forceinline__ void chain_tile(const float* xs, float* ts,
                                           float* dys, float* d0s,
                                           const float* w0, const float* w1,
                                           const float* vec, T* dx,
                                           long long r0, long long n_rows,
                                           int d_in, int lane,
                                           float2 (&vsum)[4]) {
  const int g = lane >> 2, t = lane & 3;
  float acc[8][4];
  float v[8][2];

  // t0 = x W0 + b0 -> d0s, t = silu(t0) -> ts
  zero(acc);
  tile_mma<T>(xs, XC, (d_in + 7) >> 3, SmemW<false>{w0}, 0, lane, acc);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int c = 8 * q + 2 * t;
      const float2 b0 = nlt_ld2(vec + 8 * q, t);
      const float2 t0 =
          make_float2(acc[q][2 * h] + b0.x, acc[q][2 * h + 1] + b0.y);
      st2s(d0s, g + 8 * h, c, NLT_H, t0);
      st2s(ts, g + 8 * h, c, NLT_H, silu_fast(t0));
    }
  __syncwarp();

  // y = t W1 + b1; LayerNorm statistics of rows g and g + 8
  zero(acc);
  tile_mma(ts, NLT_H, 8, SmemW<false>{w1}, 0, lane, acc);
  float mean[2], inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float2 b1 = nlt_ld2(vec + NLT_H + 8 * q, t);
      acc[q][2 * h] += b1.x;
      acc[q][2 * h + 1] += b1.y;
      s += acc[q][2 * h] + acc[q][2 * h + 1];
    }
    mean[h] = quad_sum(s) * (1.0f / NLT_H);
    float var = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float cx = acc[q][2 * h] - mean[h];
      const float cy = acc[q][2 * h + 1] - mean[h];
      var += cx * cx + cy * cy;
    }
    inv[h] = rsqrtf(quad_sum(var) * (1.0f / NLT_H) + NLT_LN_EPS);
  }

  // chat -> acc; the LayerNorm parameters' column sums; the row sums of
  // g = d_out * ls and g * chat
  cp_async_wait<0>();  // d_out has landed
  __syncwarp();
  if constexpr (sizeof(T) != sizeof(float)) {
    widen_dout(dys, lane);
    __syncwarp();
  }
  float mg[2], mgc[2];
  {
    float vb[8][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sg = 0.f, sgc = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int c = 8 * q + 2 * t;
        const float2 d = ld2s(dys, g + 8 * h, c, NLT_H);
        const float2 ls = nlt_ld2(vec + 2 * NLT_H + 8 * q, t);
        const float cx = (acc[q][2 * h] - mean[h]) * inv[h];
        const float cy = (acc[q][2 * h + 1] - mean[h]) * inv[h];
        acc[q][2 * h] = cx;
        acc[q][2 * h + 1] = cy;
        v[q][0] = h ? v[q][0] + d.x * cx : d.x * cx;
        v[q][1] = h ? v[q][1] + d.y * cy : d.y * cy;
        vb[q][0] = h ? vb[q][0] + d.x : d.x;
        vb[q][1] = h ? vb[q][1] + d.y : d.y;
        const float gx = d.x * ls.x, gy = d.y * ls.y;
        sg += gx + gy;
        sgc += gx * cx + gy * cy;
      }
      mg[h] = quad_sum(sg) * (1.0f / NLT_H);
      mgc[h] = quad_sum(sgc) * (1.0f / NLT_H);
    }
    nlt_acc2(vsum[2], col_sums(v, lane));
    nlt_acc2(vsum[3], col_sums(vb, lane));
  }

  // dy = rstd * (g - mean(g) - chat * mean(g chat)) -> dys (over d_out)
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int c = 8 * q + 2 * t;
      const float2 d = ld2s(dys, g + 8 * h, c, NLT_H);
      const float2 ls = nlt_ld2(vec + 2 * NLT_H + 8 * q, t);
      const float2 dy =
          make_float2(inv[h] * (d.x * ls.x - mg[h] - acc[q][2 * h] * mgc[h]),
                      inv[h] * (d.y * ls.y - mg[h] -
                                acc[q][2 * h + 1] * mgc[h]));
      st2s(dys, g + 8 * h, c, NLT_H, dy);
      v[q][0] = h ? v[q][0] + dy.x : dy.x;
      v[q][1] = h ? v[q][1] + dy.y : dy.y;
    }
  nlt_acc2(vsum[1], col_sums(v, lane));
  __syncwarp();

  // dt0 = (dy W1^T) * silu'(t0) -> d0s (over t0)
  zero(acc);
  tile_mma(dys, NLT_H, 8, SmemW<true>{w1}, 0, lane, acc);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int c = 8 * q + 2 * t;
      const float2 d0 = mul_silu_grad_fast(
          make_float2(acc[q][2 * h], acc[q][2 * h + 1]),
          ld2s(d0s, g + 8 * h, c, NLT_H));
      st2s(d0s, g + 8 * h, c, NLT_H, d0);
      v[q][0] = h ? v[q][0] + d0.x : d0.x;
      v[q][1] = h ? v[q][1] + d0.y : d0.y;
    }
  nlt_acc2(vsum[0], col_sums(v, lane));
  __syncwarp();

  // dx = dt0 W0^T, 64 input columns a pass
  if (dx != nullptr) {
    for (int q0 = 0; 8 * q0 < d_in; q0 += 8) {
      zero(acc);
      tile_mma(d0s, NLT_H, 8, SmemW<true>{w0}, q0, lane, acc);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = r0 + g + 8 * h;
        if (row >= n_rows) continue;
        T* dst = dx + row * d_in;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int c = 8 * (q0 + q) + 2 * t;
          if (c < d_in) Io<T>::st(dst + c, acc[q][2 * h]);
          if (c + 1 < d_in) Io<T>::st(dst + c + 1, acc[q][2 * h + 1]);
        }
      }
    }
  }
}

// c = X^T D over one warp's 16 staged rows, for X's columns i0 .. i0+15
// (X staged in TX, lx columns a row: float `at`, bf16 `at_bf16`; a bf16
// X takes two TF32 products a term) and D's 64 (fp32, `at`).
template <typename TX>
__device__ __forceinline__ void wgrad_tile(const float* X, int lx,
                                           const float* D, int i0, int lane,
                                           float (&c)[8][4]) {
  const int g = lane >> 2, t = lane & 3;
  zero(c);
#pragma unroll
  for (int kk = 0; kk < kRows; kk += 8) {
    uint32_t ab[4], as[4];
    split_a(*staged_at<TX>(X, kk + t, i0 + g, lx), ab[0], as[0]);
    split_a(*staged_at<TX>(X, kk + t, i0 + g + 8, lx), ab[1], as[1]);
    split_a(*staged_at<TX>(X, kk + t + 4, i0 + g, lx), ab[2], as[2]);
    split_a(*staged_at<TX>(X, kk + t + 4, i0 + g + 8, lx), ab[3], as[3]);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      uint32_t bb0, bs0, bb1, bs1;
      split_fast(D[at(kk + t, 8 * q + g, NLT_H)], bb0, bs0);
      split_fast(D[at(kk + t + 4, 8 * q + g, NLT_H)], bb1, bs1);
      if constexpr (sizeof(TX) == sizeof(float)) mma_tf32(c[q], as, bb0, bb1);
      mma_tf32(c[q], ab, bs0, bs1);
      mma_tf32(c[q], ab, bb0, bb1);
    }
  }
}

// Weight gradients of a block step on tensor cores. The outputs are cut
// into 16 x 64 strips: dW1 = t^T dy (strips 0-3, of t's columns) and
// dW0 = x^T dt0 (strips 4.., of x's columns, as far as d_in reaches, x
// staged in T); warp w sums strips w, w + kWarps, .. over the step's rows,
// in 3xTF32 with the row as the k dimension: A(i, r) = X[r, i0 + i] and
// B(r, j) = D[r, j], read from each warp's buffers. Each 16-row tile is
// summed in fresh accumulators, then added to acc (fp32) in warp order.
template <int XC, int NS, int kWarps, typename T>
__device__ __forceinline__ void step_wgrad(const float* bufs, int n_strips,
                                           int warp, int lane,
                                           float (&acc)[NS][8][4]) {
  constexpr int WF = kRows * (XC + 3 * NLT_H);
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int s = warp + j * kWarps;
    if (s >= n_strips) break;
    const bool w1s = s < 4;
    const int xo = w1s ? kRows * XC : 0;
    const int i0 = 16 * (w1s ? s : s - 4);
    const int dof = kRows * (XC + (w1s ? 1 : 2) * NLT_H);
    for (int w = 0; w < kWarps; ++w) {
      const float* X = bufs + w * WF + xo;
      const float* D = bufs + w * WF + dof;
      float c[8][4];
      if (w1s)
        wgrad_tile<float>(X, NLT_H, D, i0, lane, c);
      else
        wgrad_tile<T>(X, XC, D, i0, lane, c);
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][q][e] += c[q][e];
    }
  }
}

// Write warp `warp`'s strips (step_wgrad) to the block's partial row.
template <int NS, int kWarps>
__device__ __forceinline__ void store_wgrad(float* part, int d_in,
                                            int n_strips, int warp, int lane,
                                            const float (&acc)[NS][8][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int s = warp + j * kWarps;
    if (s >= n_strips) break;
    const bool w1s = s < 4;
    float* dst = w1s ? part + d_in * NLT_H : part;
    const int i0 = 16 * (w1s ? s : s - 4), rows = w1s ? NLT_H : d_in;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + g + 8 * h;
      if (i >= rows) continue;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        *reinterpret_cast<float2*>(dst + i * NLT_H + 8 * q + 2 * t) =
            make_float2(acc[j][q][2 * h], acc[j][q][2 * h + 1]);
    }
  }
}

template <bool kWide, typename T>
__global__ void __launch_bounds__(n_warps<kWide>() * 32, 1)
    embed_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dout,
                     const float* __restrict__ params, T* __restrict__ dx,
                     float* __restrict__ partial, long long n_rows,
                     int d_in) {
  constexpr int XC = x_cols<kWide>();
  constexpr int WF = warp_floats<kWide>();
  constexpr int kWarps = n_warps<kWide>(), kStep = kWarps * kRows;
  extern __shared__ __align__(16) float smem[];
  float* w0 = smem;             // (XC, 64), rows from d_in on zero
  float* w1 = w0 + XC * NLT_H;  // (64, 64)
  float* vec = w1 + HH;         // b0 | b1 | ls | lb
  float* bufs = vec + 4 * NLT_H;
  for (int i = threadIdx.x; i < XC * NLT_H; i += blockDim.x) {
    const int r = i >> 6;
    w0[at(r, i & (NLT_H - 1), NLT_H)] = r < d_in ? params[i] : 0.f;
  }
  const float* pw1 = params + d_in * NLT_H;
  for (int i = threadIdx.x; i < HH; i += blockDim.x)
    w1[at(i >> 6, i & (NLT_H - 1), NLT_H)] = pw1[i];
  for (int i = threadIdx.x; i < 4 * NLT_H; i += blockDim.x)
    vec[i] = pw1[HH + i];
  for (int i = threadIdx.x; i < kWarps * WF; i += blockDim.x) bufs[i] = 0.f;
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* xs = bufs + warp * WF;
  float* ts = xs + kRows * XC;
  float* dys = ts + kRows * NLT_H;
  float* d0s = dys + kRows * NLT_H;
  const bool x16 = rows16(x, d_in);
  const bool d16 = (reinterpret_cast<size_t>(dout) & 15) == 0;
  float2 vsum[4];  // db0, db1, dls, dlb
  nlt_fill(vsum, make_float2(0.f, 0.f));
  constexpr int NS = kWide ? 2 : 1;  // strips a warp
  const int n_strips = 4 + (d_in + 15) / 16;
  float acc[NS][8][4];
#pragma unroll
  for (int j = 0; j < NS; ++j) zero(acc[j]);
  const long long n_steps = (n_rows + kStep - 1) / kStep;

  for (long long s = blockIdx.x; s < n_steps; s += gridDim.x) {
    const long long r0 = s * kStep + warp * kRows;
    stage_tile<XC, T>(xs, dys, x, dout, r0, n_rows, d_in, x16, d16, lane);
    cp_async_wait<1>();  // x has landed
    __syncwarp();
    chain_tile<XC, T>(xs, ts, dys, d0s, w0, w1, vec, dx, r0, n_rows, d_in,
                      lane, vsum);
    __syncthreads();
    step_wgrad<XC, NS, kWarps, T>(bufs, n_strips, warp, lane, acc);
    __syncthreads();
  }

  float* part = partial + (size_t)blockIdx.x * n_params(d_in);
  store_wgrad<NS, kWarps>(part, d_in, n_strips, warp, lane, acc);
  nlt_block_vec_sums<4>(bufs, vsum, kWarps, part + d_in * NLT_H + HH);
}

template <bool kWide, typename T>
cudaError_t grid_for(long long n_rows, int* grid) {
  constexpr int kStep = n_warps<kWide>() * kRows;
  return nlt_launch_config(embed_bwd_kernel<kWide, T>, n_warps<kWide>() * 32,
                           smem_bytes<kWide>(),
                           (n_rows + kStep - 1) / kStep, grid);
}

template <bool kWide, typename T>
cudaError_t launch(const T* x, const T* dout, const float* params, T* dx,
                   float* partial, long long n_rows, int d_in, int grid,
                   cudaStream_t stream) {
  cudaError_t err = nlt_allow_smem(embed_bwd_kernel<kWide, T>,
                                   smem_bytes<kWide>());
  if (err != cudaSuccess) return err;
  embed_bwd_kernel<kWide, T><<<grid, n_warps<kWide>() * 32,
                               smem_bytes<kWide>(), stream>>>(
      x, dout, params, dx, partial, n_rows, d_in);
  return cudaGetLastError();
}

template <typename T>
int bwd_grid(long long n_rows, int d_in, int device, int* grid) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d_in < 1 || d_in > kMaxDin) return (int)cudaErrorInvalidValue;
  return (int)(d_in > NLT_H ? grid_for<true, T>(n_rows, grid)
                            : grid_for<false, T>(n_rows, grid));
}

template <typename T>
int bwd(const T* x, const T* dout, const float* params, T* dx,
        float* partial, long long n_rows, int d_in, int grid, int device,
        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d_in < 1 || d_in > kMaxDin || grid < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(d_in > NLT_H ? launch<true, T>(x, dout, params, dx, partial,
                                              n_rows, d_in, grid, st)
                            : launch<false, T>(x, dout, params, dx, partial,
                                               n_rows, d_in, grid, st));
}

using bf16 = __nv_bfloat16;

}  // namespace

// Blocks of nlt_embed_bwd[_bf16] for these sizes: the rows of its
// `partial`.
extern "C" int nlt_embed_bwd_grid(long long n_rows, int d_in, int device,
                                  int* grid) {
  return bwd_grid<float>(n_rows, d_in, device, grid);
}

extern "C" int nlt_embed_bwd_bf16_grid(long long n_rows, int d_in,
                                       int device, int* grid) {
  return bwd_grid<bf16>(n_rows, d_in, device, grid);
}

// B1. x (n_rows, d_in), dout (n_rows, 64) -> dx (n_rows, d_in) when dx is
// not null, and partial (grid, n_params) per-block parameter-gradient sums
// in the parameter blob's layout, with grid from nlt_embed_bwd_grid.
extern "C" int nlt_embed_bwd(const float* x, const float* dout,
                             const float* params, float* dx, float* partial,
                             long long n_rows, int d_in, int grid,
                             int device, void* stream) {
  return bwd<float>(x, dout, params, dx, partial, n_rows, d_in, grid, device,
                    stream);
}

// B1, bf16 instance: x, dout and dx in bf16; params and partial fp32.
extern "C" int nlt_embed_bwd_bf16(const bf16* x, const bf16* dout,
                                  const float* params, bf16* dx,
                                  float* partial, long long n_rows, int d_in,
                                  int grid, int device, void* stream) {
  return bwd<bf16>(x, dout, params, dx, partial, n_rows, d_in, grid, device,
                   stream);
}
