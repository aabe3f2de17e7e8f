// Backward of the grid-feature embedder (kernel B1).
//
// Replaces _embed_bwd_kernel (:111, via _embed_bwd :268, the custom VJP of
// embed_grid_flat) of neural_lam_tpu/ops/pallas_embed.py. Per row i =
// (node n, batch b) of the flat input x (N*B, d_in), recomputing the
// forward of csrc/embed.cu:
//   t0 = x @ W0 + b0,  t = silu(t0),  y = t @ W1 + b1,  out = LN(y)
// and, from d_out (N*B, H):
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
// Design (width 64; widths 32 and 128 below).
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
//   reduce-scattered over the warp's row lanes (`col_sums`), so that a
//   lane keeps NLT_C columns of each (`TileCol`).
// - Weight gradients on tensor cores in the same pass: a block step is
//   kWarps tiles, whose x, t, dy and dt0 stay in the warps' buffers; after
//   a barrier each warp sums its 16 x H strips of dW1 = t^T dy and dW0 =
//   x^T dt0 over the step's rows (the row as the k dimension), keeping
//   them in registers over the block's whole row range (step_wgrad). Each
//   block writes its sums once to its row of the partial-sum scratch (the
//   parameter blob's layout); the caller sums the rows in a fixed order.
// - d_in above 128 (`kChunked`, any d_in, as K1 takes it): x is staged in
//   128-column chunks, one buffer a warp, and W0 is read from device
//   memory (L2 holds it) and split at each use (GlobalW, GlobalWT), so it
//   need not fit in shared memory. The dW0 strips of a step are then too
//   many for registers: each warp sums its strips of one step at a time
//   and adds them to its block's row of the scratch (the block's own, so
//   no other block touches it), the chunks taken from the last (still
//   staged) to the first, each staged again.
// Widths (NLT_H, one library a width): at 32 the same design, the
// registers and shared memory allowing 16 warps a block of every kind; x
// is staged at 32 or 64 columns, in 64-column chunks above. At 128 W1
// alone takes 64 KB and each warp's buffers 32 KB, so W0 is always read
// from device memory, x staged at 128 columns (in 128-column chunks
// above), a block runs 5 warps, and the weight gradients are added step
// by step to the block's row as for chunked x.
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
constexpr int HH = NLT_H * NLT_H;

// Parameter blob (floats): w0[d_in*H] | w1[H*H] | b0 | b1 | ls | lb
__host__ __device__ inline int n_params(int d_in) {
  return d_in * NLT_H + HH + 4 * NLT_H;
}

// How x is staged: H columns (d_in <= H), 2H (d_in <= 2H; widths 32 and
// 64), or in chunks of x_cols columns with W0 read from device memory.
enum { kNarrow, kWide, kChunked };

template <int kKind>
__host__ __device__ constexpr int x_cols() {
  return kKind == kNarrow || (kKind == kChunked && NLT_H > 64) ? NLT_H
                                                               : 2 * NLT_H;
}

// W0 in shared memory and the weight gradients summed in registers over
// the block's rows (widths 32 and 64, whole x staged); else W0 read from
// device memory (GlobalW, GlobalWT: L2 holds it) and the weight gradients
// added step by step to the block's row of the scratch.
template <int kKind>
__host__ __device__ constexpr bool w0_shared() {
  return kKind != kChunked && NLT_H <= 64;
}

// A warp's buffers: x (16 x x_cols), t, dy, t0 then dt0 (16 x H each).
template <int kKind>
__host__ __device__ constexpr int warp_floats() {
  return kRows * (x_cols<kKind>() + 3 * NLT_H);
}

// W0 (if shared), W1 and b0 | b1 | ls | lb.
template <int kKind>
__host__ __device__ constexpr int weight_floats() {
  return (w0_shared<kKind>() ? x_cols<kKind>() * NLT_H : 0) + HH +
         4 * NLT_H;
}

// Warps a block, one block a SM: as many as the shared memory holds
// beside the weights, at most 16 (at 64: 12 narrow, 8 wide, 10 chunked;
// at 128: 5).
template <int kKind>
__host__ __device__ constexpr int n_warps() {
  const int fit = (232448 / 4 - weight_floats<kKind>()) / warp_floats<kKind>();
  return fit < 16 ? fit : 16;
}

template <int kKind>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)weight_floats<kKind>() +
                          (size_t)n_warps<kKind>() * warp_floats<kKind>());
}
static_assert(smem_bytes<kNarrow>() <= 232448 &&
                  smem_bytes<kWide>() <= 232448 &&
                  smem_bytes<kChunked>() <= 232448,
              "shared memory of a block");
static_assert(NLT_H != 64 || (n_warps<kNarrow>() == 12 &&
                              n_warps<kWide>() == 8),
              "width 64's warps a block");

// The gradient of silu with the fast exponential and division: within
// a few ulp of nlt_silu_grad (silu_fast is in tc_common.cuh).
__device__ __forceinline__ float2 mul_silu_grad_fast(float2 d, float2 v) {
  const float sx = __fdividef(1.0f, 1.0f + __expf(-v.x));
  const float sy = __fdividef(1.0f, 1.0f + __expf(-v.y));
  return make_float2(d.x * sx * (1.0f + v.x * (1.0f - sx)),
                     d.y * sy * (1.0f + v.y * (1.0f - sy)));
}

// One halving of a reduce-scatter over the lanes `mask` apart: a lane
// with that bit set keeps the upper half of a, the other the lower half,
// each adding its partner's copy of the half it keeps.
template <int N>
__device__ __forceinline__ void halve(const float (&a)[N], float (&b)[N / 2],
                                      bool upper, int mask) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float send = upper ? a[i] : a[i + N / 2];
    b[i] = (upper ? a[i + N / 2] : a[i]) +
           __shfl_xor_sync(0xffffffffu, send, mask);
  }
}

// Sums over the warp's 16 rows of a C-layout tile's columns, given per
// lane as v[q][e] = rows g and g+8 of column 8q + 2t + e already added:
// reduce-scattered over the 8 lanes of a column (xor 16, 8, 4), so that
// lane (g, t) returns NLT_C column sums, r[j] the sum of column
// `col_of(lane, j)`. Fixed order.
__device__ __forceinline__ Cols col_sums(const float (&v)[NLT_NQ][2],
                                         int lane) {
  float a[2 * NLT_NQ], b[NLT_NQ], c[NLT_NQ / 2];
#pragma unroll
  for (int q = 0; q < NLT_NQ; ++q) a[2 * q] = v[q][0], a[2 * q + 1] = v[q][1];
  halve(a, b, lane & 16, 16);
  halve(b, c, lane & 8, 8);
  Cols r;
  halve(c, r.v, lane & 4, 4);
  return r;
}

// The column of col_sums' r[j] for lane (g, t): value i = g*NLT_C + j of
// the tile's 2*NLT_NQ, column 8*(i/2) + 2t + i%2 (at width 64, 2*lane + j).
struct TileCol {
  __device__ __forceinline__ int operator()(int lane, int j) const {
    const int i = (lane >> 2) * NLT_C + j;
    return 8 * (i >> 1) + 2 * (lane & 3) + (i & 1);
  }
};

// Where a bf16 d_out tile is staged: the second half of the warp's dy
// buffer, in the swizzled bf16 layout (`staged_at`, H values a row).
constexpr int kDoutBf16At = kRows * NLT_H / 2;

// Stage rows r0 .. r0+15 of x (columns 0 .. nc-1, zero-padded to a
// multiple of 8 by stage_x; the columns past that are never written) into
// xs and of d_out into dys (rows past n_rows as zeros), as two cp.async
// groups: x, then d_out, which the chain waits for only at its LayerNorm.
// 16-byte copies where the rows allow them. A bf16 d_out goes raw to dys +
// kDoutBf16At (`widen_dout` makes it fp32), one value at a time by plain
// loads where its rows are not 16-byte aligned (bf16 has no 2-byte
// cp.async).
template <int XC, typename T>
__device__ __forceinline__ void stage_tile(float* xs, float* dys,
                                           const T* __restrict__ x,
                                           const T* __restrict__ dout,
                                           long long r0, long long n_rows,
                                           int d_in, int nc, bool x16,
                                           bool d16, int lane) {
  stage_x<XC>(xs, x, r0, n_rows, d_in, 0, nc, x16, lane);
  cp_async_commit();
  if constexpr (sizeof(T) != sizeof(float)) {
    float* dh = dys + kDoutBf16At;
    if (d16) {
      for (int i = lane; i < kRows * NLT_H / 8; i += 32) {
        const int r = i / (NLT_H / 8), c = 8 * (i % (NLT_H / 8));
        const bool ok = r0 + r < n_rows;
        cp_async16(staged_at<T>(dh, r, c, NLT_H),
                   dout + (ok ? r0 + r : 0) * NLT_H + c, ok);
      }
    } else {
      for (int i = lane; i < kRows * NLT_H; i += 32) {
        const int r = i / NLT_H, c = i % NLT_H;
        const bool ok = r0 + r < n_rows;
        *staged_at<T>(dh, r, c, NLT_H) =
            ok ? dout[(r0 + r) * NLT_H + c] : __float2bfloat16_rn(0.f);
      }
    }
  } else if (d16) {
    for (int i = lane; i < kRows * NLT_H / 4; i += 32) {
      const int r = i / (NLT_H / 4), c = 4 * (i % (NLT_H / 4));
      const bool ok = r0 + r < n_rows;
      cp_async16(dys + at(r, c, NLT_H), dout + (ok ? r0 + r : 0) * NLT_H + c,
                 ok);
    }
  } else {
    for (int i = lane; i < kRows * NLT_H; i += 32) {
      const int r = i / NLT_H, c = i % NLT_H;
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
// first, rows 0-7 written, and then rows 8-15. Lane l takes the column
// pairs l, l + 32, .. of every row. Whole warp, after the tile has landed.
__device__ __forceinline__ void widen_dout(float* dys, int lane) {
  constexpr int kPairs = NLT_H / 2, kPer = (kPairs + 31) / 32;
  const float* dh = dys + kDoutBf16At;
  auto bf2 = [&](int r, int c) {
    return *reinterpret_cast<const __nv_bfloat162*>(
        staged_at<__nv_bfloat16>(dh, r, c, NLT_H));
  };
  __nv_bfloat162 hi[kRows / 2][kPer];
#pragma unroll
  for (int r = 0; r < kRows / 2; ++r)
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int p = lane + 32 * j;
      if (p < kPairs) hi[r][j] = bf2(r + kRows / 2, 2 * p);
    }
#pragma unroll
  for (int r = 0; r < kRows / 2; ++r)
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int p = lane + 32 * j;
      if (p < kPairs) st2s(dys, r, 2 * p, NLT_H, __bfloat1622float2(bf2(r, 2 * p)));
    }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < kRows / 2; ++r)
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int p = lane + 32 * j;
      if (p < kPairs)
        st2s(dys, r + kRows / 2, 2 * p, NLT_H, __bfloat1622float2(hi[r][j]));
    }
}

// The chain of one staged tile (rows r0..) of x in T: writes t to ts, dy
// to dys (over d_out), dt0 to d0s, dx when asked; adds the tile's column
// sums of dt0, dy, d_out * chat and d_out to vsum. w0 is W0 in shared
// memory (`w0_shared`), else null: W0 is read from params. Chunked: x's
// later chunks are staged here, each over the one before.
template <int kKind, typename T>
__device__ __forceinline__ void chain_tile(float* xs, float* ts, float* dys,
                                           float* d0s, const T* x,
                                           const float* params,
                                           const float* w0, const float* w1,
                                           const float* vec, T* dx,
                                           long long r0, long long n_rows,
                                           int d_in, bool x16, int lane,
                                           Cols (&vsum)[4]) {
  constexpr int XC = x_cols<kKind>();
  const int g = lane >> 2, t = lane & 3;
  float acc[NLT_NQ][4];
  float v[NLT_NQ][2];

  // t0 = x W0 + b0 -> d0s, t = silu(t0) -> ts
  zero(acc);
  if constexpr (kKind == kChunked) {
    for (int c0 = 0; c0 < d_in; c0 += XC) {
      const int nc = min(XC, d_in - c0);
      if (c0 > 0) {
        __syncwarp();  // every lane is done with the previous chunk
        stage_x<XC>(xs, x, r0, n_rows, d_in, c0, nc, x16, lane);
        cp_async_commit();
        cp_async_wait<0>();
        __syncwarp();
      }
      tile_mma<T>(xs, XC, (nc + 7) >> 3,
                  GlobalW{params + (size_t)c0 * NLT_H, d_in - c0}, 0, lane,
                  acc);
    }
  } else if constexpr (w0_shared<kKind>()) {
    tile_mma<T>(xs, XC, (d_in + 7) >> 3, SmemW<false>{w0}, 0, lane, acc);
  } else {
    tile_mma<T>(xs, XC, (d_in + 7) >> 3, GlobalW{params, d_in}, 0, lane,
                acc);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < NLT_NQ; ++q) {
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
  tile_mma(ts, NLT_H, NLT_NQ, SmemW<false>{w1}, 0, lane, acc);
  float mean[2], inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < NLT_NQ; ++q) {
      const float2 b1 = nlt_ld2(vec + NLT_H + 8 * q, t);
      acc[q][2 * h] += b1.x;
      acc[q][2 * h + 1] += b1.y;
      s += acc[q][2 * h] + acc[q][2 * h + 1];
    }
    mean[h] = quad_sum(s) * (1.0f / NLT_H);
    float var = 0.f;
#pragma unroll
    for (int q = 0; q < NLT_NQ; ++q) {
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
    float vb[NLT_NQ][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sg = 0.f, sgc = 0.f;
#pragma unroll
      for (int q = 0; q < NLT_NQ; ++q) {
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
    cols_acc(vsum[2], col_sums(v, lane));
    cols_acc(vsum[3], col_sums(vb, lane));
  }

  // dy = rstd * (g - mean(g) - chat * mean(g chat)) -> dys (over d_out)
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < NLT_NQ; ++q) {
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
  cols_acc(vsum[1], col_sums(v, lane));
  __syncwarp();

  // dt0 = (dy W1^T) * silu'(t0) -> d0s (over t0)
  zero(acc);
  tile_mma(dys, NLT_H, NLT_NQ, SmemW<true>{w1}, 0, lane, acc);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < NLT_NQ; ++q) {
      const int c = 8 * q + 2 * t;
      const float2 d0 = mul_silu_grad_fast(
          make_float2(acc[q][2 * h], acc[q][2 * h + 1]),
          ld2s(d0s, g + 8 * h, c, NLT_H));
      st2s(d0s, g + 8 * h, c, NLT_H, d0);
      v[q][0] = h ? v[q][0] + d0.x : d0.x;
      v[q][1] = h ? v[q][1] + d0.y : d0.y;
    }
  cols_acc(vsum[0], col_sums(v, lane));
  __syncwarp();

  // dx = dt0 W0^T, H input columns a pass
  if (dx != nullptr) {
    for (int q0 = 0; 8 * q0 < d_in; q0 += NLT_NQ) {
      zero(acc);
      if constexpr (w0_shared<kKind>())
        tile_mma(d0s, NLT_H, NLT_NQ, SmemW<true>{w0}, q0, lane, acc);
      else
        tile_mma(d0s, NLT_H, NLT_NQ, GlobalWT{params, d_in}, q0, lane, acc);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = r0 + g + 8 * h;
        if (row >= n_rows) continue;
        T* dst = dx + row * d_in;
#pragma unroll
        for (int q = 0; q < NLT_NQ; ++q) {
          const int c = 8 * (q0 + q) + 2 * t;
          if (c < d_in) Io<T>::st(dst + c, acc[q][2 * h]);
          if (c + 1 < d_in) Io<T>::st(dst + c + 1, acc[q][2 * h + 1]);
        }
      }
    }
  }
}

// c (+)= X^T D over one warp's 16 staged rows, for X's columns i0 ..
// i0+15 (X staged in TX, lx columns a row: float `at`, bf16 `at_bf16`; a
// bf16 X takes two TF32 products a term) and D's H (fp32, `at`).
template <typename TX>
__device__ __forceinline__ void wgrad_tile(const float* X, int lx,
                                           const float* D, int i0, int lane,
                                           float (&c)[NLT_NQ][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kRows; kk += 8) {
    uint32_t ab[4], as[4];
    split_a(*staged_at<TX>(X, kk + t, i0 + g, lx), ab[0], as[0]);
    split_a(*staged_at<TX>(X, kk + t, i0 + g + 8, lx), ab[1], as[1]);
    split_a(*staged_at<TX>(X, kk + t + 4, i0 + g, lx), ab[2], as[2]);
    split_a(*staged_at<TX>(X, kk + t + 4, i0 + g + 8, lx), ab[3], as[3]);
#pragma unroll
    for (int q = 0; q < NLT_NQ; ++q) {
      uint32_t bb0, bs0, bb1, bs1;
      split_fast(D[at(kk + t, 8 * q + g, NLT_H)], bb0, bs0);
      split_fast(D[at(kk + t + 4, 8 * q + g, NLT_H)], bb1, bs1);
      if constexpr (sizeof(TX) == sizeof(float)) mma_tf32(c[q], as, bb0, bb1);
      mma_tf32(c[q], ab, bs0, bs1);
      mma_tf32(c[q], ab, bb0, bb1);
    }
  }
}

// Strips of the weight gradients: 16 x H blocks of dW1 = t^T dy (strips
// 0 .. kW1Strips-1, of t's columns) and of dW0 = x^T dt0 (the next, of
// x's columns, as far as d_in reaches).
constexpr int kW1Strips = NLT_H / 16;

// The sum over the step's tiles (the kWarps warps' buffers, in warp order)
// of strip s's X^T D: X at column i0 of the buffer at offset xo (lx
// columns, in TX), D the buffer at offset dof. Each tile is summed in
// fresh accumulators and added to c in fp32.
template <int kKind, int kWarps, typename TX>
__device__ __forceinline__ void strip_sum(const float* bufs, int xo, int lx,
                                          int dof, int i0, int lane,
                                          float (&c)[NLT_NQ][4]) {
  constexpr int WF = warp_floats<kKind>();
  for (int w = 0; w < kWarps; ++w) {
    float ct[NLT_NQ][4];
    zero(ct);
    wgrad_tile<TX>(bufs + w * WF + xo, lx, bufs + w * WF + dof, i0, lane, ct);
#pragma unroll
    for (int q = 0; q < NLT_NQ; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[q][e] += ct[q][e];
  }
}

// Weight gradients of a block step on tensor cores, summed in registers:
// warp w sums strips w, w + kWarps, .. over the step's rows, with the row
// as the k dimension: A(i, r) = X[r, i0 + i] and B(r, j) = D[r, j], read
// from each warp's buffers (x in T), into acc over the block's whole row
// range.
template <int kKind, int NS, int kWarps, typename T>
__device__ __forceinline__ void step_wgrad(const float* bufs, int n_strips,
                                           int warp, int lane,
                                           float (&acc)[NS][NLT_NQ][4]) {
  constexpr int XC = x_cols<kKind>();
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int s = warp + j * kWarps;
    if (s >= n_strips) break;
    if (s < kW1Strips)
      strip_sum<kKind, kWarps, float>(bufs, kRows * XC, NLT_H,
                                      kRows * (XC + NLT_H), 16 * s, lane,
                                      acc[j]);
    else
      strip_sum<kKind, kWarps, T>(bufs, 0, XC, kRows * (XC + 2 * NLT_H),
                                  16 * (s - kW1Strips), lane, acc[j]);
  }
}

// dst[(i0 + i) * H + j] (+)= c for the strip's rows i0 + i < rows. `add`:
// add to what dst holds (the block's own partial row), else store.
__device__ __forceinline__ void put_strip(float* dst, int i0, int rows,
                                          int lane, const float (&c)[NLT_NQ][4],
                                          bool add) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + g + 8 * h;
    if (i >= rows) continue;
#pragma unroll
    for (int q = 0; q < NLT_NQ; ++q) {
      float2* p = reinterpret_cast<float2*>(dst + i * NLT_H + 8 * q + 2 * t);
      float2 v = make_float2(c[q][2 * h], c[q][2 * h + 1]);
      if (add) {
        const float2 o = *p;
        v = make_float2(o.x + v.x, o.y + v.y);
      }
      *p = v;
    }
  }
}

// Weight gradients of a block step, added to the block's partial row:
// strips w, w + kWarps, .. of warp w, each summed over the step's tiles
// (`strip_sum`) and added to its place in `part` (this warp's alone). The
// dW0 strips take x's columns c0 .. c0 + nc - 1 as staged.
template <int kKind, int kWarps, typename T>
__device__ __forceinline__ void step_wgrad_global(const float* bufs,
                                                  float* part, int d_in,
                                                  int c0, int nc, bool w1,
                                                  int warp, int lane) {
  constexpr int XC = x_cols<kKind>();
  const int n_strips = (w1 ? kW1Strips : 0) + (nc + 15) / 16;
  for (int s = warp; s < n_strips; s += kWarps) {
    float c[NLT_NQ][4];
    zero(c);
    if (w1 && s < kW1Strips) {
      strip_sum<kKind, kWarps, float>(bufs, kRows * XC, NLT_H,
                                      kRows * (XC + NLT_H), 16 * s, lane, c);
      put_strip(part + d_in * NLT_H, 16 * s, NLT_H, lane, c, true);
    } else {
      const int i0 = 16 * (s - (w1 ? kW1Strips : 0));
      strip_sum<kKind, kWarps, T>(bufs, 0, XC, kRows * (XC + 2 * NLT_H), i0,
                                  lane, c);
      put_strip(part + (size_t)c0 * NLT_H, i0, nc, lane, c, true);
    }
  }
}

template <int kKind, typename T>
__global__ void __launch_bounds__(n_warps<kKind>() * 32, 1)
    embed_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dout,
                     const float* __restrict__ params, T* __restrict__ dx,
                     float* __restrict__ partial, long long n_rows,
                     int d_in) {
  constexpr int XC = x_cols<kKind>();
  constexpr int WF = warp_floats<kKind>();
  constexpr int kWarps = n_warps<kKind>(), kStep = kWarps * kRows;
  constexpr bool kW0 = w0_shared<kKind>();
  extern __shared__ __align__(16) float smem[];
  float* w0 = kW0 ? smem : nullptr;              // (XC, H), rows from d_in on zero
  float* w1 = smem + (kW0 ? XC * NLT_H : 0);     // (H, H)
  float* vec = w1 + HH;                          // b0 | b1 | ls | lb
  float* bufs = vec + 4 * NLT_H;
  if constexpr (kW0) {
    for (int i = threadIdx.x; i < XC * NLT_H; i += blockDim.x) {
      const int r = i / NLT_H;
      w0[at(r, i % NLT_H, NLT_H)] = r < d_in ? params[i] : 0.f;
    }
  }
  const float* pw1 = params + (size_t)d_in * NLT_H;
  for (int i = threadIdx.x; i < HH; i += blockDim.x)
    w1[at(i / NLT_H, i % NLT_H, NLT_H)] = pw1[i];
  for (int i = threadIdx.x; i < 4 * NLT_H; i += blockDim.x)
    vec[i] = pw1[HH + i];
  for (int i = threadIdx.x; i < kWarps * WF; i += blockDim.x) bufs[i] = 0.f;
  float* part = partial + (size_t)blockIdx.x * n_params(d_in);
  if constexpr (!w0_shared<kKind>()) {
    // the weight gradients are added step by step to this block's row
    for (int i = threadIdx.x; i < d_in * NLT_H + HH; i += blockDim.x)
      part[i] = 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* xs = bufs + warp * WF;
  float* ts = xs + kRows * XC;
  float* dys = ts + kRows * NLT_H;
  float* d0s = dys + kRows * NLT_H;
  const bool x16 = rows16(x, d_in);
  const bool d16 = (reinterpret_cast<size_t>(dout) & 15) == 0;
  Cols vsum[4];  // db0, db1, dls, dlb
  cols_fill(vsum, cols_fill(0.f));
  // strips a warp, registers: at most kW1Strips + XC/16 strips in all
  constexpr int NS = w0_shared<kKind>()
                         ? (kW1Strips + XC / 16 + kWarps - 1) / kWarps
                         : 1;
  const int n_strips = kW1Strips + (d_in + 15) / 16;
  float acc[NS][NLT_NQ][4];
#pragma unroll
  for (int j = 0; j < NS; ++j) zero(acc[j]);
  const long long n_steps = (n_rows + kStep - 1) / kStep;
  const int nc0 = kKind == kChunked ? min(XC, d_in) : d_in;

  for (long long s = blockIdx.x; s < n_steps; s += gridDim.x) {
    const long long r0 = s * kStep + warp * kRows;
    stage_tile<XC, T>(xs, dys, x, dout, r0, n_rows, d_in, nc0, x16, d16,
                      lane);
    cp_async_wait<1>();  // x has landed
    __syncwarp();
    chain_tile<kKind, T>(xs, ts, dys, d0s, x, params, w0, w1, vec, dx, r0,
                         n_rows, d_in, x16, lane, vsum);
    __syncthreads();
    if constexpr (w0_shared<kKind>()) {
      step_wgrad<kKind, NS, kWarps, T>(bufs, n_strips, warp, lane, acc);
    } else if constexpr (kKind != kChunked) {
      step_wgrad_global<kKind, kWarps, T>(bufs, part, d_in, 0, d_in, true,
                                          warp, lane);
    } else {
      // x's chunks from the last (still staged) to the first, each staged
      // again by every warp; dW1's strips with the last
      const int n_ch = (d_in + XC - 1) / XC;
      for (int ch = n_ch - 1; ch >= 0; --ch) {
        const int c0 = ch * XC, nc = min(XC, d_in - c0);
        if (ch < n_ch - 1) {
          __syncthreads();  // every warp is done with the staged chunk
          stage_x<XC>(xs, x, r0, n_rows, d_in, c0, nc, x16, lane);
          cp_async_commit();
          cp_async_wait<0>();
          __syncthreads();
        }
        step_wgrad_global<kKind, kWarps, T>(bufs, part, d_in, c0, nc,
                                            ch == n_ch - 1, warp, lane);
      }
    }
    __syncthreads();
  }

  if constexpr (w0_shared<kKind>()) {
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int st = warp + j * kWarps;
      if (st >= n_strips) break;
      if (st < kW1Strips)
        put_strip(part + d_in * NLT_H, 16 * st, NLT_H, lane, acc[j], false);
      else
        put_strip(part, 16 * (st - kW1Strips), d_in, lane, acc[j], false);
    }
  }
  nlt_block_vec_sums<4>(bufs, vsum, kWarps, part + d_in * NLT_H + HH,
                        TileCol{});
}

template <int kKind, typename T>
cudaError_t grid_for(long long n_rows, int* grid) {
  constexpr int kStep = n_warps<kKind>() * kRows;
  return nlt_launch_config(embed_bwd_kernel<kKind, T>, n_warps<kKind>() * 32,
                           smem_bytes<kKind>(),
                           (n_rows + kStep - 1) / kStep, grid);
}

template <int kKind, typename T>
cudaError_t launch(const T* x, const T* dout, const float* params, T* dx,
                   float* partial, long long n_rows, int d_in, int grid,
                   cudaStream_t stream) {
  cudaError_t err = nlt_allow_smem(embed_bwd_kernel<kKind, T>,
                                   smem_bytes<kKind>());
  if (err != cudaSuccess) return err;
  embed_bwd_kernel<kKind, T><<<grid, n_warps<kKind>() * 32,
                               smem_bytes<kKind>(), stream>>>(
      x, dout, params, dx, partial, n_rows, d_in);
  return cudaGetLastError();
}

// The kind of staging for d_in: narrow up to H, wide up to 2H at widths
// 32 and 64, chunked above.
inline int kind_of(int d_in) {
  return d_in <= NLT_H ? kNarrow
         : (NLT_H <= 64 && d_in <= 2 * NLT_H) ? kWide
                                               : kChunked;
}

template <typename T>
int bwd_grid(long long n_rows, int d_in, int device, int* grid) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d_in < 1) return (int)cudaErrorInvalidValue;
  switch (kind_of(d_in)) {
    case kNarrow: return (int)grid_for<kNarrow, T>(n_rows, grid);
    case kWide:
      if constexpr (NLT_H <= 64) return (int)grid_for<kWide, T>(n_rows, grid);
      return (int)cudaErrorInvalidValue;
    default: return (int)grid_for<kChunked, T>(n_rows, grid);
  }
}

template <typename T>
int bwd(const T* x, const T* dout, const float* params, T* dx,
        float* partial, long long n_rows, int d_in, int grid, int device,
        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (d_in < 1 || grid < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (kind_of(d_in)) {
    case kNarrow:
      return (int)launch<kNarrow, T>(x, dout, params, dx, partial, n_rows,
                                     d_in, grid, st);
    case kWide:
      if constexpr (NLT_H <= 64)
        return (int)launch<kWide, T>(x, dout, params, dx, partial, n_rows,
                                     d_in, grid, st);
      return (int)cudaErrorInvalidValue;
    default:
      return (int)launch<kChunked, T>(x, dout, params, dx, partial, n_rows,
                                      d_in, grid, st);
  }
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
