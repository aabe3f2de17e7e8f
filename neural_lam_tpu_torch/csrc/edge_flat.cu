// Flat-layout edge-MLP tail and processor edge layer (kernels K2 and K3).
//
// Replaces, from neural_lam_tpu/ops/pallas_edge_flat.py:
//   K2  _tail_sum_flat_kernel (edge_tail_sum_flat): static edge term ew
//   K3  _layer_flat_kernel (edge_layer_flat) and _layer_flat_win_kernel
//       (edge_layer_flat_win): evolving edge state, one kernel for both,
//       since the sender row is read by index from the node table here
//       instead of from a pre-gathered array or a one-hot window.
//
// Per (virtual row v, batch element b), over the row's K edge slots k:
//   x0[k]  = table[senders[v*K+k], b] + rec_rows[v, b]
//            + ew[v*K+k]                          (K2; b0 is inside ew)
//            + edge[v*K+k, b] @ W_e + b0           (K3)
//   msg[k] = LayerNorm(silu(x0[k]) @ W2 + b2)
//   edge_out[v*K+k, b] = edge[v*K+k, b] + msg[k]   (K3, padding slots too)
//   virt[v, b] = sum_k mask[v, k] * msg[k]
//
// K2 (`edge_tail_kernel`): one warp owns one (v, b) pair and all K slots
// of it, so the masked slot sum is a register sum; W2 sits in shared
// memory and the product runs on CUDA cores (`nlt_mm64`). Bound (fp32
// CUDA cores, bench shapes): operations -- 2*64*64 FLOP per slot and
// batch element against ~1 KB of traffic per slot.
//
// K3 (`edge_layer_tc_kernel`) runs both 64x64 products on tensor cores in
// 3xTF32 (tc_common.cuh), which keeps fp32 accuracy at three TF32
// products per term. Its bound on this card is then the bytes (~1.2 KB
// per slot and batch element: the edge row in, edge_out out, the sender
// and receiver rows), not the operations: at GraphLAM's m2m[0] 3 x 3.9
// GFLOP take 0.024 ms at the TF32 peak against 0.043 ms for 144 MB.
// What holds it is the latency of each warp's chain of dependent steps
// (products, silu, LayerNorm, stores): with the products taken out it
// runs within 10% of its time, and more warps per SM make it faster
// (probes/torch_k3_probe.py); so the design buys warps with shared memory.
// - One warp owns one tile: 16 consecutive slot rows (v*K + k) at one
//   batch element b, the m16 of `mma.sync` m16n8k8: 16/K virtual rows
//   (2 at K = 8, 16 at K = 1); for a K that does not divide 16 the
//   tile takes floor(16/K) virtual rows and its last rows are padding.
//   Warps walk their tiles on their own; tile t is (16/K-row group t/B,
//   batch element t%B), so the warps of a block share rows.
// - A tile's edge rows and gathered sender rows are staged by 16-byte
//   cp.async into 16 x 68 buffers (the padded stride makes the
//   A-fragment reads (row g, column t) hit 32 distinct banks). The edge
//   rows have two buffers a warp, so the next tile's are in flight while
//   this one is computed; the sender rows one, refilled for the next tile
//   as soon as the second product has read it. The receiver rows and the
//   masks are loaded into registers at the top of the tile.
// - W_e and W2 are split once per block into TF32 big/small halves and
//   stored in fragment order, so a lane loads the B fragments of one
//   (k step, 8-column tile) with one 128-bit load.
// - Product 1 (E @ W_e) leaves x0 - b0 - table - rec in the C fragments;
//   the lane adds the rest, applies silu and writes X1 over the staged
//   sender rows (the C and A fragment layouts differ), and product 2
//   (X1 @ W2) reads it back as its A operand.
// - A lane holds 16 of the 64 columns of rows g and g+8, so the
//   LayerNorm statistics are quad sums (two shfl.xor); edge_out = edge +
//   msg is written from the staged edge rows. virt: at K = 1, 2, 4, 8 the
//   K rows of a virtual row sit in lanes that differ in the low bits of
//   g, summed by shfl.xor; other K sum the masked rows through shared
//   memory. A fixed order and no atomics: two calls give bit-identical
//   outputs.
#include "common.cuh"
#include "tc_common.cuh"

namespace {

constexpr int kWarps = 8;  // K2: warps per block
constexpr int HH = NLT_H * NLT_H;

// Parameter blob (floats): w2[64*64] | b2 | ls | lb  [| we[64*64] | b0]
constexpr int kTailParams = HH + 3 * NLT_H;

// ------------------------------------------------------------------ K2 ----

template <int K>
__global__ void __launch_bounds__(kWarps * 32)
    edge_tail_kernel(const float* __restrict__ table,
                     const int* __restrict__ senders,
                     const float* __restrict__ ew,  // (M, 64)
                     const float* __restrict__ rec_rows,
                     const float* __restrict__ mask,
                     const float* __restrict__ params,
                     float* __restrict__ virt, int n_virt, int B) {
  extern __shared__ float smem[];
  nlt_load_params(smem, params, kTailParams);
  __syncthreads();
  const float* w2 = smem;
  const float* b2 = w2 + HH;
  const float* ls = b2 + NLT_H;
  const float* lb = ls + NLT_H;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* xs = smem + nlt_round4(kTailParams) + warp * K * NLT_H;
  const int W = B * NLT_H;
  const float2 b2v = nlt_ld2(b2, lane), lsv = nlt_ld2(ls, lane),
               lbv = nlt_ld2(lb, lane);
  const long long n_items = (long long)n_virt * B;

  for (long long item = (long long)blockIdx.x * kWarps + warp; item < n_items;
       item += (long long)gridDim.x * kWarps) {
    const int v = (int)(item / B), b = (int)(item % B);
    const size_t slot0 = (size_t)v * K;
    const float2 rec = nlt_ld2(rec_rows + (size_t)v * W + b * NLT_H, lane);
    float2 x0[K];
#pragma unroll
    for (int k = 0; k < K; ++k) x0[k] = nlt_ld2(ew + (slot0 + k) * NLT_H, lane);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = senders[slot0 + k];
      const float2 g = nlt_ld2(table + (size_t)s * W + b * NLT_H, lane);
      nlt_st2(xs + k * NLT_H, lane,
              nlt_silu2(nlt_add2(nlt_add2(x0[k], g), rec)));
    }
    __syncwarp();
    float2 y[K];
    nlt_fill(y, b2v);
    nlt_mm64<K>(xs, NLT_H, w2, NLT_H, lane, y);
    __syncwarp();  // xs is rewritten by the next item
    float2 sum = make_float2(0.f, 0.f);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float2 msg = nlt_layer_norm(y[k], lsv, lbv);
      const float m = mask[slot0 + k];
      sum.x = fmaf(m, msg.x, sum.x);
      sum.y = fmaf(m, msg.y, sum.y);
    }
    nlt_st2(virt + (size_t)v * W + b * NLT_H, lane, sum);
  }
}

template <int K>
cudaError_t tail_launch(const float* table, const int* senders,
                        const float* ew, const float* rec_rows,
                        const float* mask, const float* params, float* virt,
                        int n_virt, int B, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (nlt_round4(kTailParams) + kWarps * K * NLT_H);
  const long long items = (long long)n_virt * B;
  int grid = 0;
  cudaError_t err = nlt_launch_config(edge_tail_kernel<K>, kWarps * 32, smem,
                                      (items + kWarps - 1) / kWarps, &grid);
  if (err != cudaSuccess) return err;
  edge_tail_kernel<K><<<grid, kWarps * 32, smem, stream>>>(
      table, senders, ew, rec_rows, mask, params, virt, n_virt, B);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ K3 ----

// K3's warps per block, one block per SM: the most that the shared memory
// holds (probes/torch_k3_probe.py times 8 and 10 beside it).
constexpr int kLayerWarps = 12;
constexpr int kRows = 16;               // slot rows of a tile
constexpr int kLd = NLT_H + 4;          // padded stride of a staged row
constexpr int kTileF = kRows * kLd;     // floats of one staged tile
constexpr int kFrag = 8 * 8 * 32;       // (k step, 8-column tile, lane)
enum { V_B0, V_B2, V_LS, V_LB, N_VEC };  // vectors in shared memory

// Weights in fragment order, the vectors, and per warp two edge buffers
// and a sender buffer.
constexpr size_t kLayerSmem = 2 * kFrag * sizeof(uint4) +
                              N_VEC * NLT_H * sizeof(float) +
                              (size_t)kLayerWarps * 3 * kTileF * sizeof(float);
static_assert(kLayerSmem <= 232448, "shared memory of a block");

// silu with the fast exponential and division: within a few ulp of
// nlt_silu, and far fewer instructions on the kernel's critical path.
__device__ __forceinline__ float2 silu_fast(float2 v) {
  return make_float2(__fdividef(v.x, 1.0f + __expf(-v.x)),
                     __fdividef(v.y, 1.0f + __expf(-v.y)));
}

// B fragments of W (64 x 64, (in, out) row-major) for (k step ks, 8-column
// tile q, lane): {big(b0), big(b1), small(b0), small(b1)} with b0 =
// W[8ks + t, 8q + g], b1 = W[8ks + t + 4, 8q + g]. Unrolled over the
// block's threads, so that every thread's loads are in flight at once:
// the split is each block's fixed cost, a large share of K3's time on
// small edge sets.
__device__ __forceinline__ void split_weights(uint4* frag,
                                              const float* __restrict__ w) {
#pragma unroll
  for (int i0 = 0; i0 < kFrag; i0 += kLayerWarps * 32) {
    const int i = i0 + threadIdx.x;
    if (i < kFrag) {
      const int ln = i & 31, q = (i >> 5) & 7, ks = i >> 8;
      const float* p = w + (8 * ks + (ln & 3)) * NLT_H + 8 * q + (ln >> 2);
      uint32_t bb0, bs0, bb1, bs1;
      split_tf32(p[0], bb0, bs0);
      split_tf32(p[4 * NLT_H], bb1, bs1);
      frag[i] = make_uint4(bb0, bb1, bs0, bs1);
    }
  }
}

// acc[q] += A @ W over the 8-column tiles q, in 3xTF32: A the staged
// 16 x 64 tile `a` (stride kLd), W in fragment order (`split_weights`).
__device__ __forceinline__ void tile_product(const float* a,
                                             const uint4* __restrict__ frag,
                                             int lane, float (&acc)[8][4]) {
  const float* a0 = a + (lane >> 2) * kLd + (lane & 3);
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    uint32_t ab[4], as[4];
    split_tf32(a0[8 * ks], ab[0], as[0]);                // (g, t)
    split_tf32(a0[8 * kLd + 8 * ks], ab[1], as[1]);      // (g + 8, t)
    split_tf32(a0[8 * ks + 4], ab[2], as[2]);            // (g, t + 4)
    split_tf32(a0[8 * kLd + 8 * ks + 4], ab[3], as[3]);  // (g + 8, t + 4)
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const uint4 w = frag[(ks * 8 + q) * 32 + lane];
      mma_tf32(acc[q], as, w.x, w.y);
      mma_tf32(acc[q], ab, w.z, w.w);
      mma_tf32(acc[q], ab, w.x, w.y);
    }
  }
}

// Tile t of K3: its 16/K virtual rows from v0 (K rows each; the tile's
// rows from n_rows on are padding) at batch element b.
template <int K>
struct Tile {
  int v0, b, n_rows;
  __device__ __forceinline__ Tile(int t, int n_virt, int B) {
    constexpr int kVpt = kRows / K;
    v0 = t / B * kVpt;
    b = t % B;
    n_rows = min(kVpt, n_virt - v0) * K;
  }
};

// The sender of the tile's row (lane % 16), for `stage_rows`; 0 past the
// last tile or row.
template <int K>
__device__ __forceinline__ int tile_senders(const int* __restrict__ senders,
                                            int t, int n_tiles, int n_virt,
                                            int B, int lane) {
  if (t >= n_tiles) return 0;
  const Tile<K> tl(t, n_virt, B);
  const int row = lane & 15;
  return row < tl.n_rows ? senders[(size_t)tl.v0 * K + row] : 0;
}

// Stage tile t's rows into `dst`: its edge rows (table == nullptr) or
// its sender rows table[s] (s from `tile_senders`, in s_l); rows past the
// tile's n_rows as zeros, nothing past the last tile. Commits one
// cp.async group either way.
template <int K>
__device__ __forceinline__ void stage_rows(float* dst,
                                           const float* __restrict__ edge_in,
                                           const float* __restrict__ table,
                                           int s_l, int t, int n_tiles,
                                           int n_virt, int B, int lane) {
  if (t < n_tiles) {
    const Tile<K> tl(t, n_virt, B);
    const size_t slot0 = (size_t)tl.v0 * K;
    const size_t W = (size_t)B * NLT_H, col0 = (size_t)tl.b * NLT_H;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int row = 2 * j + (lane >> 4), c = 4 * (lane & 15);
      const bool ok = row < tl.n_rows;
      const int s = __shfl_sync(0xffffffffu, s_l, row);
      const float* src = table != nullptr
                             ? table + (size_t)s * W
                             : edge_in + (ok ? slot0 + row : slot0) * W;
      cp_async16(dst + row * kLd + c, src + col0 + c, ok);
    }
  }
  cp_async_commit();
}

template <int K>
__global__ void __launch_bounds__(kLayerWarps * 32, 1)
    edge_layer_tc_kernel(const float* __restrict__ table,
                         const int* __restrict__ senders,
                         const float* __restrict__ edge_in,  // (M, W)
                         const float* __restrict__ rec_rows,
                         const float* __restrict__ mask,
                         const float* __restrict__ params,
                         float* __restrict__ edge_out,
                         float* __restrict__ virt, int n_virt, int B) {
  constexpr int kVpt = kRows / K;  // virtual rows of a tile
  extern __shared__ __align__(16) float smem[];
  uint4* we_f = reinterpret_cast<uint4*>(smem);
  uint4* w2_f = we_f + kFrag;
  float* vec = reinterpret_cast<float*>(w2_f + kFrag);
  split_weights(we_f, params + HH + 3 * NLT_H);
  split_weights(w2_f, params);
  for (int i = threadIdx.x; i < N_VEC * NLT_H; i += blockDim.x)  // b0 | b2..
    vec[i] = i < NLT_H ? params[2 * HH + 3 * NLT_H + i]
                       : params[HH + i - NLT_H];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // this warp's two edge buffers (tile i in buffer i % 2) and its sender
  // buffer (the sender rows, then X1)
  float* stages = vec + N_VEC * NLT_H + warp * 3 * kTileF;
  float* X = stages + 2 * kTileF;
  const int W = B * NLT_H;
  const int n_tiles = (n_virt + kVpt - 1) / kVpt * B;
  const int stride = gridDim.x * kLayerWarps;

  int tile = blockIdx.x * kLayerWarps + warp;
  // cp.async groups in commit order: E(i), G(i), E(i+1), then per tile i
  // G(i+1) after its second product and E(i+2) at its end, so that tile
  // i's wait leaves only E(i+1) in flight
  stage_rows<K>(stages, edge_in, nullptr, 0, tile, n_tiles, n_virt, B, lane);
  stage_rows<K>(X, edge_in, table,
                tile_senders<K>(senders, tile, n_tiles, n_virt, B, lane),
                tile, n_tiles, n_virt, B, lane);
  stage_rows<K>(stages + kTileF, edge_in, nullptr, 0, tile + stride, n_tiles,
                n_virt, B, lane);
  for (int i = 0; tile < n_tiles; tile += stride, ++i) {
    float* E = stages + (i & 1) * kTileF;
    const Tile<K> tl(tile, n_virt, B);
    const size_t slot0 = (size_t)tl.v0 * K;
    const size_t col0 = (size_t)tl.b * NLT_H;
    // loads of this tile's receiver rows and masks, and of the next tile's
    // senders, before the staged rows are needed
    const int s_next =
        tile_senders<K>(senders, tile + stride, n_tiles, n_virt, B, lane);
    float2 rec[2][8];
    float m[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = g + 8 * h;
      const int v = tl.v0 + min(row, tl.n_rows - 1) / K;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        rec[h][q] = *reinterpret_cast<const float2*>(
            rec_rows + (size_t)v * W + col0 + 8 * q + 2 * t);
      m[h] = row < tl.n_rows ? mask[slot0 + row] : 0.f;
    }
    cp_async_wait<1>();  // E(i) and G(i) have landed
    __syncwarp();

    // x0 = E @ W_e + b0 + table[senders] + rec;  X1 = silu(x0) -> X
    float acc[8][4];
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
    tile_product(E, we_f, lane, acc);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = g + 8 * h;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int c = 8 * q + 2 * t;
        const float2 b0 = *reinterpret_cast<const float2*>(vec + c);
        float2* xp = reinterpret_cast<float2*>(X + row * kLd + c);
        const float2 gv = *xp;
        *xp = silu_fast(
            make_float2(acc[q][2 * h] + b0.x + gv.x + rec[h][q].x,
                        acc[q][2 * h + 1] + b0.y + gv.y + rec[h][q].y));
      }
    }
    __syncwarp();

    // y = X1 @ W2 + b2
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
    tile_product(X, w2_f, lane, acc);
    __syncwarp();  // every lane has read X1: X takes the next sender rows
    stage_rows<K>(X, edge_in, table, s_next, tile + stride, n_tiles, n_virt,
                  B, lane);

    // msg = LN(y) over the quad's 64 columns; edge_out = edge + msg
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = g + 8 * h;
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float2 b2 =
            *reinterpret_cast<const float2*>(vec + V_B2 * NLT_H + 8 * q + 2 * t);
        acc[q][2 * h] += b2.x;
        acc[q][2 * h + 1] += b2.y;
        s += acc[q][2 * h] + acc[q][2 * h + 1];
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      const float mean = s * (1.0f / NLT_H);
      float var = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float cx = acc[q][2 * h] - mean, cy = acc[q][2 * h + 1] - mean;
        var += cx * cx + cy * cy;
      }
      var += __shfl_xor_sync(0xffffffffu, var, 1);
      var += __shfl_xor_sync(0xffffffffu, var, 2);
      const float inv = rsqrtf(var * (1.0f / NLT_H) + NLT_LN_EPS);
      const bool ok = row < tl.n_rows;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int c = 8 * q + 2 * t;
        const float2 ls =
            *reinterpret_cast<const float2*>(vec + V_LS * NLT_H + c);
        const float2 lb =
            *reinterpret_cast<const float2*>(vec + V_LB * NLT_H + c);
        const float2 msg =
            make_float2((acc[q][2 * h] - mean) * inv * ls.x + lb.x,
                        (acc[q][2 * h + 1] - mean) * inv * ls.y + lb.y);
        if (ok) {
          const float2 e = *reinterpret_cast<const float2*>(E + row * kLd + c);
          *reinterpret_cast<float2*>(edge_out + (slot0 + row) * W + col0 + c) =
              nlt_add2(e, msg);
        }
        acc[q][2 * h] = m[h] * msg.x;  // from here on: the masked message
        acc[q][2 * h + 1] = m[h] * msg.y;
      }
    }

    // virt[v, b] = sum over the virtual row's K slot rows
    if constexpr ((K & (K - 1)) == 0) {
      // rows g and g+8 of a lane; the K rows of a virtual row are the
      // lanes whose g differ in the low log2(K) bits
#pragma unroll
      for (int o = 4; o < 4 * K; o <<= 1)
#pragma unroll
        for (int q = 0; q < 8; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[q][e] += __shfl_xor_sync(0xffffffffu, acc[q][e], o);
      if (g % K == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = (g + 8 * h) / K;  // virtual row within the tile
          if (tl.v0 + j < n_virt) {
            float* dst = virt + (size_t)(tl.v0 + j) * W + col0 + 2 * t;
#pragma unroll
            for (int q = 0; q < 8; ++q)
              *reinterpret_cast<float2*>(dst + 8 * q) =
                  make_float2(acc[q][2 * h], acc[q][2 * h + 1]);
          }
        }
      }
    } else {
      __syncwarp();  // every lane has read its edge rows: E takes the sums
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < 8; ++q)
          *reinterpret_cast<float2*>(E + (g + 8 * h) * kLd + 8 * q + 2 * t) =
              make_float2(acc[q][2 * h], acc[q][2 * h + 1]);
      __syncwarp();
      for (int j = 0; j < kVpt && tl.v0 + j < n_virt; ++j) {
        float2 sum = make_float2(0.f, 0.f);
#pragma unroll
        for (int k = 0; k < K; ++k)
          sum = nlt_add2(sum, nlt_ld2(E + (j * K + k) * kLd, lane));
        nlt_st2(virt + (size_t)(tl.v0 + j) * W + col0, lane, sum);
      }
    }
    __syncwarp();  // E is free: it takes the tile two ahead
    stage_rows<K>(E, edge_in, nullptr, 0, tile + 2 * stride, n_tiles, n_virt,
                  B, lane);
  }
  cp_async_wait<0>();
}

template <int K>
cudaError_t layer_launch(const float* table, const int* senders,
                         const float* edge_in, const float* rec_rows,
                         const float* mask, const float* params,
                         float* edge_out, float* virt, int n_virt, int B,
                         cudaStream_t stream) {
  const long long tiles =
      (long long)((n_virt + kRows / K - 1) / (kRows / K)) * B;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t err = nlt_launch_config(
      edge_layer_tc_kernel<K>, kLayerWarps * 32, kLayerSmem,
      (tiles + kLayerWarps - 1) / kLayerWarps, &grid);
  if (err != cudaSuccess) return err;
  edge_layer_tc_kernel<K><<<grid, kLayerWarps * 32, kLayerSmem, stream>>>(
      table, senders, edge_in, rec_rows, mask, params, edge_out, virt, n_virt,
      B);
  return cudaGetLastError();
}

}  // namespace

// K2. virt (n_virt, B*64).
extern "C" int nlt_edge_tail_sum(const float* table, const int* senders,
                                 const float* ew, const float* rec_rows,
                                 const float* mask, const float* params,
                                 float* virt, int n_virt, int K, int B,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_virt == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define NLT_CASE(KK)                                                      \
  case KK:                                                                \
    return (int)tail_launch<KK>(table, senders, ew, rec_rows, mask, params, \
                                virt, n_virt, B, s);
  switch (K) {
    NLT_FOR_K(NLT_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NLT_CASE
}

// K3. edge_out (n_virt*K, B*64), virt (n_virt, B*64).
extern "C" int nlt_edge_layer(const float* edge_rep, const float* table,
                              const int* senders, const float* rec_rows,
                              const float* mask, const float* params,
                              float* edge_out, float* virt, int n_virt, int K,
                              int B, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_virt == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define NLT_CASE(KK)                                                   \
  case KK:                                                             \
    return (int)layer_launch<KK>(table, senders, edge_rep, rec_rows, mask, \
                                 params, edge_out, virt, n_virt, B, s);
  switch (K) {
    NLT_FOR_K(NLT_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NLT_CASE
}
