// The edge-MLP tensor-core kernel `edge_tc_kernel<K, kMode, kBatched>`,
// in two layouts and three modes. Included by csrc/edge_flat.cu (K2, K3:
// the flat layout) and csrc/edge.cu (P1, P2, P3: the batched layout).
//
// Replaces, from neural_lam_tpu/ops/:
//   K2  pallas_edge_flat.py _tail_sum_flat_kernel     <K, TAIL_SUM, false>
//   K3  pallas_edge_flat.py _layer_flat_kernel and
//       _layer_flat_win_kernel                        <K, LAYER, false>
//   P1  pallas_edge.py _tail_kernel                   <K, X0, true>
//   P2  pallas_edge.py _tail_sum_kernel               <K, TAIL_SUM, true>
//   P3  pallas_edge.py _layer_kernel, both in_gather  <K, LAYER, true>
// The sender row is read by index from the node table here, so each pair
// of Pallas variants (pre-gathered rows, a one-hot window, a resident
// table) is one kernel. The JAX package has no flat P1, so X0 has the
// batched instance only.
//
// Per (virtual row v, batch element b), over the row's K edge slots k:
//   x0[k]  = table[senders[v*K+k], b] + rec_rows[v, b]
//            + ew[v*K+k]                          (TAIL_SUM; b0 is in ew)
//            + edge[v*K+k, b] @ W_e + b0           (LAYER)
//          = edge[v*K+k, b], materialised          (X0)
//   msg[k] = LayerNorm(silu(x0[k]) @ W2 + b2)
//   out[v*K+k, b] = edge[v*K+k, b] + msg[k]        (LAYER)
//                 = msg[k]                         (P1, P2, when out != null)
//   virt[v, b] = sum_k mask[v, k] * msg[k]
// out is written at every slot of a virtual row, padding slots included,
// as the Pallas kernels write it.
//
// Layouts (`row_at`): flat, (rows, B*64) for every array (row stride
// B*64, batch stride 64); batched, the JAX package's (B, rows, 64) (row
// stride 64, batch stride rows*64), with rows = n_virt*K for edge and out,
// n_send for the table and n_virt for rec_rows and virt. ew (M, 64) is
// shared by every batch element in both. At B = 1 the two are the same
// bytes.
//
// Bound on this card: the bytes. The 64x64 products run on tensor cores
// in 3xTF32 (tc_common.cuh), which keeps fp32 accuracy at three TF32
// products per term; ~1.2 KB a slot row (the edge row in, out out, the
// sender and receiver rows; X0: x0 in, msg out) then outweighs 3 x 16
// KFLOP a product at the TF32 peak (at GraphLAM's m2m[0], B = 4: 0.043 ms
// for 144 MB against 0.024 ms).
// What holds the kernel is the latency of each warp's chain of dependent
// steps (products, silu, LayerNorm, stores): with the products taken out
// it runs within 10% of its time, and more warps per SM make it faster
// (probes/torch_k3_probe.py); so the design buys warps with shared memory.
// - One warp owns one tile: 16 consecutive slot rows (v*K + k) at one
//   batch element b, the m16 of `mma.sync` m16n8k8: 16/K virtual rows
//   (2 at K = 8, 16 at K = 1); for a K that does not divide 16 the
//   tile takes floor(16/K) virtual rows and its last rows are padding.
//   Warps walk their tiles on their own; tile t is (16/K-row group t/B,
//   batch element t%B), so tiles t and t+1 read the same rows (with the
//   shared ew, each ew row comes from DRAM once). Warp w of block c takes
//   tiles w*G + c, then every (warps * G)-th, G the grid: each round of
//   tiles spreads over every block, so a last, partial round does not
//   pile up on the first SMs, and a set of fewer tiles than the card
//   holds warps (HiLAM's upper levels at batch 1: 32-384 tiles) runs as
//   one block per tile, up to one block an SM, each tile's chain alone
//   (or nearly) on its SM.
// - A tile's edge (ew, x0) rows and gathered sender rows are staged by
//   16-byte cp.async into 16 x 68 float buffers (the padded stride makes
//   the A-fragment reads (row g, column t) hit 32 distinct banks; 16
//   distinct words, two lanes a word, for bf16 rows). The edge
//   rows have two buffers a warp, so the next tile's are in flight while
//   this one is computed; the sender rows one, refilled for the next tile
//   as soon as the second product has read it. The receiver rows and the
//   masks are loaded into registers at the top of the tile. X0 has no
//   sender rows and no receiver rows: two buffers a warp.
// - W_e and W2 are split once per block into TF32 big/small halves and
//   stored in fragment order, so a lane loads the B fragments of one
//   (k step, 8-column tile) with one 128-bit load. The split is each
//   block's fixed cost, a large share of the time on small edge sets.
// - Product 1 (E @ W_e) leaves x0 - b0 - table - rec in the C fragments;
//   the lane adds the rest and applies silu into the C fragments, and,
//   once the quad has read its staged sender rows, writes X1 over them
//   (the C and A fragment layouts differ), and product 2
//   (X1 @ W2) reads it back as its A operand. TAIL_SUM has no product 1:
//   x0 = ew + table + rec from the staged ew rows. X0 has neither: each
//   lane applies silu in place to the x0 groups it staged itself, and
//   product 2 reads the edge buffer.
// - A lane holds 16 of the 64 columns of rows g and g+8, so the
//   LayerNorm statistics are quad sums (two shfl.xor); out is written
//   from the C fragments (and, with LAYER, the staged edge rows). virt:
//   at K = 1, 2, 4, 8 the K rows of a virtual row sit in lanes that differ
//   in the low bits of g, summed by shfl.xor; other K sum the masked rows
//   through shared memory. A fixed order and no atomics: two calls give
//   bit-identical outputs.
// - LAYER: 12 warps a block, one block a SM, the most that the shared
//   memory holds with two split weight matrices; TAIL_SUM: one matrix
//   fewer leaves room for 14; X0, with two buffers a warp and no receiver
//   rows in registers: 16.
// - Storage type T (`edge_tc_kernel<K, kMode, kBatched, T>`): float, or
//   __nv_bfloat16 for the bf16 instances of K2, K3, P2 and P3 (the JAX
//   package's bf16 path: table, ew or edge, rec_rows, out and virt in
//   bf16; mask and parameters fp32). Both stage their rows raw by the same
//   cp.async copies (a bf16 row in the first half of a float row of the
//   buffer) and convert a value to fp32 where they read it: the product's
//   A fragments, the sums into x0, the residual, the receiver rows. A
//   bf16 value is exact in TF32, so a product whose A operand is staged
//   bf16 (LAYER's first) takes two TF32 products a term, not three. The
//   LayerNorm and the sums run in fp32, and each output is rounded to
//   nearest even as it is stored: the JAX kernels' fp32 math on bf16
//   inputs. P1's x0 is fp32 in the bf16 path too, so X0 has the float
//   instance only. With the bytes halved, K3's and P3's bound stays the
//   bytes (K3 at m2m[0], B = 4: 72 MB, 0.0216 ms against 0.0197 ms for
//   five TF32 products a term), and K2's and P2's one product, on fp32
//   X1, makes theirs about even; each warp's chain holds them all the
//   same (PERF.md, section 6).
//
// Widths (NLT_H, one library a width; the note above gives 64's). At 32
// the same design, at 16 warps a block for every mode: a tile and the
// split weights (8 KB a matrix) are small, and a lane holds 8 of a row's
// 32 columns. At 128 the split weights (128 KB a matrix in fragment
// order) do not fit: W2 is kept as fp32 pairs in fragment order (64 KB,
// FragF32) and split at each use, LAYER's W_e is read from device memory
// (GlobalW; L2 holds it) and split at each use, and the warps a block are
// what the shared memory holds beside W2 (6 for LAYER and TAIL_SUM, 9 for
// X0). A lane then holds 32 of a row's 128 columns (64 fp32 accumulators)
// and the k-step loop of a product is unrolled by 2, not whole, to bound
// the code. The products (4x 64's per row) rather than the bytes (2x)
// may bound it there.
#pragma once

#include "common.cuh"
#include "tc_common.cuh"

namespace {

constexpr int HH = NLT_H * NLT_H;
constexpr int NQ = NLT_NQ;  // 8-column tiles of a row, k steps of a product
// Weights split once into fragment order (uint4, FragW) at widths 32 and
// 64; at 128, W2 as fp32 pairs (FragF32) and W_e from device memory.
constexpr bool kSplitOnce = NLT_H <= 64;
// k steps of a product unrolled together (whole at 32 and 64)
constexpr int kKsUnroll = NLT_H > 64 ? 2 : NQ;

// What x0 is made of (see the note above); LAYER = 1 and TAIL_SUM = 0, so
// a bool kLayer names the same mode.
enum { TAIL_SUM, LAYER, X0 };

// Parameter blob (floats): w2[H*H] | b2 | ls | lb  [| we[H*H] | b0]
// (the LAYER blob; the others stop at lb).

// Warps per block at width 64 (probes/torch_k3_probe.py times 8 and 10
// for LAYER, probes/torch_k1k2_probe.py 12 for TAIL_SUM).
constexpr int kLayerWarps = 12;
constexpr int kTailWarps = 14;
constexpr int kX0Warps = 16;
constexpr int kRows = 16;               // slot rows of a tile
constexpr int kLd = NLT_H + 4;          // padded stride of a staged row
constexpr int kTileF = kRows * kLd;     // floats of one staged tile
constexpr int kFrag = NQ * NQ * 32;     // (k step, 8-column tile, lane)
enum { V_B0, V_B2, V_LS, V_LB, N_VEC };  // vectors in shared memory

// Shared memory of the weights: W_e's (LAYER) and W2's split fragments,
// or, at 128, W2's fp32 pairs alone.
template <int kMode>
__host__ __device__ constexpr size_t weight_bytes() {
  return kSplitOnce ? (kMode == LAYER ? 2 : 1) * kFrag * sizeof(uint4)
                    : kFrag * sizeof(float2);
}

// Staged tiles a warp: two edge (ew, x0) buffers and, but for X0, a
// sender buffer.
template <int kMode>
__host__ __device__ constexpr int n_bufs() {
  return kMode == X0 ? 2 : 3;
}

template <int kMode>
__host__ __device__ constexpr int n_warps() {
  if (NLT_H == 64)
    return kMode == LAYER ? kLayerWarps
           : kMode == X0  ? kX0Warps
                          : kTailWarps;
  if (NLT_H == 32) return 16;
  // 128: what the shared memory holds beside the weights, at most 16
  const size_t fit = (232448 - weight_bytes<kMode>() -
                      N_VEC * NLT_H * sizeof(float)) /
                     (n_bufs<kMode>() * kTileF * sizeof(float));
  return fit < 16 ? (int)fit : 16;
}

// The weights, the vectors and the warps' staged tiles.
template <int kMode>
constexpr size_t smem_bytes() {
  return weight_bytes<kMode>() + N_VEC * NLT_H * sizeof(float) +
         (size_t)n_warps<kMode>() * n_bufs<kMode>() * kTileF *
             sizeof(float);
}
static_assert(smem_bytes<TAIL_SUM>() <= 232448 &&
                  smem_bytes<LAYER>() <= 232448 && smem_bytes<X0>() <= 232448,
              "shared memory of a block");

// Offset (floats) of row `row` of batch element b in an array of `rows`
// rows a batch element: flat (rows, B*64) or batched (B, rows, 64).
template <bool kBatched>
__device__ __forceinline__ size_t row_at(size_t row, int b, size_t rows,
                                         int B) {
  return kBatched ? ((size_t)b * rows + row) * NLT_H
                  : (row * B + b) * NLT_H;
}

// B fragments of W (H x H, (in, out) row-major) for (k step ks, 8-column
// tile q, lane): {big(b0), big(b1), small(b0), small(b1)} with b0 =
// W[8ks + t, 8q + g], b1 = W[8ks + t + 4, 8q + g]. Unrolled over the
// block's kThreads threads, so that every thread's loads are in flight at
// once.
template <int kThreads = kLayerWarps * 32>
__device__ __forceinline__ void split_weights(uint4* frag,
                                              const float* __restrict__ w) {
#pragma unroll
  for (int i0 = 0; i0 < kFrag; i0 += kThreads) {
    const int i = i0 + threadIdx.x;
    if (i < kFrag) {
      // unsigned: a power-of-two NQ divides by shifts
      const unsigned i5 = (unsigned)i >> 5;
      const int ln = i & 31, q = i5 % NQ, ks = i5 / NQ;
      const float* p = w + (8 * ks + (ln & 3)) * NLT_H + 8 * q + (ln >> 2);
      uint32_t bb0, bs0, bb1, bs1;
      split_tf32(p[0], bb0, bs0);
      split_tf32(p[4 * NLT_H], bb1, bs1);
      frag[i] = make_uint4(bb0, bb1, bs0, bs1);
    }
  }
}

// Row stride, in values of T, of a staged tile: every buffer is a float
// tile (kLd floats a row), and a tile of T staged raw by `stage_rows`
// keeps its rows there, so a bf16 row fills the first half of one.
template <typename T>
__host__ __device__ constexpr int staged_stride() {
  return kLd * (int)(sizeof(float) / sizeof(T));
}

// Columns c, c+1 of row `row` of a staged tile of T, as fp32.
template <typename T>
__device__ __forceinline__ float2 ld2_staged(const float* buf, int row,
                                            int c) {
  return Io<T>::ld2(reinterpret_cast<const T*>(buf) +
                    row * staged_stride<T>() + c);
}

// A staged value of T as a TF32 operand: float by split_tf32, bf16 by
// split_a (its own big half, its small half zero).
__device__ __forceinline__ void split_staged(float x, uint32_t& big,
                                             uint32_t& small) {
  split_tf32(x, big, small);
}
__device__ __forceinline__ void split_staged(__nv_bfloat16 x, uint32_t& big,
                                             uint32_t& small) {
  split_a(x, big, small);
}

// acc[q] += A @ W over the 8-column tiles q, in 3xTF32: A the staged
// 16 x H tile `a` of T (`staged_stride`), W from the reader wb (FragW on
// the fragments of `split_weights`; at 128, FragF32 or GlobalW, tc_common.cuh).
// A bf16 A has no small half: two products a term.
template <typename T, class WB>
__device__ __forceinline__ void tile_product(const float* a, WB wb,
                                             int lane, float (&acc)[NQ][4]) {
  constexpr int ld = staged_stride<T>();
  const T* a0 = reinterpret_cast<const T*>(a) + (lane >> 2) * ld + (lane & 3);
#pragma unroll kKsUnroll
  for (int ks = 0; ks < NQ; ++ks) {
    uint32_t ab[4], as[4];
    split_staged(a0[8 * ks], ab[0], as[0]);               // (g, t)
    split_staged(a0[8 * ld + 8 * ks], ab[1], as[1]);      // (g + 8, t)
    split_staged(a0[8 * ks + 4], ab[2], as[2]);           // (g, t + 4)
    split_staged(a0[8 * ld + 8 * ks + 4], ab[3], as[3]);  // (g + 8, t + 4)
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const uint4 w =
          wb(8 * ks + (lane & 3), 8 * q + (lane >> 2), ks, q, lane);
      if constexpr (sizeof(T) == sizeof(float))
        mma_tf32(acc[q], as, w.x, w.y);
      mma_tf32(acc[q], ab, w.z, w.w);
      mma_tf32(acc[q], ab, w.x, w.y);
    }
  }
}

// Tile t: its 16/K virtual rows from v0 (K rows each; the tile's rows from
// n_rows on are padding) at batch element b.
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

// Stage tile t's rows into `dst`, raw, by 16-byte cp.async copies (rows
// of `staged_stride<T>()` values): its edge rows (table == nullptr; with
// kShared, rows of the (M, H) ew that every batch element shares) or its
// sender rows table[s] (s from `tile_senders`, in s_l; n_send rows a batch
// element); rows past the tile's n_rows as zeros, nothing past the last
// tile. Commits one cp.async group either way.
template <int K, bool kShared, bool kBatched, typename T>
__device__ __forceinline__ void stage_rows(float* dst,
                                           const T* __restrict__ edge_in,
                                           const T* __restrict__ table,
                                           int s_l, int t, int n_tiles,
                                           int n_virt, int n_send, int B,
                                           int lane) {
  constexpr int kPer = 16 / sizeof(T);  // values a copy
  constexpr int kCopies = NLT_H / kPer;  // copies a row: 4 to 32
  if (t < n_tiles) {
    const Tile<K> tl(t, n_virt, B);
    const size_t slot0 = (size_t)tl.v0 * K, M = (size_t)n_virt * K;
#pragma unroll
    for (int j = 0; j < kRows * kCopies / 32; ++j) {
      const int row = j * (32 / kCopies) + lane / kCopies;
      const int c = kPer * (lane % kCopies);
      const bool ok = row < tl.n_rows;
      const int s = __shfl_sync(0xffffffffu, s_l, row);
      const size_t e_row = ok ? slot0 + row : slot0;
      const T* src =
          table != nullptr ? table + row_at<kBatched>(s, tl.b, n_send, B)
          : kShared        ? edge_in + e_row * NLT_H
                           : edge_in + row_at<kBatched>(e_row, tl.b, M, B);
      cp_async16(reinterpret_cast<T*>(dst) + row * staged_stride<T>() + c,
                 src + c, ok);
    }
  }
  cp_async_commit();
}

// LAYER: K3 / P3 (edge_in = edge, out = edge_out). TAIL_SUM: K2 / P2
// (edge_in = ew; out = msg or null, written by P2 only). X0: P1 (edge_in
// = x0; out = msg or null; table, senders and rec_rows unused).
template <int K, int kMode, bool kBatched, typename T>
__global__ void __launch_bounds__(n_warps<kMode>() * 32, 1)
    edge_tc_kernel(const T* __restrict__ table,
                   const int* __restrict__ senders,
                   const T* __restrict__ edge_in,
                   const T* __restrict__ rec_rows,
                   const float* __restrict__ mask,
                   const float* __restrict__ params,
                   T* __restrict__ out, T* __restrict__ virt,
                   int n_virt, int n_send, int B) {
  constexpr int kVpt = kRows / K;  // virtual rows of a tile
  constexpr int kWarps = n_warps<kMode>();
  constexpr bool kLayer = kMode == LAYER, kX0 = kMode == X0;
  constexpr bool kSh = kMode == TAIL_SUM;  // ew rows: one for every b
  static_assert(!kX0 || sizeof(T) == 4, "X0 (P1) is instantiated for float");
  extern __shared__ __align__(16) float smem[];
  uint4* we_f = reinterpret_cast<uint4*>(smem);  // kLayer only
  uint4* w2_f = we_f + (kLayer ? kFrag : 0);
  float2* w2_p = reinterpret_cast<float2*>(smem);  // at 128
  float* vec = smem + weight_bytes<kMode>() / sizeof(float);
  if constexpr (kSplitOnce) {
    if constexpr (kLayer)
      split_weights<kWarps * 32>(we_f, params + HH + 3 * NLT_H);
    split_weights<kWarps * 32>(w2_f, params);
  } else {
    frags_f32(w2_p, params, NLT_H, NQ);
  }
  // the readers of W_e (LAYER's first product) and W2
  const auto we_r = [&] {
    if constexpr (kSplitOnce)
      return FragW{we_f};
    else
      return GlobalW{params + HH + 3 * NLT_H, NLT_H};
  }();
  const auto w2_r = [&] {
    if constexpr (kSplitOnce)
      return FragW{w2_f};
    else
      return FragF32{w2_p};
  }();
  for (int i = threadIdx.x; i < N_VEC * NLT_H; i += blockDim.x)  // b0 | b2..
    vec[i] = i >= NLT_H ? params[HH + i - NLT_H]
             : kLayer   ? params[2 * HH + 3 * NLT_H + i]
                        : 0.f;
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // this warp's two edge buffers (tile i in buffer i % 2) and, but for
  // X0, its sender buffer (the sender rows, then X1)
  float* stages = vec + N_VEC * NLT_H + warp * (kX0 ? 2 : 3) * kTileF;
  float* X = stages + 2 * kTileF;
  const size_t M = (size_t)n_virt * K;
  const int n_tiles = (n_virt + kVpt - 1) / kVpt * B;
  const int stride = gridDim.x * kWarps;

  int tile = warp * gridDim.x + blockIdx.x;
  // cp.async groups in commit order: E(i), G(i), E(i+1), then per tile i
  // G(i+1) after its second product and E(i+2) at its end, so that tile
  // i's wait leaves only E(i+1) in flight. X0 commits no G: E(i), E(i+1),
  // then E(i+2) per tile, and the same wait leaves E(i+1) in flight.
  stage_rows<K, kSh, kBatched, T>(stages, edge_in, nullptr, 0, tile,
                                  n_tiles, n_virt, n_send, B, lane);
  if constexpr (!kX0)
    stage_rows<K, kSh, kBatched, T>(
        X, edge_in, table,
        tile_senders<K>(senders, tile, n_tiles, n_virt, B, lane), tile,
        n_tiles, n_virt, n_send, B, lane);
  stage_rows<K, kSh, kBatched, T>(stages + kTileF, edge_in, nullptr, 0,
                                  tile + stride, n_tiles, n_virt, n_send, B,
                                  lane);
  for (int i = 0; tile < n_tiles; tile += stride, ++i) {
    float* E = stages + (i & 1) * kTileF;
    const Tile<K> tl(tile, n_virt, B);
    const size_t slot0 = (size_t)tl.v0 * K;
    // loads of this tile's receiver rows and masks, and of the next tile's
    // senders, before the staged rows are needed
    int s_next = 0;
    if constexpr (!kX0)
      s_next =
          tile_senders<K>(senders, tile + stride, n_tiles, n_virt, B, lane);
    float2 rec[2][NQ];
    float m[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = g + 8 * h;
      if constexpr (!kX0) {
        const int v = tl.v0 + min(row, tl.n_rows - 1) / K;
        const T* rp =
            rec_rows + row_at<kBatched>(v, tl.b, n_virt, B) + 2 * t;
#pragma unroll
        for (int q = 0; q < NQ; ++q) rec[h][q] = Io<T>::ld2(rp + 8 * q);
      }
      m[h] = row < tl.n_rows ? mask[slot0 + row] : 0.f;
    }
    cp_async_wait<1>();  // E(i) and G(i) have landed
    if constexpr (kX0) {
      // X1 = silu(x0) in place: each lane over the 16-byte groups it
      // staged (`stage_rows`), which its own wait has made visible to it
      constexpr int kCp = NLT_H / 4;  // 16-byte groups a row
#pragma unroll
      for (int j = 0; j < kRows * kCp / 32; ++j) {
        const unsigned ul = lane;
        float4* p = reinterpret_cast<float4*>(
            E + (j * (32 / kCp) + ul / kCp) * kLd + 4 * (ul % kCp));
        const float4 v = *p;
        const float2 lo = silu_fast(make_float2(v.x, v.y));
        const float2 hi = silu_fast(make_float2(v.z, v.w));
        *p = make_float4(lo.x, lo.y, hi.x, hi.y);
      }
    }
    __syncwarp();

    float acc[NQ][4];
    if constexpr (!kX0) {
      // x0 = E @ W_e + b0 (LAYER) or ew, + table[senders] + rec;
      // X1 = silu(x0) -> X
      zero(acc);
      if constexpr (kLayer) tile_product<T>(E, we_r, lane, acc);
      // X1 into acc, then over the staged sender rows (a staged bf16 row
      // lies under fp32 columns that other lanes of its quad write)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = g + 8 * h;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int c = 8 * q + 2 * t;
          float2 e;
          if constexpr (kLayer) {
            const float2 b0 = *reinterpret_cast<const float2*>(vec + c);
            e = make_float2(acc[q][2 * h] + b0.x, acc[q][2 * h + 1] + b0.y);
          } else {
            e = ld2_staged<T>(E, row, c);
          }
          const float2 gv = ld2_staged<T>(X, row, c);
          const float2 x1 = silu_fast(make_float2(e.x + gv.x + rec[h][q].x,
                                                  e.y + gv.y + rec[h][q].y));
          acc[q][2 * h] = x1.x;
          acc[q][2 * h + 1] = x1.y;
        }
      }
      __syncwarp();
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          *reinterpret_cast<float2*>(X + (g + 8 * h) * kLd + 8 * q + 2 * t) =
              make_float2(acc[q][2 * h], acc[q][2 * h + 1]);
      __syncwarp();
    }

    // y = X1 @ W2 + b2
    zero(acc);
    tile_product<float>(kX0 ? E : X, w2_r, lane, acc);
    if constexpr (!kX0) {
      __syncwarp();  // every lane has read X1: X takes the next sender rows
      stage_rows<K, kSh, kBatched, T>(X, edge_in, table, s_next,
                                      tile + stride, n_tiles, n_virt, n_send,
                                      B, lane);
    }

    // msg = LN(y) over the quad's H columns; out = edge + msg (LAYER)
    // or msg (P1, P2, when asked)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = g + 8 * h;
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const float2 b2 =
            *reinterpret_cast<const float2*>(vec + V_B2 * NLT_H + 8 * q + 2 * t);
        acc[q][2 * h] += b2.x;
        acc[q][2 * h + 1] += b2.y;
        s += acc[q][2 * h] + acc[q][2 * h + 1];
      }
      const float mean = quad_sum(s) * (1.0f / NLT_H);
      float var = 0.f;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const float cx = acc[q][2 * h] - mean, cy = acc[q][2 * h + 1] - mean;
        var += cx * cx + cy * cy;
      }
      const float inv = rsqrtf(quad_sum(var) * (1.0f / NLT_H) + NLT_LN_EPS);
      const bool ok = row < tl.n_rows;
      T* op = out + row_at<kBatched>(slot0 + row, tl.b, M, B);
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int c = 8 * q + 2 * t;
        const float2 ls =
            *reinterpret_cast<const float2*>(vec + V_LS * NLT_H + c);
        const float2 lb =
            *reinterpret_cast<const float2*>(vec + V_LB * NLT_H + c);
        const float2 msg =
            make_float2((acc[q][2 * h] - mean) * inv * ls.x + lb.x,
                        (acc[q][2 * h + 1] - mean) * inv * ls.y + lb.y);
        if constexpr (kLayer) {
          if (ok)
            Io<T>::st2(op + c, nlt_add2(ld2_staged<T>(E, row, c), msg));
        } else if constexpr (kBatched) {
          if (ok && out != nullptr) Io<T>::st2(op + c, msg);
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
        for (int q = 0; q < NQ; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[q][e] += __shfl_xor_sync(0xffffffffu, acc[q][e], o);
      if (g % K == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = (g + 8 * h) / K;  // virtual row within the tile
          if (tl.v0 + j < n_virt) {
            T* dst =
                virt + row_at<kBatched>(tl.v0 + j, tl.b, n_virt, B) + 2 * t;
#pragma unroll
            for (int q = 0; q < NQ; ++q)
              Io<T>::st2(dst + 8 * q,
                         make_float2(acc[q][2 * h], acc[q][2 * h + 1]));
          }
        }
      }
    } else {
      __syncwarp();  // every lane has read E (X0: X1): E takes the sums
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          *reinterpret_cast<float2*>(E + (g + 8 * h) * kLd + 8 * q + 2 * t) =
              make_float2(acc[q][2 * h], acc[q][2 * h + 1]);
      __syncwarp();
      for (int j = 0; j < kVpt && tl.v0 + j < n_virt; ++j) {
        // columns c, c + 1 of the row, c = 2*lane + 64*i
#pragma unroll
        for (int i = 0; i < (NLT_H + 63) / 64; ++i) {
          const int c = 2 * lane + 64 * i;
          if (c < NLT_H) {
            float2 sum = make_float2(0.f, 0.f);
#pragma unroll
            for (int k = 0; k < K; ++k)
              sum = nlt_add2(sum, *reinterpret_cast<const float2*>(
                                      E + (j * K + k) * kLd + c));
            Io<T>::st2(virt + row_at<kBatched>(tl.v0 + j, tl.b, n_virt, B) +
                           c,
                       sum);
          }
        }
      }
    }
    __syncwarp();  // E is free: it takes the tile two ahead
    stage_rows<K, kSh, kBatched, T>(E, edge_in, nullptr, 0,
                                    tile + 2 * stride, n_tiles, n_virt,
                                    n_send, B, lane);
  }
  cp_async_wait<0>();
}

template <int K, int kMode, bool kBatched, typename T>
cudaError_t tc_launch(const T* table, const int* senders, const T* edge_in,
                      const T* rec_rows, const float* mask,
                      const float* params, T* out, T* virt, int n_virt,
                      int n_send, int B, cudaStream_t stream) {
  constexpr int kWarps = n_warps<kMode>();
  auto kernel = edge_tc_kernel<K, kMode, kBatched, T>;
  const long long tiles =
      (long long)((n_virt + kRows / K - 1) / (kRows / K)) * B;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t err = nlt_launch_config(kernel, kWarps * 32,
                                      smem_bytes<kMode>(), tiles, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kWarps * 32, smem_bytes<kMode>(), stream>>>(
      table, senders, edge_in, rec_rows, mask, params, out, virt, n_virt,
      n_send, B);
  return cudaGetLastError();
}

// One launch of edge_tc_kernel<K, kMode, kBatched, T> for the K (1..8)
// of the edge set, on `device`'s stream; 0 or a cudaError_t.
template <int kMode, bool kBatched, typename T>
int tc_dispatch(const T* table, const int* senders, const T* edge_in,
                const T* rec_rows, const float* mask, const float* params,
                T* out, T* virt, int n_virt, int K, int B, int n_send,
                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_virt == 0 || B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define NLT_CASE(KK)                                                     \
  case KK:                                                               \
    return (int)tc_launch<KK, kMode, kBatched, T>(                    \
        table, senders, edge_in, rec_rows, mask, params, out, virt,     \
        n_virt, n_send, B, s);
  switch (K) {
    NLT_FOR_K(NLT_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NLT_CASE
}

}  // namespace
