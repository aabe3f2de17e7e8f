// Grid-feature embedder (kernel K1).
//
// Replaces _embed_fwd_kernel (embed_grid_flat) of
// neural_lam_tpu/ops/pallas_embed.py. Per row i = (node n, batch b) of the
// flat input x (N, B*d_in) == (N*B, d_in):
//   out[i] = LayerNorm(silu(x[i] @ W0 + b0) @ W1 + b1)
// out (N, B*H) == (N*B, H). The TPU kernel's zero-padding of d_in to a
// lane multiple and its kron-widened weights are not needed here.
//
// Bound (bench shapes: 255,136 rows, d_in 56): 3.9 GFLOP against 122 MB
// of x and out. On CUDA cores that is operations (0.059 ms at the fp32
// peak); the products run on tensor cores in 3xTF32 (tc_common.cuh),
// where three TF32 products a term take 0.024 ms, so the bytes bound it
// (0.037 ms).
//
// Design: the forward half of B1's chain (csrc/embed_bwd.cu), without its
// backward and weight-gradient buffers.
// - A warp takes 16-row tiles on its own, no block-wide step: its x rows
//   are staged by cp.async into a swizzled buffer (at, tc_common.cuh),
//   zero-padded to a multiple of 8 columns, and double-buffered, so the
//   next tile's rows are in flight while this one is computed.
// - t0 = x W0 and y = t W1 run as mma.sync m16n8k8 in 3xTF32; t =
//   silu(t0 + b0) goes from the C layout to the A layout through the
//   tile's own x buffer (its rows have been read by then). The LayerNorm
//   runs in the C fragments (a row's 64 columns lie in a lane quad:
//   statistics by quad shuffles, fp32), and out is stored from them.
// - The weights are split into TF32 big/small halves once per block and
//   kept in fragment order (K3's way), so a lane loads the B fragments of
//   one (k step, 8-column tile) with one 128-bit load and the products
//   split only their A operand. That takes twice the shared memory of
//   fp32 weights split at each use (B1's way), but at d_in <= 64 both fit
//   the block of 16 warps that the registers allow (20 spill), one block
//   a SM; 8 warps up to 128 columns. Above 128, x is staged in 64-column
//   chunks, one buffer a warp, and W0 is read from device memory and
//   split at each use (it need not fit in shared memory): any d_in runs.
// Rows past n_rows are staged as zeros and never stored.
//
// Widths (NLT_H, one library a width; the note above gives 64's; out is
// (n_rows, H)). At 32 the same design: a lane holds 8 of a row's 32
// columns, the weights' fragments are 8 KB (W1) and up to 16 KB (W0, 64
// columns), and every kind runs 16 warps a block; the bench's d_in 56
// takes the wide kind. At 128, W1's split fragments (128 KB) and W0's do
// not fit beside the warps' buffers: W1 is kept as fp32 pairs in fragment
// order (64 KB, FragF32) and split at each use, and W0 is always read
// from device memory (GlobalW, L2 holds it) and split at each use; x is
// staged at 128 columns (d_in <= 128, two buffers a warp, 10 warps a
// block) or in 128-column chunks. A lane holds 32 of a row's 128 columns.
//
// bf16 instance (`embed_kernel<kKind, __nv_bfloat16>`, entry
// nlt_embed_bf16): x read in bf16, staged raw by the same cp.async copies
// into a swizzled bf16 tile (`at_bf16`, one value at a time when d_in is
// not a multiple of 8), and converted at the A-fragment reads of t0 = x
// W0, which takes two TF32 products a term (a bf16 value has no small
// half); t, y and the LayerNorm in fp32 on the fp32 weights, out stored
// in bf16 (round to nearest even): the JAX kernel with
// out_dtype=bfloat16. Its bytes halve (61 MB, 0.018 ms at the bench), so
// the products bound it (0.020 ms).
#include "common.cuh"
#include "tc_common.cuh"

namespace {

constexpr int HH = NLT_H * NLT_H;  // W1's floats
// Weights split once into fragment order (FragW) at widths 32 and 64; at
// 128, W1 as fp32 pairs (FragF32) and W0 from device memory (GlobalW).
constexpr bool kSplitOnce = NLT_H <= 64;

// How x is staged: H columns (d_in <= H), 2H (d_in <= 2H; widths 32 and
// 64), or in H-column chunks with W0 read from device memory (GlobalW,
// tc_common.cuh; tile_mma's reader of B(k, n) = W0[k, n], zero from row
// `rows` on, offset to a chunk's first row, split at each use).
enum { kNarrow, kWide, kChunked };

template <int kKind>
__host__ __device__ constexpr int x_cols() {
  return kKind == kWide ? 2 * NLT_H : NLT_H;
}

// x buffers a warp: two (double-buffered), one when chunked.
template <int kKind>
__host__ __device__ constexpr int n_bufs() {
  return kKind == kChunked ? 1 : 2;
}

// Fragments (split_frags) of one 8-row k step of a (rows, H) weight.
constexpr int kStepFrags = NLT_NQ * 32;

// k steps of W0 in shared memory: x_cols / 8, none when chunked or at 128.
template <int kKind>
__host__ __device__ constexpr int w0_steps() {
  return kKind == kChunked || !kSplitOnce ? 0 : x_cols<kKind>() / 8;
}

// Shared memory of the weights: W1's and W0's fragments, or, at 128, W1's
// fp32 pairs.
template <int kKind>
__host__ __device__ constexpr size_t weight_bytes() {
  return kSplitOnce
             ? sizeof(uint4) * kStepFrags * (NLT_NQ + w0_steps<kKind>())
             : sizeof(float2) * kStepFrags * NLT_NQ;
}

// Warps a block, one block a SM: what the shared memory holds beside the
// weights, at most 16 (at 64: 16, 8 for the wide kind).
template <int kKind>
__host__ __device__ constexpr int n_warps() {
  const size_t fit =
      (232448 - weight_bytes<kKind>() - sizeof(float) * 4 * NLT_H) /
      (sizeof(float) * n_bufs<kKind>() * kTcRows * x_cols<kKind>());
  return fit < 16 ? (int)fit : 16;
}

// The weights, b0 | b1 | ls | lb, and the warps' x buffers (16 x x_cols
// each).
template <int kKind>
constexpr size_t smem_bytes() {
  return weight_bytes<kKind>() +
         sizeof(float) * (4 * NLT_H + (size_t)n_warps<kKind>() *
                                          n_bufs<kKind>() * kTcRows *
                                          x_cols<kKind>());
}
static_assert(smem_bytes<kNarrow>() <= 232448 &&
                  smem_bytes<kWide>() <= 232448 &&
                  smem_bytes<kChunked>() <= 232448,
              "shared memory of a block");
static_assert(NLT_H != 64 || (n_warps<kNarrow>() == 16 &&
                              n_warps<kWide>() == 8 &&
                              n_warps<kChunked>() == 16),
              "width 64's warps a block");

// Stage tile `tile`'s x rows into xs (nothing past the last tile) and
// commit one cp.async group either way.
template <int XC, typename T>
__device__ __forceinline__ void stage_tile(float* xs,
                                           const T* __restrict__ x,
                                           long long tile, long long n_tiles,
                                           long long n_rows, int d_in,
                                           bool x16, int lane) {
  if (tile < n_tiles)
    stage_x<XC>(xs, x, tile * kTcRows, n_rows, d_in, 0, d_in, x16, lane);
  cp_async_commit();
}

template <int kKind, typename T>
__global__ void __launch_bounds__(n_warps<kKind>() * 32, 1)
    embed_kernel(const T* __restrict__ x, const float* __restrict__ params,
                 T* __restrict__ out, long long n_rows, int d_in) {
  constexpr int XC = x_cols<kKind>(), kWarps = n_warps<kKind>();
  constexpr int kBuf = kTcRows * XC;  // floats of one x buffer
  constexpr bool kChunk = kKind == kChunked;
  extern __shared__ __align__(16) float smem[];
  uint4* w1f = reinterpret_cast<uint4*>(smem);  // W1's fragments
  uint4* w0f = w1f + NLT_NQ * kStepFrags;       // W0's, if in shared memory
  float2* w1p = reinterpret_cast<float2*>(smem);  // W1's pairs, at 128
  float* vec = smem + weight_bytes<kKind>() / sizeof(float);
  float* bufs = vec + 4 * NLT_H;                // after b0 | b1 | ls | lb
  const float* pw1 = params + (size_t)d_in * NLT_H;
  if constexpr (kSplitOnce) {
    split_frags(w1f, pw1, NLT_H, NLT_NQ);
    if constexpr (w0_steps<kKind>() > 0)
      split_frags(w0f, params, d_in, w0_steps<kKind>());
  } else {
    frags_f32(w1p, pw1, NLT_H, NLT_NQ);
  }
  for (int i = threadIdx.x; i < 4 * NLT_H; i += blockDim.x)
    vec[i] = pw1[HH + i];
  __syncthreads();
  // the reader of W1
  const auto w1_r = [&] {
    if constexpr (kSplitOnce)
      return FragW{w1f};
    else
      return FragF32{w1p};
  }();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* xb = bufs + warp * n_bufs<kKind>() * kBuf;
  const bool x16 = rows16(x, d_in);
  const long long n_tiles = (n_rows + kTcRows - 1) / kTcRows;
  const long long stride = (long long)gridDim.x * kWarps;
  long long tile = (long long)blockIdx.x * kWarps + warp;
  if constexpr (!kChunk) {
    // cp.async groups in commit order: X(0), X(1), then X(i+2) once tile
    // i's second product has read its buffer; tile i's wait leaves only
    // X(i+1) in flight
    stage_tile<XC>(xb, x, tile, n_tiles, n_rows, d_in, x16, lane);
    stage_tile<XC>(xb + kBuf, x, tile + stride, n_tiles, n_rows, d_in, x16,
                   lane);
  }
  for (int i = 0; tile < n_tiles; tile += stride, ++i) {
    const long long r0 = tile * kTcRows;
    float* xs = xb + (kChunk ? 0 : (i & 1) * kBuf);
    float acc[NLT_NQ][4];
    zero(acc);
    // t0 = x W0
    if constexpr (kChunk) {
      for (int c0 = 0; c0 < d_in; c0 += NLT_H) {
        const int nc = min(NLT_H, d_in - c0);
        __syncwarp();  // every lane is done with the buffer
        stage_x<XC>(xs, x, r0, n_rows, d_in, c0, nc, x16, lane);
        cp_async_commit();
        cp_async_wait<0>();
        __syncwarp();
        tile_mma<T>(xs, XC, (nc + 7) >> 3,
                    GlobalW{params + (size_t)c0 * NLT_H, d_in - c0}, 0, lane,
                    acc);
      }
    } else {
      cp_async_wait<1>();  // X(i) has landed
      __syncwarp();
      if constexpr (kSplitOnce)
        tile_mma<T>(xs, XC, (d_in + 7) >> 3, FragW{w0f}, 0, lane, acc);
      else
        tile_mma<T>(xs, XC, (d_in + 7) >> 3, GlobalW{params, d_in}, 0, lane,
                    acc);
    }
    __syncwarp();  // every lane has read x: xs takes t

    // t = silu(t0 + b0) -> xs (16 x H)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < NLT_NQ; ++q) {
        const float2 b0 = nlt_ld2(vec + 8 * q, t);
        st2s(xs, g + 8 * h, 8 * q + 2 * t, NLT_H,
             silu_fast(make_float2(acc[q][2 * h] + b0.x,
                                   acc[q][2 * h + 1] + b0.y)));
      }
    __syncwarp();

    // y = t W1 + b1
    zero(acc);
    tile_mma(xs, NLT_H, NLT_NQ, w1_r, 0, lane, acc);
    if constexpr (!kChunk) {
      __syncwarp();  // every lane has read t: xs takes the tile two ahead
      stage_tile<XC>(xs, x, tile + 2 * stride, n_tiles, n_rows, d_in, x16,
                     lane);
    }

    // out = LN(y) over the quad's H columns, rows g and g + 8
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
      const float mean = quad_sum(s) * (1.0f / NLT_H);
      float var = 0.f;
#pragma unroll
      for (int q = 0; q < NLT_NQ; ++q) {
        const float cx = acc[q][2 * h] - mean;
        const float cy = acc[q][2 * h + 1] - mean;
        var += cx * cx + cy * cy;
      }
      const float inv = rsqrtf(quad_sum(var) * (1.0f / NLT_H) + NLT_LN_EPS);
      const long long row = r0 + g + 8 * h;
      if (row < n_rows) {
        T* dst = out + row * NLT_H + 2 * t;
#pragma unroll
        for (int q = 0; q < NLT_NQ; ++q) {
          const float2 ls = nlt_ld2(vec + 2 * NLT_H + 8 * q, t);
          const float2 lb = nlt_ld2(vec + 3 * NLT_H + 8 * q, t);
          Io<T>::st2(dst + 8 * q,
                     make_float2((acc[q][2 * h] - mean) * inv * ls.x + lb.x,
                                 (acc[q][2 * h + 1] - mean) * inv * ls.y +
                                     lb.y));
        }
      }
    }
  }
  if constexpr (!kChunk) cp_async_wait<0>();
}

template <int kKind, typename T>
cudaError_t launch(const T* x, const float* params, T* out, long long n_rows,
                   int d_in, cudaStream_t stream) {
  constexpr int kWarps = n_warps<kKind>();
  const long long tiles = (n_rows + kTcRows - 1) / kTcRows;
  auto kernel = embed_kernel<kKind, T>;
  int grid = 0;
  cudaError_t err =
      nlt_launch_config(kernel, kWarps * 32, smem_bytes<kKind>(),
                        (tiles + kWarps - 1) / kWarps, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kWarps * 32, smem_bytes<kKind>(), stream>>>(x, params, out,
                                                             n_rows, d_in);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const T* x, const float* params, T* out, long long n_rows,
             int d_in, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_rows == 0) return 0;
  if (d_in < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (d_in <= NLT_H)
    return (int)launch<kNarrow>(x, params, out, n_rows, d_in, s);
  if constexpr (kSplitOnce) {
    if (d_in <= 2 * NLT_H)
      return (int)launch<kWide>(x, params, out, n_rows, d_in, s);
  }
  return (int)launch<kChunked>(x, params, out, n_rows, d_in, s);
}

}  // namespace

// K1. x (n_rows, d_in) -> out (n_rows, H), n_rows = N*B; params is the
// blob w0[d_in*H] | w1[H*H] | b0 | b1 | ls | lb.
extern "C" int nlt_embed(const float* x, const float* params, float* out,
                         long long n_rows, int d_in, int device,
                         void* stream) {
  return dispatch(x, params, out, n_rows, d_in, device, stream);
}

// K1, bf16 instance: x and out in bf16.
extern "C" int nlt_embed_bf16(const __nv_bfloat16* x, const float* params,
                              __nv_bfloat16* out, long long n_rows, int d_in,
                              int device, void* stream) {
  return dispatch(x, params, out, n_rows, d_in, device, stream);
}
