// Grid-feature embedder (kernel K1).
//
// Replaces _embed_fwd_kernel (embed_grid_flat) of
// neural_lam_tpu/ops/pallas_embed.py. Per row i = (node n, batch b) of the
// flat input x (N, B*d_in) == (N*B, d_in):
//   out[i] = LayerNorm(silu(x[i] @ W0 + b0) @ W1 + b1)
// out (N, B*64) == (N*B, 64). The TPU kernel's zero-padding of d_in to a
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

// How x is staged: 64 columns (d_in <= 64), 128 (d_in <= 128), or in
// 64-column chunks with W0 read from device memory.
enum { kNarrow, kWide, kChunked };

template <int kKind>
__host__ __device__ constexpr int x_cols() {
  return kKind == kWide ? 2 * NLT_H : NLT_H;
}

// Warps a block, one block a SM.
template <int kKind>
__host__ __device__ constexpr int n_warps() {
  return kKind == kWide ? 8 : 16;
}

// x buffers a warp: two (double-buffered), one when chunked.
template <int kKind>
__host__ __device__ constexpr int n_bufs() {
  return kKind == kChunked ? 1 : 2;
}

// Fragments (split_frags) of one 8-row k step of a (rows, 64) weight.
constexpr int kStepFrags = 8 * 32;

// k steps of W0 in shared memory: x_cols / 8, none when chunked.
template <int kKind>
__host__ __device__ constexpr int w0_steps() {
  return kKind == kChunked ? 0 : x_cols<kKind>() / 8;
}

// W1's and W0's fragments, b0 | b1 | ls | lb, and the warps' x buffers
// (16 x x_cols each).
template <int kKind>
constexpr size_t smem_bytes() {
  return sizeof(uint4) * kStepFrags * (8 + w0_steps<kKind>()) +
         sizeof(float) * (4 * NLT_H + (size_t)n_warps<kKind>() *
                                          n_bufs<kKind>() * kTcRows *
                                          x_cols<kKind>());
}
static_assert(smem_bytes<kNarrow>() <= 232448 &&
                  smem_bytes<kWide>() <= 232448 &&
                  smem_bytes<kChunked>() <= 232448,
              "shared memory of a block");

// tile_mma's reader of B(k, n) = W0[k, n] from device memory, zero from
// row `rows` on (W0 offset to a chunk's first row), split at each use.
struct GlobalW {
  const float* w;
  int rows;
  __device__ __forceinline__ float ld(int k, int n) const {
    return k < rows ? __ldg(w + k * NLT_H + n) : 0.f;
  }
  __device__ __forceinline__ uint4 operator()(int c, int n, int, int,
                                              int) const {
    return split_pair(ld(c, n), ld(c + 4, n));
  }
};

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
  uint4* w0f = w1f + 8 * kStepFrags;            // W0's, unless chunked
  float* vec = reinterpret_cast<float*>(w0f + w0_steps<kKind>() * kStepFrags);
  float* bufs = vec + 4 * NLT_H;                // after b0 | b1 | ls | lb
  const float* pw1 = params + (size_t)d_in * NLT_H;
  split_frags(w1f, pw1, NLT_H, 8);
  if constexpr (!kChunk) split_frags(w0f, params, d_in, w0_steps<kKind>());
  for (int i = threadIdx.x; i < 4 * NLT_H; i += blockDim.x)
    vec[i] = pw1[HH + i];
  __syncthreads();

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
    float acc[8][4];
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
      tile_mma<T>(xs, XC, (d_in + 7) >> 3, FragW{w0f}, 0, lane, acc);
    }
    __syncwarp();  // every lane has read x: xs takes t

    // t = silu(t0 + b0) -> xs (16 x 64)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float2 b0 = nlt_ld2(vec + 8 * q, t);
        st2s(xs, g + 8 * h, 8 * q + 2 * t, NLT_H,
             silu_fast(make_float2(acc[q][2 * h] + b0.x,
                                   acc[q][2 * h + 1] + b0.y)));
      }
    __syncwarp();

    // y = t W1 + b1
    zero(acc);
    tile_mma(xs, NLT_H, 8, FragW{w1f}, 0, lane, acc);
    if constexpr (!kChunk) {
      __syncwarp();  // every lane has read t: xs takes the tile two ahead
      stage_tile<XC>(xs, x, tile + 2 * stride, n_tiles, n_rows, d_in, x16,
                     lane);
    }

    // out = LN(y) over the quad's 64 columns, rows g and g + 8
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
      const float mean = quad_sum(s) * (1.0f / NLT_H);
      float var = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float cx = acc[q][2 * h] - mean;
        const float cy = acc[q][2 * h + 1] - mean;
        var += cx * cx + cy * cy;
      }
      const float inv = rsqrtf(quad_sum(var) * (1.0f / NLT_H) + NLT_LN_EPS);
      const long long row = r0 + g + 8 * h;
      if (row < n_rows) {
        T* dst = out + row * NLT_H + 2 * t;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
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
  if (d_in <= 2 * NLT_H)
    return (int)launch<kWide>(x, params, out, n_rows, d_in, s);
  return (int)launch<kChunked>(x, params, out, n_rows, d_in, s);
}

}  // namespace

// K1. x (n_rows, d_in) -> out (n_rows, 64), n_rows = N*B; params is the
// blob w0[d_in*64] | w1[64*64] | b0 | b1 | ls | lb.
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
