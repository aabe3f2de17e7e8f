// The whole m2g decoder per grid node (kernel K4).
//
// Replaces, from neural_lam_tpu/ops/pallas_grid_update.py,
// _grid_update_kernel (grid_update_flat) and _grid_update_win_kernel
// (grid_update_flat_win): one kernel for both, reading each sender row by
// index from the mesh table. Per node row i = (virtual row v, batch b) of
// a virt_identity m2g set (one virtual row per grid node), K slots:
//   gr   = ge + LayerNorm(silu(ge @ enc_w0 + enc_b0) @ enc_w1 + enc_b1)
//   rec  = gr @ w_i
//   x[k] = silu(table[senders[v*K+k], b] + ew[v*K+k] + rec)   (b0 is in ew)
//   agg  = sum_k mask[v, k] * LayerNorm(x[k] @ w2 + b2)
//   ro   = gr + LayerNorm(silu([gr, agg] @ a_w0 + a_b0) @ a_w1 + a_b1)
//   out  = silu(ro @ o_w0 + o_b0) @ o_w1 + o_b1                 (no LN)
// ge rows at v >= n_ge read as zeros (virtual-row padding; the caller
// slices those outputs off). out (n_virt, B*d_out), any d_out >= 1: the
// output map runs in chunks of H columns (the JAX kernel pads B*d_out to
// a multiple of 128 and takes any d_out too).
//
// Bound (fp32 CUDA cores, bench shapes): operations -- ~11.3 64x64
// products per node row and batch element against ~2 KB of traffic.
//
// Design (width 64). All weights (~151 KB fp32, o_w1 zero-padded per chunk in
// the kernel's own layout) sit in dynamic shared memory, so one block of
// kWarps warps runs per SM and walks the rows grid-stride. Each warp owns
// kRows node rows: each product reads a weight row once (`LDS.64`, two
// columns a lane) for all of them, with the inputs broadcast four at a
// time (`LDS.128`), so a weight read feeds 2*kRows FFMAs a lane. Per warp,
// a (kRows, 128) staging tile holds gr in its first 64 columns and each
// product's input in the other 64: the edge MLP's input slot by slot, then
// agg, so that [gr, agg] is the aggregation MLP's 128-wide input as it
// stands. On the H100, 4 rows a warp with 24 warps ran faster than 8 rows
// with 16 (chip_smoke.py): past a few rows a warp, more warps to hide the
// gathers', LayerNorms' and products' latencies pay more than fewer
// shared-memory reads per FFMA. ptxas keeps 24 warps at <= 80 registers
// without spills.
//
// The output map (o_w1, o_b1) is zero-padded per H-column chunk into
// shared memory beside the other weights (`kOutSmem`) while they fit: at
// width 64, d_out up to 128 (two chunks) at 24 warps; past that it reads
// o_w1 from device memory (L2 holds it) with the columns masked.
//
// Widths (NLT_H, one library a width): a lane holds NLT_C = H/32 columns
// of a row (`Cols`, common.cuh): one at 32, two at 64 (the note above),
// four at 128. At 32 all weights sit in shared memory as at 64 (~38 KB).
// At 128 they take ~600 KB, so they are streamed: the block walks its
// rows in block-wide steps of kWarps x kRows rows, and each product's
// matrix (H x H; a_w0 as its two halves, the output map per chunk) is
// copied into one of two shared buffers by cp.async while the previous
// product runs from the other, with one __syncthreads per product. A
// weight then comes from L2 once per 64 rows, not once per 4.
//
// bf16 instance (`grid_update_kernel<K, __nv_bfloat16>`, entry
// nlt_grid_update_bf16): table, ew, ge and out in bf16, each value
// converted to fp32 as it is loaded and the output rounded to nearest
// even as it is stored; the math between is the float instance's, on the
// fp32 weights (the JAX kernel's fp32 math on bf16 inputs).
#include "common.cuh"
#include "tc_common.cuh"

namespace {

// Weights resident in shared memory (widths 32 and 64) or streamed
// through it, one matrix a product (128).
constexpr bool kStream = NLT_H > 64;
constexpr int kWarps = kStream ? 16 : 24;
constexpr int kRows = 4;  // node rows per warp and step
constexpr int HH = NLT_H * NLT_H;
constexpr int kLdx = 2 * NLT_H;  // staging row stride

// Parameter blob (floats), offsets:
constexpr int kEncW0 = 0;
constexpr int kEncW1 = kEncW0 + HH;
constexpr int kWI = kEncW1 + HH;
constexpr int kW2 = kWI + HH;
constexpr int kAW0 = kW2 + HH;  // (2H, H)
constexpr int kAW1 = kAW0 + 2 * HH;
constexpr int kOW0 = kAW1 + HH;
constexpr int kVec = kOW0 + HH;  // 12 vectors of H, in this order:
enum { ENC_B0, ENC_B1, ENC_LS, ENC_LB, B2, E_LS, E_LB, A_B0, A_B1, A_LS, A_LB,
       O_B0, N_VEC };
constexpr int kOW1 = kVec + N_VEC * NLT_H;  // (H, d_out), then o_b1[d_out]

// Resident shared memory (floats): the blob up to kOW1, then (kOutSmem)
// the output map per H-column chunk c at kOW1Pad + c * kChunkF, o_w1's
// columns as (H, H) then o_b1's as H, zero-padded past d_out, then the
// warps' staging tiles. Streamed: two (H, H) weight buffers, the vectors,
// the staging tiles.
constexpr int kOW1Pad = kOW1;
constexpr int kChunkF = HH + NLT_H;
constexpr int kStaging = kRows * kLdx;  // floats per warp
constexpr int kVecS = 2 * HH;           // streamed: the vectors' offset

// Offset in the blob of the matrix of product stage s < 8 (a_w0 in two
// halves; the resident kernel reads a_w0 whole from stage 4).
__host__ __device__ constexpr int stage_at(int s) {
  return s == 0   ? kEncW0
         : s == 1 ? kEncW1
         : s == 2 ? kWI
         : s == 3 ? kW2
         : s == 4 ? kAW0
         : s == 5 ? kAW0 + HH
         : s == 6 ? kAW1
                  : kOW0;
}

// Floats of shared memory a block of the kernel takes.
__host__ __device__ constexpr size_t smem_floats(bool out_smem, int n_ch) {
  return kStream ? (size_t)kVecS + N_VEC * NLT_H + kWarps * kStaging
                 : (size_t)kOW1 + (out_smem ? (size_t)n_ch * kChunkF : 0) +
                       kWarps * kStaging;
}
static_assert(smem_floats(true, 1) * sizeof(float) <= 232448,
              "shared memory of a block");

// acc[r] += xs[r*ldx + k] * o_w1[k, j] for k < H and this lane's columns j
// = c0 + NLT_C*lane .. of o_w1 (H, d_out) in device memory, zero past
// d_out.
template <int R>
__device__ __forceinline__ void out_mm_global(const float* __restrict__ xs,
                                              const float* __restrict__ w,
                                              int d_out, int c0, int lane,
                                              Cols (&acc)[R]) {
  const int j0 = c0 + NLT_C * lane;
#pragma unroll 4
  for (int k = 0; k < NLT_H; ++k) {
    Cols wv;
#pragma unroll
    for (int i = 0; i < NLT_C; ++i)
      wv.v[i] = j0 + i < d_out ? __ldg(w + (size_t)k * d_out + j0 + i) : 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float xv = xs[r * kLdx + k];
#pragma unroll
      for (int i = 0; i < NLT_C; ++i)
        acc[r].v[i] = fmaf(xv, wv.v[i], acc[r].v[i]);
    }
  }
}

template <int K, typename T, bool kOutSmem>
__global__ void __launch_bounds__(kWarps * 32, 1)
    grid_update_kernel(const T* __restrict__ table,
                       const int* __restrict__ senders,
                       const T* __restrict__ ew, const T* __restrict__ ge,
                       const float* __restrict__ mask,
                       const float* __restrict__ params,
                       T* __restrict__ out, int n_virt, int n_ge, int B,
                       int d_out) {
  extern __shared__ __align__(16) float smem[];
  const int n_ch = (d_out + NLT_H - 1) / NLT_H;  // output-map chunks
  if constexpr (kStream) {
    for (int i = threadIdx.x; i < N_VEC * NLT_H; i += blockDim.x)
      smem[kVecS + i] = params[kVec + i];
  } else {
    nlt_load_params(smem, params, kOW1);
    if constexpr (kOutSmem) {
      for (int i = threadIdx.x; i < n_ch * kChunkF; i += blockDim.x) {
        const int c = i / kChunkF, e = i - c * kChunkF;
        const int k = e / NLT_H, j = c * NLT_H + e % NLT_H;
        float v = 0.f;
        if (j < d_out)
          v = params[kOW1 + (k < NLT_H ? k * d_out + j : NLT_H * d_out + j)];
        smem[kOW1Pad + i] = v;
      }
    }
  }
  __syncthreads();
  const float* vecs = smem + (kStream ? kVecS : kVec);
  float* staging =
      smem + smem_floats(kOutSmem, n_ch) - (size_t)kWarps * kStaging;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* xs = staging + warp * kStaging;  // gr in columns 0..H-1
  float* xin = xs + NLT_H;                // product inputs
  auto vec = [&](int which) { return cols_ld(vecs + which * NLT_H, lane); };
  const int W = B * NLT_H;
  const long long n_rows = (long long)n_virt * B;
  const long long step = (long long)gridDim.x * kWarps * kRows;
  // resident: each warp walks its own rows; streamed: the block walks
  // block-wide steps, every warp through every step (rows past n_rows
  // are computed on a clamped row and not stored)
  long long base = (long long)blockIdx.x * kWarps * kRows +
                   (kStream ? 0 : warp * kRows);

  // streamed: copy product stage s's matrix into buf (stages 0-7 of
  // stage_at, then the output map's chunks), one cp.async group
  auto issue = [&](int s, float* buf) {
    if (s < 8) {
      const float* src = params + stage_at(s);
      for (int i = threadIdx.x; i < HH / 4; i += blockDim.x)
        cp_async16(buf + 4 * i, src + 4 * i, true);
    } else {
      const int c0 = (s - 8) * NLT_H;
      for (int i = threadIdx.x; i < HH; i += blockDim.x) {
        const int k = i / NLT_H, j = c0 + i % NLT_H;
        const bool ok = j < d_out;
        cp_async4(buf + i, params + (ok ? kOW1 + k * d_out + j : 0), ok);
      }
    }
    cp_async_commit();
  };
  int n_stage = 0;  // streamed: stages begun (stage i in buffer i % 2)
  if constexpr (kStream)
    if (base < n_rows) issue(0, smem);
  // The matrix of product stage s (0-7, then 8 + output chunk). Streamed:
  // waits for it, lets every warp finish the previous product, and starts
  // the copy of the next stage into the buffer that product read.
  auto weights = [&](int s) -> const float* {
    if constexpr (!kStream) {
      return smem + (s < 8 ? stage_at(s) : kOW1Pad + (s - 8) * kChunkF);
    } else {
      cp_async_wait<0>();
      __syncthreads();
      float* cur = smem + (n_stage & 1) * HH;
      float* other = smem + ((n_stage + 1) & 1) * HH;
      ++n_stage;
      if (s + 1 < 8 + n_ch)
        issue(s + 1, other);
      else if (base + step < n_rows)
        issue(0, other);
      return cur;
    }
  };

  for (; base < n_rows; base += step) {
    const long long r0 = kStream ? base + warp * kRows : base;
    int vr[kRows], br[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long i = r0 + r < n_rows ? r0 + r : n_rows - 1;
      vr[r] = (int)(i / B);
      br[r] = (int)(i % B);
    }

    // encoding grid MLP (residual)
    Cols t[kRows], gev[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      gev[r] = vr[r] < n_ge
                   ? cols_ldt(ge + (size_t)vr[r] * W + br[r] * NLT_H, lane)
                   : cols_fill(0.f);
      cols_st(xin + r * kLdx, lane, gev[r]);
    }
    __syncwarp();
    cols_fill(t, vec(ENC_B0));
    cols_mm<kRows>(xin, kLdx, weights(0), NLT_H, lane, t);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kRows; ++r) cols_st(xin + r * kLdx, lane, cols_silu(t[r]));
    __syncwarp();
    cols_fill(t, vec(ENC_B1));
    cols_mm<kRows>(xin, kLdx, weights(1), NLT_H, lane, t);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      cols_st(xs + r * kLdx, lane,
              cols_add(gev[r], cols_layer_norm(t[r], vec(ENC_LS), vec(ENC_LB))));
    __syncwarp();

    // receiver term of the edge MLP's first layer
    Cols rec[kRows];
    cols_fill(rec, cols_fill(0.f));
    cols_mm<kRows>(xs, kLdx, weights(2), NLT_H, lane, rec);

    // edge MLP, slot by slot, over the warp's rows
    Cols agg[kRows];
    cols_fill(agg, cols_fill(0.f));
    const float* w2 = weights(3);
#pragma unroll 1
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const size_t slot = (size_t)vr[r] * K + k;
        const int s = senders[slot];
        const Cols g =
            cols_ldt(table + (size_t)s * W + br[r] * NLT_H, lane);
        const Cols e = cols_ldt(ew + slot * NLT_H, lane);
        cols_st(xin + r * kLdx, lane,
                cols_silu(cols_add(cols_add(g, e), rec[r])));
      }
      __syncwarp();
      Cols m[kRows];
      cols_fill(m, vec(B2));
      cols_mm<kRows>(xin, kLdx, w2, NLT_H, lane, m);
      __syncwarp();  // xin is rewritten by the next slot
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const Cols msg = cols_layer_norm(m[r], vec(E_LS), vec(E_LB));
        const float mk = mask[(size_t)vr[r] * K + k];
#pragma unroll
        for (int i = 0; i < NLT_C; ++i)
          agg[r].v[i] = fmaf(mk, msg.v[i], agg[r].v[i]);
      }
    }
    // aggregation MLP input: [gr, agg], rows of 2H
#pragma unroll
    for (int r = 0; r < kRows; ++r) cols_st(xin + r * kLdx, lane, agg[r]);
    __syncwarp();

    // aggregation MLP (residual)
    cols_fill(t, vec(A_B0));
    if constexpr (kStream) {
      cols_mm<kRows>(xs, kLdx, weights(4), NLT_H, lane, t);   // gr half
      cols_mm<kRows>(xin, kLdx, weights(5), NLT_H, lane, t);  // agg half
    } else {
      cols_mm<kRows>(xs, kLdx, weights(4), 2 * NLT_H, lane, t);
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kRows; ++r) cols_st(xin + r * kLdx, lane, cols_silu(t[r]));
    __syncwarp();
    cols_fill(t, vec(A_B1));
    cols_mm<kRows>(xin, kLdx, weights(6), NLT_H, lane, t);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const Cols ro = cols_add(cols_ld(xs + r * kLdx, lane),
                               cols_layer_norm(t[r], vec(A_LS), vec(A_LB)));
      cols_st(xin + r * kLdx, lane, ro);
    }
    __syncwarp();

    // output map (no LN), in chunks of H columns
    cols_fill(t, vec(O_B0));
    cols_mm<kRows>(xin, kLdx, weights(7), NLT_H, lane, t);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kRows; ++r) cols_st(xin + r * kLdx, lane, cols_silu(t[r]));
    __syncwarp();
    // output chunk c (columns c*H ..): bias, product, stores
    auto out_chunk = [&](int c) {
      const int j0 = c * NLT_H + NLT_C * lane;  // this lane's first column
      if constexpr (kStream || !kOutSmem) {
        Cols b1;
#pragma unroll
        for (int i = 0; i < NLT_C; ++i)
          b1.v[i] = j0 + i < d_out ? params[kOW1 + NLT_H * d_out + j0 + i]
                                   : 0.f;
        cols_fill(t, b1);
      } else {
        cols_fill(t, cols_ld(smem + kOW1Pad + c * kChunkF + HH, lane));
      }
      if constexpr (kStream || kOutSmem)
        cols_mm<kRows>(xin, kLdx, weights(8 + c), NLT_H, lane, t);
      else
        out_mm_global<kRows>(xin, params + kOW1, d_out, c * NLT_H, lane, t);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r0 + r >= n_rows) continue;
        T* o = out + ((size_t)vr[r] * B + br[r]) * d_out;
#pragma unroll
        for (int i = 0; i < NLT_C; ++i)
          if (j0 + i < d_out) Io<T>::st(o + j0 + i, t[r].v[i]);
      }
    };
    if (n_ch == 1) {
      out_chunk(0);  // the usual case (d_out <= H), straight-line
    } else {
      for (int c = 0; c < n_ch; ++c) out_chunk(c);
    }
    __syncwarp();  // the staging tile is rewritten by the next step
  }
  if constexpr (kStream) cp_async_wait<0>();
}

template <int K, typename T, bool kOutSmem>
cudaError_t launch(const T* table, const int* senders, const T* ew,
                   const T* ge, const float* mask, const float* params,
                   T* out, int n_virt, int n_ge, int B, int d_out,
                   size_t smem, cudaStream_t stream) {
  const long long rows = (long long)n_virt * B;
  const long long per_block = (long long)kWarps * kRows;
  auto kernel = grid_update_kernel<K, T, kOutSmem>;
  int grid = 0;
  cudaError_t err = nlt_launch_config(kernel, kWarps * 32, smem,
                                      (rows + per_block - 1) / per_block,
                                      &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      table, senders, ew, ge, mask, params, out, n_virt, n_ge, B, d_out);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const T* table, const int* senders, const T* ew, const T* ge,
             const float* mask, const float* params, T* out, int n_virt,
             int n_ge, int K, int B, int d_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_virt == 0) return 0;
  if (d_out < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // resident: the output map in shared memory while it fits beside the
  // other weights and the staging tiles (always, streamed)
  const int n_ch = (d_out + NLT_H - 1) / NLT_H;
  const bool out_smem =
      kStream || smem_floats(true, n_ch) * sizeof(float) <= 232448;
  const size_t smem = smem_floats(out_smem, n_ch) * sizeof(float);
#define NLT_GU_CASE(KK)                                                     \
  case KK:                                                                  \
    return out_smem ? (int)launch<KK, T, true>(table, senders, ew, ge, mask, \
                                               params, out, n_virt, n_ge,   \
                                               B, d_out, smem, s)           \
                    : (int)launch<KK, T, kStream>(                          \
                          table, senders, ew, ge, mask, params, out,        \
                          n_virt, n_ge, B, d_out, smem, s);
  switch (K) {
    NLT_FOR_K(NLT_GU_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NLT_GU_CASE
}

}  // namespace

// K4. out (n_virt, B*d_out); ge has n_ge <= n_virt rows.
extern "C" int nlt_grid_update(const float* table, const int* senders,
                               const float* ew, const float* ge,
                               const float* mask, const float* params,
                               float* out, int n_virt, int n_ge, int K, int B,
                               int d_out, int device, void* stream) {
  return dispatch(table, senders, ew, ge, mask, params, out, n_virt, n_ge, K,
                  B, d_out, device, stream);
}

// K4, bf16 instance: table, ew, ge and out in bf16.
extern "C" int nlt_grid_update_bf16(
    const __nv_bfloat16* table, const int* senders, const __nv_bfloat16* ew,
    const __nv_bfloat16* ge, const float* mask, const float* params,
    __nv_bfloat16* out, int n_virt, int n_ge, int K, int B, int d_out,
    int device, void* stream) {
  return dispatch(table, senders, ew, ge, mask, params, out, n_virt, n_ge, K,
                  B, d_out, device, stream);
}
