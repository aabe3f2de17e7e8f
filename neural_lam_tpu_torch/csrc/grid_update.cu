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
// slices those outputs off). out (n_virt, B*d_out), d_out <= 64.
//
// Bound (fp32 CUDA cores, bench shapes): operations -- ~11.3 64x64
// products per node row and batch element against ~2 KB of traffic.
//
// Design. All weights (~147 KB fp32, o_w1 zero-padded to 64 columns in
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
// bf16 instance (`grid_update_kernel<K, __nv_bfloat16>`, entry
// nlt_grid_update_bf16): table, ew, ge and out in bf16, each value
// converted to fp32 as it is loaded and the output rounded to nearest
// even as it is stored; the math between is the float instance's, on the
// fp32 weights (the JAX kernel's fp32 math on bf16 inputs).
#include "common.cuh"

namespace {

constexpr int kWarps = 24;
constexpr int kRows = 4;  // node rows per warp and step
constexpr int HH = NLT_H * NLT_H;
constexpr int kLdx = 2 * NLT_H;  // staging row stride

// Parameter blob (floats), offsets:
constexpr int kEncW0 = 0;
constexpr int kEncW1 = kEncW0 + HH;
constexpr int kWI = kEncW1 + HH;
constexpr int kW2 = kWI + HH;
constexpr int kAW0 = kW2 + HH;  // (128, 64)
constexpr int kAW1 = kAW0 + 2 * HH;
constexpr int kOW0 = kAW1 + HH;
constexpr int kVec = kOW0 + HH;  // 12 vectors of 64, in this order:
enum { ENC_B0, ENC_B1, ENC_LS, ENC_LB, B2, E_LS, E_LB, A_B0, A_B1, A_LS, A_LB,
       O_B0, N_VEC };
constexpr int kOW1 = kVec + N_VEC * NLT_H;  // (64, d_out), then o_b1[d_out]

// Shared memory (floats): the blob up to kOW1, then o_w1 as (64, 64) and
// o_b1 as 64, both zero-padded past d_out, then the warps' staging tiles.
constexpr int kOW1Pad = kOW1;
constexpr int kOB1Pad = kOW1Pad + HH;
constexpr int kWeights = kOB1Pad + NLT_H;
constexpr int kStaging = kRows * kLdx;  // floats per warp

template <int K, typename T>
__global__ void __launch_bounds__(kWarps * 32, 1)
    grid_update_kernel(const T* __restrict__ table,
                       const int* __restrict__ senders,
                       const T* __restrict__ ew, const T* __restrict__ ge,
                       const float* __restrict__ mask,
                       const float* __restrict__ params,
                       T* __restrict__ out, int n_virt, int n_ge, int B,
                       int d_out) {
  extern __shared__ float smem[];
  nlt_load_params(smem, params, kOW1);
  for (int i = threadIdx.x; i < HH + NLT_H; i += blockDim.x) {
    const int k = i >> 6, j = i & (NLT_H - 1);
    float v = 0.f;
    if (j < d_out)
      v = params[kOW1 + (k < NLT_H ? k * d_out + j : NLT_H * d_out + j)];
    smem[kOW1Pad + i] = v;
  }
  __syncthreads();
  const float* P = smem;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* xs = smem + kWeights + warp * kStaging;  // gr in columns 0..63
  float* xin = xs + NLT_H;                       // product inputs
  auto vec = [&](int which) { return nlt_ld2(P + kVec + which * NLT_H, lane); };
  const int W = B * NLT_H;
  const long long n_rows = (long long)n_virt * B;

  for (long long r0 = ((long long)blockIdx.x * kWarps + warp) * kRows;
       r0 < n_rows; r0 += (long long)gridDim.x * kWarps * kRows) {
    int vr[kRows], br[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long i = r0 + r < n_rows ? r0 + r : n_rows - 1;
      vr[r] = (int)(i / B);
      br[r] = (int)(i % B);
    }

    // encoding grid MLP (residual)
    float2 t[kRows], gev[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      gev[r] = vr[r] < n_ge
                   ? nlt_ld2t(ge + (size_t)vr[r] * W + br[r] * NLT_H, lane)
                   : make_float2(0.f, 0.f);
      nlt_st2(xin + r * kLdx, lane, gev[r]);
    }
    __syncwarp();
    nlt_fill(t, vec(ENC_B0));
    nlt_mm64<kRows>(xin, kLdx, P + kEncW0, NLT_H, lane, t);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kRows; ++r) nlt_st2(xin + r * kLdx, lane, nlt_silu2(t[r]));
    __syncwarp();
    nlt_fill(t, vec(ENC_B1));
    nlt_mm64<kRows>(xin, kLdx, P + kEncW1, NLT_H, lane, t);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      nlt_st2(xs + r * kLdx, lane,
              nlt_add2(gev[r], nlt_layer_norm(t[r], vec(ENC_LS), vec(ENC_LB))));
    __syncwarp();

    // receiver term of the edge MLP's first layer
    float2 rec[kRows];
    nlt_fill(rec, make_float2(0.f, 0.f));
    nlt_mm64<kRows>(xs, kLdx, P + kWI, NLT_H, lane, rec);

    // edge MLP, slot by slot, over the warp's rows
    float2 agg[kRows];
    nlt_fill(agg, make_float2(0.f, 0.f));
#pragma unroll 1
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const size_t slot = (size_t)vr[r] * K + k;
        const int s = senders[slot];
        const float2 g =
            nlt_ld2t(table + (size_t)s * W + br[r] * NLT_H, lane);
        const float2 e = nlt_ld2t(ew + slot * NLT_H, lane);
        nlt_st2(xin + r * kLdx, lane,
                nlt_silu2(nlt_add2(nlt_add2(g, e), rec[r])));
      }
      __syncwarp();
      float2 m[kRows];
      nlt_fill(m, vec(B2));
      nlt_mm64<kRows>(xin, kLdx, P + kW2, NLT_H, lane, m);
      __syncwarp();  // xin is rewritten by the next slot
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float2 msg = nlt_layer_norm(m[r], vec(E_LS), vec(E_LB));
        const float mk = mask[(size_t)vr[r] * K + k];
        agg[r].x = fmaf(mk, msg.x, agg[r].x);
        agg[r].y = fmaf(mk, msg.y, agg[r].y);
      }
    }
    // aggregation MLP input: [gr, agg], rows of 128
#pragma unroll
    for (int r = 0; r < kRows; ++r) nlt_st2(xin + r * kLdx, lane, agg[r]);
    __syncwarp();

    // aggregation MLP (residual)
    nlt_fill(t, vec(A_B0));
    nlt_mm64<kRows>(xs, kLdx, P + kAW0, 2 * NLT_H, lane, t);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kRows; ++r) nlt_st2(xin + r * kLdx, lane, nlt_silu2(t[r]));
    __syncwarp();
    nlt_fill(t, vec(A_B1));
    nlt_mm64<kRows>(xin, kLdx, P + kAW1, NLT_H, lane, t);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float2 ro = nlt_add2(nlt_ld2(xs + r * kLdx, lane),
                                 nlt_layer_norm(t[r], vec(A_LS), vec(A_LB)));
      nlt_st2(xin + r * kLdx, lane, ro);
    }
    __syncwarp();

    // output map (no LN); o_w1 zero-padded to 64 columns
    nlt_fill(t, vec(O_B0));
    nlt_mm64<kRows>(xin, kLdx, P + kOW0, NLT_H, lane, t);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kRows; ++r) nlt_st2(xin + r * kLdx, lane, nlt_silu2(t[r]));
    __syncwarp();
    nlt_fill(t, nlt_ld2(P + kOB1Pad, lane));
    nlt_mm64<kRows>(xin, kLdx, P + kOW1Pad, NLT_H, lane, t);
    const int j = 2 * lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r0 + r >= n_rows) continue;
      T* o = out + ((size_t)vr[r] * B + br[r]) * d_out;
      if (j < d_out) Io<T>::st(o + j, t[r].x);
      if (j + 1 < d_out) Io<T>::st(o + j + 1, t[r].y);
    }
    __syncwarp();  // the staging tile is rewritten by the next step
  }
}

template <int K, typename T>
cudaError_t launch(const T* table, const int* senders, const T* ew,
                   const T* ge, const float* mask, const float* params,
                   T* out, int n_virt, int n_ge, int B, int d_out,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kWeights + kWarps * kStaging);
  const long long rows = (long long)n_virt * B;
  const long long per_block = (long long)kWarps * kRows;
  auto kernel = grid_update_kernel<K, T>;
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
  if (d_out < 1 || d_out > NLT_H) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define NLT_GU_CASE(KK)                                                     \
  case KK:                                                                  \
    return (int)launch<KK, T>(table, senders, ew, ge, mask, params, out,    \
                              n_virt, n_ge, B, d_out, s);
  switch (K) {
    NLT_GU_CASE(1)
    NLT_GU_CASE(2)
    NLT_GU_CASE(3)
    NLT_GU_CASE(4)
    NLT_GU_CASE(5)
    NLT_GU_CASE(6)
    NLT_GU_CASE(7)
    NLT_GU_CASE(8)
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
