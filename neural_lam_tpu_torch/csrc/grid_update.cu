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
// One warp owns kRows node rows and their K slots. All eight weight
// matrices (~135 KB fp32) sit in dynamic shared memory, so one block of
// kWarps warps runs per SM and walks the rows grid-stride. Bound (fp32
// CUDA cores, bench shapes): operations -- ~11.3 64x64 products per node
// row and batch element against ~2 KB of traffic.
#include "common.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kRows = 2;  // node rows per warp and step
constexpr int HH = NLT_H * NLT_H;

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

__host__ __device__ inline int n_params(int d_out) {
  return kOW1 + NLT_H * d_out + d_out;
}

template <int K>
__host__ __device__ constexpr int xs_floats() {
  return kRows * (K * NLT_H > 2 * NLT_H ? K * NLT_H : 2 * NLT_H);
}

template <int K>
__global__ void __launch_bounds__(kWarps * 32, 1)
    grid_update_kernel(const float* __restrict__ table,
                       const int* __restrict__ senders,
                       const float* __restrict__ ew,
                       const float* __restrict__ ge,
                       const float* __restrict__ mask,
                       const float* __restrict__ params,
                       float* __restrict__ out, int n_virt, int n_ge, int B,
                       int d_out) {
  extern __shared__ float smem[];
  const int n_par = n_params(d_out);
  nlt_load_params(smem, params, n_par);
  __syncthreads();
  const float* P = smem;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* xs = smem + nlt_round4(n_par) + warp * xs_floats<K>();
  auto vec = [&](int which) { return nlt_ld2(P + kVec + which * NLT_H, lane); };
  const int W = B * NLT_H;
  const long long n_rows = (long long)n_virt * B;

  for (long long r0 = ((long long)blockIdx.x * kWarps + warp) * kRows;
       r0 < n_rows; r0 += (long long)gridDim.x * kWarps * kRows) {
    int vr[kRows], br[kRows];
    bool ok[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      ok[r] = r0 + r < n_rows;
      const long long i = ok[r] ? r0 + r : n_rows - 1;
      vr[r] = (int)(i / B);
      br[r] = (int)(i % B);
    }

    // encoding grid MLP (residual)
    float2 gev[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      gev[r] = vr[r] < n_ge
                   ? nlt_ld2(ge + (size_t)vr[r] * W + br[r] * NLT_H, lane)
                   : make_float2(0.f, 0.f);
      nlt_st2(xs + r * NLT_H, lane, gev[r]);
    }
    __syncwarp();
    float2 t[kRows];
    nlt_fill(t, vec(ENC_B0));
    nlt_mm64<kRows>(xs, NLT_H, P + kEncW0, NLT_H, lane, t);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kRows; ++r) nlt_st2(xs + r * NLT_H, lane, nlt_silu2(t[r]));
    __syncwarp();
    nlt_fill(t, vec(ENC_B1));
    nlt_mm64<kRows>(xs, NLT_H, P + kEncW1, NLT_H, lane, t);
    __syncwarp();
    float2 gr[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      gr[r] = nlt_add2(gev[r], nlt_layer_norm(t[r], vec(ENC_LS), vec(ENC_LB)));
      nlt_st2(xs + r * NLT_H, lane, gr[r]);
    }
    __syncwarp();

    // receiver term of the edge MLP's first layer
    float2 rec[kRows];
    nlt_fill(rec, make_float2(0.f, 0.f));
    nlt_mm64<kRows>(xs, NLT_H, P + kWI, NLT_H, lane, rec);
    __syncwarp();

    // edge MLP over the K sender slots of each row
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const size_t slot = (size_t)vr[r] * K + k;
        const int s = senders[slot];
        const float2 g = nlt_ld2(table + (size_t)s * W + br[r] * NLT_H, lane);
        const float2 e = nlt_ld2(ew + slot * NLT_H, lane);
        nlt_st2(xs + (r * K + k) * NLT_H, lane,
                nlt_silu2(nlt_add2(nlt_add2(g, e), rec[r])));
      }
    }
    __syncwarp();
    float2 m[kRows * K];
    nlt_fill(m, vec(B2));
    nlt_mm64<kRows * K>(xs, NLT_H, P + kW2, NLT_H, lane, m);
    __syncwarp();
    float2 agg[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      agg[r] = make_float2(0.f, 0.f);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float2 msg = nlt_layer_norm(m[r * K + k], vec(E_LS), vec(E_LB));
        const float mk = mask[(size_t)vr[r] * K + k];
        agg[r].x = fmaf(mk, msg.x, agg[r].x);
        agg[r].y = fmaf(mk, msg.y, agg[r].y);
      }
      // aggregation MLP input: concat(gr, agg), rows of 128
      nlt_st2(xs + r * 2 * NLT_H, lane, gr[r]);
      nlt_st2(xs + r * 2 * NLT_H + NLT_H, lane, agg[r]);
    }
    __syncwarp();

    // aggregation MLP (residual)
    nlt_fill(t, vec(A_B0));
    nlt_mm64<kRows>(xs, 2 * NLT_H, P + kAW0, 2 * NLT_H, lane, t);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kRows; ++r) nlt_st2(xs + r * NLT_H, lane, nlt_silu2(t[r]));
    __syncwarp();
    nlt_fill(t, vec(A_B1));
    nlt_mm64<kRows>(xs, NLT_H, P + kAW1, NLT_H, lane, t);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float2 ro =
          nlt_add2(gr[r], nlt_layer_norm(t[r], vec(A_LS), vec(A_LB)));
      nlt_st2(xs + r * NLT_H, lane, ro);
    }
    __syncwarp();

    // output map (no LN)
    nlt_fill(t, vec(O_B0));
    nlt_mm64<kRows>(xs, NLT_H, P + kOW0, NLT_H, lane, t);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kRows; ++r) nlt_st2(xs + r * NLT_H, lane, nlt_silu2(t[r]));
    __syncwarp();
    const float* ow1 = P + kOW1;
    const float* ob1 = ow1 + NLT_H * d_out;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = lane + 32 * c;
        if (j < d_out) {
          float acc = ob1[j];
          for (int k = 0; k < NLT_H; ++k)
            acc = fmaf(xs[r * NLT_H + k], ow1[k * d_out + j], acc);
          if (ok[r]) out[((size_t)vr[r] * B + br[r]) * d_out + j] = acc;
        }
      }
    }
    __syncwarp();  // xs is rewritten by the next step
  }
}

template <int K>
cudaError_t launch(const float* table, const int* senders, const float* ew,
                   const float* ge, const float* mask, const float* params,
                   float* out, int n_virt, int n_ge, int B, int d_out,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (nlt_round4(n_params(d_out)) +
                                       kWarps * xs_floats<K>());
  const long long rows = (long long)n_virt * B;
  const long long per_block = (long long)kWarps * kRows;
  int grid = 0;
  cudaError_t err = nlt_launch_config(grid_update_kernel<K>, kWarps * 32,
                                      smem, (rows + per_block - 1) / per_block,
                                      &grid);
  if (err != cudaSuccess) return err;
  grid_update_kernel<K><<<grid, kWarps * 32, smem, stream>>>(
      table, senders, ew, ge, mask, params, out, n_virt, n_ge, B, d_out);
  return cudaGetLastError();
}

}  // namespace

// K4. out (n_virt, B*d_out); ge has n_ge <= n_virt rows.
extern "C" int nlt_grid_update(const float* table, const int* senders,
                               const float* ew, const float* ge,
                               const float* mask, const float* params,
                               float* out, int n_virt, int n_ge, int K, int B,
                               int d_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_virt == 0) return 0;
  if (d_out < 1 || d_out > 2 * 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define NLT_GU_CASE(KK)                                                     \
  case KK:                                                                  \
    return (int)launch<KK>(table, senders, ew, ge, mask, params, out,       \
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
