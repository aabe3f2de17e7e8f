// Backward of the whole m2g decoder per grid node (kernel B5/B6).
//
// Replaces, from neural_lam_tpu/ops/pallas_grid_update.py,
// _grid_update_bwd_kernel :752 (via _grid_update_bwd :793, chain
// _grid_update_bwd_chain :616) and _grid_update_win_bwd_kernel :767 (via
// grid_update_flat_win_bwd :904): one kernel for both, reading each sender row
// by index from the mesh table and writing the per-slot cotangent d_x0,
// which the caller folds onto the table (ops/message_passing.py,
// fold_senders).
//
// Recomputes the forward of csrc/grid_update.cu per node row (v, b):
//   t1 = silu(t1p = ge @ enc_w0 + enc_b0),  t2 = t1 @ enc_w1 + enc_b1
//   gr = ge + LN_e(t2),  rec = gr @ w_i
//   x0[k] = table[senders[v*K+k], b] + ew[v*K+k] + rec,  y2[k] = silu(x0[k]) @ w2 + b2
//   agg = sum_k mask[v, k] * LN_x(y2[k])
//   u1 = silu(u0p = gr @ a_wr + agg @ a_wa + a_b0),  u2 = u1 @ a_w1 + a_b1
//   ro = gr + LN_u(u2),  y = silu(y0p = ro @ o_w0 + o_b0),  out = y @ o_w1 + o_b1
// and chains d_out back through it (LayerNorm backward in fp32 from each
// row's mean and rstd) to d_x0 (M, W) per slot, d_ew (M, 64) summed over
// b, d_ge (n_ge, W) for the real rows only, and all 21 parameter
// gradients. Rows v >= n_ge read ge as zeros and are neither read nor
// written past ge's end; padding slots (mask 0) get no share of d_agg.
//
// Design. One warp owns one virtual row v and walks its batch elements b,
// so d_ew's sum over b is a register sum. The weights (~135 KB, plus the
// same again transposed for the backward products) do not fit in shared
// memory beside the nine weight-gradient accumulators, so the weights are
// read through L1/L2 (read-only loads of a blob the wrapper packs, the
// transposes included) and shared memory holds the accumulators: each of
// the 256 threads owns one 4x4 tile of each 64x64 gradient. After each
// batch element the block's 8 node rows (14 activations and gradients
// each) and 8*K slot rows are staged in shared memory, and every thread
// adds their products into its tiles. Each block writes its partial sums
// once, in the parameter blob's layout; the caller sums them in a fixed
// order (no float atomics). Bound (fp32 CUDA cores, bench shapes):
// operations -- ~3x the forward's ~11.3 64x64 products per node row and
// batch element; the weight reads through L1/L2 are what this simple
// design pays beyond that.
#include "bwd_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int HH = NLT_H * NLT_H;

// Parameter blob (floats), as csrc/grid_update.cu reads it:
constexpr int kEncW0 = 0;
constexpr int kEncW1 = kEncW0 + HH;
constexpr int kWI = kEncW1 + HH;
constexpr int kW2 = kWI + HH;
constexpr int kAWr = kW2 + HH;  // a_w0 rows 0..63
constexpr int kAWa = kAWr + HH;  // a_w0 rows 64..127
constexpr int kAW1 = kAWa + HH;
constexpr int kOW0 = kAW1 + HH;
constexpr int kVec = kOW0 + HH;
enum { ENC_B0, ENC_B1, ENC_LS, ENC_LB, B2, E_LS, E_LB, A_B0, A_B1, A_LS, A_LB,
       O_B0, N_VEC };
constexpr int kOW1 = kVec + N_VEC * NLT_H;  // (64, d_out), then o_b1[d_out]

__host__ __device__ inline int n_params(int d_out) {
  return kOW1 + NLT_H * d_out + d_out;
}

// Transposed blob: the eight 64x64 matrices above, each transposed, at the
// same offsets, then o_w1^T (d_out, 64) at kVec.
enum { M_ENC_W0, M_ENC_W1, M_WI, M_W2, M_AWR, M_AWA, M_AW1, M_OW0, M_OW1,
       N_MAT };
// Offset of gradient matrix m in the parameter blob.
__host__ __device__ constexpr int mat_offset(int m) {
  return m == M_OW1 ? kOW1 : m * HH;
}
static_assert(mat_offset(M_AWA) == kAWa && mat_offset(M_OW0) == kOW0,
              "matrix order of the parameter blob");

// Staged node tensors, one 64-wide row per warp each.
enum { S_GE, S_T1, S_GR, S_AGG, S_U1, S_RO, S_Y, S_DOUT, S_DY0P, S_DU2,
       S_DU0P, S_DREC, S_DT2, S_DT1P, N_STAGE };

template <int K>
constexpr size_t smem_floats() {
  return (size_t)N_MAT * HH + N_STAGE * kWarps * NLT_H +
         2 * kWarps * K * NLT_H;
}

// acc (in shared memory, element-major: acc[e*256 + tid]) += X^T D tile.
__device__ __forceinline__ void tile_acc_smem(float* acc, const float* X,
                                              const float* D, int rows,
                                              int ti, int tj, int tid) {
  float a[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) a[e] = acc[e * 256 + tid];
  nlt_tile_acc(X, NLT_H, D, NLT_H, rows, ti, tj, a);
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e * 256 + tid] = a[e];
}

template <int K>
__global__ void __launch_bounds__(kWarps * 32, 1)
    grid_update_bwd_kernel(const float* __restrict__ table,
                           const int* __restrict__ senders,
                           const float* __restrict__ ew,
                           const float* __restrict__ ge,
                           const float* __restrict__ mask,
                           const float* __restrict__ P,   // parameter blob
                           const float* __restrict__ PT,  // transposed blob
                           const float* __restrict__ d_out_g,
                           float* __restrict__ d_x0, float* __restrict__ d_ew,
                           float* __restrict__ d_ge,
                           float* __restrict__ partial, int n_virt, int n_ge,
                           int B, int d_out) {
  extern __shared__ __align__(16) float smem[];
  float* acc = smem;  // N_MAT x 16 x 256
  float* stage = acc + N_MAT * HH;
  float* x1s = stage + N_STAGE * kWarps * NLT_H;  // (kWarps*K, 64)
  float* dx2s = x1s + kWarps * K * NLT_H;
  for (int i = threadIdx.x; i < N_MAT * HH; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tid = threadIdx.x, ti = tid >> 4, tj = tid & 15;
  const int W = B * NLT_H;
  const float2 zero = make_float2(0.f, 0.f);
  auto vec = [&](int which) { return nlt_ld2(P + kVec + which * NLT_H, lane); };
  auto row = [&](int which) { return stage + (which * kWarps + warp) * NLT_H; };
  auto node_mm = [&](int which, const float* w, float2 init) {
    float2 o[1] = {init};
    nlt_mm64<1>(row(which), NLT_H, w, NLT_H, lane, o);
    return o[0];
  };
  float2 vsum[N_VEC];  // per-lane shares of the 12 vector gradients
  nlt_fill(vsum, zero);
  float dob1[2] = {0.f, 0.f};  // o_b1 columns lane and lane + 32
  float* x1w = x1s + warp * K * NLT_H;
  float* dx2w = dx2s + warp * K * NLT_H;
  const float* ow1t = PT + kVec;
  const int n_chunks = (n_virt + kWarps - 1) / kWarps;

  for (int chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
    const int v0 = chunk * kWarps + warp;
    const bool ok = v0 < n_virt;
    const int v = ok ? v0 : n_virt - 1;
    const size_t slot0 = (size_t)v * K;
    float2 dew[K];
    nlt_fill(dew, zero);
    for (int b = 0; b < B; ++b) {
      const size_t col = (size_t)b * NLT_H;
      // ---- forward recompute ----
      const float2 gev =
          v < n_ge ? nlt_ld2(ge + (size_t)v * W + col, lane) : zero;
      nlt_st2(row(S_GE), lane, gev);
      __syncwarp();
      const float2 t1p = node_mm(S_GE, P + kEncW0, vec(ENC_B0));
      nlt_st2(row(S_T1), lane, nlt_silu2(t1p));
      __syncwarp();
      const float2 t2 = node_mm(S_T1, P + kEncW1, vec(ENC_B1));
      const NltLn s_e = nlt_ln_stats(t2);
      const float2 gr =
          nlt_add2(gev, nlt_ln_apply(s_e, vec(ENC_LS), vec(ENC_LB)));
      nlt_st2(row(S_GR), lane, gr);
      __syncwarp();
      const float2 rec = node_mm(S_GR, P + kWI, zero);
      float2 x0[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int s = senders[slot0 + k];
        x0[k] = nlt_add2(
            nlt_add2(nlt_ld2(table + (size_t)s * W + col, lane),
                     nlt_ld2(ew + (slot0 + k) * NLT_H, lane)),
            rec);
        nlt_st2(x1w + k * NLT_H, lane, nlt_silu2(x0[k]));
      }
      __syncwarp();
      float2 y2[K];
      nlt_fill(y2, vec(B2));
      nlt_mm64<K>(x1w, NLT_H, P + kW2, NLT_H, lane, y2);
      float mk[K];
      float2 agg = zero;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        mk[k] = mask[slot0 + k];
        const float2 msg =
            nlt_ln_apply(nlt_ln_stats(y2[k]), vec(E_LS), vec(E_LB));
        agg.x = fmaf(mk[k], msg.x, agg.x);
        agg.y = fmaf(mk[k], msg.y, agg.y);
      }
      nlt_st2(row(S_AGG), lane, agg);
      __syncwarp();
      const float2 u0p = node_mm(S_AGG, P + kAWa,
                                 node_mm(S_GR, P + kAWr, vec(A_B0)));
      nlt_st2(row(S_U1), lane, nlt_silu2(u0p));
      __syncwarp();
      const float2 u2 = node_mm(S_U1, P + kAW1, vec(A_B1));
      const NltLn s_u = nlt_ln_stats(u2);
      nlt_st2(row(S_RO), lane,
              nlt_add2(gr, nlt_ln_apply(s_u, vec(A_LS), vec(A_LB))));
      __syncwarp();
      const float2 y0p = node_mm(S_RO, P + kOW0, vec(O_B0));
      nlt_st2(row(S_Y), lane, nlt_silu2(y0p));
      // ---- backward chain ----
      float* dout_row = row(S_DOUT);
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        const int c = lane + 32 * c2;
        const float d = (ok && c < d_out)
                            ? d_out_g[((size_t)v * B + b) * d_out + c]
                            : 0.f;
        dout_row[c] = d;
        dob1[c2] += d;
      }
      __syncwarp();
      float2 dyv[1] = {zero};
      nlt_mm64<1>(dout_row, NLT_H, ow1t, d_out, lane, dyv);
      const float2 d_y0p = nlt_mul_silu_grad(dyv[0], y0p);
      nlt_acc2(vsum[O_B0], d_y0p);
      nlt_st2(row(S_DY0P), lane, d_y0p);
      __syncwarp();
      const float2 d_ro = node_mm(S_DY0P, PT + kOW0, zero);
      const float2 d_u2 =
          nlt_ln_grad(s_u, vec(A_LS), d_ro, vsum[A_LS], vsum[A_LB]);
      nlt_acc2(vsum[A_B1], d_u2);
      nlt_st2(row(S_DU2), lane, d_u2);
      __syncwarp();
      const float2 d_u0p =
          nlt_mul_silu_grad(node_mm(S_DU2, PT + kAW1, zero), u0p);
      nlt_acc2(vsum[A_B0], d_u0p);
      nlt_st2(row(S_DU0P), lane, d_u0p);
      __syncwarp();
      float2 d_gr = node_mm(S_DU0P, PT + kAWr, d_ro);
      const float2 d_agg = node_mm(S_DU0P, PT + kAWa, zero);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float m = ok ? mk[k] : 0.f;
        const float2 dmsg = make_float2(m * d_agg.x, m * d_agg.y);
        const float2 dy = nlt_ln_grad(nlt_ln_stats(y2[k]), vec(E_LS), dmsg,
                                      vsum[E_LS], vsum[E_LB]);
        nlt_acc2(vsum[B2], dy);
        nlt_st2(dx2w + k * NLT_H, lane, dy);
      }
      __syncwarp();
      float2 dx1[K];
      nlt_fill(dx1, zero);
      nlt_mm64<K>(dx2w, NLT_H, PT + kW2, NLT_H, lane, dx1);
      float2 d_rec = zero;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float2 d0 = nlt_mul_silu_grad(dx1[k], x0[k]);
        nlt_acc2(d_rec, d0);
        nlt_acc2(dew[k], d0);
        if (ok) nlt_st2(d_x0 + (slot0 + k) * W + col, lane, d0);
      }
      nlt_st2(row(S_DREC), lane, d_rec);
      __syncwarp();
      d_gr = node_mm(S_DREC, PT + kWI, d_gr);
      const float2 d_t2 =
          nlt_ln_grad(s_e, vec(ENC_LS), d_gr, vsum[ENC_LS], vsum[ENC_LB]);
      nlt_acc2(vsum[ENC_B1], d_t2);
      nlt_st2(row(S_DT2), lane, d_t2);
      __syncwarp();
      const float2 d_t1p =
          nlt_mul_silu_grad(node_mm(S_DT2, PT + kEncW1, zero), t1p);
      nlt_acc2(vsum[ENC_B0], d_t1p);
      nlt_st2(row(S_DT1P), lane, d_t1p);
      __syncwarp();
      const float2 d_gev = node_mm(S_DT1P, PT + kEncW0, d_gr);
      if (ok && v < n_ge) nlt_st2(d_ge + (size_t)v * W + col, lane, d_gev);
      // ---- weight gradients of the block's rows ----
      __syncthreads();
      auto st = [&](int which) { return stage + which * kWarps * NLT_H; };
      tile_acc_smem(acc + M_ENC_W0 * HH, st(S_GE), st(S_DT1P), kWarps, ti, tj, tid);
      tile_acc_smem(acc + M_ENC_W1 * HH, st(S_T1), st(S_DT2), kWarps, ti, tj, tid);
      tile_acc_smem(acc + M_WI * HH, st(S_GR), st(S_DREC), kWarps, ti, tj, tid);
      tile_acc_smem(acc + M_W2 * HH, x1s, dx2s, kWarps * K, ti, tj, tid);
      tile_acc_smem(acc + M_AWR * HH, st(S_GR), st(S_DU0P), kWarps, ti, tj, tid);
      tile_acc_smem(acc + M_AWA * HH, st(S_AGG), st(S_DU0P), kWarps, ti, tj, tid);
      tile_acc_smem(acc + M_AW1 * HH, st(S_U1), st(S_DU2), kWarps, ti, tj, tid);
      tile_acc_smem(acc + M_OW0 * HH, st(S_RO), st(S_DY0P), kWarps, ti, tj, tid);
      tile_acc_smem(acc + M_OW1 * HH, st(S_Y), st(S_DOUT), kWarps, ti, tj, tid);
      __syncthreads();
    }
    if (ok) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        nlt_st2(d_ew + (slot0 + k) * NLT_H, lane, dew[k]);
    }
  }

  float* part = partial + (size_t)blockIdx.x * n_params(d_out);
#pragma unroll
  for (int m = 0; m < N_MAT; ++m) {
    float a[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) a[e] = acc[(m * 16 + e) * 256 + tid];
    nlt_tile_store(part + mat_offset(m), NLT_H, m == M_OW1 ? d_out : NLT_H, ti,
                   tj, a);
  }
  // vector gradients: the 12 of width 64, then o_b1 (d_out wide)
  nlt_block_vec_sums<N_VEC>(stage, vsum, kWarps, part + kVec);
  float* red = stage;
#pragma unroll
  for (int c2 = 0; c2 < 2; ++c2) red[warp * NLT_H + lane + 32 * c2] = dob1[c2];
  __syncthreads();
  for (int c = threadIdx.x; c < d_out; c += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w * NLT_H + c];
    part[kOW1 + NLT_H * d_out + c] = s;
  }
}

template <int K>
cudaError_t grid_for(int n_virt, int* grid) {
  return nlt_launch_config(grid_update_bwd_kernel<K>, kWarps * 32,
                           sizeof(float) * smem_floats<K>(),
                           (n_virt + kWarps - 1) / kWarps, grid);
}

template <int K>
cudaError_t launch(const float* table, const int* senders, const float* ew,
                   const float* ge, const float* mask, const float* params,
                   const float* tparams, const float* d_out_g, float* d_x0,
                   float* d_ew, float* d_ge, float* partial, int n_virt,
                   int n_ge, int B, int d_out, int grid,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<K>();
  cudaError_t err = nlt_allow_smem(grid_update_bwd_kernel<K>, smem);
  if (err != cudaSuccess) return err;
  grid_update_bwd_kernel<K><<<grid, kWarps * 32, smem, stream>>>(
      table, senders, ew, ge, mask, params, tparams, d_out_g, d_x0, d_ew,
      d_ge, partial, n_virt, n_ge, B, d_out);
  return cudaGetLastError();
}

}  // namespace

// Blocks of nlt_grid_update_bwd for these sizes: the rows of its `partial`.
extern "C" int nlt_grid_update_bwd_grid(int n_virt, int n_ge, int K, int B,
                                        int d_out_w, int device, int* grid) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_virt < 1) return (int)cudaErrorInvalidValue;
#define NLT_GU_BWD_CASE(KK) \
  case KK:                  \
    return (int)grid_for<KK>(n_virt, grid);
  switch (K) {
    NLT_FOR_K(NLT_GU_BWD_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NLT_GU_BWD_CASE
}

// B5/B6. d_out (n_virt, B*d_out) -> d_x0 (n_virt*K, B*64) per slot,
// d_ew (n_virt*K, 64), d_ge (n_ge, B*64), partial (grid, params) in the
// parameter blob's layout. tparams: the transposed blob (see above).
extern "C" int nlt_grid_update_bwd(const float* table, const int* senders,
                                   const float* ew, const float* ge,
                                   const float* mask, const float* params,
                                   const float* tparams, const float* d_out,
                                   float* d_x0, float* d_ew, float* d_ge,
                                   float* partial, int n_virt, int n_ge,
                                   int K, int B, int d_out_w, int grid,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_virt < 1 || grid < 1) return (int)cudaErrorInvalidValue;
  if (d_out_w < 1 || d_out_w > NLT_H) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define NLT_GU_BWD_CASE(KK)                                                 \
  case KK:                                                                  \
    return (int)launch<KK>(table, senders, ew, ge, mask, params, tparams,   \
                           d_out, d_x0, d_ew, d_ge, partial, n_virt, n_ge,  \
                           B, d_out_w, grid, s);
  switch (K) {
    NLT_FOR_K(NLT_GU_BWD_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NLT_GU_BWD_CASE
}
