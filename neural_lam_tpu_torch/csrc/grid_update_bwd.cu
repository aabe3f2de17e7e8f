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
// b, d_ge (n_ge, W) for the real rows only, the 13 bias, LayerNorm and
// o_b1 gradients, and the rows of the nine weight gradients. Rows v >= n_ge
// read ge as zeros and are neither read nor written past ge's end; padding
// slots (mask 0) get no share of d_agg.
//
// Design, in two passes. This kernel is the chain pass: one warp owns one
// virtual row v and walks its batch elements b, so d_ew's sum over b is a
// register sum; the 12 vector gradients and o_b1's are summed per block
// (`nlt_block_vec_sums`) into one row of a (blocks, 12*64 + d_out)
// scratch, which the caller sums in a fixed order (no float atomics). The
// weight gradients are not summed here: the chain writes each activation /
// gradient pair they need to a scratch in device memory, (rows, 64) row
// major, and the weight-gradient pass (csrc/weight_grad.cu, `xtd_sum`)
// sums X^T D over it. Node rows (row v*B + b): T1, GR, AGG, U1, RO, Y,
// DT1P, DT2, DREC, DU0P, DU2, DY0P; slot rows (row (v*K + k)*B + b): X1 =
// silu(x0), DX2.
//
// The weights sit in shared memory, two sets taking turns in one region:
// the forward set (the eight 64x64 matrices, 128 KB) and the backward set
// (the same transposed, then o_w1^T; at most 144 KB), copied from blobs the
// wrapper packs. For each (chunk of rows, b) every warp of the block runs
// its forward recompute on the forward set; then the block loads the
// backward set and every warp runs its backward chain, the forward state it
// needs (x0[K], y2[K], t1p, u0p, y0p, LayerNorm statistics, the mask) kept
// in registers across the swap. So one read of the weights from L2 serves
// a row per warp of the block: 16 warps at K <= 4 and 12 above (what the
// 227 KB of shared memory and the registers allow beside the weights),
// each staging only the input row of its current product and its K slot
// rows. Bound (fp32 CUDA cores, bench shapes): operations -- ~2x the
// forward's ~11.3 64x64 products per node row and batch element, plus the
// scratch's ~1.3 GB written once; the chain itself is bound by shared
// memory reads (one weight read and one broadcast per two FMAs per lane).
//
// bf16 instance (`<K, __nv_bfloat16>`, entry nlt_grid_update_bwd_bf16; the
// bf16 training path): table, ew, ge and d_out are read in bf16 and
// widened, the chain runs in fp32 as above, and d_x0, d_ew and d_ge are
// stored in bf16, each rounded once from its fp32 value, as the JAX kernel
// stores them in its inputs' dtype. The 12 node and 2 slot scratch tensors
// and the vector sums stay fp32. Same design: only the types of what is
// loaded and stored change.
#include "bwd_common.cuh"

namespace {

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
// Transposed blob: the eight 64x64 matrices above, each transposed, at the
// same offsets, then o_w1^T (d_out, 64) at kVec. The forward set is the
// blob's first kVec floats, the backward set the transposed blob's first
// kVec + 64*d_out.
constexpr int kSetFloats = kVec + HH;  // the weight region: either set

// Warps per block.
template <int K>
__host__ __device__ constexpr int warps() {
  return K <= 4 ? 16 : 12;
}

// Node rows of the scratch, in this order; then the two slot tensors.
enum { N_T1, N_GR, N_AGG, N_U1, N_RO, N_Y, N_DT1P, N_DT2, N_DREC, N_DU0P,
       N_DU2, N_DY0P, N_NODE };
enum { SL_X1, SL_DX2 };

// Per warp: the staged input rows of the node products, reused by the
// forward (F_*) and then the backward (B_*), and K slot rows (x1, then
// dx2).
enum { F_GE, F_T1, F_GR, F_AGG, F_U1, F_RO };
enum { B_DOUT, B_DY0P, B_DU2, B_DU0P, B_DREC, B_DT2, B_DT1P, N_ROWS };

template <int K>
constexpr size_t smem_floats() {
  return (size_t)kSetFloats + (size_t)warps<K>() * (N_ROWS + K) * NLT_H;
}
static_assert(sizeof(float) * (kSetFloats + 12 * (N_ROWS + 8) * NLT_H) <=
                  232448,
              "shared memory of a block");
static_assert(16 * N_VEC * NLT_H <= kSetFloats,
              "the vector sums reuse the weight region");

// dst[0, n) = src[0, n), n a multiple of 4, 16-byte aligned; whole block.
__device__ __forceinline__ void load_set(float* dst,
                                         const float* __restrict__ src,
                                         int n) {
  const float4* s = reinterpret_cast<const float4*>(src);
  float4* d = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < n / 4; i += blockDim.x) d[i] = __ldg(s + i);
}

template <int K, typename T>
__global__ void __launch_bounds__(warps<K>() * 32, 1)
    grid_update_bwd_kernel(const T* __restrict__ table,
                           const int* __restrict__ senders,
                           const T* __restrict__ ew,
                           const T* __restrict__ ge,
                           const float* __restrict__ mask,
                           const float* __restrict__ P,   // parameter blob
                           const float* __restrict__ PT,  // transposed blob
                           const T* __restrict__ d_out_g,
                           T* __restrict__ d_x0, T* __restrict__ d_ew,
                           T* __restrict__ d_ge,
                           float* __restrict__ node_s,  // (N_NODE, n_virt*B, 64)
                           float* __restrict__ slot_s,  // (2, n_virt*K*B, 64)
                           float* __restrict__ partial, int n_virt, int n_ge,
                           int B, int d_out) {
  constexpr int kWarps = warps<K>();
  extern __shared__ __align__(16) float smem[];
  float* wts = smem;  // the forward or the backward weight set
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int W = B * NLT_H;
  const size_t n_node = (size_t)n_virt * B, n_slot = n_node * K;
  const float2 zero = make_float2(0.f, 0.f);
  float* rows = smem + kSetFloats + warp * (N_ROWS + K) * NLT_H;
  float* slots = rows + N_ROWS * NLT_H;
  auto vec = [&](int which) { return nlt_ld2(P + kVec + which * NLT_H, lane); };
  auto row = [&](int which) { return rows + which * NLT_H; };
  auto node_mm = [&](int which, const float* w, float2 init) {
    float2 o[1] = {init};
    nlt_mm64<1>(row(which), NLT_H, w, NLT_H, lane, o);
    return o[0];
  };
  // this lane's two features of scratch row r (streaming store)
  auto put = [&](float* base, size_t r, float2 val) {
    __stcs(reinterpret_cast<float2*>(base + r * NLT_H) + lane, val);
  };
  float2 vsum[N_VEC];  // per-lane shares of the 12 vector gradients
  nlt_fill(vsum, zero);
  float dob1[2] = {0.f, 0.f};  // o_b1 columns lane and lane + 32
  const int n_bwd = kVec + NLT_H * d_out;
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
      const size_t nr = (size_t)v * B + b;  // node row of the scratch
      __syncthreads();  // the block is done with the weights and rows
      load_set(wts, P, kVec);  // wts: the forward set from here
      __syncthreads();
      // ---- forward recompute ----
      const float2 gev =
          v < n_ge ? nlt_ld2t(ge + (size_t)v * W + col, lane) : zero;
      nlt_st2(row(F_GE), lane, gev);
      __syncwarp();
      const float2 t1p = node_mm(F_GE, wts + kEncW0, vec(ENC_B0));
      const float2 t1 = nlt_silu2(t1p);
      nlt_st2(row(F_T1), lane, t1);
      __syncwarp();
      const float2 t2 = node_mm(F_T1, wts + kEncW1, vec(ENC_B1));
      const NltLn s_e = nlt_ln_stats(t2);
      const float2 gr =
          nlt_add2(gev, nlt_ln_apply(s_e, vec(ENC_LS), vec(ENC_LB)));
      nlt_st2(row(F_GR), lane, gr);
      __syncwarp();
      const float2 rec = node_mm(F_GR, wts + kWI, zero);
      float2 x0[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int s = senders[slot0 + k];
        x0[k] = nlt_add2(
            nlt_add2(nlt_ld2t(table + (size_t)s * W + col, lane),
                     nlt_ld2t(ew + (slot0 + k) * NLT_H, lane)),
            rec);
        const float2 x1 = nlt_silu2(x0[k]);
        nlt_st2(slots + k * NLT_H, lane, x1);
        if (ok) put(slot_s + SL_X1 * n_slot * NLT_H, (slot0 + k) * B + b, x1);
      }
      __syncwarp();
      float2 y2[K];
      nlt_fill(y2, vec(B2));
      nlt_mm64<K>(slots, NLT_H, wts + kW2, NLT_H, lane, y2);
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
      nlt_st2(row(F_AGG), lane, agg);
      __syncwarp();
      const float2 u0p = node_mm(F_AGG, wts + kAWa,
                                 node_mm(F_GR, wts + kAWr, vec(A_B0)));
      const float2 u1 = nlt_silu2(u0p);
      nlt_st2(row(F_U1), lane, u1);
      __syncwarp();
      const float2 u2 = node_mm(F_U1, wts + kAW1, vec(A_B1));
      const NltLn s_u = nlt_ln_stats(u2);
      const float2 ro = nlt_add2(gr, nlt_ln_apply(s_u, vec(A_LS), vec(A_LB)));
      nlt_st2(row(F_RO), lane, ro);
      __syncwarp();
      const float2 y0p = node_mm(F_RO, wts + kOW0, vec(O_B0));
      if (ok) {
        put(node_s + N_T1 * n_node * NLT_H, nr, t1);
        put(node_s + N_GR * n_node * NLT_H, nr, gr);
        put(node_s + N_AGG * n_node * NLT_H, nr, agg);
        put(node_s + N_U1 * n_node * NLT_H, nr, u1);
        put(node_s + N_RO * n_node * NLT_H, nr, ro);
        put(node_s + N_Y * n_node * NLT_H, nr, nlt_silu2(y0p));
      }
      __syncthreads();  // the forward set and rows are read
      load_set(wts, PT, n_bwd);  // wts: the backward set from here
      __syncthreads();
      // ---- backward chain ----
      float* dout_row = row(B_DOUT);
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        const int c = lane + 32 * c2;
        const float d =
            (ok && c < d_out)
                ? Io<T>::ld(d_out_g + ((size_t)v * B + b) * d_out + c)
                : 0.f;
        dout_row[c] = d;
        dob1[c2] += d;
      }
      __syncwarp();
      float2 dyv[1] = {zero};
      nlt_mm64<1>(dout_row, NLT_H, wts + kVec, d_out, lane, dyv);
      const float2 d_y0p = nlt_mul_silu_grad(dyv[0], y0p);
      nlt_acc2(vsum[O_B0], d_y0p);
      nlt_st2(row(B_DY0P), lane, d_y0p);
      __syncwarp();
      const float2 d_ro = node_mm(B_DY0P, wts + kOW0, zero);
      const float2 d_u2 =
          nlt_ln_grad(s_u, vec(A_LS), d_ro, vsum[A_LS], vsum[A_LB]);
      nlt_acc2(vsum[A_B1], d_u2);
      nlt_st2(row(B_DU2), lane, d_u2);
      __syncwarp();
      const float2 d_u0p =
          nlt_mul_silu_grad(node_mm(B_DU2, wts + kAW1, zero), u0p);
      nlt_acc2(vsum[A_B0], d_u0p);
      nlt_st2(row(B_DU0P), lane, d_u0p);
      __syncwarp();
      float2 d_gr = node_mm(B_DU0P, wts + kAWr, d_ro);
      const float2 d_agg = node_mm(B_DU0P, wts + kAWa, zero);
      __syncwarp();  // x1's rows are read; dx2 takes their place
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float m = ok ? mk[k] : 0.f;
        const float2 dmsg = make_float2(m * d_agg.x, m * d_agg.y);
        const float2 dy = nlt_ln_grad(nlt_ln_stats(y2[k]), vec(E_LS), dmsg,
                                      vsum[E_LS], vsum[E_LB]);
        nlt_acc2(vsum[B2], dy);
        nlt_st2(slots + k * NLT_H, lane, dy);
        if (ok) put(slot_s + SL_DX2 * n_slot * NLT_H, (slot0 + k) * B + b, dy);
      }
      __syncwarp();
      float2 dx1[K];
      nlt_fill(dx1, zero);
      nlt_mm64<K>(slots, NLT_H, wts + kW2, NLT_H, lane, dx1);
      float2 d_rec = zero;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float2 d0 = nlt_mul_silu_grad(dx1[k], x0[k]);
        nlt_acc2(d_rec, d0);
        nlt_acc2(dew[k], d0);
        if (ok) nlt_st2t(d_x0 + (slot0 + k) * W + col, lane, d0);
      }
      nlt_st2(row(B_DREC), lane, d_rec);
      __syncwarp();
      d_gr = node_mm(B_DREC, wts + kWI, d_gr);
      const float2 d_t2 =
          nlt_ln_grad(s_e, vec(ENC_LS), d_gr, vsum[ENC_LS], vsum[ENC_LB]);
      nlt_acc2(vsum[ENC_B1], d_t2);
      nlt_st2(row(B_DT2), lane, d_t2);
      __syncwarp();
      const float2 d_t1p =
          nlt_mul_silu_grad(node_mm(B_DT2, wts + kEncW1, zero), t1p);
      nlt_acc2(vsum[ENC_B0], d_t1p);
      nlt_st2(row(B_DT1P), lane, d_t1p);
      __syncwarp();
      const float2 d_gev = node_mm(B_DT1P, wts + kEncW0, d_gr);
      if (ok) {
        put(node_s + N_DY0P * n_node * NLT_H, nr, d_y0p);
        put(node_s + N_DU2 * n_node * NLT_H, nr, d_u2);
        put(node_s + N_DU0P * n_node * NLT_H, nr, d_u0p);
        put(node_s + N_DREC * n_node * NLT_H, nr, d_rec);
        put(node_s + N_DT2 * n_node * NLT_H, nr, d_t2);
        put(node_s + N_DT1P * n_node * NLT_H, nr, d_t1p);
        if (v < n_ge) nlt_st2t(d_ge + (size_t)v * W + col, lane, d_gev);
      }
    }
    if (ok) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        nlt_st2t(d_ew + (slot0 + k) * NLT_H, lane, dew[k]);
    }
  }

  // vector gradients: the 12 of width 64, then o_b1 (d_out wide), summed
  // in the weight region
  __syncthreads();
  float* red = wts;
  float* part = partial + (size_t)blockIdx.x * (N_VEC * NLT_H + d_out);
  nlt_block_vec_sums<N_VEC>(red, vsum, kWarps, part);
#pragma unroll
  for (int c2 = 0; c2 < 2; ++c2) red[warp * NLT_H + lane + 32 * c2] = dob1[c2];
  __syncthreads();
  for (int c = threadIdx.x; c < d_out; c += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w * NLT_H + c];
    part[N_VEC * NLT_H + c] = s;
  }
}

template <int K, typename T>
cudaError_t grid_for(int n_virt, int* grid) {
  return nlt_launch_config(grid_update_bwd_kernel<K, T>, warps<K>() * 32,
                           sizeof(float) * smem_floats<K>(),
                           (n_virt + warps<K>() - 1) / warps<K>(), grid);
}

template <int K, typename T>
cudaError_t launch(const T* table, const int* senders, const T* ew,
                   const T* ge, const float* mask, const float* params,
                   const float* tparams, const T* d_out_g, T* d_x0, T* d_ew,
                   T* d_ge, float* node_s, float* slot_s, float* partial,
                   int n_virt, int n_ge, int B, int d_out, int grid,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<K>();
  cudaError_t err = nlt_allow_smem(grid_update_bwd_kernel<K, T>, smem);
  if (err != cudaSuccess) return err;
  grid_update_bwd_kernel<K, T><<<grid, warps<K>() * 32, smem, stream>>>(
      table, senders, ew, ge, mask, params, tparams, d_out_g, d_x0, d_ew,
      d_ge, node_s, slot_s, partial, n_virt, n_ge, B, d_out);
  return cudaGetLastError();
}

template <typename T>
int bwd_grid(int n_virt, int K, int device, int* grid) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_virt < 1) return (int)cudaErrorInvalidValue;
#define NLT_GU_BWD_CASE(KK) \
  case KK:                  \
    return (int)grid_for<KK, T>(n_virt, grid);
  switch (K) {
    NLT_FOR_K(NLT_GU_BWD_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NLT_GU_BWD_CASE
}

template <typename T>
int bwd(const T* table, const int* senders, const T* ew, const T* ge,
        const float* mask, const float* params, const float* tparams,
        const T* d_out, T* d_x0, T* d_ew, T* d_ge, float* node_s,
        float* slot_s, float* partial, int n_virt, int n_ge, int K, int B,
        int d_out_w, int grid, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_virt < 1 || grid < 1) return (int)cudaErrorInvalidValue;
  if (d_out_w < 1 || d_out_w > NLT_H) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define NLT_GU_BWD_CASE(KK)                                                \
  case KK:                                                                 \
    return (int)launch<KK, T>(table, senders, ew, ge, mask, params,        \
                              tparams, d_out, d_x0, d_ew, d_ge, node_s,    \
                              slot_s, partial, n_virt, n_ge, B, d_out_w,   \
                              grid, s);
  switch (K) {
    NLT_FOR_K(NLT_GU_BWD_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NLT_GU_BWD_CASE
}

using bf16 = __nv_bfloat16;

}  // namespace

// Blocks of nlt_grid_update_bwd[_bf16] for these sizes: the rows of its
// `partial`.
extern "C" int nlt_grid_update_bwd_grid(int n_virt, int n_ge, int K, int B,
                                        int d_out_w, int device, int* grid) {
  return bwd_grid<float>(n_virt, K, device, grid);
}

extern "C" int nlt_grid_update_bwd_bf16_grid(int n_virt, int n_ge, int K,
                                             int B, int d_out_w, int device,
                                             int* grid) {
  return bwd_grid<bf16>(n_virt, K, device, grid);
}

// B5/B6's chain pass. d_out (n_virt, B*d_out) -> d_x0 (n_virt*K, B*64) per
// slot, d_ew (n_virt*K, 64), d_ge (n_ge, B*64), the scratch node_s
// (12, n_virt*B, 64) and slot_s (2, n_virt*K*B, 64) (see above), and
// partial (grid, 12*64 + d_out): each block's sums of the 12 vector
// gradients, then o_b1's. tparams: the transposed blob (see above).
extern "C" int nlt_grid_update_bwd(const float* table, const int* senders,
                                   const float* ew, const float* ge,
                                   const float* mask, const float* params,
                                   const float* tparams, const float* d_out,
                                   float* d_x0, float* d_ew, float* d_ge,
                                   float* node_s, float* slot_s,
                                   float* partial, int n_virt, int n_ge,
                                   int K, int B, int d_out_w, int grid,
                                   int device, void* stream) {
  return bwd<float>(table, senders, ew, ge, mask, params, tparams, d_out,
                    d_x0, d_ew, d_ge, node_s, slot_s, partial, n_virt, n_ge,
                    K, B, d_out_w, grid, device, stream);
}

// B5/B6's chain pass, bf16 instance: table, ew, ge, d_out, d_x0, d_ew and
// d_ge in bf16; the scratch, the blobs and partial fp32.
extern "C" int nlt_grid_update_bwd_bf16(
    const bf16* table, const int* senders, const bf16* ew, const bf16* ge,
    const float* mask, const float* params, const float* tparams,
    const bf16* d_out, bf16* d_x0, bf16* d_ew, bf16* d_ge, float* node_s,
    float* slot_s, float* partial, int n_virt, int n_ge, int K, int B,
    int d_out_w, int grid, int device, void* stream) {
  return bwd<bf16>(table, senders, ew, ge, mask, params, tparams, d_out,
                   d_x0, d_ew, d_ge, node_s, slot_s, partial, n_virt, n_ge,
                   K, B, d_out_w, grid, device, stream);
}
