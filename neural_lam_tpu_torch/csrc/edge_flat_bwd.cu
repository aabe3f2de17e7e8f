// Backward of the flat-layout edge-MLP tail and processor edge layer
// (kernels B2 and B3/B4).
//
// Replaces, from neural_lam_tpu/ops/pallas_edge_flat.py:
//   B2    _tail_bwd_kernel :526 (via _edge_tail_sum_flat_bwd :583)
//   B3/B4 _layer_bwd_kernel :846 (via _edge_layer_flat_bwd :908) and
//         _layer_bwd_win_kernel :1093 (via edge_layer_flat_win_bwd :1163):
//         one kernel for both, since the sender row is read by index from
//         the node table. It writes the per-slot cotangent d_x0; the caller folds it
//         onto the sender table (ops/message_passing.py, fold_senders), as
//         the windowed TPU kernel's caller folds its window cotangents.
//
// Recomputes the forward of csrc/edge_flat.cu per (virtual row v, batch
// element b), over the row's K slots k:
//   x0[k] = table[senders[v*K+k], b] + rec_rows[v, b]
//           + ew[v*K+k]                        (B2; b0 is inside ew)
//           + edge[v*K+k, b] @ W_e + b0         (B3)
//   y[k]  = silu(x0[k]) @ W2 + b2,  msg[k] = LN(y[k])
// and, from d_virt (and, for B3, d_edge_out, which may be absent):
//   d_msg[k] = mask[v, k] * d_virt[v, b] (+ d_edge_out[v*K+k, b])
//   d_y      = LN backward;  d_x0 = (d_y @ W2^T) * silu'(x0)
//   d_x0 (M, W) per slot, d_rec[v, b] = sum_k d_x0[k],
//   B2: d_ew[v*K+k] = sum_b d_x0;  B3: d_edge = d_edge_out + d_x0 @ W_e^T
//   dW2 = sum silu(x0)^T d_y, db2 = sum d_y, dLN scale/bias,
//   B3: dW_e = sum edge^T d_x0, db0 = sum d_x0.
//
// One warp owns one virtual row v and walks its batch elements, so the
// per-slot sum over b (d_ew) and over k (d_rec) are register sums. After
// each batch element the block's rows (kWarps*K of them) are staged in
// shared memory and each thread adds their products into the 4x4 tiles of
// dW2 (and dW_e) it owns, in registers; each block writes its partial sums
// once, in the parameter blob's layout, and the caller sums them in a fixed
// order. W2 and W_e are held in shared memory twice, as given and
// transposed, so the backward products read them as the forward does.
// Bound (fp32 CUDA cores, bench shapes): operations -- three 64x64
// products per slot and batch element for W2 (five with W_e) against
// ~1.5 KB of traffic per slot.
#include "bwd_common.cuh"

namespace {

constexpr int kWarps = 8;  // warps per block, one virtual row each

// Parameter blob (floats): w2[64*64] | b2 | ls | lb  [| we[64*64] | b0]
constexpr int kTailParams = NLT_H * NLT_H + 3 * NLT_H;
constexpr int kLayerParams = 2 * NLT_H * NLT_H + 4 * NLT_H;

template <int K, bool kLayer>
constexpr int smem_floats() {
  constexpr int n_par = kLayer ? kLayerParams : kTailParams;
  constexpr int n_mat = kLayer ? 2 : 1;
  constexpr int n_stage = kLayer ? 4 : 2;
  return nlt_round4(n_par) + n_mat * NLT_H * NLT_H +
         n_stage * kWarps * K * NLT_H + kWarps * 3 * NLT_H;
}

template <int K, bool kLayer>
__global__ void __launch_bounds__(kWarps * 32, 1)
    edge_bwd_kernel(const float* __restrict__ table,
                    const int* __restrict__ senders,
                    const float* __restrict__ edge_in,  // B2: ew (M,64); B3: (M,W)
                    const float* __restrict__ rec_rows,
                    const float* __restrict__ mask,
                    const float* __restrict__ params,
                    const float* __restrict__ d_virt,
                    const float* __restrict__ d_edge_out,  // B3, may be null
                    float* __restrict__ d_x0,
                    float* __restrict__ d_edge,  // B2: d_ew (M,64); B3: (M,W)
                    float* __restrict__ d_rec, float* __restrict__ partial,
                    int n_virt, int B) {
  extern __shared__ __align__(16) float smem[];
  constexpr int n_par = kLayer ? kLayerParams : kTailParams;
  constexpr int HH = NLT_H * NLT_H;
  constexpr int kSlots = kWarps * K;  // staged rows per step
  nlt_load_params(smem, params, n_par);
  const float* w2 = smem;
  const float* b2 = w2 + HH;
  const float* ls = b2 + NLT_H;
  const float* we = ls + 2 * NLT_H;
  const float* b0 = we + HH;
  float* w2t = smem + nlt_round4(n_par);
  float* wet = w2t + HH;  // B3 only
  float* x1s = w2t + (kLayer ? 2 : 1) * HH;  // (kSlots, 64) each
  float* dx2s = x1s + kSlots * NLT_H;
  float* es = dx2s + kSlots * NLT_H;  // B3 only
  float* d0s = es + kSlots * NLT_H;   // B3 only
  float* red = x1s + (kLayer ? 4 : 2) * kSlots * NLT_H;
  nlt_load_transposed(w2t, params);
  if constexpr (kLayer) nlt_load_transposed(wet, params + HH + 3 * NLT_H);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tid = threadIdx.x, ti = tid >> 4, tj = tid & 15;
  const int W = B * NLT_H;
  const float2 b2v = nlt_ld2(b2, lane), lsv = nlt_ld2(ls, lane);
  const float2 zero = make_float2(0.f, 0.f);
  float2 vsum[3];  // db2, dls, dlb
  nlt_fill(vsum, zero);
  float2 db0 = zero;
  float aw2[16] = {}, awe[16] = {};
  float* x1w = x1s + warp * K * NLT_H;
  float* dx2w = dx2s + warp * K * NLT_H;
  float* ew_ = es + warp * K * NLT_H;
  float* d0w = d0s + warp * K * NLT_H;
  const int n_chunks = (n_virt + kWarps - 1) / kWarps;

  for (int chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
    const int v0 = chunk * kWarps + warp;
    const bool ok = v0 < n_virt;
    const int v = ok ? v0 : n_virt - 1;
    const size_t slot0 = (size_t)v * K;
    float2 dew[kLayer ? 1 : K];
    nlt_fill(dew, zero);
    for (int b = 0; b < B; ++b) {
      const size_t col = (size_t)b * NLT_H;
      const float2 rec = nlt_ld2(rec_rows + (size_t)v * W + col, lane);
      float2 x0[K];
      if constexpr (kLayer) {
#pragma unroll
        for (int k = 0; k < K; ++k)
          nlt_st2(ew_ + k * NLT_H, lane,
                  nlt_ld2(edge_in + (slot0 + k) * W + col, lane));
        __syncwarp();
        nlt_fill(x0, nlt_ld2(b0, lane));
        nlt_mm64<K>(ew_, NLT_H, we, NLT_H, lane, x0);
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k)
          x0[k] = nlt_ld2(edge_in + (slot0 + k) * NLT_H, lane);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int s = senders[slot0 + k];
        const float2 g = nlt_ld2(table + (size_t)s * W + col, lane);
        x0[k] = nlt_add2(nlt_add2(x0[k], g), rec);
        nlt_st2(x1w + k * NLT_H, lane, nlt_silu2(x0[k]));
      }
      __syncwarp();
      float2 y[K];
      nlt_fill(y, b2v);
      nlt_mm64<K>(x1w, NLT_H, w2, NLT_H, lane, y);
      const float2 dv =
          ok ? nlt_ld2(d_virt + (size_t)v * W + col, lane) : zero;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float m = ok ? mask[slot0 + k] : 0.f;
        float2 dmsg = make_float2(m * dv.x, m * dv.y);
        if constexpr (kLayer) {
          if (ok && d_edge_out != nullptr)
            nlt_acc2(dmsg, nlt_ld2(d_edge_out + (slot0 + k) * W + col, lane));
        }
        const float2 dy =
            nlt_ln_grad(nlt_ln_stats(y[k]), lsv, dmsg, vsum[1], vsum[2]);
        nlt_acc2(vsum[0], dy);
        nlt_st2(dx2w + k * NLT_H, lane, dy);
      }
      __syncwarp();
      float2 dx1[K];
      nlt_fill(dx1, zero);
      nlt_mm64<K>(dx2w, NLT_H, w2t, NLT_H, lane, dx1);
      float2 drec = zero;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float2 d0 = nlt_mul_silu_grad(dx1[k], x0[k]);
        nlt_acc2(drec, d0);
        if (ok) nlt_st2(d_x0 + (slot0 + k) * W + col, lane, d0);
        if constexpr (kLayer) {
          nlt_acc2(db0, d0);
          nlt_st2(d0w + k * NLT_H, lane, d0);
        } else {
          nlt_acc2(dew[k], d0);
        }
      }
      if (ok) nlt_st2(d_rec + (size_t)v * W + col, lane, drec);
      if constexpr (kLayer) {
        __syncwarp();
        float2 de[K];
        nlt_fill(de, zero);
        nlt_mm64<K>(d0w, NLT_H, wet, NLT_H, lane, de);
        if (ok) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const size_t at = (slot0 + k) * W + col;
            if (d_edge_out != nullptr) nlt_acc2(de[k], nlt_ld2(d_edge_out + at, lane));
            nlt_st2(d_edge + at, lane, de[k]);
          }
        }
      }
      __syncthreads();
      nlt_tile_acc(x1s, NLT_H, dx2s, NLT_H, kSlots, ti, tj, aw2);
      if constexpr (kLayer)
        nlt_tile_acc(es, NLT_H, d0s, NLT_H, kSlots, ti, tj, awe);
      __syncthreads();
    }
    if constexpr (!kLayer) {
      if (ok) {
#pragma unroll
        for (int k = 0; k < K; ++k)
          nlt_st2(d_edge + (slot0 + k) * NLT_H, lane, dew[k]);
      }
    }
  }

  float* part = partial + (size_t)blockIdx.x * n_par;
  nlt_tile_store(part, NLT_H, NLT_H, ti, tj, aw2);
  nlt_block_vec_sums<3>(red, vsum, kWarps, part + HH);
  if constexpr (kLayer) {
    nlt_tile_store(part + HH + 3 * NLT_H, NLT_H, NLT_H, ti, tj, awe);
    const float2 one[1] = {db0};
    nlt_block_vec_sums<1>(red, one, kWarps, part + 2 * HH + 3 * NLT_H);
  }
}

template <int K, bool kLayer>
cudaError_t grid_for(int n_virt, int* grid) {
  return nlt_launch_config(edge_bwd_kernel<K, kLayer>, kWarps * 32,
                           sizeof(float) * smem_floats<K, kLayer>(),
                           (n_virt + kWarps - 1) / kWarps, grid);
}

template <int K, bool kLayer>
cudaError_t launch(const float* table, const int* senders,
                   const float* edge_in, const float* rec_rows,
                   const float* mask, const float* params,
                   const float* d_virt, const float* d_edge_out, float* d_x0,
                   float* d_edge, float* d_rec, float* partial, int n_virt,
                   int B, int grid, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<K, kLayer>();
  cudaError_t err = nlt_allow_smem(edge_bwd_kernel<K, kLayer>, smem);
  if (err != cudaSuccess) return err;
  edge_bwd_kernel<K, kLayer><<<grid, kWarps * 32, smem, stream>>>(
      table, senders, edge_in, rec_rows, mask, params, d_virt, d_edge_out,
      d_x0, d_edge, d_rec, partial, n_virt, B);
  return cudaGetLastError();
}

template <bool kLayer>
int query(int n_virt, int K, int device, int* grid) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_virt < 1) return (int)cudaErrorInvalidValue;
#define NLT_EDGE_BWD_CASE(KK) \
  case KK:                    \
    return (int)grid_for<KK, kLayer>(n_virt, grid);
  switch (K) {
    NLT_FOR_K(NLT_EDGE_BWD_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NLT_EDGE_BWD_CASE
}

template <bool kLayer>
int dispatch(const float* table, const int* senders, const float* edge_in,
             const float* rec_rows, const float* mask, const float* params,
             const float* d_virt, const float* d_edge_out, float* d_x0,
             float* d_edge, float* d_rec, float* partial, int n_virt, int K,
             int B, int grid, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_virt < 1 || grid < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define NLT_EDGE_BWD_CASE(KK)                                                \
  case KK:                                                                   \
    return (int)launch<KK, kLayer>(table, senders, edge_in, rec_rows, mask,  \
                                   params, d_virt, d_edge_out, d_x0, d_edge, \
                                   d_rec, partial, n_virt, B, grid, s);
  switch (K) {
    NLT_FOR_K(NLT_EDGE_BWD_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NLT_EDGE_BWD_CASE
}

}  // namespace

// Blocks of nlt_edge_tail_sum_bwd / nlt_edge_layer_bwd for these sizes:
// the rows of their `partial`.
extern "C" int nlt_edge_tail_sum_bwd_grid(int n_virt, int K, int B,
                                          int device, int* grid) {
  return query<false>(n_virt, K, device, grid);
}

extern "C" int nlt_edge_layer_bwd_grid(int n_virt, int K, int B, int device,
                                       int* grid) {
  return query<true>(n_virt, K, device, grid);
}

// B2. d_virt (n_virt, B*64) -> d_x0 (M, B*64), d_ew (M, 64),
// d_rec (n_virt, B*64), partial (grid, params) in the blob's layout.
extern "C" int nlt_edge_tail_sum_bwd(const float* table, const int* senders,
                                     const float* ew, const float* rec_rows,
                                     const float* mask, const float* params,
                                     const float* d_virt, float* d_x0,
                                     float* d_ew, float* d_rec,
                                     float* partial, int n_virt, int K, int B,
                                     int grid, int device, void* stream) {
  return dispatch<false>(table, senders, ew, rec_rows, mask, params, d_virt,
                         nullptr, d_x0, d_ew, d_rec, partial, n_virt, K, B,
                         grid, device, stream);
}

// B3/B4. d_virt (n_virt, B*64), d_edge_out (M, B*64) or null -> d_x0,
// d_edge (M, B*64), d_rec (n_virt, B*64), partial (grid, params).
extern "C" int nlt_edge_layer_bwd(const float* edge_rep, const float* table,
                                  const int* senders, const float* rec_rows,
                                  const float* mask, const float* params,
                                  const float* d_virt,
                                  const float* d_edge_out, float* d_x0,
                                  float* d_edge, float* d_rec,
                                  float* partial, int n_virt, int K, int B,
                                  int grid, int device, void* stream) {
  return dispatch<true>(table, senders, edge_rep, rec_rows, mask, params,
                        d_virt, d_edge_out, d_x0, d_edge, d_rec, partial,
                        n_virt, K, B, grid, device, stream);
}
