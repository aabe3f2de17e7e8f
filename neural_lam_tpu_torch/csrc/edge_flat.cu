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
// One warp owns one (v, b) pair and all K slots of it, so the masked slot
// sum is a register sum: no atomics, the same order on every run. The
// weights sit in shared memory; the block walks (v, b) pairs grid-stride.
// Bound (fp32 CUDA cores, bench shapes): operations -- 2*64*64 FLOP per
// slot and batch element for W2 (and W_e in K3) against ~1 KB of traffic
// per slot, far above the card's FLOP-per-byte balance point.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // warps per block

// Parameter blob (floats): w2[64*64] | b2 | ls | lb  [| we[64*64] | b0]
constexpr int kTailParams = NLT_H * NLT_H + 3 * NLT_H;
constexpr int kLayerParams = 2 * NLT_H * NLT_H + 4 * NLT_H;

template <int K, bool kLayer>
__global__ void __launch_bounds__(kWarps * 32)
    edge_kernel(const float* __restrict__ table, const int* __restrict__ senders,
                const float* __restrict__ edge_in,  // K2: ew (M,64); K3: (M,W)
                const float* __restrict__ rec_rows,
                const float* __restrict__ mask,
                const float* __restrict__ params, float* __restrict__ edge_out,
                float* __restrict__ virt, int n_virt, int B) {
  extern __shared__ float smem[];
  constexpr int n_par = kLayer ? kLayerParams : kTailParams;
  nlt_load_params(smem, params, n_par);
  __syncthreads();
  const float* w2 = smem;
  const float* b2 = w2 + NLT_H * NLT_H;
  const float* ls = b2 + NLT_H;
  const float* lb = ls + NLT_H;
  const float* we = lb + NLT_H;
  const float* b0 = we + NLT_H * NLT_H;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* xs = smem + nlt_round4(n_par) + warp * K * NLT_H;
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
    float2 e[kLayer ? K : 1];
    if constexpr (kLayer) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        e[k] = nlt_ld2(edge_in + (slot0 + k) * W + b * NLT_H, lane);
        nlt_st2(xs + k * NLT_H, lane, e[k]);
      }
      __syncwarp();
      nlt_fill(x0, nlt_ld2(b0, lane));
      nlt_mm64<K>(xs, NLT_H, we, NLT_H, lane, x0);
      __syncwarp();
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k)
        x0[k] = nlt_ld2(edge_in + (slot0 + k) * NLT_H, lane);
    }
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
      if constexpr (kLayer)
        nlt_st2(edge_out + (slot0 + k) * W + b * NLT_H, lane,
                nlt_add2(e[k], msg));
      const float m = mask[slot0 + k];
      sum.x = fmaf(m, msg.x, sum.x);
      sum.y = fmaf(m, msg.y, sum.y);
    }
    nlt_st2(virt + (size_t)v * W + b * NLT_H, lane, sum);
  }
}

template <int K, bool kLayer>
cudaError_t launch(const float* table, const int* senders,
                   const float* edge_in, const float* rec_rows,
                   const float* mask, const float* params, float* edge_out,
                   float* virt, int n_virt, int B, cudaStream_t stream) {
  constexpr int n_par = kLayer ? kLayerParams : kTailParams;
  const size_t smem =
      sizeof(float) * (nlt_round4(n_par) + kWarps * K * NLT_H);
  const long long items = (long long)n_virt * B;
  int grid = 0;
  cudaError_t err = nlt_launch_config(edge_kernel<K, kLayer>, kWarps * 32,
                                      smem, (items + kWarps - 1) / kWarps,
                                      &grid);
  if (err != cudaSuccess) return err;
  edge_kernel<K, kLayer><<<grid, kWarps * 32, smem, stream>>>(
      table, senders, edge_in, rec_rows, mask, params, edge_out, virt, n_virt,
      B);
  return cudaGetLastError();
}

template <bool kLayer>
int dispatch(const float* table, const int* senders, const float* edge_in,
             const float* rec_rows, const float* mask, const float* params,
             float* edge_out, float* virt, int n_virt, int K, int B,
             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_virt == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define NLT_EDGE_CASE(KK)                                                   \
  case KK:                                                                  \
    return (int)launch<KK, kLayer>(table, senders, edge_in, rec_rows, mask, \
                                   params, edge_out, virt, n_virt, B, s);
  switch (K) {
    NLT_EDGE_CASE(1)
    NLT_EDGE_CASE(2)
    NLT_EDGE_CASE(3)
    NLT_EDGE_CASE(4)
    NLT_EDGE_CASE(5)
    NLT_EDGE_CASE(6)
    NLT_EDGE_CASE(7)
    NLT_EDGE_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NLT_EDGE_CASE
}

}  // namespace

// K2. virt (n_virt, B*64).
extern "C" int nlt_edge_tail_sum(const float* table, const int* senders,
                                 const float* ew, const float* rec_rows,
                                 const float* mask, const float* params,
                                 float* virt, int n_virt, int K, int B,
                                 int device, void* stream) {
  return dispatch<false>(table, senders, ew, rec_rows, mask, params, nullptr,
                         virt, n_virt, K, B, device, stream);
}

// K3. edge_out (n_virt*K, B*64), virt (n_virt, B*64).
extern "C" int nlt_edge_layer(const float* edge_rep, const float* table,
                              const int* senders, const float* rec_rows,
                              const float* mask, const float* params,
                              float* edge_out, float* virt, int n_virt, int K,
                              int B, int device, void* stream) {
  return dispatch<true>(table, senders, edge_rep, rec_rows, mask, params,
                        edge_out, virt, n_virt, K, B, device, stream);
}
