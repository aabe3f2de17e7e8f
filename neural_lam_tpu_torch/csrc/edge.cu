// Batched-layout edge-MLP tail (kernels P1, P2) and processor edge layer
// (kernel P3).
//
// Replaces, from neural_lam_tpu/ops/pallas_edge.py:
//   P1  _tail_kernel (edge_tail): the tail on a materialised x0
//   P2  _tail_sum_kernel (edge_tail_sum): x0 summed from its parts; the
//       sender rows are read by index from the node table here instead of
//       from a pre-gathered (B, M, h) array
//   P3  _layer_kernel (edge_layer), both variants: in_gather=False
//       streams pre-gathered sender rows, in_gather=True gathers them from
//       a VMEM-resident table; here the sender row is always read by index
//
// Layout: per batch element b, edge rows (x0, edge state, messages) at
// (b*M + slot)*64, virtual rows (rec_rows, virt) at (b*N_virt + v)*64, node
// rows (send_t) at (b*N_send + s)*64 -- the JAX package's (B, rows, h).
//
// Per (batch element b, virtual row v), over the row's K edge slots k:
//   x0[k]  = x0[b, v*K+k]                                  (P1)
//          = send_t[b, senders[v*K+k]] + ew[v*K+k] + rec[b, v]     (P2)
//          = edge[b, v*K+k] @ W_e + b0 + send_t[b, senders[v*K+k]]
//            + rec[b, v]                                   (P3)
//   msg[k] = LayerNorm(silu(x0[k]) @ W2 + b2)
//   out[b, v*K+k] = msg[k] (P1/P2, when asked) or edge + msg (P3), padding
//                   slots included, as the Pallas kernels write them
//   virt[b, v] = sum_k mask[v*K+k] * msg[k]
//
// Design: the K2/K3 one (csrc/edge_flat.cu). One warp owns one (b, v) pair
// and all K slots of it, so the masked slot sum is a register sum: no
// atomics, the same order on every run. Consecutive warps take consecutive
// virtual rows of one batch element, so a warp's row loads and stores are
// 256 contiguous bytes and neighbouring warps touch neighbouring rows. The
// weights sit in shared memory; the block walks (b, v) pairs grid-stride.
// Bound (fp32 CUDA cores): operations -- 2*64*64 FLOP per slot for W2 (and
// W_e in P3) against at most ~1 KB of traffic per slot, above the card's
// FLOP-per-byte balance point; the products stage each slot's row in shared
// memory and read the weights as broadcasts (`nlt_mm64`), K rows per weight
// read.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // warps per block

// Parameter blob (floats): w2[64*64] | b2 | ls | lb  [| we[64*64] | b0]
constexpr int kTailParams = NLT_H * NLT_H + 3 * NLT_H;
constexpr int kLayerParams = 2 * NLT_H * NLT_H + 4 * NLT_H;

enum Mode { kTail, kTailSum, kLayer };

template <int K, int kMode>
__global__ void __launch_bounds__(kWarps * 32)
    edge_kernel(const float* __restrict__ x_in,  // P1: x0 (B,M,64); P2: ew
                                                 // (M,64); P3: edge (B,M,64)
                const float* __restrict__ send_t,  // P2/P3: (B, N_send, 64)
                const int* __restrict__ senders,   // P2/P3: (M,)
                const float* __restrict__ rec_rows,  // P2/P3: (B, N_virt, 64)
                const float* __restrict__ mask,      // (M,)
                const float* __restrict__ params,
                float* __restrict__ out,  // P1/P2: msg or null; P3: edge_out
                float* __restrict__ virt, int n_virt, int n_send, int B) {
  extern __shared__ float smem[];
  constexpr bool kHasLayer = kMode == kLayer;
  constexpr int n_par = kHasLayer ? kLayerParams : kTailParams;
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
  const float2 b2v = nlt_ld2(b2, lane), lsv = nlt_ld2(ls, lane),
               lbv = nlt_ld2(lb, lane);
  const size_t M = (size_t)n_virt * K;
  const long long n_items = (long long)n_virt * B;

  for (long long item = (long long)blockIdx.x * kWarps + warp; item < n_items;
       item += (long long)gridDim.x * kWarps) {
    const int b = (int)(item / n_virt), v = (int)(item % n_virt);
    const size_t slot0 = (size_t)v * K;
    const size_t row0 = (size_t)b * M + slot0;  // (b, slot0) edge row
    float2 x0[K];
    float2 e[kHasLayer ? K : 1];
    if constexpr (kMode == kTail) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        x0[k] = nlt_ld2(x_in + (row0 + k) * NLT_H, lane);
    } else {
      const float2 rec =
          nlt_ld2(rec_rows + ((size_t)b * n_virt + v) * NLT_H, lane);
      if constexpr (kHasLayer) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          e[k] = nlt_ld2(x_in + (row0 + k) * NLT_H, lane);
          nlt_st2(xs + k * NLT_H, lane, e[k]);
        }
        __syncwarp();
        nlt_fill(x0, nlt_ld2(b0, lane));
        nlt_mm64<K>(xs, NLT_H, we, NLT_H, lane, x0);
        __syncwarp();  // xs is rewritten below
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k)
          x0[k] = nlt_ld2(x_in + (slot0 + k) * NLT_H, lane);
      }
      const float* table = send_t + (size_t)b * n_send * NLT_H;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int s = senders[slot0 + k];
        const float2 g = nlt_ld2(table + (size_t)s * NLT_H, lane);
        x0[k] = nlt_add2(nlt_add2(x0[k], g), rec);
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) nlt_st2(xs + k * NLT_H, lane, nlt_silu2(x0[k]));
    __syncwarp();
    float2 y[K];
    nlt_fill(y, b2v);
    nlt_mm64<K>(xs, NLT_H, w2, NLT_H, lane, y);
    __syncwarp();  // xs is rewritten by the next item
    float2 sum = make_float2(0.f, 0.f);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float2 msg = nlt_layer_norm(y[k], lsv, lbv);
      if constexpr (kHasLayer)
        nlt_st2(out + (row0 + k) * NLT_H, lane, nlt_add2(e[k], msg));
      else if (out != nullptr)
        nlt_st2(out + (row0 + k) * NLT_H, lane, msg);
      const float m = mask[slot0 + k];
      sum.x = fmaf(m, msg.x, sum.x);
      sum.y = fmaf(m, msg.y, sum.y);
    }
    nlt_st2(virt + ((size_t)b * n_virt + v) * NLT_H, lane, sum);
  }
}

template <int K, int kMode>
cudaError_t launch(const float* x_in, const float* send_t, const int* senders,
                   const float* rec_rows, const float* mask,
                   const float* params, float* out, float* virt, int n_virt,
                   int n_send, int B, cudaStream_t stream) {
  constexpr int n_par = kMode == kLayer ? kLayerParams : kTailParams;
  const size_t smem =
      sizeof(float) * (nlt_round4(n_par) + kWarps * K * NLT_H);
  const long long items = (long long)n_virt * B;
  int grid = 0;
  cudaError_t err = nlt_launch_config(edge_kernel<K, kMode>, kWarps * 32,
                                      smem, (items + kWarps - 1) / kWarps,
                                      &grid);
  if (err != cudaSuccess) return err;
  edge_kernel<K, kMode><<<grid, kWarps * 32, smem, stream>>>(
      x_in, send_t, senders, rec_rows, mask, params, out, virt, n_virt,
      n_send, B);
  return cudaGetLastError();
}

template <int kMode>
int dispatch(const float* x_in, const float* send_t, const int* senders,
             const float* rec_rows, const float* mask, const float* params,
             float* out, float* virt, int n_virt, int K, int B, int n_send,
             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_virt == 0 || B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define NLT_EDGE_CASE(KK)                                                    \
  case KK:                                                                   \
    return (int)launch<KK, kMode>(x_in, send_t, senders, rec_rows, mask,     \
                                  params, out, virt, n_virt, n_send, B, s);
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

// P1. msg (B, n_virt*K, 64) when msg is not null, virt (B, n_virt, 64).
extern "C" int nlt_batched_edge_tail(const float* x0, const float* mask,
                                     const float* params, float* msg,
                                     float* virt, int n_virt, int K, int B,
                                     int device, void* stream) {
  return dispatch<kTail>(x0, nullptr, nullptr, nullptr, mask, params, msg,
                         virt, n_virt, K, B, 0, device, stream);
}

// P2. msg (B, n_virt*K, 64) when msg is not null, virt (B, n_virt, 64).
extern "C" int nlt_batched_edge_tail_sum(const float* send_t,
                                         const int* senders, const float* ew,
                                         const float* rec_rows,
                                         const float* mask,
                                         const float* params, float* msg,
                                         float* virt, int n_virt, int K,
                                         int B, int n_send, int device,
                                         void* stream) {
  return dispatch<kTailSum>(ew, send_t, senders, rec_rows, mask, params, msg,
                            virt, n_virt, K, B, n_send, device, stream);
}

// P3. edge_out (B, n_virt*K, 64), virt (B, n_virt, 64).
extern "C" int nlt_batched_edge_layer(const float* edge_rep,
                                      const float* send_t, const int* senders,
                                      const float* rec_rows,
                                      const float* mask, const float* params,
                                      float* edge_out, float* virt,
                                      int n_virt, int K, int B, int n_send,
                                      int device, void* stream) {
  return dispatch<kLayer>(edge_rep, send_t, senders, rec_rows, mask, params,
                          edge_out, virt, n_virt, K, B, n_send, device,
                          stream);
}
