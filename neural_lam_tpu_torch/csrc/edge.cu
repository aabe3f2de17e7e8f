// Batched-layout edge-MLP tail (kernels P1, P2) and processor edge layer
// (kernel P3): the JAX package's (B, rows, 64) layout.
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
// P2 and P3 are the batched-layout instances of the tensor-core kernel in
// edge_tc.cuh (`edge_tc_kernel<K, false, true>` and `<K, true, true>`),
// K2's and K3's kernel with the strides of (B, rows, 64): 3xTF32 products
// on 16-row tiles, weights split once into fragment order, cp.async
// staging, a fixed-order virt sum. Bound on this card: the bytes (the
// edge rows in and out, the gathered sender rows, ew, rec_rows, virt),
// not the products; each warp's chain of dependent steps holds them, as
// it holds K3 (edge_tc.cuh). P2 writes msg from the same C fragments from
// which P3 writes edge_out, when the caller asks for messages.
//
// P1, per (batch element b, virtual row v), over the row's K edge slots k:
//   msg[k] = LayerNorm(silu(x0[b, v*K+k]) @ W2 + b2)
//   msg[b, v*K+k] = msg[k] when asked, padding slots included
//   virt[b, v] = sum_k mask[v*K+k] * msg[k]
// Layout: edge rows (x0, msg) at (b*M + slot)*64, virtual rows (virt) at
// (b*N_virt + v)*64.
//
// P1's design, on CUDA cores: one warp owns one (b, v) pair and all K
// slots of it, so the masked slot sum is a register sum: no atomics, the
// same order on every run. Consecutive warps take consecutive virtual
// rows of one batch element, so a warp's row loads and stores are 256
// contiguous bytes. W2 sits in shared memory; the block walks (b, v)
// pairs grid-stride. Bound (fp32 CUDA cores): operations -- 2*64*64 FLOP
// a slot against ~0.5 KB of traffic a slot, above the card's FLOP-per-byte
// balance point; the product stages each slot's row in shared memory and
// reads the weights as broadcasts (`nlt_mm64`), K rows per weight read.
#include "common.cuh"
#include "edge_tc.cuh"

namespace {

constexpr int kP1Warps = 8;  // warps per block

// Parameter blob (floats): w2[64*64] | b2 | ls | lb
constexpr int kTailParams = NLT_H * NLT_H + 3 * NLT_H;

template <int K>
__global__ void __launch_bounds__(kP1Warps * 32)
    edge_tail_kernel(const float* __restrict__ x0_in,  // (B, M, 64)
                     const float* __restrict__ mask,   // (M,)
                     const float* __restrict__ params,
                     float* __restrict__ msg_out,  // (B, M, 64) or null
                     float* __restrict__ virt, int n_virt, int B) {
  extern __shared__ float smem[];
  nlt_load_params(smem, params, kTailParams);
  __syncthreads();
  const float* w2 = smem;
  const float* b2 = w2 + NLT_H * NLT_H;
  const float* ls = b2 + NLT_H;
  const float* lb = ls + NLT_H;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* xs = smem + nlt_round4(kTailParams) + warp * K * NLT_H;
  const float2 b2v = nlt_ld2(b2, lane), lsv = nlt_ld2(ls, lane),
               lbv = nlt_ld2(lb, lane);
  const size_t M = (size_t)n_virt * K;
  const long long n_items = (long long)n_virt * B;

  for (long long item = (long long)blockIdx.x * kP1Warps + warp;
       item < n_items; item += (long long)gridDim.x * kP1Warps) {
    const int b = (int)(item / n_virt), v = (int)(item % n_virt);
    const size_t slot0 = (size_t)v * K;
    const size_t row0 = (size_t)b * M + slot0;  // (b, slot0) edge row
#pragma unroll
    for (int k = 0; k < K; ++k)
      nlt_st2(xs + k * NLT_H, lane,
              nlt_silu2(nlt_ld2(x0_in + (row0 + k) * NLT_H, lane)));
    __syncwarp();
    float2 y[K];
    nlt_fill(y, b2v);
    nlt_mm64<K>(xs, NLT_H, w2, NLT_H, lane, y);
    __syncwarp();  // xs is rewritten by the next item
    float2 sum = make_float2(0.f, 0.f);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float2 msg = nlt_layer_norm(y[k], lsv, lbv);
      if (msg_out != nullptr)
        nlt_st2(msg_out + (row0 + k) * NLT_H, lane, msg);
      const float m = mask[slot0 + k];
      sum.x = fmaf(m, msg.x, sum.x);
      sum.y = fmaf(m, msg.y, sum.y);
    }
    nlt_st2(virt + ((size_t)b * n_virt + v) * NLT_H, lane, sum);
  }
}

template <int K>
cudaError_t tail_launch(const float* x0, const float* mask,
                        const float* params, float* msg, float* virt,
                        int n_virt, int B, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (nlt_round4(kTailParams) + kP1Warps * K * NLT_H);
  const long long items = (long long)n_virt * B;
  int grid = 0;
  cudaError_t err =
      nlt_launch_config(edge_tail_kernel<K>, kP1Warps * 32, smem,
                        (items + kP1Warps - 1) / kP1Warps, &grid);
  if (err != cudaSuccess) return err;
  edge_tail_kernel<K><<<grid, kP1Warps * 32, smem, stream>>>(
      x0, mask, params, msg, virt, n_virt, B);
  return cudaGetLastError();
}

}  // namespace

// P1. msg (B, n_virt*K, 64) when msg is not null, virt (B, n_virt, 64).
extern "C" int nlt_batched_edge_tail(const float* x0, const float* mask,
                                     const float* params, float* msg,
                                     float* virt, int n_virt, int K, int B,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_virt == 0 || B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define NLT_CASE(KK) \
  case KK:           \
    return (int)tail_launch<KK>(x0, mask, params, msg, virt, n_virt, B, s);
  switch (K) {
    NLT_FOR_K(NLT_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NLT_CASE
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
  return tc_dispatch<false, true>(send_t, senders, ew, rec_rows, mask, params,
                                  msg, virt, n_virt, K, B, n_send, device,
                                  stream);
}

// P3. edge_out (B, n_virt*K, 64), virt (B, n_virt, 64).
extern "C" int nlt_batched_edge_layer(const float* edge_rep,
                                      const float* send_t, const int* senders,
                                      const float* rec_rows,
                                      const float* mask, const float* params,
                                      float* edge_out, float* virt,
                                      int n_virt, int K, int B, int n_send,
                                      int device, void* stream) {
  return tc_dispatch<true, true>(send_t, senders, edge_rep, rec_rows, mask,
                                 params, edge_out, virt, n_virt, K, B, n_send,
                                 device, stream);
}
