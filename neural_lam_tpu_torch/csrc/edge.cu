// Batched-layout edge-MLP tails (kernels P1, P2) and processor edge layer
// (kernel P3): the JAX package's (B, rows, H) layout (H = NLT_H, the
// width a library is built for).
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
// All three are the batched-layout instances of the tensor-core kernel in
// edge_tc.cuh (`edge_tc_kernel<K, X0, true>`, `<K, TAIL_SUM, true>` and
// `<K, LAYER, true>`), K2's and K3's kernel with the strides of (B, rows,
// 64): 3xTF32 products on 16-row tiles, weights split once into fragment
// order, cp.async staging, a fixed-order virt sum. Bound on this card:
// the bytes (x0 or the edge rows in, the edge rows or msg out, the
// gathered sender rows, ew, rec_rows, virt), not the products; each
// warp's chain of dependent steps holds them, as it holds K3
// (edge_tc.cuh). P1 and P2 write msg from the same C fragments from which
// P3 writes edge_out, when the caller asks for messages.
//
// P2 and P3 have a float and a bf16 instance (`edge_tc_kernel<..., T>`):
// the `_bf16` entries take and give bf16 send_t, ew / edge_rep, rec_rows,
// msg / edge_out and virt (the bf16 forecast path), with fp32 math
// inside. P1 has the float one only: in that path its x0 is fp32.
#include "edge_tc.cuh"

using bf16 = __nv_bfloat16;

// P1. msg (B, n_virt*K, H) when msg is not null, virt (B, n_virt, H).
extern "C" int nlt_batched_edge_tail(const float* x0, const float* mask,
                                     const float* params, float* msg,
                                     float* virt, int n_virt, int K, int B,
                                     int device, void* stream) {
  return tc_dispatch<X0, true, float>(
      nullptr, nullptr, x0, nullptr, mask, params, msg, virt, n_virt, K, B, 0,
      device, stream);
}

// P2. msg (B, n_virt*K, H) when msg is not null, virt (B, n_virt, H).
extern "C" int nlt_batched_edge_tail_sum(const float* send_t,
                                         const int* senders, const float* ew,
                                         const float* rec_rows,
                                         const float* mask,
                                         const float* params, float* msg,
                                         float* virt, int n_virt, int K,
                                         int B, int n_send, int device,
                                         void* stream) {
  return tc_dispatch<TAIL_SUM, true, float>(
      send_t, senders, ew, rec_rows, mask, params, msg, virt, n_virt, K, B,
      n_send, device, stream);
}

// P3. edge_out (B, n_virt*K, H), virt (B, n_virt, H).
extern "C" int nlt_batched_edge_layer(const float* edge_rep,
                                      const float* send_t, const int* senders,
                                      const float* rec_rows,
                                      const float* mask, const float* params,
                                      float* edge_out, float* virt,
                                      int n_virt, int K, int B, int n_send,
                                      int device, void* stream) {
  return tc_dispatch<LAYER, true, float>(
      send_t, senders, edge_rep, rec_rows, mask, params, edge_out, virt, n_virt,
      K, B, n_send, device, stream);
}

// P2, bf16 instance.
extern "C" int nlt_batched_edge_tail_sum_bf16(
    const bf16* send_t, const int* senders, const bf16* ew,
    const bf16* rec_rows, const float* mask, const float* params, bf16* msg,
    bf16* virt, int n_virt, int K, int B, int n_send, int device,
    void* stream) {
  return tc_dispatch<TAIL_SUM, true, bf16>(
      send_t, senders, ew, rec_rows, mask, params, msg, virt, n_virt, K, B,
      n_send, device, stream);
}

// P3, bf16 instance.
extern "C" int nlt_batched_edge_layer_bf16(
    const bf16* edge_rep, const bf16* send_t, const int* senders,
    const bf16* rec_rows, const float* mask, const float* params,
    bf16* edge_out, bf16* virt, int n_virt, int K, int B, int n_send,
    int device, void* stream) {
  return tc_dispatch<LAYER, true, bf16>(
      send_t, senders, edge_rep, rec_rows, mask, params, edge_out, virt, n_virt,
      K, B, n_send, device, stream);
}
