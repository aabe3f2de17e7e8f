// Flat-layout edge-MLP tail and processor edge layer (kernels K2 and K3).
//
// Replaces, from neural_lam_tpu/ops/pallas_edge_flat.py:
//   K2  _tail_sum_flat_kernel (edge_tail_sum_flat): static edge term ew
//   K3  _layer_flat_kernel (edge_layer_flat) and _layer_flat_win_kernel
//       (edge_layer_flat_win): evolving edge state, one kernel for both,
//       since the sender row is read by index from the node table here
//       instead of from a pre-gathered array or a one-hot window.
//
// Both are the flat-layout instances of the tensor-core kernel in
// edge_tc.cuh, whose note gives the design: K3 = `edge_tc_kernel<K,
// LAYER, false>`, K2 = `edge_tc_kernel<K, TAIL_SUM, false>`. The flat
// layout keeps
// every array as (rows, B*H): a slot row of batch element b is H
// floats at column b*H (H = NLT_H, the width a library is built for).
//
// Bound on this card: the bytes. K3 at GraphLAM's m2m[0], B = 4: 144 MB
// (0.043 ms) against 3 x 3.9 GFLOP at the TF32 peak (0.024 ms). K2 at
// g2m: ~123 MB (the table, ew, rec_rows, virt; 0.037 ms) against 3 x 3.3
// GFLOP (0.020 ms); its sender gather reads a row a slot from a 65 MB
// table that L2 cannot hold. Each warp's chain of dependent steps holds
// both (probes/torch_k3_probe.py); for K2 neither 12 warps, nor 16 with
// ew read into registers and the sender rows double-buffered, was faster
// (probes/torch_k1k2_probe.py).
//
// Each has a float and a bf16 instance (`edge_tc_kernel<..., T>`): the
// `_bf16` entries take and give bf16 table, ew / edge_rep, rec_rows,
// edge_out and virt (the bf16 forecast path), with fp32 math inside.
#include "edge_tc.cuh"

using bf16 = __nv_bfloat16;

// K2. virt (n_virt, B*H).
extern "C" int nlt_edge_tail_sum(const float* table, const int* senders,
                                 const float* ew, const float* rec_rows,
                                 const float* mask, const float* params,
                                 float* virt, int n_virt, int K, int B,
                                 int device, void* stream) {
  return tc_dispatch<TAIL_SUM, false, float>(
      table, senders, ew, rec_rows, mask, params, nullptr, virt, n_virt, K, B,
      0, device, stream);
}

// K3. edge_out (n_virt*K, B*H), virt (n_virt, B*H).
extern "C" int nlt_edge_layer(const float* edge_rep, const float* table,
                              const int* senders, const float* rec_rows,
                              const float* mask, const float* params,
                              float* edge_out, float* virt, int n_virt, int K,
                              int B, int device, void* stream) {
  return tc_dispatch<LAYER, false, float>(
      table, senders, edge_rep, rec_rows, mask, params, edge_out, virt, n_virt,
      K, B, 0, device, stream);
}

// K2, bf16 instance.
extern "C" int nlt_edge_tail_sum_bf16(const bf16* table, const int* senders,
                                      const bf16* ew, const bf16* rec_rows,
                                      const float* mask, const float* params,
                                      bf16* virt, int n_virt, int K, int B,
                                      int device, void* stream) {
  return tc_dispatch<TAIL_SUM, false, bf16>(
      table, senders, ew, rec_rows, mask, params, nullptr, virt, n_virt, K, B,
      0, device, stream);
}

// K3, bf16 instance.
extern "C" int nlt_edge_layer_bf16(const bf16* edge_rep, const bf16* table,
                                   const int* senders, const bf16* rec_rows,
                                   const float* mask, const float* params,
                                   bf16* edge_out, bf16* virt, int n_virt,
                                   int K, int B, int device, void* stream) {
  return tc_dispatch<LAYER, false, bf16>(
      table, senders, edge_rep, rec_rows, mask, params, edge_out, virt, n_virt,
      K, B, 0, device, stream);
}
