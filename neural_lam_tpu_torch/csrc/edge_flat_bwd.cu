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
// Both recompute the forward of csrc/edge_flat.cu per (virtual row v, batch
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
// In both, one warp owns one virtual row v and walks its batch elements,
// so the per-slot sum over b (d_ew, kept in the warp's shared memory) and
// over k (d_rec, in registers) need no other warp,
// and the vector gradients are summed per block (`nlt_block_vec_sums`)
// into a row of a (blocks, n) scratch that the caller sums in a fixed
// order (no float atomics). W2 (and W_e) sit in shared memory as given and
// transposed, so the backward products read them as the forward does.
//
// Both run in two passes. These kernels are the chain passes: each writes
// X1 = silu(x0) and DY = d_y to a scratch, each (M*B, 64) with row
// (v*K + k)*B + b, and the weight-gradient pass (csrc/weight_grad.cu,
// `xtd_sum`) sums dW2 = X1^T DY and, for B3, dW_e = edge^T d_x0
// (edge_rep and d_x0 viewed (M*B, 64) have that row order as they are).
// So a chain has no block-wide step after its weight load: each warp
// stages only its own rows, in two K x 64 buffers that its products take
// in turn, and walks its rows on its own; warps per block are set by K
// (`layer_warps`), one block per SM. Bound (fp32 CUDA cores, bench
// shapes): operations -- two (B2) or four (B3) 64x64 products per slot
// and batch element, plus the scratch's two (M*B, 64) tensors written
// once. What holds the chains is the shared-memory traffic of
// `nlt_mm64`: a weight load and input broadcasts per k for few FFMAs.
//
// bf16 instances (`<K, __nv_bfloat16>`, entries nlt_*_bwd_bf16; the bf16
// training path): table, ew or edge_rep, rec_rows, d_virt and d_edge_out
// are read in bf16 through `Io<T>` and widened, the chain runs in fp32 as
// above, and d_x0, d_ew, d_edge and d_rec are stored in bf16, each rounded
// once from its fp32 value, as the JAX kernels store them in their inputs'
// dtype. X1, DY and the vector sums stay fp32; so does the d_x0 of B3's
// dW_e pair, which B3's bf16 instance writes a second time, unrounded, to
// d_x0_f (the JAX kernel sums dW_e from its fp32 d_x0, while its stored
// d_gathered, which the sender fold sums, is bf16). Same plain loads,
// same design: only the types of what is loaded and stored change.
#include "bwd_common.cuh"

namespace {

constexpr int HH = NLT_H * NLT_H;

// Warps per block of both chain kernels: as many as the registers allow,
// one block per SM. ptxas of B3/B4's chain, unbounded (256 threads a
// block): 56, 71, 90, 106, 118, 129, 145 and 161 registers at K = 1..8; a
// block of 32, 24 and 16 warps caps them at 64, 80 and 128. B2's chain
// needs fewer (chip_smoke.py prints both per K).
template <int K>
__host__ __device__ constexpr int layer_warps() {
  return K == 1 ? 32 : K == 2 ? 24 : 16;
}

// ------------------------------------------------------ B2's chain pass ----

// Parameter blob (floats), as csrc/edge_flat.cu's K2 reads it:
//   w2[64*64] | b2 | ls | lb
// Shared memory: w2 | w2^T | the vectors | per warp two K x 64 staging
// buffers and a K x 64 buffer of its row's d_ew sums over b (in registers
// they spill at K = 7 and 8). The block's vector sums come out in this
// order:
enum { T_B2, T_LS, T_LB, N_TAIL_VEC };

template <int K>
__host__ __device__ constexpr size_t tail_smem_floats() {
  return 2 * HH + N_TAIL_VEC * NLT_H + (size_t)layer_warps<K>() * 3 * K * NLT_H;
}
static_assert(32 * N_TAIL_VEC * NLT_H <= 2 * HH,
              "the vector sums reuse the weight region");

template <int K, typename T>
__global__ void __launch_bounds__(layer_warps<K>() * 32, 1)
    edge_tail_bwd_kernel(const T* __restrict__ table,
                         const int* __restrict__ senders,
                         const T* __restrict__ ew,
                         const T* __restrict__ rec_rows,
                         const float* __restrict__ mask,
                         const float* __restrict__ params,
                         const T* __restrict__ d_virt,
                         T* __restrict__ d_x0, T* __restrict__ d_ew,
                         T* __restrict__ d_rec,
                         float* __restrict__ x1_s,  // (M*B, 64)
                         float* __restrict__ dy_s,  // (M*B, 64)
                         float* __restrict__ partial, int n_virt, int B) {
  constexpr int kWarps = layer_warps<K>();
  static_assert(sizeof(float) * tail_smem_floats<K>() <= 232448,
                "shared memory of a block");
  extern __shared__ __align__(16) float smem[];
  float* w2 = smem;
  float* w2t = w2 + HH;
  float* vec = w2t + HH;
  for (int i = threadIdx.x; i < HH; i += blockDim.x) w2[i] = params[i];
  for (int i = threadIdx.x; i < N_TAIL_VEC * NLT_H; i += blockDim.x)
    vec[i] = params[HH + i];
  nlt_load_transposed(w2t, params);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int W = B * NLT_H;
  const float2 zero = make_float2(0.f, 0.f);
  const float2 b2v = nlt_ld2(vec + T_B2 * NLT_H, lane);
  const float2 lsv = nlt_ld2(vec + T_LS * NLT_H, lane);
  float2 vsum[N_TAIL_VEC];  // this lane's shares of db2, dls, dlb
  nlt_fill(vsum, zero);
  // this warp's staging buffers (x1 rows, then d_y rows) and d_ew sums;
  // a lane touches only its own two columns of the sums
  float* sa = vec + N_TAIL_VEC * NLT_H + warp * 3 * K * NLT_H;
  float* sb = sa + K * NLT_H;
  float* sd = sb + K * NLT_H;
  // this lane's two features of scratch row r (streaming store)
  auto put = [&](float* base, size_t r, float2 val) {
    __stcs(reinterpret_cast<float2*>(base + r * NLT_H) + lane, val);
  };

  for (int v = blockIdx.x * kWarps + warp; v < n_virt;
       v += gridDim.x * kWarps) {
    const size_t slot0 = (size_t)v * K;
#pragma unroll
    for (int k = 0; k < K; ++k) nlt_st2(sd + k * NLT_H, lane, zero);
    for (int b = 0; b < B; ++b) {
      const size_t col = (size_t)b * NLT_H;
      const float2 rec = nlt_ld2t(rec_rows + (size_t)v * W + col, lane);
      // x0 = ew + table[senders] + rec;  y = silu(x0) @ W2 + b2  (sa: x1)
      float2 x0[K];
#pragma unroll
      for (int k = 0; k < K; ++k)
        x0[k] = nlt_ld2t(ew + (slot0 + k) * NLT_H, lane);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int s = senders[slot0 + k];
        const float2 g = nlt_ld2t(table + (size_t)s * W + col, lane);
        x0[k] = nlt_add2(nlt_add2(x0[k], g), rec);
        const float2 x1 = nlt_silu2(x0[k]);
        nlt_st2(sa + k * NLT_H, lane, x1);
        put(x1_s, (slot0 + k) * B + b, x1);
      }
      __syncwarp();
      float2 y[K];
      nlt_fill(y, b2v);
      nlt_mm64<K>(sa, NLT_H, w2, NLT_H, lane, y);
      // d_y, LayerNorm backward   (sb: d_y rows)
      const float2 dv = nlt_ld2t(d_virt + (size_t)v * W + col, lane);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float m = mask[slot0 + k];
        const float2 dmsg = make_float2(m * dv.x, m * dv.y);
        const float2 dy = nlt_ln_grad(nlt_ln_stats(y[k]), lsv, dmsg,
                                      vsum[T_LS], vsum[T_LB]);
        nlt_acc2(vsum[T_B2], dy);
        nlt_st2(sb + k * NLT_H, lane, dy);
        put(dy_s, (slot0 + k) * B + b, dy);
      }
      __syncwarp();
      // d_x0 = (d_y @ W2^T) * silu'(x0), d_rec = sum_k d_x0
      float2 dx1[K];
      nlt_fill(dx1, zero);
      nlt_mm64<K>(sb, NLT_H, w2t, NLT_H, lane, dx1);
      float2 drec = zero;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float2 d0 = nlt_mul_silu_grad(dx1[k], x0[k]);
        nlt_acc2(drec, d0);
        nlt_st2(sd + k * NLT_H, lane,
                nlt_add2(nlt_ld2(sd + k * NLT_H, lane), d0));
        nlt_st2t(d_x0 + (slot0 + k) * W + col, lane, d0);
      }
      nlt_st2t(d_rec + (size_t)v * W + col, lane, drec);
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
      nlt_st2t(d_ew + (slot0 + k) * NLT_H, lane,
               nlt_ld2(sd + k * NLT_H, lane));
  }

  __syncthreads();  // every warp is done with the weights: the sums reuse them
  nlt_block_vec_sums<N_TAIL_VEC>(
      smem, vsum, kWarps, partial + (size_t)blockIdx.x * N_TAIL_VEC * NLT_H);
}

// ------------------------------------------------- B3/B4's chain pass ----

// Parameter blob (floats), as csrc/edge_flat.cu reads it:
//   w2[64*64] | b2 | ls | lb | we[64*64] | b0
// Shared memory: w2 | we | w2^T | we^T | the vectors | per warp two K x 64
// staging buffers. The block's vector sums come out in this order:
enum { V_B2, V_LS, V_LB, V_B0, N_VEC };

template <int K>
__host__ __device__ constexpr size_t layer_smem_floats() {
  return 4 * HH + N_VEC * NLT_H + (size_t)layer_warps<K>() * 2 * K * NLT_H;
}
static_assert(32 * N_VEC * NLT_H <= 4 * HH,
              "the vector sums reuse the weight region");

template <int K, typename T>
__global__ void __launch_bounds__(layer_warps<K>() * 32, 1)
    edge_layer_bwd_kernel(const T* __restrict__ edge_rep,
                          const T* __restrict__ table,
                          const int* __restrict__ senders,
                          const T* __restrict__ rec_rows,
                          const float* __restrict__ mask,
                          const float* __restrict__ params,
                          const T* __restrict__ d_virt,
                          const T* __restrict__ d_edge_out,  // or null
                          T* __restrict__ d_x0,
                          float* __restrict__ d_x0_f,  // or null
                          T* __restrict__ d_edge,
                          T* __restrict__ d_rec,
                          float* __restrict__ x1_s,  // (M*B, 64)
                          float* __restrict__ dy_s,  // (M*B, 64)
                          float* __restrict__ partial, int n_virt, int B) {
  constexpr int kWarps = layer_warps<K>();
  static_assert(sizeof(float) * layer_smem_floats<K>() <= 232448,
                "shared memory of a block");
  extern __shared__ __align__(16) float smem[];
  float* w2 = smem;
  float* we = w2 + HH;
  float* w2t = we + HH;
  float* wet = w2t + HH;
  float* vec = wet + HH;
  for (int i = threadIdx.x; i < HH; i += blockDim.x) {
    w2[i] = params[i];
    we[i] = params[HH + 3 * NLT_H + i];
  }
  // b2, ls, lb follow w2 in the blob; b0 follows we
  for (int i = threadIdx.x; i < N_VEC * NLT_H; i += blockDim.x)
    vec[i] = params[i < 3 * NLT_H ? HH + i : 2 * HH + i];
  nlt_load_transposed(w2t, params);
  nlt_load_transposed(wet, params + HH + 3 * NLT_H);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int W = B * NLT_H;
  const float2 zero = make_float2(0.f, 0.f);
  const float2 b2v = nlt_ld2(vec + V_B2 * NLT_H, lane);
  const float2 lsv = nlt_ld2(vec + V_LS * NLT_H, lane);
  const float2 b0v = nlt_ld2(vec + V_B0 * NLT_H, lane);
  float2 vsum[N_VEC];  // this lane's shares of db2, dls, dlb, db0
  nlt_fill(vsum, zero);
  // this warp's staging buffers: the four products take them in turn
  float* sa = vec + N_VEC * NLT_H + warp * 2 * K * NLT_H;
  float* sb = sa + K * NLT_H;
  // this lane's two features of scratch row r (streaming store)
  auto put = [&](float* base, size_t r, float2 val) {
    __stcs(reinterpret_cast<float2*>(base + r * NLT_H) + lane, val);
  };

  for (int v = blockIdx.x * kWarps + warp; v < n_virt;
       v += gridDim.x * kWarps) {
    const size_t slot0 = (size_t)v * K;
    for (int b = 0; b < B; ++b) {
      const size_t col = (size_t)b * NLT_H;
      const float2 rec = nlt_ld2t(rec_rows + (size_t)v * W + col, lane);
      // x0 = edge @ W_e + b0 + table[senders] + rec   (sa: edge rows)
#pragma unroll
      for (int k = 0; k < K; ++k)
        nlt_st2(sa + k * NLT_H, lane,
                nlt_ld2t(edge_rep + (slot0 + k) * W + col, lane));
      __syncwarp();
      float2 x0[K];
      nlt_fill(x0, b0v);
      nlt_mm64<K>(sa, NLT_H, we, NLT_H, lane, x0);
      // y = silu(x0) @ W2 + b2   (sb: x1 rows)
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int s = senders[slot0 + k];
        const float2 g = nlt_ld2t(table + (size_t)s * W + col, lane);
        x0[k] = nlt_add2(nlt_add2(x0[k], g), rec);
        const float2 x1 = nlt_silu2(x0[k]);
        nlt_st2(sb + k * NLT_H, lane, x1);
        put(x1_s, (slot0 + k) * B + b, x1);
      }
      __syncwarp();
      float2 y[K];
      nlt_fill(y, b2v);
      nlt_mm64<K>(sb, NLT_H, w2, NLT_H, lane, y);
      // d_y, LayerNorm backward   (sa: d_y rows)
      const float2 dv = nlt_ld2t(d_virt + (size_t)v * W + col, lane);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float m = mask[slot0 + k];
        float2 dmsg = make_float2(m * dv.x, m * dv.y);
        if (d_edge_out != nullptr)
          nlt_acc2(dmsg, nlt_ld2t(d_edge_out + (slot0 + k) * W + col, lane));
        const float2 dy = nlt_ln_grad(nlt_ln_stats(y[k]), lsv, dmsg,
                                      vsum[V_LS], vsum[V_LB]);
        nlt_acc2(vsum[V_B2], dy);
        nlt_st2(sa + k * NLT_H, lane, dy);
        put(dy_s, (slot0 + k) * B + b, dy);
      }
      __syncwarp();
      // d_x0 = (d_y @ W2^T) * silu'(x0), d_rec = sum_k d_x0   (sb: d_x0)
      float2 dx1[K];
      nlt_fill(dx1, zero);
      nlt_mm64<K>(sa, NLT_H, w2t, NLT_H, lane, dx1);
      float2 drec = zero;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float2 d0 = nlt_mul_silu_grad(dx1[k], x0[k]);
        nlt_acc2(drec, d0);
        nlt_acc2(vsum[V_B0], d0);
        nlt_st2t(d_x0 + (slot0 + k) * W + col, lane, d0);
        if (d_x0_f != nullptr)
          nlt_st2(d_x0_f + (slot0 + k) * W + col, lane, d0);
        nlt_st2(sb + k * NLT_H, lane, d0);
      }
      nlt_st2t(d_rec + (size_t)v * W + col, lane, drec);
      __syncwarp();
      // d_edge = d_edge_out + d_x0 @ W_e^T
      float2 de[K];
      nlt_fill(de, zero);
      nlt_mm64<K>(sb, NLT_H, wet, NLT_H, lane, de);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const size_t at = (slot0 + k) * W + col;
        if (d_edge_out != nullptr)
          nlt_acc2(de[k], nlt_ld2t(d_edge_out + at, lane));
        nlt_st2t(d_edge + at, lane, de[k]);
      }
    }
  }

  __syncthreads();  // every warp is done with the weights: the sums reuse them
  nlt_block_vec_sums<N_VEC>(smem, vsum, kWarps,
                            partial + (size_t)blockIdx.x * N_VEC * NLT_H);
}

// ------------------------------------------------------------ launches ----

template <int K, typename T>
cudaError_t tail_grid_for(int n_virt, int* grid) {
  return nlt_launch_config(edge_tail_bwd_kernel<K, T>, layer_warps<K>() * 32,
                           sizeof(float) * tail_smem_floats<K>(),
                           (n_virt + layer_warps<K>() - 1) / layer_warps<K>(),
                           grid);
}

template <int K, typename T>
cudaError_t layer_grid_for(int n_virt, int* grid) {
  return nlt_launch_config(edge_layer_bwd_kernel<K, T>, layer_warps<K>() * 32,
                           sizeof(float) * layer_smem_floats<K>(),
                           (n_virt + layer_warps<K>() - 1) / layer_warps<K>(),
                           grid);
}

template <int K, typename T>
cudaError_t tail_launch(const T* table, const int* senders, const T* ew,
                        const T* rec_rows, const float* mask,
                        const float* params, const T* d_virt, T* d_x0,
                        T* d_ew, T* d_rec, float* x1_s, float* dy_s,
                        float* partial, int n_virt, int B, int grid,
                        cudaStream_t stream) {
  const size_t smem = sizeof(float) * tail_smem_floats<K>();
  cudaError_t err = nlt_allow_smem(edge_tail_bwd_kernel<K, T>, smem);
  if (err != cudaSuccess) return err;
  edge_tail_bwd_kernel<K, T><<<grid, layer_warps<K>() * 32, smem, stream>>>(
      table, senders, ew, rec_rows, mask, params, d_virt, d_x0, d_ew, d_rec,
      x1_s, dy_s, partial, n_virt, B);
  return cudaGetLastError();
}

template <int K, typename T>
cudaError_t layer_launch(const T* edge_rep, const T* table,
                         const int* senders, const T* rec_rows,
                         const float* mask, const float* params,
                         const T* d_virt, const T* d_edge_out, T* d_x0,
                         float* d_x0_f, T* d_edge, T* d_rec, float* x1_s,
                         float* dy_s, float* partial, int n_virt, int B,
                         int grid, cudaStream_t stream) {
  const size_t smem = sizeof(float) * layer_smem_floats<K>();
  cudaError_t err = nlt_allow_smem(edge_layer_bwd_kernel<K, T>, smem);
  if (err != cudaSuccess) return err;
  edge_layer_bwd_kernel<K, T><<<grid, layer_warps<K>() * 32, smem, stream>>>(
      edge_rep, table, senders, rec_rows, mask, params, d_virt, d_edge_out,
      d_x0, d_x0_f, d_edge, d_rec, x1_s, dy_s, partial, n_virt, B);
  return cudaGetLastError();
}

template <typename T>
int tail_grid(int n_virt, int K, int device, int* grid) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_virt < 1) return (int)cudaErrorInvalidValue;
#define NLT_CASE(KK) \
  case KK:           \
    return (int)tail_grid_for<KK, T>(n_virt, grid);
  switch (K) {
    NLT_FOR_K(NLT_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NLT_CASE
}

template <typename T>
int layer_grid(int n_virt, int K, int device, int* grid) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_virt < 1) return (int)cudaErrorInvalidValue;
#define NLT_CASE(KK) \
  case KK:           \
    return (int)layer_grid_for<KK, T>(n_virt, grid);
  switch (K) {
    NLT_FOR_K(NLT_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NLT_CASE
}

template <typename T>
int tail_bwd(const T* table, const int* senders, const T* ew,
             const T* rec_rows, const float* mask, const float* params,
             const T* d_virt, T* d_x0, T* d_ew, T* d_rec, float* x1_s,
             float* dy_s, float* partial, int n_virt, int K, int B, int grid,
             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_virt < 1 || grid < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define NLT_CASE(KK)                                                      \
  case KK:                                                                \
    return (int)tail_launch<KK, T>(table, senders, ew, rec_rows, mask,    \
                                   params, d_virt, d_x0, d_ew, d_rec,     \
                                   x1_s, dy_s, partial, n_virt, B, grid,  \
                                   s);
  switch (K) {
    NLT_FOR_K(NLT_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NLT_CASE
}

template <typename T>
int layer_bwd(const T* edge_rep, const T* table, const int* senders,
              const T* rec_rows, const float* mask, const float* params,
              const T* d_virt, const T* d_edge_out, T* d_x0, float* d_x0_f,
              T* d_edge, T* d_rec, float* x1_s, float* dy_s, float* partial,
              int n_virt, int K, int B, int grid, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_virt < 1 || grid < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define NLT_CASE(KK)                                                        \
  case KK:                                                                  \
    return (int)layer_launch<KK, T>(edge_rep, table, senders, rec_rows,     \
                                    mask, params, d_virt, d_edge_out, d_x0, \
                                    d_x0_f, d_edge, d_rec, x1_s, dy_s,      \
                                    partial, n_virt, B, grid, s);
  switch (K) {
    NLT_FOR_K(NLT_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NLT_CASE
}

using bf16 = __nv_bfloat16;

}  // namespace

// Blocks of nlt_edge_tail_sum_bwd[_bf16] / nlt_edge_layer_bwd[_bf16] for
// these sizes: the rows of their `partial`.
extern "C" int nlt_edge_tail_sum_bwd_grid(int n_virt, int K, int B,
                                          int device, int* grid) {
  return tail_grid<float>(n_virt, K, device, grid);
}

extern "C" int nlt_edge_tail_sum_bwd_bf16_grid(int n_virt, int K, int B,
                                               int device, int* grid) {
  return tail_grid<bf16>(n_virt, K, device, grid);
}

extern "C" int nlt_edge_layer_bwd_grid(int n_virt, int K, int B, int device,
                                       int* grid) {
  return layer_grid<float>(n_virt, K, device, grid);
}

extern "C" int nlt_edge_layer_bwd_bf16_grid(int n_virt, int K, int B,
                                            int device, int* grid) {
  return layer_grid<bf16>(n_virt, K, device, grid);
}

// B2's chain pass. d_virt (n_virt, B*64) -> d_x0 (M, B*64), d_ew (M, 64),
// d_rec (n_virt, B*64), the scratch x1_s and dy_s (M*B, 64) each (see
// above), and partial (grid, 3*64): each block's sums of db2, dls, dlb.
extern "C" int nlt_edge_tail_sum_bwd(const float* table, const int* senders,
                                     const float* ew, const float* rec_rows,
                                     const float* mask, const float* params,
                                     const float* d_virt, float* d_x0,
                                     float* d_ew, float* d_rec, float* x1_s,
                                     float* dy_s, float* partial, int n_virt,
                                     int K, int B, int grid, int device,
                                     void* stream) {
  return tail_bwd<float>(table, senders, ew, rec_rows, mask, params, d_virt,
                         d_x0, d_ew, d_rec, x1_s, dy_s, partial, n_virt, K,
                         B, grid, device, stream);
}

// B2's chain pass, bf16 instance: table, ew, rec_rows, d_virt, d_x0, d_ew
// and d_rec in bf16; the scratch and partial fp32.
extern "C" int nlt_edge_tail_sum_bwd_bf16(
    const bf16* table, const int* senders, const bf16* ew,
    const bf16* rec_rows, const float* mask, const float* params,
    const bf16* d_virt, bf16* d_x0, bf16* d_ew, bf16* d_rec, float* x1_s,
    float* dy_s, float* partial, int n_virt, int K, int B, int grid,
    int device, void* stream) {
  return tail_bwd<bf16>(table, senders, ew, rec_rows, mask, params, d_virt,
                        d_x0, d_ew, d_rec, x1_s, dy_s, partial, n_virt, K, B,
                        grid, device, stream);
}

// B3/B4's chain pass. d_virt (n_virt, B*64), d_edge_out (M, B*64) or null
// -> d_x0, d_edge (M, B*64), d_rec (n_virt, B*64), the scratch x1_s and
// dy_s (M*B, 64) each (see above), and partial (grid, 4*64): each block's
// sums of db2, dls, dlb, db0. d_x0_f: null here (d_x0 is fp32 already).
extern "C" int nlt_edge_layer_bwd(const float* edge_rep, const float* table,
                                  const int* senders, const float* rec_rows,
                                  const float* mask, const float* params,
                                  const float* d_virt,
                                  const float* d_edge_out, float* d_x0,
                                  float* d_x0_f, float* d_edge, float* d_rec,
                                  float* x1_s, float* dy_s, float* partial,
                                  int n_virt, int K, int B, int grid,
                                  int device, void* stream) {
  return layer_bwd<float>(edge_rep, table, senders, rec_rows, mask, params,
                          d_virt, d_edge_out, d_x0, d_x0_f, d_edge, d_rec,
                          x1_s, dy_s, partial, n_virt, K, B, grid, device,
                          stream);
}

// B3/B4's chain pass, bf16 instance: edge_rep, table, rec_rows, d_virt,
// d_edge_out, d_x0, d_edge and d_rec in bf16; d_x0_f (M, B*64) fp32
// receives d_x0 unrounded, for the dW_e pair.
extern "C" int nlt_edge_layer_bwd_bf16(
    const bf16* edge_rep, const bf16* table, const int* senders,
    const bf16* rec_rows, const float* mask, const float* params,
    const bf16* d_virt, const bf16* d_edge_out, bf16* d_x0, float* d_x0_f,
    bf16* d_edge, bf16* d_rec, float* x1_s, float* dy_s, float* partial,
    int n_virt, int K, int B, int grid, int device, void* stream) {
  if (d_x0_f == nullptr) return (int)cudaErrorInvalidValue;
  return layer_bwd<bf16>(edge_rep, table, senders, rec_rows, mask, params,
                         d_virt, d_edge_out, d_x0, d_x0_f, d_edge, d_rec,
                         x1_s, dy_s, partial, n_virt, K, B, grid, device,
                         stream);
}
