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
// X1 = silu(x0) and DY = d_y to a scratch, each (M*B, H) with row
// (v*K + k)*B + b, and the weight-gradient pass (csrc/weight_grad.cu,
// `xtd_sum`) sums dW2 = X1^T DY and, for B3, dW_e = edge^T d_x0
// (edge_rep and d_x0 viewed (M*B, H) have that row order as they are).
// So a chain has no block-wide step after its weight load: each warp
// stages only its own rows, in two K x H buffers that its products take
// in turn, and walks its rows on its own; warps per block are set by K
// (`layer_warps`), one block per SM. Bound (fp32 CUDA cores, bench
// shapes): operations -- two (B2) or four (B3) HxH products per slot
// and batch element, plus the scratch's two (M*B, H) tensors written
// once. What holds the chains is the shared-memory traffic of
// `cols_mm`: a weight load and input broadcasts per k for few FFMAs.
//
// Widths (NLT_H, one library a width; common.cuh's `Cols` split: a lane
// holds 1, 2 or 4 features of a row at 32, 64, 128). At 32 and 64 every
// matrix sits in shared memory, the transposed ones transposed as they
// are loaded. At 128 W2 and W2^T take 128 KB, and B3's W_e and W_e^T
// another 128 KB, more than a block may hold beside its staging buffers:
// B3 reads W_e and W_e^T from device memory (L2 holds them; the wrapper
// appends W_e^T to the blob at this width), and both chains run fewer
// warps (`layer_warps`), each lane holding twice the features.
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
// W_e in shared memory (widths 32 and 64) or read from device memory (128)
constexpr bool kWeShared = NLT_H <= 64;

// Warps per block of both chain kernels: as many as the registers allow,
// one block per SM. ptxas of B3/B4's chain at width 64, unbounded (256
// threads a block): 56, 71, 90, 106, 118, 129, 145 and 161 registers at K
// = 1..8; a block of 32, 24 and 16 warps caps them at 64, 80 and 128. At
// 128 a lane holds twice the features, so half the warps. B2's chain
// needs fewer (chip_smoke.py prints both per K and width).
template <int K>
__host__ __device__ constexpr int layer_warps() {
  return (K == 1 ? 32 : K == 2 ? 24 : 16) / (NLT_H > 64 ? 2 : 1);
}

// ------------------------------------------------------ B2's chain pass ----

// Parameter blob (floats), as csrc/edge_flat.cu's K2 reads it:
//   w2[H*H] | b2 | ls | lb
// Shared memory: w2 | w2^T | the vectors | per warp two K x H staging
// buffers and a K x H buffer of its row's d_ew sums over b (in registers
// they spill at K = 7 and 8). The block's vector sums come out in this
// order:
enum { T_B2, T_LS, T_LB, N_TAIL_VEC };

template <int K>
__host__ __device__ constexpr size_t tail_smem_floats() {
  return 2 * HH + N_TAIL_VEC * NLT_H +
         (size_t)layer_warps<K>() * 3 * K * NLT_H;
}

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
                         float* __restrict__ x1_s,  // (M*B, H)
                         float* __restrict__ dy_s,  // (M*B, H)
                         float* __restrict__ partial, int n_virt, int B) {
  constexpr int kWarps = layer_warps<K>();
  static_assert(sizeof(float) * tail_smem_floats<K>() <= 232448,
                "shared memory of a block");
  static_assert(kWarps * N_TAIL_VEC * NLT_H <= tail_smem_floats<K>(),
                "the vector sums reuse the block's shared memory");
  extern __shared__ __align__(16) float smem[];
  float* w2 = smem;
  float* w2t = w2 + HH;
  float* vec = w2t + HH;
  nlt_load_params(w2, params, HH);
  nlt_load_params(vec, params + HH, N_TAIL_VEC * NLT_H);
  nlt_load_transposed(w2t, params);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int W = B * NLT_H;
  const Cols zero = cols_fill(0.f);
  const Cols b2v = cols_ld(vec + T_B2 * NLT_H, lane);
  const Cols lsv = cols_ld(vec + T_LS * NLT_H, lane);
  Cols vsum[N_TAIL_VEC];  // this lane's shares of db2, dls, dlb
  cols_fill(vsum, zero);
  // this warp's staging buffers (x1 rows, then d_y rows) and d_ew sums;
  // a lane touches only its own columns of the sums
  float* sa = vec + N_TAIL_VEC * NLT_H + warp * 3 * K * NLT_H;
  float* sb = sa + K * NLT_H;
  float* sd = sb + K * NLT_H;

  for (int v = blockIdx.x * kWarps + warp; v < n_virt;
       v += gridDim.x * kWarps) {
    const size_t slot0 = (size_t)v * K;
#pragma unroll
    for (int k = 0; k < K; ++k) cols_st(sd + k * NLT_H, lane, zero);
    for (int b = 0; b < B; ++b) {
      const size_t col = (size_t)b * NLT_H;
      const Cols rec = cols_ldt(rec_rows + (size_t)v * W + col, lane);
      // x0 = ew + table[senders] + rec;  y = silu(x0) @ W2 + b2  (sa: x1)
      Cols x0[K];
#pragma unroll
      for (int k = 0; k < K; ++k)
        x0[k] = cols_ldt(ew + (slot0 + k) * NLT_H, lane);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int s = senders[slot0 + k];
        const Cols g = cols_ldt(table + (size_t)s * W + col, lane);
        x0[k] = cols_add(cols_add(x0[k], g), rec);
        const Cols x1 = cols_silu(x0[k]);
        cols_st(sa + k * NLT_H, lane, x1);
        cols_stcs(x1_s + ((slot0 + k) * B + b) * NLT_H, lane, x1);
      }
      __syncwarp();
      Cols y[K];
      cols_fill(y, b2v);
      cols_mm<K>(sa, NLT_H, w2, NLT_H, lane, y);
      // d_y, LayerNorm backward   (sb: d_y rows)
      const Cols dv = cols_ldt(d_virt + (size_t)v * W + col, lane);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const Cols dmsg = cols_scale(mask[slot0 + k], dv);
        const Cols dy = nlt_ln_grad(nlt_ln_stats(y[k]), lsv, dmsg,
                                    vsum[T_LS], vsum[T_LB]);
        cols_acc(vsum[T_B2], dy);
        cols_st(sb + k * NLT_H, lane, dy);
        cols_stcs(dy_s + ((slot0 + k) * B + b) * NLT_H, lane, dy);
      }
      __syncwarp();
      // d_x0 = (d_y @ W2^T) * silu'(x0), d_rec = sum_k d_x0
      Cols dx1[K];
      cols_fill(dx1, zero);
      cols_mm<K>(sb, NLT_H, w2t, NLT_H, lane, dx1);
      Cols drec = zero;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const Cols d0 = cols_mul_silu_grad(dx1[k], x0[k]);
        cols_acc(drec, d0);
        cols_st(sd + k * NLT_H, lane,
                cols_add(cols_ld(sd + k * NLT_H, lane), d0));
        cols_stt(d_x0 + (slot0 + k) * W + col, lane, d0);
      }
      cols_stt(d_rec + (size_t)v * W + col, lane, drec);
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
      cols_stt(d_ew + (slot0 + k) * NLT_H, lane,
               cols_ld(sd + k * NLT_H, lane));
  }

  __syncthreads();  // every warp is done with shared memory: the sums reuse it
  nlt_block_vec_sums<N_TAIL_VEC>(
      smem, vsum, kWarps, partial + (size_t)blockIdx.x * N_TAIL_VEC * NLT_H);
}

// ------------------------------------------------- B3/B4's chain pass ----

// Parameter blob (floats), as csrc/edge_flat.cu's K3 reads it, and at
// width 128 W_e^T after it:
//   w2[H*H] | b2 | ls | lb | we[H*H] | b0 (| wet[H*H])
// Shared memory: w2 | w2^T | (widths 32, 64: we | we^T) | the vectors |
// per warp two K x H staging buffers. The block's vector sums come out in
// this order:
enum { V_B2, V_LS, V_LB, V_B0, N_VEC };
constexpr int kBlobWe = HH + 3 * NLT_H;       // we in the blob
constexpr int kBlobWet = 2 * HH + 4 * NLT_H;  // wet in the blob (128)
constexpr int kSmemW = kWeShared ? 4 * HH : 2 * HH;

template <int K>
__host__ __device__ constexpr size_t layer_smem_floats() {
  return kSmemW + N_VEC * NLT_H + (size_t)layer_warps<K>() * 2 * K * NLT_H;
}

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
                          float* __restrict__ x1_s,  // (M*B, H)
                          float* __restrict__ dy_s,  // (M*B, H)
                          float* __restrict__ partial, int n_virt, int B) {
  constexpr int kWarps = layer_warps<K>();
  static_assert(sizeof(float) * layer_smem_floats<K>() <= 232448,
                "shared memory of a block");
  static_assert(kWarps * N_VEC * NLT_H <= layer_smem_floats<K>(),
                "the vector sums reuse the block's shared memory");
  extern __shared__ __align__(16) float smem[];
  float* w2 = smem;
  float* w2t = w2 + HH;
  float* vec = smem + kSmemW;
  nlt_load_params(w2, params, HH);
  nlt_load_transposed(w2t, params);
  // the weight of x0 = edge @ W_e and of d_edge = d_x0 @ W_e^T
  const float* we = params + kBlobWe;
  const float* wet = params + kBlobWet;
  if constexpr (kWeShared) {
    nlt_load_params(w2t + HH, we, HH);
    nlt_load_transposed(w2t + 2 * HH, we);
    we = w2t + HH;
    wet = w2t + 2 * HH;
  }
  // b2, ls, lb follow w2 in the blob; b0 follows we
  for (int i = threadIdx.x; i < N_VEC * NLT_H; i += blockDim.x)
    vec[i] = params[i < 3 * NLT_H ? HH + i : 2 * HH + i];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int W = B * NLT_H;
  const Cols zero = cols_fill(0.f);
  const Cols b2v = cols_ld(vec + V_B2 * NLT_H, lane);
  const Cols lsv = cols_ld(vec + V_LS * NLT_H, lane);
  const Cols b0v = cols_ld(vec + V_B0 * NLT_H, lane);
  Cols vsum[N_VEC];  // this lane's shares of db2, dls, dlb, db0
  cols_fill(vsum, zero);
  // this warp's staging buffers: the four products take them in turn
  float* sa = vec + N_VEC * NLT_H + warp * 2 * K * NLT_H;
  float* sb = sa + K * NLT_H;

  for (int v = blockIdx.x * kWarps + warp; v < n_virt;
       v += gridDim.x * kWarps) {
    const size_t slot0 = (size_t)v * K;
    for (int b = 0; b < B; ++b) {
      const size_t col = (size_t)b * NLT_H;
      const Cols rec = cols_ldt(rec_rows + (size_t)v * W + col, lane);
      // x0 = edge @ W_e + b0 + table[senders] + rec   (sa: edge rows)
#pragma unroll
      for (int k = 0; k < K; ++k)
        cols_st(sa + k * NLT_H, lane,
                cols_ldt(edge_rep + (slot0 + k) * W + col, lane));
      __syncwarp();
      Cols x0[K];
      cols_fill(x0, b0v);
      cols_mm<K>(sa, NLT_H, we, NLT_H, lane, x0);
      // y = silu(x0) @ W2 + b2   (sb: x1 rows)
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int s = senders[slot0 + k];
        const Cols g = cols_ldt(table + (size_t)s * W + col, lane);
        x0[k] = cols_add(cols_add(x0[k], g), rec);
        const Cols x1 = cols_silu(x0[k]);
        cols_st(sb + k * NLT_H, lane, x1);
        cols_stcs(x1_s + ((slot0 + k) * B + b) * NLT_H, lane, x1);
      }
      __syncwarp();
      Cols y[K];
      cols_fill(y, b2v);
      cols_mm<K>(sb, NLT_H, w2, NLT_H, lane, y);
      // d_y, LayerNorm backward   (sa: d_y rows)
      const Cols dv = cols_ldt(d_virt + (size_t)v * W + col, lane);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        Cols dmsg = cols_scale(mask[slot0 + k], dv);
        if (d_edge_out != nullptr)
          cols_acc(dmsg, cols_ldt(d_edge_out + (slot0 + k) * W + col, lane));
        const Cols dy = nlt_ln_grad(nlt_ln_stats(y[k]), lsv, dmsg,
                                    vsum[V_LS], vsum[V_LB]);
        cols_acc(vsum[V_B2], dy);
        cols_st(sa + k * NLT_H, lane, dy);
        cols_stcs(dy_s + ((slot0 + k) * B + b) * NLT_H, lane, dy);
      }
      __syncwarp();
      // d_x0 = (d_y @ W2^T) * silu'(x0), d_rec = sum_k d_x0   (sb: d_x0)
      Cols dx1[K];
      cols_fill(dx1, zero);
      cols_mm<K>(sa, NLT_H, w2t, NLT_H, lane, dx1);
      Cols drec = zero;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const Cols d0 = cols_mul_silu_grad(dx1[k], x0[k]);
        cols_acc(drec, d0);
        cols_acc(vsum[V_B0], d0);
        cols_stt(d_x0 + (slot0 + k) * W + col, lane, d0);
        if (d_x0_f != nullptr)
          cols_st(d_x0_f + (slot0 + k) * W + col, lane, d0);
        cols_st(sb + k * NLT_H, lane, d0);
      }
      cols_stt(d_rec + (size_t)v * W + col, lane, drec);
      __syncwarp();
      // d_edge = d_edge_out + d_x0 @ W_e^T
      Cols de[K];
      cols_fill(de, zero);
      cols_mm<K>(sb, NLT_H, wet, NLT_H, lane, de);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const size_t at = (slot0 + k) * W + col;
        if (d_edge_out != nullptr)
          cols_acc(de[k], cols_ldt(d_edge_out + at, lane));
        cols_stt(d_edge + at, lane, de[k]);
      }
    }
  }

  __syncthreads();  // every warp is done with shared memory: the sums reuse it
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

// B2's chain pass. d_virt (n_virt, B*H) -> d_x0 (M, B*H), d_ew (M, H),
// d_rec (n_virt, B*H), the scratch x1_s and dy_s (M*B, H) each (see
// above), and partial (grid, 3*H): each block's sums of db2, dls, dlb.
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

// B3/B4's chain pass. d_virt (n_virt, B*H), d_edge_out (M, B*H) or null
// -> d_x0, d_edge (M, B*H), d_rec (n_virt, B*H), the scratch x1_s and
// dy_s (M*B, H) each (see above), and partial (grid, 4*H): each block's
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
// d_edge_out, d_x0, d_edge and d_rec in bf16; d_x0_f (M, B*H) fp32
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
