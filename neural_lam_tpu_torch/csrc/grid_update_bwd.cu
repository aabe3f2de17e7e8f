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
// row's mean and rstd) to d_x0 (M, W) per slot, d_ew (M, H) summed over
// b, d_ge (n_ge, W) for the real rows only, the 13 bias, LayerNorm and
// o_b1 gradients, and the rows of the nine weight gradients. Rows v >= n_ge
// read ge as zeros and are neither read nor written past ge's end; padding
// slots (mask 0) get no share of d_agg.
//
// Design, in two passes. This kernel is the chain pass: one warp owns one
// virtual row v and walks its batch elements b, so d_ew's sum over b is a
// register sum; the 12 vector gradients are summed per block
// (`nlt_block_vec_sums`) into one row of a (blocks, 12*H + d_out)
// scratch, which the caller sums in a fixed order (no float atomics), and
// o_b1's, the column sums of d_out, are taken at the end over the block's
// rows (32 columns a pass: any d_out). The weight gradients are not summed
// here: the chain writes each activation / gradient pair they need to a
// scratch in device memory, (rows, H) row major, and the weight-gradient
// pass (csrc/weight_grad.cu, `xtd_sum`) sums X^T D over it. Node rows (row
// v*B + b): T1, GR, AGG, U1, RO, Y, DT1P, DT2, DREC, DU0P, DU2, DY0P; slot
// rows (row (v*K + k)*B + b): X1 = silu(x0), DX2.
//
// Width 64 (and 32): the weights sit in shared memory, two sets taking
// turns in one region: the forward set (the eight 64x64 matrices, 128 KB)
// and the backward set (the same transposed, then H rows of o_w1^T: 144
// KB), copied from blobs the wrapper packs. For each (chunk of rows, b)
// every warp of the block runs its forward recompute on the forward set;
// then the block loads the backward set and every warp runs its backward
// chain, the forward state it needs (x0[K], y2[K], t1p, u0p, y0p,
// LayerNorm statistics, the mask) kept in registers across the swap. The
// output map's backward d_y = d_out @ o_w1^T runs in chunks of H of
// d_out's columns: past the first, each chunk's rows of o_w1^T are loaded
// over the previous chunk's, the block in step (any d_out, as K4). So one
// read of the weights from L2 serves a row per warp of the block: 16 warps
// at K <= 4 and 12 above (what the 227 KB of shared memory and the
// registers allow beside the weights), each staging only the input row of
// its current product and its K slot rows. Bound (fp32 CUDA cores, bench
// shapes): operations -- ~2x the forward's ~11.3 HxH products per node row
// and batch element, plus the scratch's ~1.3 GB (at 64) written once; the
// chain itself is bound by shared memory reads (one weight read and one
// broadcast per NLT_C FMAs per lane).
//
// Width 128: a set is ~590 KB, so the weights are streamed as K4 streams
// them at 128 (csrc/grid_update.cu, `kStream`): each product's HxH matrix
// (the forward's eight, a_w0 as its halves; o_w1^T's chunks; the
// backward's eight, transposed) is copied by cp.async into one of two 64
// KB buffers while the previous product runs from the other, with one
// __syncthreads per product, the block in lockstep. Same warps a block,
// each lane holding 4 of a row's 128 features.
//
// bf16 instance (`<K, __nv_bfloat16>`, entry nlt_grid_update_bwd_bf16; the
// bf16 training path): table, ew, ge and d_out are read in bf16 and
// widened, the chain runs in fp32 as above, and d_x0, d_ew and d_ge are
// stored in bf16, each rounded once from its fp32 value, as the JAX kernel
// stores them in its inputs' dtype. The 12 node and 2 slot scratch tensors
// and the vector sums stay fp32. Same design: only the types of what is
// loaded and stored change.
#include "bwd_common.cuh"
#include "tc_common.cuh"

namespace {

constexpr int HH = NLT_H * NLT_H;
// Weight sets resident in shared memory (widths 32 and 64) or streamed
// through it, one matrix a product (128).
constexpr bool kStream = NLT_H > 64;

// Parameter blob (floats), as csrc/grid_update.cu reads it:
constexpr int kEncW0 = 0;
constexpr int kEncW1 = kEncW0 + HH;
constexpr int kWI = kEncW1 + HH;
constexpr int kW2 = kWI + HH;
constexpr int kAWr = kW2 + HH;  // a_w0 rows 0..H-1
constexpr int kAWa = kAWr + HH;  // a_w0 rows H..2H-1
constexpr int kAW1 = kAWa + HH;
constexpr int kOW0 = kAW1 + HH;
constexpr int kVec = kOW0 + HH;
enum { ENC_B0, ENC_B1, ENC_LS, ENC_LB, B2, E_LS, E_LB, A_B0, A_B1, A_LS, A_LB,
       O_B0, N_VEC };
// Transposed blob: the eight HxH matrices above, each transposed, at the
// same offsets, then o_w1^T (d_out, H) at kVec. The forward set is the
// blob's first kVec floats, the backward set the transposed blob's first
// kVec floats and then H rows of o_w1^T at a time (one output chunk).
constexpr int kSetFloats = kVec + HH;  // the weight region: either set
// Resident: the weight region; streamed: two HxH buffers.
constexpr int kWeightFloats = kStream ? 2 * HH : kSetFloats;

// The blob offsets of the forward products, in their order (a_w0 as its
// two halves), and of the backward products', in theirs (transposed blob).
__host__ __device__ constexpr int fwd_at(int i) {
  return i == 0   ? kEncW0
         : i == 1 ? kEncW1
         : i == 2 ? kWI
         : i == 3 ? kW2
         : i == 4 ? kAWr
         : i == 5 ? kAWa
         : i == 6 ? kAW1
                  : kOW0;
}
__host__ __device__ constexpr int bwd_at(int j) {
  return j == 0   ? kOW0
         : j == 1 ? kAW1
         : j == 2 ? kAWr
         : j == 3 ? kAWa
         : j == 4 ? kW2
         : j == 5 ? kWI
         : j == 6 ? kEncW1
                  : kEncW0;
}

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
  return (size_t)kWeightFloats + (size_t)warps<K>() * (N_ROWS + K) * NLT_H;
}
static_assert(sizeof(float) * smem_floats<8>() <= 232448 &&
                  sizeof(float) * smem_floats<4>() <= 232448,
              "shared memory of a block");
static_assert(16 * N_VEC * NLT_H <= kWeightFloats,
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
                           float* __restrict__ node_s,  // (N_NODE, n_virt*B, H)
                           float* __restrict__ slot_s,  // (2, n_virt*K*B, H)
                           float* __restrict__ partial, int n_virt, int n_ge,
                           int B, int d_out) {
  constexpr int kWarps = warps<K>();
  extern __shared__ __align__(16) float smem[];
  float* wts = smem;  // resident: the forward or the backward weight set
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int W = B * NLT_H;
  const size_t n_node = (size_t)n_virt * B, n_slot = n_node * K;
  const Cols zero = cols_fill(0.f);
  float* rows = smem + kWeightFloats + warp * (N_ROWS + K) * NLT_H;
  float* slots = rows + N_ROWS * NLT_H;
  auto vec = [&](int which) { return cols_ld(P + kVec + which * NLT_H, lane); };
  auto row = [&](int which) { return rows + which * NLT_H; };
  auto node_mm = [&](int which, const float* w, Cols init) {
    Cols o[1] = {init};
    cols_mm<1>(row(which), NLT_H, w, NLT_H, lane, o);
    return o[0];
  };
  // this lane's features of scratch row r (streaming store)
  auto put = [&](float* base, size_t r, const Cols& val) {
    cols_stcs(base + r * NLT_H, lane, val);
  };
  Cols vsum[N_VEC];  // per-lane shares of the 12 vector gradients
  cols_fill(vsum, zero);
  const int n_ch = (d_out + NLT_H - 1) / NLT_H;  // output-map chunks
  const int n_chunks = (n_virt + kWarps - 1) / kWarps;
  // (chunk, b) steps of this block, and the step it is at
  const int n_steps = ((n_chunks - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) * B;
  int step = 0;

  // Streamed: product stage s of a step (forward products 0-7, the output
  // map's chunks 8 .. 7 + n_ch, then the backward products) is copied by
  // cp.async into one of two HxH buffers while the previous one runs.
  const int n_stages = 16 + n_ch;
  auto issue = [&](int s, float* buf) {
    const float* src;
    int n = HH;
    if (s < 8) {
      src = P + fwd_at(s);
    } else if (s < 8 + n_ch) {
      const int c0 = (s - 8) * NLT_H;
      src = PT + kVec + (size_t)c0 * NLT_H;
      n = min(NLT_H, d_out - c0) * NLT_H;
    } else {
      src = PT + bwd_at(s - 8 - n_ch);
    }
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x)
      cp_async16(buf + 4 * i, src + 4 * i, true);
    cp_async_commit();
  };
  int n_issued = 0;  // streamed: stages begun (stage i in buffer i % 2)
  if constexpr (kStream) issue(0, smem);
  // The weights of stage s. Streamed: waits for its copy, lets every warp
  // finish the previous product and starts the copy of the next stage
  // (of this step or the next) into the buffer that product read.
  auto weights = [&](int s) -> const float* {
    cp_async_wait<0>();
    __syncthreads();
    float* cur = smem + (n_issued & 1) * HH;
    float* other = smem + ((n_issued + 1) & 1) * HH;
    ++n_issued;
    if (s + 1 < n_stages)
      issue(s + 1, other);
    else if (step + 1 < n_steps)
      issue(0, other);
    return cur;
  };
  // forward product i, backward product j, output chunk c of o_w1^T
  auto fw = [&](int i) -> const float* {
    if constexpr (kStream) return weights(i);
    else return wts + fwd_at(i);
  };
  auto bw = [&](int j) -> const float* {
    if constexpr (kStream) return weights(8 + n_ch + j);
    else return wts + bwd_at(j);
  };
  auto ow = [&](int c) -> const float* {
    if constexpr (kStream) {
      return weights(8 + c);
    } else {
      if (c > 0) {
        __syncthreads();  // every warp is done with the previous chunk
        const int c0 = c * NLT_H;
        load_set(wts + kVec, PT + kVec + (size_t)c0 * NLT_H,
                 min(NLT_H, d_out - c0) * NLT_H);
        __syncthreads();
      }
      return wts + kVec;
    }
  };

  for (int chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
    const int v0 = chunk * kWarps + warp;
    const bool ok = v0 < n_virt;
    const int v = ok ? v0 : n_virt - 1;
    const size_t slot0 = (size_t)v * K;
    Cols dew[K];
    cols_fill(dew, zero);
    for (int b = 0; b < B; ++b, ++step) {
      const size_t col = (size_t)b * NLT_H;
      const size_t nr = (size_t)v * B + b;  // node row of the scratch
      if constexpr (!kStream) {
        __syncthreads();  // the block is done with the weights and rows
        load_set(wts, P, kVec);  // wts: the forward set from here
        __syncthreads();
      }
      // ---- forward recompute ----
      const Cols gev =
          v < n_ge ? cols_ldt(ge + (size_t)v * W + col, lane) : zero;
      cols_st(row(F_GE), lane, gev);
      __syncwarp();
      const Cols t1p = node_mm(F_GE, fw(0), vec(ENC_B0));
      const Cols t1 = cols_silu(t1p);
      cols_st(row(F_T1), lane, t1);
      __syncwarp();
      const Cols t2 = node_mm(F_T1, fw(1), vec(ENC_B1));
      const NltLn s_e = nlt_ln_stats(t2);
      const Cols gr =
          cols_add(gev, nlt_ln_apply(s_e, vec(ENC_LS), vec(ENC_LB)));
      cols_st(row(F_GR), lane, gr);
      __syncwarp();
      const Cols rec = node_mm(F_GR, fw(2), zero);
      Cols x0[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int s = senders[slot0 + k];
        x0[k] = cols_add(
            cols_add(cols_ldt(table + (size_t)s * W + col, lane),
                     cols_ldt(ew + (slot0 + k) * NLT_H, lane)),
            rec);
        const Cols x1 = cols_silu(x0[k]);
        cols_st(slots + k * NLT_H, lane, x1);
        if (ok) put(slot_s + SL_X1 * n_slot * NLT_H, (slot0 + k) * B + b, x1);
      }
      __syncwarp();
      Cols y2[K];
      cols_fill(y2, vec(B2));
      cols_mm<K>(slots, NLT_H, fw(3), NLT_H, lane, y2);
      float mk[K];
      Cols agg = zero;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        mk[k] = mask[slot0 + k];
        cols_fma(agg, mk[k],
                 nlt_ln_apply(nlt_ln_stats(y2[k]), vec(E_LS), vec(E_LB)));
      }
      cols_st(row(F_AGG), lane, agg);
      __syncwarp();
      const Cols u0r = node_mm(F_GR, fw(4), vec(A_B0));
      const Cols u0p = node_mm(F_AGG, fw(5), u0r);
      const Cols u1 = cols_silu(u0p);
      cols_st(row(F_U1), lane, u1);
      __syncwarp();
      const Cols u2 = node_mm(F_U1, fw(6), vec(A_B1));
      const NltLn s_u = nlt_ln_stats(u2);
      const Cols ro = cols_add(gr, nlt_ln_apply(s_u, vec(A_LS), vec(A_LB)));
      cols_st(row(F_RO), lane, ro);
      __syncwarp();
      const Cols y0p = node_mm(F_RO, fw(7), vec(O_B0));
      if (ok) {
        put(node_s + N_T1 * n_node * NLT_H, nr, t1);
        put(node_s + N_GR * n_node * NLT_H, nr, gr);
        put(node_s + N_AGG * n_node * NLT_H, nr, agg);
        put(node_s + N_U1 * n_node * NLT_H, nr, u1);
        put(node_s + N_RO * n_node * NLT_H, nr, ro);
        put(node_s + N_Y * n_node * NLT_H, nr, cols_silu(y0p));
      }
      if constexpr (!kStream) {
        __syncthreads();  // the forward set and rows are read
        // wts: the backward set from here, o_w1^T's first chunk with it
        load_set(wts, PT, kVec + NLT_H * min(NLT_H, d_out));
        __syncthreads();
      }
      // ---- backward chain ----
      // d_y = d_out @ o_w1^T, H output columns (o_w1^T's rows) a chunk
      float* dout_row = row(B_DOUT);
      const T* dsrc = d_out_g + ((size_t)v * B + b) * d_out;
      Cols dyv[1] = {zero};
      for (int c = 0; c < n_ch; ++c) {
        const int c0 = c * NLT_H, nk = min(NLT_H, d_out - c0);
        const float* w = ow(c);
        __syncwarp();  // every lane is done with the previous chunk's row
        for (int j = lane; j < NLT_H; j += 32)
          dout_row[j] = ok && j < nk ? Io<T>::ld(dsrc + c0 + j) : 0.f;
        __syncwarp();
        cols_mm<1>(dout_row, NLT_H, w, nk, lane, dyv);
      }
      const Cols d_y0p = cols_mul_silu_grad(dyv[0], y0p);
      cols_acc(vsum[O_B0], d_y0p);
      cols_st(row(B_DY0P), lane, d_y0p);
      __syncwarp();
      const Cols d_ro = node_mm(B_DY0P, bw(0), zero);
      const Cols d_u2 =
          nlt_ln_grad(s_u, vec(A_LS), d_ro, vsum[A_LS], vsum[A_LB]);
      cols_acc(vsum[A_B1], d_u2);
      cols_st(row(B_DU2), lane, d_u2);
      __syncwarp();
      const Cols d_u0p =
          cols_mul_silu_grad(node_mm(B_DU2, bw(1), zero), u0p);
      cols_acc(vsum[A_B0], d_u0p);
      cols_st(row(B_DU0P), lane, d_u0p);
      __syncwarp();
      Cols d_gr = node_mm(B_DU0P, bw(2), d_ro);
      const Cols d_agg = node_mm(B_DU0P, bw(3), zero);
      __syncwarp();  // x1's rows are read; dx2 takes their place
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const Cols dmsg = cols_scale(ok ? mk[k] : 0.f, d_agg);
        const Cols dy = nlt_ln_grad(nlt_ln_stats(y2[k]), vec(E_LS), dmsg,
                                    vsum[E_LS], vsum[E_LB]);
        cols_acc(vsum[B2], dy);
        cols_st(slots + k * NLT_H, lane, dy);
        if (ok) put(slot_s + SL_DX2 * n_slot * NLT_H, (slot0 + k) * B + b, dy);
      }
      __syncwarp();
      Cols dx1[K];
      cols_fill(dx1, zero);
      cols_mm<K>(slots, NLT_H, bw(4), NLT_H, lane, dx1);
      Cols d_rec = zero;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const Cols d0 = cols_mul_silu_grad(dx1[k], x0[k]);
        cols_acc(d_rec, d0);
        cols_acc(dew[k], d0);
        if (ok) cols_stt(d_x0 + (slot0 + k) * W + col, lane, d0);
      }
      cols_st(row(B_DREC), lane, d_rec);
      __syncwarp();
      d_gr = node_mm(B_DREC, bw(5), d_gr);
      const Cols d_t2 =
          nlt_ln_grad(s_e, vec(ENC_LS), d_gr, vsum[ENC_LS], vsum[ENC_LB]);
      cols_acc(vsum[ENC_B1], d_t2);
      cols_st(row(B_DT2), lane, d_t2);
      __syncwarp();
      const Cols d_t1p =
          cols_mul_silu_grad(node_mm(B_DT2, bw(6), zero), t1p);
      cols_acc(vsum[ENC_B0], d_t1p);
      cols_st(row(B_DT1P), lane, d_t1p);
      __syncwarp();
      const Cols d_gev = node_mm(B_DT1P, bw(7), d_gr);
      if (ok) {
        put(node_s + N_DY0P * n_node * NLT_H, nr, d_y0p);
        put(node_s + N_DU2 * n_node * NLT_H, nr, d_u2);
        put(node_s + N_DU0P * n_node * NLT_H, nr, d_u0p);
        put(node_s + N_DREC * n_node * NLT_H, nr, d_rec);
        put(node_s + N_DT2 * n_node * NLT_H, nr, d_t2);
        put(node_s + N_DT1P * n_node * NLT_H, nr, d_t1p);
        if (v < n_ge) cols_stt(d_ge + (size_t)v * W + col, lane, d_gev);
      }
    }
    if (ok) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        cols_stt(d_ew + (slot0 + k) * NLT_H, lane, dew[k]);
    }
  }

  // vector gradients: the 12 of width H, summed in the weight region
  __syncthreads();
  float* red = wts;
  float* part = partial + (size_t)blockIdx.x * (N_VEC * NLT_H + d_out);
  nlt_block_vec_sums<N_VEC>(red, vsum, kWarps, part);
  // o_b1's: the column sums of d_out over the block's rows, 32 columns at
  // a time (lane c of warp w sums column c of warp w's rows), then summed
  // over the warps in warp order
  for (int c0 = 0; c0 < d_out; c0 += 32) {
    const int c = c0 + lane;
    float s = 0.f;
    if (c < d_out) {
      for (int chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
        const int v = chunk * kWarps + warp;
        if (v >= n_virt) break;
        for (int b = 0; b < B; ++b)
          s += Io<T>::ld(d_out_g + ((size_t)v * B + b) * d_out + c);
      }
    }
    red[warp * 32 + lane] = s;
    __syncthreads();
    if (threadIdx.x < 32 && c0 + (int)threadIdx.x < d_out) {
      float t = 0.f;
      for (int w = 0; w < kWarps; ++w) t += red[w * 32 + threadIdx.x];
      part[N_VEC * NLT_H + c0 + threadIdx.x] = t;
    }
    __syncthreads();
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
  if (n_virt < 1 || grid < 1 || d_out_w < 1)
    return (int)cudaErrorInvalidValue;
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

// B5/B6's chain pass. d_out (n_virt, B*d_out), any d_out >= 1 -> d_x0
// (n_virt*K, B*H) per slot, d_ew (n_virt*K, H), d_ge (n_ge, B*H), the
// scratch node_s (12, n_virt*B, H) and slot_s (2, n_virt*K*B, H) (see
// above), and partial (grid, 12*H + d_out): each block's sums of the 12 vector
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
