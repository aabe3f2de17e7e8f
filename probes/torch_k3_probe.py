"""What holds K3 (the processor edge layer, `edge_tc_kernel<K, true,
false>` of neural_lam_tpu_torch/csrc/edge_tc.cuh, built by csrc/edge_flat.cu)
on one CUDA card.

    python3 probes/torch_k3_probe.py [--rounds 2]

Builds variants of csrc/edge_flat.cu into build/k3_probe/NAME/
(git-ignored), each with a copy of csrc/edge_tc.cuh that has one textual
change, and times each at
GraphLAM's m2m[0] shape (7,424 virtual rows, K = 8, batch 4, a 6,561-row
sender table; inputs from a seeded generator) with CUDA events around 20
calls queued behind a sleep kernel:

- shipped: the source as it is;
- warps8 / warps10: kLayerWarps at 8 and 10 (shipped: 12);
- terms1 / terms0: one TF32 product per term (big*big), and no
  tensor-core product at all (the fragment loads kept): how much of the
  time the products take;
- nostores: edge_out and virt not written;
- setup: a kernel that only splits the weights into shared memory, each
  block's fixed cost;
- loads: a kernel that runs the staging loop alone (the edge and sender
  rows by cp.async, the receiver rows and masks into registers).

Beside them: one copy of the edge rows (edge_rep -> edge_out), the
card's rate for moving K3's main bytes, and a microbenchmark of the
instruction K3's products use (`mma.sync` m16n8k8 TF32, fp32
accumulators, operands in registers; 4-16 independent accumulators a
warp, 4-16 warps on each SM). Prints the card's name and power limit
first. Needs one card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "neural_lam_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "k3_probe")

_MMA3 = """      mma_tf32(acc[q], as, w.x, w.y);
      mma_tf32(acc[q], ab, w.z, w.w);
      mma_tf32(acc[q], ab, w.x, w.y);"""
_EDGE_STORE = "          if (ok) {\n            const float2 e ="
_VIRT_STORE = "          if (tl.v0 + j < n_virt) {"
VARIANTS = {
    "shipped": [],
    "warps8": [("constexpr int kLayerWarps = 12;",
                "constexpr int kLayerWarps = 8;")],
    "warps10": [("constexpr int kLayerWarps = 12;",
                 "constexpr int kLayerWarps = 10;")],
    "terms1": [(_MMA3, "      mma_tf32(acc[q], ab, w.x, w.y);")],
    "terms0": [(_MMA3, "      acc[q][0] += __uint_as_float(ab[0] ^ w.x);")],
    "nostores": [
        (_EDGE_STORE, "          if (ok && n_virt < 0) {\n"
                      "            const float2 e ="),
        (_VIRT_STORE, "          if (tl.v0 + j < n_virt && n_virt < 0) {")],
}

# Kernels that take parts of K3 alone, compiled in one translation unit
# with the shipped source (its helpers live in an anonymous namespace).
EXTRA = r"""
#include "edge_flat.cu"

namespace {

constexpr size_t kLayerSmem = smem_bytes<true>();

__global__ void __launch_bounds__(kLayerWarps * 32, 1)
    setup_kernel(const float* __restrict__ params, float* out) {
  extern __shared__ __align__(16) float smem[];
  uint4* we_f = reinterpret_cast<uint4*>(smem);
  split_weights(we_f, params + HH + 3 * NLT_H);
  split_weights(we_f + kFrag, params);
  __syncthreads();
  if (smem[threadIdx.x] == 12345.f) out[blockIdx.x] = 1.f;
}

template <int K>
__global__ void __launch_bounds__(kLayerWarps * 32, 1)
    loads_kernel(const float* __restrict__ table,
                 const int* __restrict__ senders,
                 const float* __restrict__ edge_in,
                 const float* __restrict__ rec_rows,
                 const float* __restrict__ mask, float* out, int n_virt,
                 int B) {
  constexpr int kVpt = kRows / K;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* stages = smem + 4 * 2 * kFrag + N_VEC * NLT_H + warp * 3 * kTileF;
  float* X = stages + 2 * kTileF;
  const int W = B * NLT_H;
  const int n_tiles = (n_virt + kVpt - 1) / kVpt * B;
  const int stride = gridDim.x * kLayerWarps;
  int tile = warp * gridDim.x + blockIdx.x;
  float dsum = 0.f;
  stage_rows<K, false, false, float>(stages, edge_in, nullptr, 0, tile, n_tiles,
                              n_virt, 0, B, lane);
  stage_rows<K, false, false, float>(
      X, edge_in, table,
      tile_senders<K>(senders, tile, n_tiles, n_virt, B, lane), tile,
      n_tiles, n_virt, 0, B, lane);
  stage_rows<K, false, false, float>(stages + kTileF, edge_in, nullptr, 0,
                              tile + stride, n_tiles, n_virt, 0, B, lane);
  for (int i = 0; tile < n_tiles; tile += stride, ++i) {
    float* E = stages + (i & 1) * kTileF;
    const Tile<K> tl(tile, n_virt, B);
    const size_t col0 = (size_t)tl.b * NLT_H;
    const int s_next =
        tile_senders<K>(senders, tile + stride, n_tiles, n_virt, B, lane);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = g + 8 * h;
      const int v = tl.v0 + min(row, tl.n_rows - 1) / K;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        dsum += rec_rows[(size_t)v * W + col0 + 8 * q + 2 * t];
      dsum += row < tl.n_rows ? mask[(size_t)tl.v0 * K + row] : 0.f;
    }
    cp_async_wait<1>();
    __syncwarp();
    dsum += E[lane] + X[lane];
    __syncwarp();
    stage_rows<K, false, false, float>(X, edge_in, table, s_next, tile + stride,
                                n_tiles, n_virt, 0, B, lane);
    stage_rows<K, false, false, float>(E, edge_in, nullptr, 0, tile + 2 * stride,
                                n_tiles, n_virt, 0, B, lane);
  }
  cp_async_wait<0>();
  if (dsum == 12345.f) out[0] = dsum;
}

template <int NACC>
__global__ void __launch_bounds__(512, 1) hmma_kernel(int iters, float* out) {
  float acc[NACC][4] = {};
  uint32_t a[4];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1e-3f * (threadIdx.x + i));
  const uint32_t b0 = __float_as_uint(1e-3f), b1 = __float_as_uint(2e-3f);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < NACC; ++j) mma_tf32(acc[j], a, b0, b1);
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NACC; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

extern "C" int probe_setup(const float* params, float* out, int blocks,
                           void* stream) {
  cudaError_t err = nlt_allow_smem(setup_kernel, kLayerSmem);
  if (err != cudaSuccess) return (int)err;
  setup_kernel<<<blocks, kLayerWarps * 32, kLayerSmem, (cudaStream_t)stream>>>(
      params, out);
  return (int)cudaGetLastError();
}

extern "C" int probe_loads(const float* table, const int* senders,
                           const float* edge_in, const float* rec_rows,
                           const float* mask, float* out, int n_virt, int B,
                           void* stream) {
  const long long tiles = (long long)((n_virt + 1) / 2) * B;  // K = 8
  int grid = 0;
  cudaError_t err = nlt_launch_config(loads_kernel<8>, kLayerWarps * 32,
                                      kLayerSmem, tiles, &grid);
  if (err != cudaSuccess) return (int)err;
  loads_kernel<8><<<grid, kLayerWarps * 32, kLayerSmem, (cudaStream_t)stream>>>(
      table, senders, edge_in, rec_rows, mask, out, n_virt, B);
  return (int)cudaGetLastError();
}

extern "C" int probe_hmma(int nacc, int blocks, int threads, int iters,
                          float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nacc == 16) hmma_kernel<16><<<blocks, threads, 0, s>>>(iters, out);
  else if (nacc == 8) hmma_kernel<8><<<blocks, threads, 0, s>>>(iters, out);
  else hmma_kernel<4><<<blocks, threads, 0, s>>>(iters, out);
  return (int)cudaGetLastError();
}
"""


def build(nvcc, flags):
    """One nvcc per variant and the extra kernels, all started together.
    A variant's edge_flat.cu includes the edge_tc.cuh beside it (a quoted
    include looks in the includer's directory first)."""
    os.makedirs(OUT, exist_ok=True)
    src = open(os.path.join(CSRC, "edge_tc.cuh")).read()
    jobs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: no single match for {old!r}")
            text = text.replace(old, new)
        vdir = os.path.join(OUT, name)
        os.makedirs(vdir, exist_ok=True)
        with open(os.path.join(vdir, "edge_tc.cuh"), "w") as f:
            f.write(text)
        path = os.path.join(vdir, "edge_flat.cu")
        shutil.copyfile(os.path.join(CSRC, "edge_flat.cu"), path)
        jobs[name] = path
    path = os.path.join(OUT, "extra.cu")
    with open(path, "w") as f:
        f.write(EXTRA)
    jobs["extra"] = path
    procs = {}
    for name, path in jobs.items():
        lib = os.path.join(OUT, f"lib{name}.so")
        procs[name] = (subprocess.Popen(
            [nvcc, *flags, "-I", CSRC, "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_k3_probe: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from neural_lam_tpu_torch.ops import _build

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip())
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    libs = build(_build._nvcc(), flags)
    P, I = ctypes.c_void_p, ctypes.c_int
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    n_virt, K, B, H, n_send = 7424, 8, 4, 64, 6561
    W, M = B * H, n_virt * K
    edge = torch.randn(M, W, device=dev, generator=gen)
    table = torch.randn(n_send, W, device=dev, generator=gen)
    senders = torch.randint(0, n_send, (M,), device=dev, generator=gen,
                            dtype=torch.int32)
    rec = torch.randn(n_virt, W, device=dev, generator=gen)
    mask = (torch.rand(n_virt, K, device=dev, generator=gen) < 0.8).float()
    params = torch.randn(2 * H * H + 4 * H, device=dev, generator=gen) * 0.1
    edge_out = torch.empty_like(edge)
    virt = torch.empty(n_virt, W, device=dev)
    out = torch.zeros(132 * 512 * 4, device=dev)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def k3(lib):
        f = lib.nlt_edge_layer
        f.argtypes = [P] * 8 + [I] * 4 + [P]
        rc = f(edge.data_ptr(), table.data_ptr(), senders.data_ptr(),
               rec.data_ptr(), mask.data_ptr(), params.data_ptr(),
               edge_out.data_ptr(), virt.data_ptr(), n_virt, K, B, 0,
               stream())
        if rc:
            raise RuntimeError(f"launch failed: {rc}")

    def ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda._sleep(200_000_000)
        ev[0].record()
        for _ in range(reps):
            fn()
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]) / reps

    extra = libs["extra"]
    extra.probe_setup.argtypes = [P, P, I, P]
    extra.probe_loads.argtypes = [P] * 6 + [I, I, P]
    extra.probe_hmma.argtypes = [I, I, I, I, P, P]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    runs = {name: (lambda lib=libs[name]: k3(lib)) for name in VARIANTS}
    runs["setup"] = lambda: extra.probe_setup(params.data_ptr(),
                                              out.data_ptr(), sms, stream())
    runs["loads"] = lambda: extra.probe_loads(
        table.data_ptr(), senders.data_ptr(), edge.data_ptr(),
        rec.data_ptr(), mask.data_ptr(), out.data_ptr(), n_virt, B, stream())
    runs["copy of the edge rows"] = lambda: edge_out.copy_(edge)
    times = {name: [] for name in runs}
    for _ in range(args.rounds):
        for name, fn in runs.items():
            times[name].append(ms(fn))
    print(f"K3 at m2m[0] (K=8, {n_virt} rows, B=4), ms per call, "
          f"{args.rounds} interleaved rounds:")
    for name, ts in times.items():
        print(f"  {name}: {', '.join(f'{t:.4f}' for t in ts)}")
    iters = 20000
    for nacc in (4, 8, 16):
        for warps in (4, 8, 16):
            t = ms(lambda: extra.probe_hmma(nacc, sms, 32 * warps, iters,
                                            out.data_ptr(), stream()), 3)
            n = sms * warps * iters * nacc
            print(f"mma.sync m16n8k8 TF32: {nacc} accumulators a warp, "
                  f"{warps} warps a SM: {n / sms / (t * 1e-3):.4e} per s "
                  f"per SM, {2 * 1024 * n / (t * 1e-3) / 1e12:.1f} TFLOP/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
