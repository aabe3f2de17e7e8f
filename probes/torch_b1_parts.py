"""What holds B1 (the grid embedder's backward, `embed_bwd_kernel` in
neural_lam_tpu_torch/csrc/embed_bwd.cu) on one CUDA card.

    python3 probes/torch_b1_parts.py [--rounds 2] [--src FILE]

Builds variants of csrc/embed_bwd.cu (or of FILE, a copy of it from
another checkout) into build/b1_parts/ (git-ignored), each a copy of
the source with textual changes, and times each at the
bench shape of the training step's call (63,784 grid nodes x batch 4 =
255,136 rows, d_in 56, no dx; inputs from a seeded generator) with CUDA
events around 20 calls queued behind a sleep kernel:

- shipped: the source as it is;
- nowgrad: the block step's weight-gradient sums left out;
- nochain: the warp's chain (its products, LayerNorm and column sums)
  left out: the staging and the weight-gradient sums alone;
- stage: both left out: the staging, barriers and partial writes alone;
- noprod: the chain's products left out (fragment loads and splits kept);
- rna: every TF32 split by two `cvt.rna` (tc_common.cuh's split_tf32)
  instead of the kernel's integer rounding;
- warps8 / warps10: 8 or 10 warps a block at d_in <= 64 (shipped: 12).

A variant whose anchor text is not in the source once is skipped with a
note (an anchor marked "*" is replaced wherever it occurs). Prints the
card's name and power limit first. Needs one card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "neural_lam_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "b1_parts")

_CHAIN = "    chain_tile<XC>("
_NOCHAIN = "    if (n_rows < 0) chain_tile<XC>("
# without the chain, nothing waits for d_out's copies: wait for both at once
_WAIT = ("    cp_async_wait<1>();  // x has landed", "    cp_async_wait<0>();")
_WGRAD = "    __syncthreads();\n    step_"
_NOWGRAD = "    __syncthreads();\n    if (n_rows < 0) step_"
_MMA3 = """      mma_tf32(acc[q], as, bb0, bb1);
      mma_tf32(acc[q], ab, bs0, bs1);
      mma_tf32(acc[q], ab, bb0, bb1);"""
VARIANTS = {
    "shipped": [],
    "nowgrad": [(_WGRAD, _NOWGRAD)],
    "nochain": [(_CHAIN, _NOCHAIN), _WAIT],
    "stage": [(_WGRAD, _NOWGRAD), (_CHAIN, _NOCHAIN), _WAIT],
    "noprod": [(_MMA3, "      acc[q][0] += __uint_as_float(ab[0] ^ bb0 ^ "
                       "bs1 ^ as[1]);")],
    "rna": [("void split_fast(", "void split_fast_unused("),
            ("*split_fast(", "split_tf32(")],
    "warps8": [("return kWide ? 8 : 12;", "return 8;")],
    "warps10": [("return kWide ? 8 : 12;", "return kWide ? 8 : 10;")],
}


def build(nvcc, flags, src_path):
    """One nvcc per variant, all started together; {name: library}."""
    os.makedirs(OUT, exist_ok=True)
    src = open(src_path).read()
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old.startswith("*"):
                text = text.replace(old[1:], new)
                continue
            if text.count(old) != 1:
                print(f"variant {name}: no single match for {old[:50]!r}; "
                      "skipped")
                break
            text = text.replace(old, new, 1)
        else:
            path = os.path.join(OUT, f"{name}.cu")
            with open(path, "w") as f:
                f.write(text)
            lib = os.path.join(OUT, f"lib{name}.so")
            procs[name] = (subprocess.Popen(
                [nvcc, *flags, "-I", CSRC, "-o", lib, path],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"nvcc failed for {name}:\n{log[-3000:]}")
            continue
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"{name}: {'; '.join(regs)}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--src", default=os.path.join(CSRC, "embed_bwd.cu"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_b1_parts: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from neural_lam_tpu_torch.ops import _build

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip())
    libs = build(_build._nvcc(), _build.NVCC_FLAGS, args.src)
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, d_in, H = 63784 * 4, 56, 64
    x = torch.randn(rows, d_in, device=dev, generator=gen)
    dout = torch.randn(rows, H, device=dev, generator=gen)
    n_par = d_in * H + H * H + 4 * H
    params = torch.randn(n_par, device=dev, generator=gen) * 0.1
    partial = torch.empty(132 * 4 * n_par, device=dev)

    def runner(lib):
        lib.nlt_embed_bwd_grid.argtypes = [LL, I, I, ctypes.POINTER(I)]
        lib.nlt_embed_bwd.argtypes = [P] * 5 + [LL, I, I, I, P]
        grid = I(0)
        if lib.nlt_embed_bwd_grid(rows, d_in, 0, ctypes.byref(grid)):
            raise RuntimeError("grid query failed")

        def run():
            rc = lib.nlt_embed_bwd(
                x.data_ptr(), dout.data_ptr(), params.data_ptr(), None,
                partial.data_ptr(), rows, d_in, grid.value, 0,
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed: {rc}")
        return run

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

    runs = {name: runner(lib) for name, lib in libs.items()}
    times = {name: [] for name in runs}
    for _ in range(args.rounds):
        for name, fn in runs.items():
            times[name].append(ms(fn))
    print(f"B1 kernel at {rows} rows, d_in {d_in}, no dx; ms per call, "
          f"{args.rounds} interleaved rounds:")
    for name, ts in times.items():
        print(f"  {name}: {', '.join(f'{t:.4f}' for t in ts)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
