"""The forward kernels' width-64 instances of two or more trees on one CUDA
card: each kernel's time at its main-path shape, tree against tree.

    python3 probes/torch_fwd64_probe.py build/parent . [--rounds 2]

Builds every root's forward libraries (K1-K4, P1-P3) at hidden width 64 at
once (one nvcc per source and root), then runs one worker process per root
and round, in the order P C C P for two roots: each worker imports that
root's `neural_lam_tpu_torch`, builds the bench GraphLAM (batch 4) and
4-level HiLAM (batch 1) at width 64 from one seed, and times each kernel's
fp32 and bf16 instances (P1: fp32) at the shapes of this tree's
`chip_smoke.main_path_cases` with CUDA events (queued behind a sleep
kernel, 20 calls, `chip_smoke.cuda_ms`), and prints one JSON line. Then
the per-kernel medians a root and each root's ratio to the first root's.
Prints the card's name and power limit first and last.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORWARD = ("embed", "edge_flat", "grid_update", "edge")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def worker(root):
    sys.path.insert(0, os.path.abspath(root))
    import torch

    cs = _chip_smoke()
    from neural_lam_tpu_torch import entry
    from neural_lam_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all(FORWARD)
    gm, _ = entry.build_model(**cs.BENCH, device="cuda")
    hm, _ = entry.build_model(**cs.BENCH, device="cuda", model="hi_lam")
    times = {}
    with torch.no_grad():
        for dt in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device="cuda").manual_seed(26)

            def rand(*shape):
                return torch.randn(*shape, device="cuda",
                                   generator=gen).to(dt)

            for name, mod, args, *_ in cs.main_path_cases(torch, gm, hm,
                                                          rand, dt):
                kern = getattr(mod, name)
                tag = name + ("[bf16]" if dt == torch.bfloat16 else "")
                times[tag] = cs.cuda_ms(torch, lambda: kern(*args), 20)
    print(json.dumps({"root": root, "ms": times}), flush=True)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("roots", nargs="+")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--worker", action="store_true")
    args = parser.parse_args()
    if args.worker:
        worker(args.roots[0])
        return 0
    cs = _chip_smoke()
    print(cs.smi_line(), flush=True)
    t0 = time.time()
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from neural_lam_tpu_torch.ops import _build; "
            f"_build.build_all({FORWARD!r})")
    builds = [subprocess.Popen([sys.executable, "-c", code,
                                os.path.abspath(r)]) for r in args.roots]
    if any(b.wait() for b in builds):
        raise SystemExit("a build failed")
    print(f"builds: {time.time() - t0:.1f} s", flush=True)
    order = []
    for _ in range(args.rounds):
        order += args.roots + args.roots[::-1]
    order = order[:len(args.roots) * args.rounds]
    runs = {r: [] for r in args.roots}
    for root in order:
        out = subprocess.run([sys.executable, __file__, root, "--worker"],
                             check=True, capture_output=True, text=True,
                             timeout=600).stdout
        line = json.loads(out.strip().splitlines()[-1])
        print(json.dumps(line), flush=True)
        runs[root].append(line["ms"])
    first = args.roots[0]
    med = {r: {k: sorted(x[k] for x in rs)[len(rs) // 2] for k in rs[0]}
           for r, rs in runs.items()}
    for k in med[first]:
        print(f"{k}: " + ", ".join(
            f"{r} {med[r][k]:.4f} ms ({med[r][k] / med[first][k]:.3f}x)"
            for r in args.roots))
    print(cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
