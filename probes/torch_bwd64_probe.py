"""The backward kernels' width-64 instances of two trees on one CUDA card:
each kernel's time at its training-step shape, tree against tree.

    python3 probes/torch_bwd64_probe.py PARENT CHANGE

Builds both roots' backward libraries (B1-B6 and xtd_sum) at hidden width
64 at once (one nvcc per source and root), then runs one worker process
per run in the order parent, change, change, parent: each worker
imports that root's `neural_lam_tpu_torch`, builds the bench GraphLAM and
4-level HiLAM (batch 4) at width 64 from one seed, and times each backward
kernel's fp32 and bf16 instances at the shapes of this tree's
`chip_smoke.bwd_main_path_cases` (GraphLAM's: B1 at the training step's
call, B2 at g2m, B3/B4 at m2m[0], B5/B6 at m2g, xtd_sum at the decoder's
pairs, xtd_reduce at their partials) with CUDA events (queued behind a
sleep kernel, 10 calls, `chip_smoke.cuda_ms`), and prints one JSON line.
Then per kernel each root's two times and the change's mean over the
parent's. Prints the card's name and power limit first and last.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKWARD = ("embed_bwd", "edge_flat_bwd", "grid_update_bwd", "weight_grad")


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
    from neural_lam_tpu_torch.ops import _build, weight_grad

    kernels = {}
    if "h" not in inspect.signature(weight_grad.n_blocks).parameters:
        # a tree from before n_blocks and xtd_reduce took the width (64)
        old_blocks, old_reduce = weight_grad.n_blocks, weight_grad.xtd_reduce
        weight_grad.n_blocks = (
            lambda ns, dev, h=64, per_sm=weight_grad.BLOCKS_PER_SM:
            old_blocks(ns, dev, per_sm))
        kernels["xtd_reduce"] = lambda partial, first, widths, h: (
            old_reduce(partial, first, widths))
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all(BACKWARD)
    gm, _ = entry.build_model(**cs.BENCH, device="cuda")
    hm, _ = entry.build_model(**cs.BENCH, device="cuda", model="hi_lam")
    times = {}
    with torch.no_grad():
        for dt in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device="cuda").manual_seed(27)

            def rand(*shape):
                return torch.randn(*shape, device="cuda",
                                   generator=gen).to(dt)

            for (name, mod, args, *_, timed) in cs.bwd_main_path_cases(
                    torch, gm, hm, rand, dt):
                if not timed:
                    continue
                kern = kernels.get(name, getattr(mod, name))
                tag = name + ("[bf16]" if dt == torch.bfloat16 else "")
                times[tag] = cs.cuda_ms(torch, lambda: kern(*args), 10)
    print(json.dumps({"root": root, "ms": times}), flush=True)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("roots", nargs="+", help="PARENT CHANGE")
    parser.add_argument("--worker", action="store_true")
    args = parser.parse_args()
    if args.worker:
        worker(args.roots[0])
        return 0
    if len(args.roots) != 2:
        parser.error("give two roots: PARENT CHANGE")
    cs = _chip_smoke()
    print(cs.smi_line(), flush=True)
    t0 = time.time()
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from neural_lam_tpu_torch.ops import _build; "
            f"_build.build_all({BACKWARD!r})")
    builds = [subprocess.Popen([sys.executable, "-c", code,
                                os.path.abspath(r)]) for r in args.roots]
    if any(b.wait() for b in builds):
        raise SystemExit("a build failed")
    print(f"builds: {time.time() - t0:.1f} s", flush=True)
    parent, change = args.roots
    runs = {r: [] for r in args.roots}
    for root in (parent, change, change, parent):
        out = subprocess.run([sys.executable, __file__, root, "--worker"],
                             check=True, capture_output=True, text=True,
                             timeout=600).stdout
        line = json.loads(out.strip().splitlines()[-1])
        print(json.dumps(line), flush=True)
        runs[root].append(line["ms"])
    for k in runs[parent][0]:
        p, c = ([x[k] for x in runs[r]] for r in (parent, change))
        print(f"{k}: parent {p[0]:.4f}, {p[1]:.4f} ms; change {c[0]:.4f}, "
              f"{c[1]:.4f} ms ({sum(c) / sum(p):.3f}x)")
    print(cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
