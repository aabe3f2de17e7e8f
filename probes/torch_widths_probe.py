"""The forward kernels at hidden widths 32 and 128 alone on one CUDA card:
phase 19 of `chip_smoke.py` without phases 2-18.

    python3 probes/torch_widths_probe.py [--parts abcd]

Builds the forward libraries (K1-K4, P1-P3) at widths 32, 64 and 128 (one
nvcc per source and width, all started together; 64 for K4's wide output
maps) and runs `chip_smoke.widths_phase`: each instance's registers and
spill (19a); every forward kernel's fp32 and bf16 instances at 32 and 128
against their plain versions and timed, and K4 at output maps wider than
its width (19b); the bench GraphLAM and 4-level HiLAM forecasting at
those widths through `entry.forecast`, and through `predict.main` and
`train.main --eval val` at 128 (19c); the raises at width 48 and for
training at 128 (19d). `--parts` runs a subset (`ab`: the builds and the
kernels alone). Prints the kernels' JSON records and ends with the card's
name and power limit. Exits non-zero without a card or when a check
fails.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--parts", default="abcd")
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from neural_lam_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["WANDB_MODE"] = "disabled"
    print(cs.smi_line())
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    name = torch.cuda.get_device_name(0)
    peak_flops, peak_tf32, peak_bw, label = cs.peaks(name)
    print(f"device: {name}; peaks used for bounds: {label}")
    t0 = time.time()
    _build.build_all(_build.FORWARD, widths=_build.WIDTHS)
    print(f"kernel build: {time.time() - t0:.1f} s")
    reset_counts, counts, counts_bf16, plain_kernels = cs.kernel_registry()
    zero = {k: 0 for k in counts()}
    records = []
    peaks = (peak_flops, peak_tf32, peak_bw)
    t0 = time.time()
    if args.parts == "abcd":
        cs.widths_phase(torch, np, counts, counts_bf16, reset_counts,
                        plain_kernels, zero, records, peaks)
    else:
        if "a" in args.parts:
            cs.width_build(_build)
        if "b" in args.parts:
            for h in cs.NEW_WIDTHS:
                cs.width_kernel_cases(torch, h, counts, counts_bf16,
                                      records, peaks)
            cs.k4_d_out_cases(torch, np, counts, counts_bf16)
        if "d" in args.parts:
            cs.width_raises(torch, np, counts, reset_counts)
    print(f"phase 19 ({args.parts}): {time.time() - t0:.1f} s")
    print(json.dumps({"kernels": records}))
    print(cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
