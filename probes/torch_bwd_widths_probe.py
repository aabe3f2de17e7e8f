"""The backward kernels at hidden widths 32 and 128 alone on one CUDA card:
phase 20 of `chip_smoke.py` without phases 2-19.

    python3 probes/torch_bwd_widths_probe.py

Builds the backward libraries (B1-B6 and xtd_sum) at widths 32, 64 and 128
(one nvcc per source and width, all started together) and runs
`chip_smoke.bwd_widths_phase`: each instance's registers and spill at 32
and 128 (20a); every backward kernel's fp32 and bf16 instances at the
training-step shapes of the bench GraphLAM and 4-level HiLAM at 32 and
128 against their plain versions and timed, B1 at d_in 160 and B5/B6 at
output maps wider than the width (20b); `train.main` for GraphLAM and
HiLAM at both widths, fp32 and bf16, 4 steps each with their launches and
first-step gradients held (20c). Prints the kernels' JSON records and
ends with the card's name and power limit. Exits non-zero without a card
or when a check fails.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
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
    # the training paths (20c) run the forward kernels too
    _build.build_all(_build.SOURCES, widths=_build.WIDTHS)
    print(f"kernel build: {time.time() - t0:.1f} s")
    reset_counts, counts, counts_bf16, plain_kernels = cs.kernel_registry()
    records = []
    peaks = (peak_flops, peak_tf32, peak_bw)
    cs.bwd_widths_phase(torch, np, counts, counts_bf16, reset_counts,
                        plain_kernels, records, peaks)
    print(json.dumps({"kernels": records}))
    print(cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
