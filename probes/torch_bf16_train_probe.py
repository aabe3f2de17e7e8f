"""bf16 training alone on one CUDA card: phase 12 of `chip_smoke.py`
without phases 2-11.

    python3 probes/torch_bf16_train_probe.py

Builds every kernel library from `neural_lam_tpu_torch/csrc/` (one nvcc
per source, all started together), prints the build time and ptxas's
registers and spills for the backward kernels' bf16 instances and for
`xtd_sum`, then runs `chip_smoke.bf16_train_phase`: the bf16 instances of
B1, B2, B3/B4, B5/B6 and `xtd_sum` with bf16-X pairs against their plain
versions and timed beside their fp32 instances at the main-path shapes,
at K = 1..8; the bf16 training steps of the bench GraphLAM and HiLAM at
batch 4; `train.main --precision bf16` and its checkpoint's `--eval test
--precision bf16`. Ends with the kernels' JSON records and the card's
name and power limit. Exits non-zero without a card or when a check
fails.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BWD_SOURCES = ("embed_bwd", "edge_flat_bwd", "grid_update_bwd",
               "weight_grad")


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
    print(cs.smi_line())
    t0 = time.time()
    _build.build_all()
    print(f"kernel build: {time.time() - t0:.1f} s")
    for src in BWD_SOURCES:
        log = _build.build_log(src)
        for fn, info in sorted(re.findall(
                r"Compiling entry function '(\w+)'.*?\n(.*?Used \d+ "
                r"registers[^\n]*)", log, re.S)):
            used = re.search(r"Used [^\n]*", info).group(0)
            spill = ", ".join(re.findall(r"\d+ bytes spill \w+", info))
            print(f"  {src}: {cs.kernel_name(fn)}: {used}; "
                  f"{spill or 'no spill line'}")
    name = torch.cuda.get_device_name(0)
    peak_flops, peak_tf32, peak_bw, label = cs.peaks(name)
    print(f"device: {name}; peaks used for bounds: {label}")
    reset_counts, counts, counts_bf16, plain_kernels = cs.kernel_registry()
    zero_all = {k: 0 for k in counts()}
    records = []
    t0 = time.time()
    cs.bf16_train_phase(torch, np, counts, counts_bf16, reset_counts,
                        plain_kernels, records, zero_all, peak_flops,
                        peak_tf32, peak_bw)
    print(f"phase 12: {time.time() - t0:.1f} s")
    print(json.dumps({"kernels": records}))
    print(cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
