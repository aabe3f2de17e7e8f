"""HiLAMParallel alone on one CUDA card: phase 14 of `chip_smoke.py`
without phases 2-13.

    python3 probes/torch_hlp_probe.py

Builds every kernel library from `neural_lam_tpu_torch/csrc/` (one nvcc
per source, all started together) and runs
`chip_smoke.hilam_parallel_phase` at `benchmarks.py`'s
hi_lam_parallel_meps_ar19 configuration: the launch tables, the 19-step
rollout against the plain path, P1 with messages at every batched chunk
shape, fp32 and bf16 training beside a 3-level HiLAM, and the train and
predict CLIs. Ends with the card's name and power limit. Exits non-zero
without a card or when a check fails.
"""

from __future__ import annotations

import importlib.util
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
    t0 = time.time()
    _build.build_all()
    print(f"kernel build: {time.time() - t0:.1f} s")
    _, peak_tf32, peak_bw, _ = cs.peaks(torch.cuda.get_device_name(0))
    reset_counts, counts, counts_bf16, plain_kernels = cs.kernel_registry()
    zero_all = dict({k: 0 for k in cs.FWD + cs.BATCHED}, xtd_sum=0,
                    xtd_reduce=0, **{k + "_bwd": 0 for k in cs.FWD})
    t0 = time.time()
    cs.hilam_parallel_phase(torch, np, counts, counts_bf16, reset_counts,
                            plain_kernels, zero_all, peak_tf32, peak_bw)
    print(f"phase 14: {time.time() - t0:.1f} s")
    print(cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
