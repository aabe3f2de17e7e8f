"""The rest of training alone on one CUDA card: phase 13 of
`chip_smoke.py` without phases 2-12.

    python3 probes/torch_train_runtime_probe.py

Builds every kernel library from `neural_lam_tpu_torch/csrc/` (one nvcc
per source, all started together) and runs
`chip_smoke.rest_of_training_phase`: one AdamW step with and without
`--remat` on the same weights and batch (the bench GraphLAM at ar_steps 4
in fp32 and bf16, the bench HiLAM at ar_steps 2), `train.main` on a
268x238 MDP datastore serially and with the pooled loader, the prefetcher,
remat and a trace, and a SIGTERM'd `train.main` subprocess resumed with
`--load auto --restore_opt`. Ends with the card's name and power limit.
Exits non-zero without a card or when a check fails.
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
    print(cs.smi_line())
    t0 = time.time()
    _build.build_all()
    print(f"kernel build: {time.time() - t0:.1f} s")
    reset_counts, counts, counts_bf16, _ = cs.kernel_registry()
    t0 = time.time()
    cs.rest_of_training_phase(torch, np, counts, counts_bf16, reset_counts)
    print(f"phase 13: {time.time() - t0:.1f} s")
    print(cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
