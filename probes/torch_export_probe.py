"""The serving export and the kernels' operators alone on one CUDA card:
phase 18 of `chip_smoke.py` without phases 2-17.

    python3 probes/torch_export_probe.py

Builds every kernel library from `neural_lam_tpu_torch/csrc/` (one nvcc
per source, all started together) and runs `chip_smoke.export_phase`:
the operators' dispatcher overhead and the predict steps' host and busy
ms (18a), the bench GraphLAM (fp32, bf16) and the 4-level HiLAM exported,
reloaded in a fresh process and held against the eager step (18b), the
bench graph's interactive pages (18d) and a hidden_layers 2 GraphLAM
(18c). Ends with the card's name and power limit. Exits non-zero without
a card or when a check fails.
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
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    t0 = time.time()
    _build.build_all()
    print(f"kernel build: {time.time() - t0:.1f} s")
    reset_counts, counts, counts_bf16, _ = cs.kernel_registry()
    t0 = time.time()
    cs.export_phase(torch, np, counts, counts_bf16, reset_counts)
    print(f"phase 18: {time.time() - t0:.1f} s")
    print(cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
