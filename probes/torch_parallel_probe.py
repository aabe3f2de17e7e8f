"""Data parallelism and the spatial schemes alone on one CUDA card:
phases 16-17 of `chip_smoke.py` without phases 2-15.

    python3 probes/torch_parallel_probe.py

Builds every kernel library from `neural_lam_tpu_torch/csrc/` (one nvcc
per source, all started together) and runs `chip_smoke.parallel_phase`:
train.main on one process at batch 4 and as a one-rank nccl world, then
two rank processes on the card with gloo (16a: 3 data-parallel AdamW
steps through train.main; 16b-c: every family grid-sharded against its
unsharded run, launches against the per-rank tables, collectives and
timings), then two more (17a-b: every family under mesh_rs and
mesh_halo, held the same way, its collectives against their tables;
17c: train.main under mesh_halo against 16a's losses). Ends with the
card's name and power limit. Exits non-zero without a card or when a
check fails.
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
    reset_counts, counts, _, _ = cs.kernel_registry()
    t0 = time.time()
    cs.parallel_phase(torch, np, counts, reset_counts)
    print(f"phases 16-17: {time.time() - t0:.1f} s")
    print(cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
