"""The latent models alone on one CUDA card: phase 15 of `chip_smoke.py`
without phases 2-14.

    python3 probes/torch_efm_probe.py

Builds every kernel library from `neural_lam_tpu_torch/csrc/` (one nvcc
per source, all started together) and runs `chip_smoke.latent_phase`:
GraphEFM at benchmarks.py's graph_efm_meps_ar4 and HiEFM at its
prob_model_global_0p7deg (prior-mean rollouts with their launch and fold
tables, ensembles at batch 1 and 4 against the plain path, ELBO and
crps_ens training in fp32 and bf16), then the train, eval and predict
CLIs on a small global datastore. Ends with the card's name and power
limit. Exits non-zero without a card or when a check fails.
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
    reset_counts, counts, counts_bf16, plain_kernels = cs.kernel_registry()
    zero_all = dict.fromkeys(cs.FWD + cs.BATCHED, 0)
    zero_all.update(xtd_sum=0, xtd_reduce=0,
                    **{k + "_bwd": 0 for k in cs.FWD})
    t0 = time.time()
    cs.latent_phase(torch, np, counts, counts_bf16, reset_counts,
                    plain_kernels, zero_all)
    print(f"phase 15: {time.time() - t0:.1f} s")
    print(cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
