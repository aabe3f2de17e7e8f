"""How a last-bit difference a step grows over a HiLAMParallel rollout,
on the CPU: the yardstick for the 19-step kernel-vs-plain limit of
`chip_smoke.py`'s phase 14.

    python3 probes/torch_rollout_noise_probe.py [--nx 81] [--noise 5e-7]

Builds HiLAMParallel (3 levels, hidden 64, 4 processor layers, seeded
weights) on an nx x nx DummyDatastore, rolls it 19 steps at batch 4 on
the plain path, then again with seeded Gaussian noise of the given size
added to each predict step's output, and prints the max abs gap between
the two rollouts at steps 1, 4 and 19.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    sys.path.insert(0, ROOT)
    import torch

    from neural_lam_tpu_torch import entry

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--nx", type=int, default=81)
    parser.add_argument("--noise", type=float, default=5e-7)
    args = parser.parse_args(argv)
    model, _ = entry.build_model(
        nx=args.nx, ny=args.nx, hidden_dim=64, processor_layers=4,
        n_features={"state": 17, "forcing": 6, "static": 4}, n_timesteps=20,
        device="cpu", model="hi_lam_parallel", n_max_levels=3)
    inputs = entry.make_inputs(model, 4, 19, seed=0)
    clean = entry.forecast(model, *inputs)
    step = model.predict_step
    gen = torch.Generator().manual_seed(1)

    def noisy(*a, **kw):
        out, std = step(*a, **kw)
        return out + args.noise * torch.randn(out.shape, generator=gen), std

    model.predict_step = noisy
    perturbed = entry.forecast(model, *inputs)
    for s in (1, 4, 19):
        gap = float((clean[:, s - 1] - perturbed[:, s - 1]).abs().max())
        print(f"step {s}: max abs gap {gap:.3e} (largest |output| "
              f"{float(clean[:, s - 1].abs().max()):.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
