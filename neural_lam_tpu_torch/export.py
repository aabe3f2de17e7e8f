"""Serving export: a checkpoint's predict step as a `torch.export` program.

Counterpart of neural_lam_tpu/export.py. The artifact is an
`ExportedProgram` (`torch.export.save`) of one predict step at a fixed
batch size, with the weights, the graph and the rollout context baked in,
so that a serving process can load and call it without the model code;
beside it, a sidecar JSON with the input/output contract:

    python -m neural_lam_tpu_torch.export --config_path cfg.yaml \\
        --model graph_lam --graph multiscale --load ckpt/min_val_loss \\
        --batch_size 4 --out model.pt2

    from neural_lam_tpu_torch.export import load_exported
    step = load_exported("model.pt2")
    next_state, pred_std = step(prev_state, prev_prev_state, forcing)

Inputs and outputs are in STANDARDIZED units, the predict step's own
contract: (B, N_grid, d_state) twice and (B, N_grid, d_forcing) in,
(prediction, pred_std) out, pred_std a zero scalar for a model without
`--output_std`. The program holds the port's fused kernels as the
operators of `ops/library.py` (`nlt::*`), which `load_exported` registers
first (it imports nothing of the models), and it runs on the device it
was exported on: `--device` defaults to cuda and raises without it. The
route of each edge set (flat or batched) is the one the eager step takes
at the exported batch size.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch


class PredictStep(torch.nn.Module):
    """One predict step of `model` on its rollout context, computed once
    here (`precompute_rollout_ctx`): (prev_state, prev_prev_state,
    forcing) -> (prediction, pred_std), pred_std a zero scalar where the
    model has no std head."""

    def __init__(self, model):
        super().__init__()
        self.model = model
        with torch.no_grad():
            self.ctx = model.precompute_rollout_ctx()

    def forward(self, prev_state, prev_prev_state, forcing):
        pred, std = self.model.predict_step(prev_state, prev_prev_state,
                                            forcing, ctx=self.ctx)
        if std is None:
            std = prev_state.new_zeros(())
        return pred, std


def export_predict_step(model, batch_size: int):
    """(ExportedProgram of a batch_size-shaped predict step on the model's
    device, its sidecar metadata)."""
    n = model.num_grid_nodes
    d = model.num_state_vars
    d_f = model.grid_dim - 2 * d - model.grid_static_dim
    dev = model.device

    def zeros(width):
        return torch.zeros((batch_size, n, width), device=dev)

    with torch.no_grad():
        program = torch.export.export(PredictStep(model),
                                      (zeros(d), zeros(d), zeros(d_f)),
                                      strict=False)
    meta = {
        "model": type(model).__name__,
        "batch_size": batch_size,
        "n_grid": n,
        "n_state_vars": d,
        "n_forcing_features": d_f,
        "output_std": bool(model.output_std),
        "platforms": [torch.device(dev).type],
        "units": "standardized (apply state_mean/std outside)",
    }
    return program, meta


def load_exported(path):
    """Load an exported artifact; returns a callable (prev, prev_prev,
    forcing) -> (prediction, pred_std) on the device it was exported on,
    run without autograd. Registers the kernels' operators first and
    imports nothing of the models."""
    from .ops import library

    library.load_all()
    module = torch.export.load(str(path)).module()

    def step(prev_state, prev_prev_state, forcing):
        with torch.no_grad():
            return module(prev_state, prev_prev_state, forcing)

    return step


def main(argv=None):
    from .predict import add_model_flags, prepare

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config_path", required=True)
    add_model_flags(parser)
    parser.add_argument("--load", required=True,
                        help="checkpoint to restore: a directory of the "
                             "port's, or a reference .ckpt/.pt file")
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--out", required=True, help="output .pt2 path")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.set_defaults(ensemble_members=0)
    args = parser.parse_args(argv)

    t0 = time.time()
    model, _, meta_ckpt = prepare(args)
    model.eval()
    program, meta = export_predict_step(model, args.batch_size)
    out = Path(args.out)
    torch.export.save(program, str(out))
    meta["checkpoint_step"] = meta_ckpt.get("step")
    with open(out.with_suffix(out.suffix + ".json"), "w") as f:
        json.dump(meta, f, indent=2)
    print(json.dumps({
        "out": str(out),
        "bytes": out.stat().st_size,
        "elapsed_s": round(time.time() - t0, 1),
        **{k: meta[k] for k in ("platforms", "batch_size", "n_grid")},
    }), flush=True)


if __name__ == "__main__":
    main()
