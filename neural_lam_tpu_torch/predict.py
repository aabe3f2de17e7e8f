"""Inference CLI: roll a trained checkpoint forward and write a forecast.

Counterpart of neural_lam_tpu/predict.py, with the same flags and output
(the reference has no dedicated inference entry point; forecasting is only
reachable through `--eval`, ref: neural_lam/train_model.py:293-296). It
loads a checkpoint, picks an initialization from a datastore split, runs
the autoregressive rollout, un-standardizes, and writes a self-describing
zarr (or .npz) with time stamps and feature names:

    python -m neural_lam_tpu_torch.predict --config_path cfg.yaml \\
        --model graph_lam --graph multiscale --load ckpt/min_val_loss \\
        --ar_steps 10 --split test --sample_idx -1 --out forecast.zarr

`--load` takes one of three sources:

- a checkpoint directory of the port (`<dir>/state.pt`, written by the
  port's trainer or by `checkpoint.save_checkpoint`);
- a JAX package checkpoint, once `convert_jax_checkpoint.py` has turned it
  into the port's format;
- a reference Neural-LAM Lightning `.ckpt` or state-dict `.pt` file, read
  through `torch_compat.load_torch_checkpoint`.

Boundary handling matches evaluation: the boundary ring is forced with
the datastore's stored future states for the forecast window (a real
deployment feeds these from the host model's forecast instead).
`--precision bf16` (or `bf16-mixed`, the same here, as in the JAX CLI)
forecasts on the bf16 path: fp32 parameters, activations stored in bf16,
the kernels' bf16 instances. Everything runs on CUDA unless `--device
cpu`; without CUDA the default raises.

`--ensemble_members N` samples N members (`ensemble.sample_rollout`, its
noise from a generator seeded with `--seed`) of an `--output_std` or
latent model (`--model graph_efm|hi_efm`, `--latent_dim`); the written
array then has a leading `member` dim.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

def add_model_flags(parser):
    """Architecture flags (those of the JAX predict and export CLIs). They
    must reconstruct the SAME model the checkpoint was trained with —
    structural mismatches fail loudly at restore, but parameter-free knobs
    (mesh_aggr) would silently change the math if dropped."""
    parser.add_argument("--model", default="graph_lam")
    parser.add_argument("--graph", default="multiscale")
    parser.add_argument("--hidden_dim", type=int, default=64)
    parser.add_argument("--hidden_layers", type=int, default=1)
    parser.add_argument("--processor_layers", type=int, default=4)
    parser.add_argument("--mesh_aggr", default="sum",
                        choices=["sum", "mean"])
    parser.add_argument("--output_std", action="store_true")
    parser.add_argument("--latent_dim", type=int, default=32)
    parser.add_argument("--num_past_forcing_steps", type=int, default=1)
    parser.add_argument("--num_future_forcing_steps", type=int, default=1)
    parser.add_argument("--precision", default="32",
                        choices=["32", "bf16", "bf16-mixed"],
                        help="bf16 and bf16-mixed: the bf16 forecast path")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config_path", required=True)
    add_model_flags(parser)
    parser.add_argument("--load", required=True,
                        help="checkpoint to restore: a directory of the "
                             "port's, or a reference .ckpt/.pt file")
    parser.add_argument("--split", default="test",
                        choices=["train", "val", "test"])
    parser.add_argument("--sample_idx", type=int, default=-1,
                        help="initialization sample within the split "
                             "(-1 = latest available)")
    parser.add_argument("--ar_steps", type=int, default=10)
    parser.add_argument("--ensemble_members", type=int, default=0,
                        help="sample N members (needs an output_std or "
                             "latent model); 0 = deterministic forecast")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", required=True,
                        help="output path: *.zarr directory or *.npz")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser.parse_args(argv)


def compute_dtype_of(precision: str):
    """ModelArgs.compute_dtype of a --precision flag, as the JAX CLIs map
    it: "bfloat16" for bf16 and bf16-mixed, else None (fp32)."""
    return "bfloat16" if precision.startswith("bf16") else None


def check_supported(args):
    """Raise for a model the port does not have, and for an ensemble of a
    model that cannot sample one."""
    from .models import MODELS

    if args.model not in MODELS:
        raise ValueError(
            f"--model {args.model!r} is not one of the port's models "
            f"{sorted(MODELS)}")
    if args.ensemble_members > 0 and not (
            args.output_std or getattr(MODELS[args.model], "is_latent",
                                       False)):
        raise ValueError("--ensemble_members: ensemble sampling needs an "
                         "--output_std or latent model (graph_efm, hi_efm)")


def prepare(args):
    """(model with the checkpoint's weights, datastore, checkpoint meta)
    on `args.device`; the graph comes from <datastore root>/graph/<graph>,
    built there first when absent."""
    from .checkpoint import load_checkpoint
    from .config import load_config_and_datastore
    from .device import resolve_device
    from .graph.storage import load_or_build_graph
    from .models import MODELS
    from .models.ar_model import ModelArgs

    check_supported(args)
    device = resolve_device(args.device)
    config, datastore = load_config_and_datastore(args.config_path)
    model_args = ModelArgs(
        hidden_dim=args.hidden_dim,
        hidden_layers=args.hidden_layers,
        processor_layers=args.processor_layers,
        mesh_aggr=args.mesh_aggr,
        output_std=args.output_std,
        latent_dim=args.latent_dim,
        num_past_forcing_steps=args.num_past_forcing_steps,
        num_future_forcing_steps=args.num_future_forcing_steps,
        compute_dtype=compute_dtype_of(args.precision),
    )
    graph = load_or_build_graph(datastore, args.graph, device)
    model = MODELS[args.model](model_args, config, datastore, graph,
                               device=device)
    if Path(args.load).is_file():
        from .torch_compat import load_torch_checkpoint

        state, meta = load_torch_checkpoint(args.load, model.state_dict()), {}
    else:
        state, _, meta = load_checkpoint(args.load, device)
    model.load_state_dict(state)
    return model, datastore, meta


def rollout(model, datastore, args):
    """Standardized forecast (ar_steps, N, d) as numpy, or with
    `args.ensemble_members` the members (m, ar_steps, N, d), and the valid
    times as int64 epoch-ns, from sample `args.sample_idx` of
    `args.split`."""
    from .dataset import WeatherDataset, collate

    ds = WeatherDataset(datastore, split=args.split, ar_steps=args.ar_steps,
                        num_past_forcing_steps=args.num_past_forcing_steps,
                        num_future_forcing_steps=args.num_future_forcing_steps)
    raw = collate([ds[args.sample_idx]])
    init_states, target_states, forcing = (
        torch.as_tensor(b, device=model.device) for b in raw[:3])
    with torch.no_grad():
        if args.ensemble_members > 0:
            from .ensemble import sample_rollout

            gen = torch.Generator(device=model.device)
            gen.manual_seed(args.seed)
            pred = sample_rollout(model, init_states, forcing, target_states,
                                  gen, n_members=args.ensemble_members)
        else:
            pred, _ = model.unroll_prediction(init_states, forcing,
                                              target_states)
    # valid times stay on the host as int64 ns
    return pred[0].cpu().numpy(), np.asarray(raw[3][0])


def write_forecast(out, prediction, times, names, attrs):
    """Write the forecast as a .npz or a consolidated zarr group (chunks
    zlib-compressed, so no system libblosc is needed); returns its dims,
    with a leading "member" for an ensemble's 4-dim prediction."""
    from .datastore.zarr_reader import consolidate_metadata, write_zarr_array

    out = Path(out)
    dims = (["member"] if prediction.ndim == 4 else []) + [
        "time", "grid_index", "state_feature"]
    if out.suffix == ".npz":
        np.savez_compressed(out, state=prediction, time=times.astype("int64"),
                            state_feature=np.array(names))
        return dims
    zlib = {"id": "zlib", "level": 5}
    out.mkdir(parents=True, exist_ok=True)
    write_zarr_array(out, "state", prediction, dims=dims, attrs=attrs,
                     compressor=zlib)
    write_zarr_array(out, "time", times, dims=["time"], compressor=zlib)
    write_zarr_array(out, "state_feature", np.array(names, dtype=object),
                     dims=["state_feature"], compressor=None)
    consolidate_metadata(out)
    return dims


def main(argv=None):
    """Run the CLI; returns the JSON summary it prints, with the init and
    rollout seconds added."""
    args = parse_args(argv)
    t0 = time.time()
    model, datastore, meta = prepare(args)
    init_s = time.time() - t0
    print(f"restored step-{meta.get('step', '?')} checkpoint, "
          f"init built in {init_s:.1f}s", flush=True)

    t0 = time.time()
    prediction, times = rollout(model, datastore, args)
    rollout_s = time.time() - t0
    members = (f", {args.ensemble_members} members"
               if args.ensemble_members > 0 else "")
    print(f"rollout ({args.ar_steps} steps{members}) in {rollout_s:.1f}s",
          flush=True)

    # un-standardize to physical units
    stats = datastore.get_standardization_dataarray(category="state")
    mean = np.asarray(stats["state_mean"], np.float32)
    std = np.asarray(stats["state_std"], np.float32)
    prediction = prediction * std + mean
    times = times.astype("datetime64[ns]")
    names = list(datastore.get_vars_names("state"))
    dims = write_forecast(args.out, prediction, times, names, attrs={
        "units": "per-variable physical units",
        "source_checkpoint": str(args.load), "model": args.model})
    summary = {
        "out": str(args.out),
        "shape": list(prediction.shape),
        "dims": dims,
        "first_valid_time": str(times[0]),
        "last_valid_time": str(times[-1]),
    }
    print(json.dumps(summary), flush=True)
    return dict(summary, init_s=init_s, rollout_s=rollout_s)


if __name__ == "__main__":
    main()
