"""Training runtime and CLI.

Counterpart of neural_lam_tpu/train.py (ref: neural_lam/train_model.py:
27-300) for one device:

    python -m neural_lam_tpu_torch.train --config_path config.yaml \\
        --hidden_dim 64 --processor_layers 4 --epochs 1 --batch_size 4

One training step is `training_loss` over an autoregressive unroll, its
backward (through the hand-written backward kernels on CUDA) and one
`torch.optim.AdamW(lr, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.01)`
update -- optax's `adamw` as the JAX trainer configures it -- at a learning
rate from one of three schedules (`lr_at`). `fit` runs epochs with an
optional step cap, validates (`val_mean_loss`), and keeps the `last` and
`min_val_loss` checkpoints; metrics go to stdout and
<run_dir>/metrics.jsonl. Everything runs on CUDA unless `--device cpu`.

Not ported yet: `--eval test`, example plots, ensemble evaluation,
multi-host and spatial sharding, W&B, profiling, `--remat`.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
from argparse import ArgumentParser
from pathlib import Path

import numpy as np
import torch

from .checkpoint import load_checkpoint, save_checkpoint
from .config import load_config_and_datastore
from .dataset import WeatherDataModule
from .device import resolve_device
from .graph.build import create_graph
from .graph.storage import graph_from_bundle, load_graph_bundle
from .models import MODELS
from .models.ar_model import ModelArgs


@dataclasses.dataclass
class TrainFlags:
    """Runtime flags the trainer reads (the single-device part of ref:
    train_model.py:29-209; batch size and unroll lengths belong to the
    datamodule)."""

    epochs: int = 200
    val_interval: int = 1
    seed: int = 42
    load: str | None = None
    restore_opt: bool = False
    run_name: str = "run"
    save_dir: str = "saved_models"
    # "constant" | "cosine" | "warmup_cosine" (train.py:240-251)
    lr_schedule: str = "constant"
    warmup_steps: int = 1000
    decay_steps: int = 100_000
    # stop after this many optimizer steps (0 = no cap)
    max_steps: int = 0


def lr_at(step: int, lr: float, schedule: str = "constant",
          warmup_steps: int = 1000, decay_steps: int = 100_000) -> float:
    """Learning rate of optimizer step `step` (0-based), as optax's
    schedules give it: constant; `cosine_decay_schedule(lr, decay_steps)`;
    `warmup_cosine_decay_schedule(0, lr, warmup_steps, decay_steps)`."""
    def cosine(peak, t, n):
        t = min(float(t), float(n))
        return peak * 0.5 * (1.0 + math.cos(math.pi * t / n))

    if schedule == "constant":
        return lr
    if schedule == "cosine":
        return cosine(lr, step, decay_steps)
    if schedule == "warmup_cosine":
        if step < warmup_steps:
            return lr * step / warmup_steps
        return cosine(lr, step - warmup_steps, decay_steps - warmup_steps)
    raise ValueError(f"unknown lr_schedule {schedule!r}")


class MetricsLogger:
    """stdout + JSONL metrics sink (<run_dir>/metrics.jsonl)."""

    def __init__(self, run_dir: Path):
        self.path = Path(run_dir) / "metrics.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, metrics: dict, step: int | None = None):
        rec = {"_time": time.time()}
        if step is not None:
            rec["step"] = step
        rec.update({k: (float(v) if np.ndim(v) == 0
                        else np.asarray(v).tolist())
                    for k, v in metrics.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps({k: v for k, v in rec.items()
                          if not k.startswith("_")}), flush=True)


class Trainer:
    """Training loop over a model and a datamodule, on the model's device."""

    def __init__(self, model, flags: TrainFlags, run_dir=None):
        self.model = model
        self.flags = flags
        self.device = model.device
        self.run_dir = Path(run_dir or Path(flags.save_dir) / flags.run_name)
        self._logger = None
        self.optimizer = torch.optim.AdamW(
            model.parameters(), lr=model.args.lr, betas=(0.9, 0.95),
            eps=1e-8, weight_decay=0.01,
        )
        self.global_step = 0
        self.best_val_loss = float("inf")

    @property
    def logger(self) -> MetricsLogger:
        if self._logger is None:
            self._logger = MetricsLogger(self.run_dir)
        return self._logger

    def init_state(self):
        """Restore `flags.load` (model, and the optimizer with
        `restore_opt`) when given."""
        if not self.flags.load:
            return
        model_state, opt_state, meta = load_checkpoint(self.flags.load,
                                                       self.device)
        self.model.load_state_dict(model_state)
        if self.flags.restore_opt and opt_state is not None:
            self.optimizer.load_state_dict(opt_state)
        self.global_step = int(meta.get("step", 0))
        self.best_val_loss = float(meta.get("best_val_loss", float("inf")))
        print(f"Restored checkpoint from {self.flags.load} "
              f"(step {self.global_step})", flush=True)

    def to_device(self, batch):
        return tuple(torch.as_tensor(b, device=self.device) for b in batch)

    def train_step(self, batch):
        """One AdamW step on a device batch; returns the loss (a 0-dim
        tensor on the device, not synchronised)."""
        f = self.flags
        lr = lr_at(self.global_step, self.model.args.lr, f.lr_schedule,
                   f.warmup_steps, f.decay_steps)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.model.training_loss(batch)
        loss.backward()
        self.optimizer.step()
        self.global_step += 1
        return loss.detach()

    def train_batches(self, datamodule, epoch: int):
        """Device batches of one training epoch (seeded shuffle)."""
        loader = datamodule.train_dataloader(seed=self.flags.seed)
        loader.set_epoch(epoch)
        for batch in loader:
            yield self.to_device(batch)

    def save(self, name: str, meta: dict):
        save_checkpoint(self.run_dir, name, self.model.state_dict(),
                        self.optimizer.state_dict(), meta)

    def fit(self, datamodule):
        """Train for `flags.epochs` (or until `flags.max_steps`), validating
        every `val_interval` epochs. Returns the per-step losses."""
        datamodule.setup("fit")
        flags = self.flags
        losses = []
        for epoch in range(flags.epochs):
            t0 = time.time()
            epoch_losses = []
            for batch in self.train_batches(datamodule, epoch):
                if flags.max_steps and self.global_step >= flags.max_steps:
                    break
                epoch_losses.append(float(self.train_step(batch)))
            dt = time.time() - t0
            losses += epoch_losses
            self.logger.log({"epoch": epoch,
                             "train_loss": float(np.mean(epoch_losses))
                             if epoch_losses else float("nan"),
                             "epoch_s": dt,
                             "batches_per_s": len(epoch_losses) / dt
                             if dt > 0 else 0.0}, step=self.global_step)
            capped = bool(flags.max_steps
                          and self.global_step >= flags.max_steps)
            if flags.val_interval and (epoch + 1) % flags.val_interval == 0:
                val = self.validate(datamodule)
                val_loss = val["val_mean_loss"]
                log = {"epoch": epoch, "val_mean_loss": val_loss}
                tsl = val["time_step_loss"]
                for step in self.model.args.val_steps_to_log:
                    if step <= len(tsl):
                        log[f"val_loss_unroll{step}"] = tsl[step - 1]
                self.logger.log(log, step=self.global_step)
                meta = {"step": self.global_step, "epoch": epoch,
                        "val_mean_loss": val_loss,
                        "best_val_loss": min(self.best_val_loss, val_loss)}
                if val_loss < self.best_val_loss:
                    self.best_val_loss = val_loss
                    self.save("min_val_loss", meta)
                self.save("last", meta)
            if capped:
                break
        return losses

    @torch.no_grad()
    def validate(self, datamodule):
        """Mean loss per unroll step over the val split
        (ref: ar_model.py:324-373): time_step_loss (T,), val_mean_loss,
        and per-(T, d) mse / mae."""
        tsl, mse, mae = [], [], []
        for batch in datamodule.val_dataloader():
            out = self.model.eval_step_metrics(self.to_device(batch))
            tsl.append(out["time_step_loss"].cpu().numpy())
            mse.append(out["mse"].cpu().numpy())
            mae.append(out["mae"].cpu().numpy())
        if not tsl:
            raise ValueError("no validation batches were produced")
        tsl = np.concatenate(tsl).mean(axis=0)
        return {"time_step_loss": tsl, "val_mean_loss": float(tsl.mean()),
                "mse": np.concatenate(mse).mean(axis=0),
                "mae": np.concatenate(mae).mean(axis=0)}


def load_or_build_graph(datastore, name: str, device):
    """The graph under <datastore root>/graph/<name>, built there first when
    absent, as the JAX trainer does: hierarchical when the name holds
    "hier", one level when it holds "1level", multiscale otherwise."""
    graph_dir = Path(datastore.root_path) / "graph" / name
    if not (graph_dir / "meta.json").exists():
        print(f"graph '{name}' not found under {graph_dir.parent}; "
              "building it", flush=True)
        create_graph(str(graph_dir), datastore.get_xy("state", stacked=False),
                     n_max_levels=1 if "1level" in name.lower() else None,
                     hierarchical="hier" in name.lower())
    return graph_from_bundle(load_graph_bundle(str(graph_dir)), device)


def main(input_args=None):
    """CLI mirroring `python -m neural_lam_tpu.train` for what the port
    runs: GraphLAM and HiLAM (`--model hi_lam --graph hierarchical`)
    training on one device."""
    parser = ArgumentParser(description="Train the PyTorch port's models")
    parser.add_argument("--config_path", type=str, required=True)
    parser.add_argument("--model", type=str, default="graph_lam",
                        choices=sorted(MODELS))
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--epochs", type=int, default=200)
    parser.add_argument("--max_steps", type=int, default=0)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--load", type=str)
    parser.add_argument("--restore_opt", action="store_true")
    parser.add_argument("--graph", type=str, default="multiscale")
    parser.add_argument("--hidden_dim", type=int, default=64)
    parser.add_argument("--hidden_layers", type=int, default=1)
    parser.add_argument("--processor_layers", type=int, default=4)
    parser.add_argument("--mesh_aggr", type=str, default="sum",
                        choices=["sum", "mean"])
    parser.add_argument("--output_std", action="store_true")
    parser.add_argument("--ar_steps_train", type=int, default=1)
    parser.add_argument("--ar_steps_eval", type=int, default=10)
    parser.add_argument("--loss", type=str, default="wmse")
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--lr_schedule", default="constant",
                        choices=["constant", "cosine", "warmup_cosine"])
    parser.add_argument("--warmup_steps", type=int, default=1000)
    parser.add_argument("--decay_steps", type=int, default=100_000)
    parser.add_argument("--val_interval", type=int, default=1)
    parser.add_argument("--num_past_forcing_steps", type=int, default=1)
    parser.add_argument("--num_future_forcing_steps", type=int, default=1)
    parser.add_argument("--val_steps_to_log", nargs="+", type=int,
                        default=[1, 2, 3, 5, 10, 15, 19])
    parser.add_argument("--run_name", type=str, default=None)
    parser.add_argument("--save_dir", type=str, default="saved_models")
    args = parser.parse_args(input_args)

    device = resolve_device(args.device)
    torch.manual_seed(args.seed)
    config, datastore = load_config_and_datastore(args.config_path)
    model_args = ModelArgs(
        hidden_dim=args.hidden_dim, hidden_layers=args.hidden_layers,
        processor_layers=args.processor_layers, mesh_aggr=args.mesh_aggr,
        output_std=args.output_std, loss=args.loss, lr=args.lr,
        num_past_forcing_steps=args.num_past_forcing_steps,
        num_future_forcing_steps=args.num_future_forcing_steps,
        val_steps_to_log=tuple(args.val_steps_to_log),
    )
    flags = TrainFlags(
        epochs=args.epochs, val_interval=args.val_interval, seed=args.seed,
        load=args.load, restore_opt=args.restore_opt,
        run_name=args.run_name
        or f"{args.model}-{args.processor_layers}x{args.hidden_dim}-"
           f"{time.strftime('%m_%d_%H_%M')}",
        save_dir=args.save_dir, lr_schedule=args.lr_schedule,
        warmup_steps=args.warmup_steps, decay_steps=args.decay_steps,
        max_steps=args.max_steps,
    )
    graph = load_or_build_graph(datastore, args.graph, device)
    model = MODELS[args.model](
        model_args, config, datastore, graph, device=device,
        generator=torch.Generator().manual_seed(args.seed))
    datamodule = WeatherDataModule(
        datastore, ar_steps_train=args.ar_steps_train,
        ar_steps_eval=args.ar_steps_eval, standardize=True,
        num_past_forcing_steps=args.num_past_forcing_steps,
        num_future_forcing_steps=args.num_future_forcing_steps,
        batch_size=args.batch_size,
    )
    trainer = Trainer(model, flags)
    trainer.init_state()
    trainer.fit(datamodule)


if __name__ == "__main__":
    main()
