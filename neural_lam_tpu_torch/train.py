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

Evaluation (`--eval val|test`, ref: train_model.py:167-208) runs the
checkpoint given by `--load` over the split at `--batch_size`, the last
batch partial where the split does not divide, and prints what it
computes. `--eval test` (`Trainer.test`) writes to <run_dir>/ the rescaled
error maps `test_rmse.csv` / `test_mae.csv` (lead time x variable), the
spatial loss maps `mean_spatial_loss.npy` and `spatial_loss_t{t}.npy`,
and, where matplotlib imports (`main` checks and prints which case
holds), their figures (`test_rmse.pdf`, `test_mae.pdf`,
`spatial_loss_t{t}.pdf`) and `--n_example_pred` example forecasts
(`example_{pred,target}_{i}.npy`, `example_{i}_{var}_t{t}.png`);
matplotlib is imported only to draw.

`--precision bf16` (or `bf16-mixed`) trains and evaluates on the bf16
path, as the JAX trainer maps both to compute_dtype="bfloat16": fp32
parameters and AdamW state, activations and their gradients stored in
bf16 (the kernels' bf16 instances forward and backward), the loss and
the parameter gradients fp32. Its checkpoints have the fp32 format.

The runtime around the steps (JAX: train.py:53-470):
- `--remat` checkpoints each predict step of the unroll
  (`ModelArgs.remat`): the backward recomputes a step's forward.
- `--num_workers` threads fill the batches' rows, `--prefetch_batches`
  batches ahead (`dataset.WeatherDataLoader`), and `DevicePrefetcher`
  copies them to the card from pinned memory on a side stream while the
  step before runs. Every setting gives the same batches in the same
  order. The epoch log adds `input_wait_s`: the time the steps waited for
  their batch.
- SIGTERM or SIGINT finishes the current step, saves `last` with
  `"preempted": true` and stops; `--load auto` resumes from
  <run_dir>/last when it exists. `TrainFlags.ckpt_every_steps` also
  saves `last` every that many steps.
- `--profile_steps N` runs steps [profile_start, profile_start + N)
  under `torch.profiler` (CPU, and CUDA on the card), writes the trace to
  <run_dir>/profile/ and prints the ops that took the most device time
  (CPU time on the CPU), from the profiler's own averages.
- Metrics also go to W&B (`--wandb_project`) where `wandb` imports.

Not ported yet: ensemble evaluation (`--ensemble_members`, ROADMAP.md
queue 1, item 5), multi-host and spatial sharding.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import re
import signal
import threading
import time
from argparse import ArgumentParser
from pathlib import Path

import numpy as np
import torch

from .checkpoint import (checkpoint_exists, load_checkpoint,
                         save_checkpoint)
from .config import load_config_and_datastore
from .dataset import BackgroundIterator, WeatherDataModule
from .device import resolve_device
from .graph.storage import load_or_build_graph
from .models import MODELS
from .models.ar_model import ModelArgs
from .predict import compute_dtype_of


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
    # also save "last" every this many optimizer steps (0 = off)
    ckpt_every_steps: int = 0
    # trace steps [profile_start, profile_start + profile_steps) with
    # torch.profiler into <run_dir>/profile (0 = off)
    profile_steps: int = 0
    profile_start: int = 3
    # batches copied to the device ahead of the step (0 = synchronous)
    prefetch_batches: int = 2
    wandb_project: str = "neural_lam_tpu"


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


class DevicePrefetcher:
    """Iterate the loader's batches as tensors on `device`, placed by a
    daemon thread up to `depth` batches ahead of the consumer, in the
    loader's order (`dataset.BackgroundIterator`). On CUDA each batch is
    copied from pinned host memory with non_blocking=True on a side
    stream; the consuming stream waits on that copy's event, and each
    tensor records the consuming stream, so its memory is not reused
    before the step that reads it is done. On the CPU the arrays are
    wrapped as they are. An error of the loader is raised again on the
    consuming thread. `close()` (idempotent) stops and joins the thread,
    and the loader's own threads with it: call it when leaving the loop
    early."""

    def __init__(self, loader, device, depth: int = 2):
        self.device = torch.device(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._batches = BackgroundIterator(self._placed(loader), depth)

    def _placed(self, loader):
        it = iter(loader)
        try:
            for batch in it:
                yield self._place(batch)
        finally:
            close = getattr(it, "close", None)
            if close is not None:  # stops the loader's own threads
                close()

    def _place(self, batch):
        if self._stream is None:
            return tuple(torch.as_tensor(b) for b in batch), None
        with torch.cuda.stream(self._stream):
            out = tuple(torch.from_numpy(b).pin_memory().to(
                self.device, non_blocking=True) for b in batch)
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def __iter__(self):
        for batch, event in self._batches:
            if event is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(event)
                for t in batch:
                    t.record_stream(stream)
            yield batch

    def close(self):
        self._batches.close()


class MetricsLogger:
    """stdout + JSONL metrics sink (<run_dir>/metrics.jsonl), forwarded to
    W&B where the `wandb` package imports (the reference's sink,
    ref: train_model.py:271-275): the run is started in __init__ with the
    summary metrics defined (ref: utils.py:236-243), `log` sends the
    scalars and `log_image` a figure. Without wandb one line says so."""

    def __init__(self, run_dir: Path, run_name: str | None = None,
                 config: dict | None = None, val_steps=(),
                 project: str = "neural_lam_tpu"):
        self.path = Path(run_dir) / "metrics.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._wandb = None
        try:
            import wandb
        except ImportError:
            print(f"wandb is not installed: metrics go to {self.path} and "
                  "stdout only", flush=True)
            return
        try:
            wandb.init(project=project, name=run_name, config=config or {},
                       dir=str(self.path.parent))
            wandb.define_metric("val_mean_loss", summary="min")
            for step in val_steps:
                wandb.define_metric(f"val_loss_unroll{step}", summary="min")
        except Exception as e:  # no login, no network
            print(f"W&B logging could not start ({type(e).__name__}: {e}): "
                  f"metrics go to {self.path} and stdout only", flush=True)
            return
        self._wandb = wandb

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
        if self._wandb is not None:
            self._wandb.log({k: v for k, v in rec.items()
                             if not k.startswith("_") and np.ndim(v) == 0},
                            step=step)

    def log_image(self, name: str, fig):
        """Send a matplotlib figure to W&B as an image (the reference logs
        its example and error figures so, ref: ar_model.py:420-566);
        nothing without wandb."""
        if self._wandb is not None:
            self._wandb.log({name: self._wandb.Image(fig)})


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
        """The run's MetricsLogger, started at its first use (its run
        config: the model args and the flags, as the JAX trainer's)."""
        if self._logger is None:
            config = {
                **{f"model.{k}": v for k, v in vars(self.model.args).items()},
                **{f"train.{k}": v for k, v in vars(self.flags).items()},
            }
            self._logger = MetricsLogger(
                self.run_dir, run_name=self.flags.run_name, config=config,
                val_steps=self.model.args.val_steps_to_log,
                project=self.flags.wandb_project)
        return self._logger

    def init_state(self):
        """Restore `flags.load` (model, and the optimizer with
        `restore_opt`) when given; "auto" is <run_dir>/last where it has
        a committed save, also one that a save killed midway moved aside
        (a relaunch after preemption; needs a stable --run_name), else a
        fresh start."""
        if self.flags.load == "auto":
            last = self.run_dir / "last"
            self.flags = dataclasses.replace(
                self.flags,
                load=str(last) if checkpoint_exists(last) else None)
            if self.flags.load is None:
                print(f"--load auto: no checkpoint at {last}, starting "
                      "fresh", flush=True)
        if not self.flags.load:
            return
        model_state, opt_state, meta = load_checkpoint(self.flags.load,
                                                       self.device)
        self.model.load_state_dict(model_state)
        if self.flags.restore_opt:
            if opt_state is None:
                raise ValueError(
                    f"--restore_opt: checkpoint {self.flags.load} holds no "
                    "optimizer state"
                    + (" (it was converted from the JAX package, whose "
                       "AdamW state is not carried across)"
                       if "converted_from" in meta else ""))
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

    def _maybe_profile(self):
        """Start a torch.profiler trace before step `profile_start`; stop
        it before step `profile_start + profile_steps`, write it to
        <run_dir>/profile/ and print the top ops. A profiler that fails
        to start or stop is reported and training goes on untraced."""
        f = self.flags
        if not f.profile_steps:
            return
        prof = getattr(self, "_profiler", None)
        if prof is None and self.global_step == f.profile_start:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            try:
                prof = torch.profiler.profile(activities=activities)
                prof.start()
            except Exception as e:
                print(f"profiling unavailable: {type(e).__name__}: {e}",
                      flush=True)
                self.flags = dataclasses.replace(f, profile_steps=0)
                return
            self._profiler = prof
        elif (prof is not None
              and self.global_step >= f.profile_start + f.profile_steps):
            self._finish_profile()

    def _finish_profile(self):
        """Stop an open trace (also when training ends inside the window),
        export it and print the ops with the most self time."""
        prof = getattr(self, "_profiler", None)
        if prof is None:
            return
        self._profiler = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        out = self.run_dir / "profile"
        out.mkdir(parents=True, exist_ok=True)
        trace = out / f"trace_step{self.flags.profile_start}.json"
        prof.export_chrome_trace(str(trace))
        print(f"profiler trace written to {trace}", flush=True)
        rows = list(prof.key_averages())
        if self.device.type == "cuda":
            # the kernels themselves: not the host ops that launched them,
            # nor the device ranges of annotations (such as
            # "Optimizer.step#AdamW.step") that repeat their time
            key, what = "self_device_time_total", "device"
            rows = [e for e in rows
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)
                    and re.fullmatch(r"[\w.]+#[\w.]+", e.key) is None]
        else:
            key, what = "self_cpu_time_total", "CPU"
        rows = sorted(rows, key=lambda e: getattr(e, key, 0),
                      reverse=True)[:8]
        print(f"top {what} ops:", flush=True)
        for e in rows:
            print(f"  {getattr(e, key, 0) / 1e3:10.3f} ms  x{e.count:<6d} "
                  f"{e.key}", flush=True)

    def fit(self, datamodule):
        """Train for `flags.epochs` (or until `flags.max_steps`), validating
        every `val_interval` epochs. On SIGTERM or SIGINT the current step
        finishes, `last` is saved with "preempted": true and training
        stops; the earlier handlers are back when fit returns. Returns the
        per-step losses."""
        datamodule.setup("fit")
        flags = self.flags
        logger = self.logger  # started (W&B with it) before the first step
        stop = threading.Event()
        prev_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev_handlers[sig] = signal.signal(
                    sig, lambda signum, frame: stop.set())
            except ValueError:  # not the main thread
                pass
        losses = []
        try:
            for epoch in range(flags.epochs):
                t0 = time.time()
                epoch_losses, wait = self._train_epoch(datamodule, epoch,
                                                       stop)
                dt = time.time() - t0
                losses += epoch_losses
                n = len(epoch_losses)
                logger.log({
                    "epoch": epoch,
                    "train_loss": float(np.mean(epoch_losses)) if n
                    else float("nan"),
                    "epoch_s": dt,
                    "batches_per_s": n / dt if dt > 0 else 0.0,
                    "input_wait_s": wait}, step=self.global_step)
                capped = bool(flags.max_steps
                              and self.global_step >= flags.max_steps)
                if (flags.val_interval
                        and (epoch + 1) % flags.val_interval == 0):
                    self._validate_and_save(datamodule, epoch)
                if stop.is_set():
                    print("Preemption signal received: saving last "
                          "checkpoint and stopping.", flush=True)
                    self.save("last", {"step": self.global_step,
                                       "epoch": epoch,
                                       "best_val_loss": self.best_val_loss,
                                       "preempted": True})
                    break
                if capped:
                    break
        finally:
            self._finish_profile()
            for sig, handler in prev_handlers.items():
                signal.signal(sig, handler)
        return losses

    def _train_epoch(self, datamodule, epoch, stop):
        """The steps of one epoch, through the prefetcher when
        `prefetch_batches` > 0; stops at `max_steps` or after the step in
        which `stop` was set. Returns (losses, seconds waited for
        batches)."""
        flags = self.flags
        loader = datamodule.train_dataloader(seed=flags.seed)
        loader.set_epoch(epoch)
        if flags.prefetch_batches > 0:
            batches = DevicePrefetcher(loader, self.device,
                                       flags.prefetch_batches)
        else:
            batches = map(self.to_device, loader)
        it = iter(batches)
        losses, wait = [], 0.0
        try:
            while not (flags.max_steps
                       and self.global_step >= flags.max_steps):
                t_wait = time.perf_counter()
                batch = next(it, None)
                wait += time.perf_counter() - t_wait
                if batch is None:
                    break
                self._maybe_profile()
                losses.append(float(self.train_step(batch)))
                if (flags.ckpt_every_steps
                        and self.global_step % flags.ckpt_every_steps == 0):
                    self.save("last", {"step": self.global_step,
                                       "epoch": epoch,
                                       "best_val_loss": self.best_val_loss})
                if stop.is_set():
                    break
        finally:
            if isinstance(batches, DevicePrefetcher):
                batches.close()
        return losses, wait

    def _validate_and_save(self, datamodule, epoch):
        """Validate, log, and save `min_val_loss` (on improvement) and
        `last`."""
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

    @torch.no_grad()
    def validate(self, datamodule):
        """Mean loss per unroll step over the val split
        (ref: ar_model.py:324-373): time_step_loss (T,), val_mean_loss,
        and per-(T, d) mse / mae."""
        agg = _EvalAggregator()
        for batch in datamodule.val_dataloader():
            agg.add(self.model.eval_step_metrics(self.to_device(batch)))
        return agg.summarize()

    @torch.no_grad()
    def test(self, datamodule, make_plots=True):
        """Test epoch: losses, rmse/mae error maps rescaled to physical
        units, mean spatial loss maps, csv/npy files and, with
        `make_plots`, their figures and example forecasts
        (ref: ar_model.py:375-454, 610-696)."""
        datamodule.setup("test")
        agg = _EvalAggregator(keep_spatial=True)
        example_batch = None
        for batch in datamodule.test_dataloader():
            if example_batch is None:
                example_batch = batch
            agg.add(self.model.eval_step_metrics(self.to_device(batch)))
        summary = agg.summarize()

        model = self.model
        datastore = model.datastore
        args = model.args
        state_std = model.statics.state_std.cpu().numpy()
        log = {"test_mean_loss": summary["val_mean_loss"]}
        for step in args.val_steps_to_log:
            if step <= len(summary["time_step_loss"]):
                log[f"test_loss_unroll{step}"] = \
                    summary["time_step_loss"][step - 1]
        self.logger.log(log)

        artifacts = {}
        var_names = datastore.get_vars_names("state")
        for name, arr in (("rmse", np.sqrt(summary["mse"])),
                          ("mae", summary["mae"])):
            rescaled = arr * state_std  # (T, d)
            full_name = f"test_{name}"
            artifacts[full_name] = rescaled
            np.savetxt(self.run_dir / f"{full_name}.csv", rescaled,
                       delimiter=",")
            # watched metrics: chosen variables at chosen lead times
            # (ref: ar_model.py:599-606)
            if full_name in args.metrics_watch:
                watch = {}
                for var_i, steps in args.var_leads_metrics_watch.items():
                    for step in steps:
                        if step - 1 < rescaled.shape[0]:
                            watch[f"{full_name}_{var_names[int(var_i)]}_"
                                  f"step_{step}"] = \
                                float(rescaled[step - 1, int(var_i)])
                if watch:
                    self.logger.log(watch)

        # lead time t is unroll index t - 1; maps only at the logged ones
        spatial = summary["mean_spatial_loss"]
        lead_times = [t for t in args.val_steps_to_log
                      if 1 <= t <= spatial.shape[0]]
        np.save(self.run_dir / "mean_spatial_loss.npy", spatial)
        for t in lead_times:
            np.save(self.run_dir / f"spatial_loss_t{t}.npy", spatial[t - 1])

        if make_plots:
            from . import vis

            for name, arr in artifacts.items():
                fig = vis.plot_error_map(arr, datastore)
                fig.savefig(self.run_dir / f"{name}.pdf")
                self.logger.log_image(name, fig)
            for t in lead_times:
                fig = vis.plot_spatial_error(
                    spatial[t - 1], datastore,
                    title=f"Test loss, t={t} ({datastore.step_length * t} h)")
                fig.savefig(self.run_dir / f"spatial_loss_t{t}.pdf")
                self.logger.log_image(f"test_loss_t{t}", fig)
            vis.plt.close("all")
            self.plot_examples(example_batch, n_examples=min(
                args.n_example_pred, example_batch[0].shape[0]))
        return {**log, **{k: v.tolist() for k, v in artifacts.items()}}

    @torch.no_grad()
    def plot_examples(self, batch, n_examples=1):
        """Per-variable, per-step prediction/target figures and arrays of
        the first `n_examples` samples of `batch`
        (ref: ar_model.py:456-566)."""
        from . import vis

        model = self.model
        datastore = model.datastore
        prediction, target, _, _ = model.common_step(self.to_device(batch))
        mean = model.statics.state_mean.cpu().numpy()
        std = model.statics.state_std.cpu().numpy()
        pred = prediction.cpu().numpy() * std + mean
        tgt = target.cpu().numpy() * std + mean
        var_names = datastore.get_vars_names("state")
        var_units = datastore.get_vars_units("state")
        for ex in range(n_examples):
            np.save(self.run_dir / f"example_pred_{ex + 1}.npy", pred[ex])
            np.save(self.run_dir / f"example_target_{ex + 1}.npy", tgt[ex])
            for t in range(pred.shape[1]):
                for var_i, (vn, vu) in enumerate(zip(var_names, var_units)):
                    fig = vis.plot_prediction(
                        pred[ex, t, :, var_i], tgt[ex, t, :, var_i],
                        datastore,
                        title=f"{vn} ({vu}), t={t + 1} "
                              f"({datastore.step_length * (t + 1)} h)")
                    fig.savefig(self.run_dir
                                / f"example_{ex + 1}_{vn}_t{t + 1}.png")
                    self.logger.log_image(f"{vn}_example_{ex + 1}", fig)
                    vis.plt.close("all")


class _EvalAggregator:
    """Per-sample sums of what `eval_step_metrics` gives over the batches
    of a split, divided by the sample count (ref: ar_model.py:610-644:
    gather, then the mean over samples). A partial last batch counts its
    own samples; nothing is padded."""

    def __init__(self, keep_spatial=False):
        self.keep_spatial = keep_spatial
        self.n = 0
        self.sums = {}

    def add(self, out):
        keys = ["time_step_loss", "mse", "mae"] + (
            ["spatial_loss"] if self.keep_spatial else [])
        self.n += out["time_step_loss"].shape[0]
        for k in keys:
            s = out[k].double().sum(dim=0).cpu().numpy()
            self.sums[k] = self.sums[k] + s if k in self.sums else s

    def summarize(self):
        if not self.n:
            raise ValueError(
                "no evaluation batches were produced: the split has fewer "
                "samples than one unroll needs")
        mean = {k: (v / self.n).astype(np.float32)
                for k, v in self.sums.items()}
        out = {"time_step_loss": mean["time_step_loss"],
               "val_mean_loss": float(mean["time_step_loss"].mean()),
               "mse": mean["mse"], "mae": mean["mae"]}
        if self.keep_spatial:
            out["mean_spatial_loss"] = mean["spatial_loss"]
        return out


def main(input_args=None):
    """CLI mirroring `python -m neural_lam_tpu.train` for what the port
    runs: GraphLAM and HiLAM (`--model hi_lam --graph hierarchical`)
    training and evaluation on one device. Returns what `--eval` printed
    (None when training)."""
    parser = ArgumentParser(description="Train the PyTorch port's models")
    parser.add_argument("--config_path", type=str, required=True)
    parser.add_argument("--model", type=str, default="graph_lam",
                        choices=sorted(MODELS))
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--epochs", type=int, default=200)
    parser.add_argument("--max_steps", type=int, default=0)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--load", type=str,
                        help="checkpoint path to load, or 'auto' to resume "
                             "from <save_dir>/<run_name>/last when it "
                             "exists (pair with --restore_opt for a true "
                             "resume)")
    parser.add_argument("--restore_opt", action="store_true")
    parser.add_argument("--precision", type=str, default="32",
                        choices=["32", "bf16", "bf16-mixed"],
                        help="bf16 and bf16-mixed: the bf16 path "
                             "(fp32 parameters, bf16 activations), in "
                             "training and evaluation")
    parser.add_argument("--graph", type=str, default="multiscale")
    parser.add_argument("--hidden_dim", type=int, default=64)
    parser.add_argument("--hidden_layers", type=int, default=1)
    parser.add_argument("--processor_layers", type=int, default=4)
    parser.add_argument("--mesh_aggr", type=str, default="sum",
                        choices=["sum", "mean"])
    parser.add_argument("--output_std", action="store_true")
    parser.add_argument("--remat", action="store_true",
                        help="gradient-checkpoint each unroll step "
                             "(memory for compute in long-AR training)")
    parser.add_argument("--ar_steps_train", type=int, default=1)
    parser.add_argument("--ar_steps_eval", type=int, default=10)
    parser.add_argument("--loss", type=str, default="wmse")
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--lr_schedule", default="constant",
                        choices=["constant", "cosine", "warmup_cosine"])
    parser.add_argument("--warmup_steps", type=int, default=1000)
    parser.add_argument("--decay_steps", type=int, default=100_000)
    parser.add_argument("--profile_steps", type=int, default=0,
                        help="capture a torch.profiler trace of N train "
                             "steps into <run_dir>/profile")
    parser.add_argument("--val_interval", type=int, default=1)
    parser.add_argument("--num_past_forcing_steps", type=int, default=1)
    parser.add_argument("--num_future_forcing_steps", type=int, default=1)
    parser.add_argument("--prefetch_batches", type=int, default=2,
                        help="device-prefetch depth: batches transferred "
                             "ahead of the step (0 = synchronous)")
    parser.add_argument("--num_workers", type=int, default=4,
                        help="loader worker threads (ref: torch DataLoader "
                        "num_workers); <=1 fills batches ahead on one "
                        "thread")
    parser.add_argument("--val_steps_to_log", nargs="+", type=int,
                        default=[1, 2, 3, 5, 10, 15, 19])
    parser.add_argument("--eval", type=str, choices=["val", "test"])
    parser.add_argument("--n_example_pred", type=int, default=1)
    parser.add_argument("--metrics_watch", nargs="+", default=[],
                        help="names of metrics to log watched values for")
    parser.add_argument("--var_leads_metrics_watch", type=str, default="{}",
                        help="JSON dict var_index -> [lead steps] to watch")
    parser.add_argument("--ensemble_members", type=int, default=0,
                        help="ensemble evaluation; not ported yet")
    parser.add_argument("--run_name", type=str, default=None)
    parser.add_argument("--wandb_project", type=str,
                        default="neural_lam_tpu",
                        help="W&B project to log to (when wandb is "
                             "importable; ref: train_model.py:169)")
    parser.add_argument("--save_dir", type=str, default="saved_models")
    args = parser.parse_args(input_args)
    if args.ensemble_members > 0:
        raise NotImplementedError(
            "--ensemble_members: ensemble evaluation is not ported yet "
            "(ROADMAP.md queue 1, item 5)")
    compute_dtype = compute_dtype_of(args.precision)

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
        metrics_watch=tuple(args.metrics_watch),
        var_leads_metrics_watch={
            int(k): v
            for k, v in json.loads(args.var_leads_metrics_watch).items()},
        n_example_pred=args.n_example_pred,
        compute_dtype=compute_dtype,
        remat=args.remat,
    )
    flags = TrainFlags(
        epochs=args.epochs, val_interval=args.val_interval, seed=args.seed,
        load=args.load, restore_opt=args.restore_opt,
        run_name=args.run_name
        or f"{args.model}-{args.processor_layers}x{args.hidden_dim}-"
           f"{time.strftime('%m_%d_%H_%M')}",
        save_dir=args.save_dir, lr_schedule=args.lr_schedule,
        warmup_steps=args.warmup_steps, decay_steps=args.decay_steps,
        max_steps=args.max_steps, profile_steps=args.profile_steps,
        prefetch_batches=args.prefetch_batches,
        wandb_project=args.wandb_project,
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
        batch_size=args.batch_size, num_workers=args.num_workers,
    )
    trainer = Trainer(model, flags)
    trainer.init_state()
    if args.eval == "val":
        datamodule.setup("fit")
        result = trainer.validate(datamodule)
    elif args.eval == "test":
        # figures only where matplotlib imports: the card's machine may
        # have none
        make_plots = importlib.util.find_spec("matplotlib") is not None
        print("--eval test: " + ("matplotlib imports, figures are drawn"
                                 if make_plots else "matplotlib is not "
                                 "installed, no figures are drawn"),
              flush=True)
        result = trainer.test(datamodule, make_plots=make_plots)
    else:
        trainer.fit(datamodule)
        return None
    print(result, flush=True)
    return result


if __name__ == "__main__":
    main()
