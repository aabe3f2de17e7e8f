"""Entry points: build a GraphLAM, HiLAM, HiLAMParallel, GraphEFM or
HiEFM, run a forecast rollout or an ensemble, and train it for a few
steps.

Counterpart of `_build_model` in the repository's `__graft_entry__.py`
and of the rollouts `bench.py` and `benchmarks.py` time: a DummyDatastore
of the given grid and feature counts (or, with `global_grid=True`, a
DummyGlobalDatastore of nx longitudes by ny latitudes), the mesh graph
built for it (multiscale for GraphLAM and GraphEFM, hierarchical for the
others; icosahedral on the global grid), and the model with weights drawn
from a seeded `torch.Generator`.

    model, datastore = build_model(nx=268, ny=238,
                                   n_features={"state": 17, "forcing": 6,
                                               "static": 4})
    init, forcing, true = make_inputs(model, batch_size=4, steps=4)
    prediction = forecast(model, init, forcing, true)
    losses = train_steps(model, datastore, batch_size=4, ar_steps=1,
                         steps=10)
    hilam, _ = build_model(model="hi_lam", nx=268, ny=238)
    parallel, _ = build_model(model="hi_lam_parallel", nx=268, ny=238,
                              n_max_levels=3)
    efm, _ = build_model(model="hi_efm", nx=512, ny=256, global_grid=True,
                         refinements=5, n_max_levels=3)
    members = sample_ensemble(efm, *make_inputs(efm, 1, 4), n_members=5)

Everything defaults to device="cuda" and raises when CUDA is absent;
pass device="cpu" to run the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

import dataclasses
import tempfile

import numpy as np
import torch

from .config import DatastoreSelection, NeuralLAMConfig, TrainingConfig
from .dataset import WeatherDataModule
from .datastore.dummy import DummyDatastore
from .datastore.dummy_global import DummyGlobalDatastore
from .device import resolve_device
from .ensemble import sample_rollout
from .graph.build import create_graph
from .graph.global_mesh import create_global_graph
from .graph.storage import graph_from_bundle
from .models import MODELS, is_hierarchical
from .models.ar_model import ModelArgs
from .train import Trainer, TrainFlags


def build_model(nx=60, ny=60, hidden_dim=64, processor_layers=4,
                n_features=None, n_timesteps=20, seed=0, device="cuda",
                compute_dtype=None, model="graph_lam", n_max_levels=None,
                global_grid=False, refinements=3, hidden_layers=1):
    """(model, datastore) on `device`, weights from `seed`: `model` is
    "graph_lam" or "graph_efm" (multiscale mesh graph), "hi_lam",
    "hi_lam_parallel" or "hi_efm" (hierarchical mesh graph, which needs
    at least 27 grid points per side on a LAM grid). `n_max_levels` caps
    the mesh levels (None: as many as the grid takes). `global_grid`:
    an nx x ny (longitude x latitude) DummyGlobalDatastore and an
    icosahedral mesh refined `refinements` times (`n_max_levels` levels
    from the finest up). `hidden_layers` other than 1 gives MLPs that the
    fused kernels do not take: every round runs the plain route."""
    if model not in MODELS:
        raise ValueError(f"unknown model {model!r}; one of {sorted(MODELS)}")
    device = resolve_device(device)
    hierarchical = is_hierarchical(model)
    if global_grid:
        datastore = DummyGlobalDatastore(n_lon=nx, n_lat=ny,
                                         n_timesteps=n_timesteps,
                                         n_features=n_features)
        kind = "dummydata_global"
    else:
        datastore = DummyDatastore(grid_shape=(nx, ny),
                                   n_timesteps=n_timesteps,
                                   n_features=n_features)
        kind = "dummydata"
    config = NeuralLAMConfig(
        datastore=DatastoreSelection(kind=kind, config_path=""),
        training=TrainingConfig(),
    )
    with tempfile.TemporaryDirectory() as gdir:
        if global_grid:
            bundle = create_global_graph(
                gdir, datastore.get_xy("state", stacked=True),
                refinements=refinements, n_levels=n_max_levels,
                hierarchical=hierarchical)
        else:
            bundle = create_graph(gdir,
                                  datastore.get_xy("state", stacked=False),
                                  n_max_levels=n_max_levels,
                                  hierarchical=hierarchical)
    graph = graph_from_bundle(bundle, device)
    args = ModelArgs(hidden_dim=hidden_dim, hidden_layers=hidden_layers,
                     processor_layers=processor_layers,
                     compute_dtype=compute_dtype)
    net = MODELS[model](args, config, datastore, graph, device=device,
                        generator=torch.Generator().manual_seed(seed))
    return net, datastore


def make_inputs(model, batch_size: int, steps: int, seed: int = 0):
    """Random (init_states (B, 2, N, d), forcing (B, T, N, d_f),
    true_states (B, T, N, d)) on the model's device, drawn with numpy from
    `seed`."""
    rng = np.random.default_rng(seed)
    n = model.num_grid_nodes
    d = model.num_state_vars
    d_f = model.grid_dim - 2 * d - model.grid_static_dim

    def t(shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device=model.device)

    return (t((batch_size, 2, n, d)), t((batch_size, steps, n, d_f)),
            t((batch_size, steps, n, d)))


def forecast(model, init_states, forcing_features, true_states):
    """Rollout prediction (B, T, N, d) from `model.unroll_prediction`,
    without autograd. Inputs are moved to the model's device."""
    dev = model.device
    with torch.no_grad():
        prediction, _ = model.unroll_prediction(
            torch.as_tensor(init_states, device=dev),
            torch.as_tensor(forcing_features, device=dev),
            torch.as_tensor(true_states, device=dev),
        )
    return prediction


def sample_ensemble(model, init_states, forcing_features, true_states,
                    n_members: int = 5, seed: int = 0):
    """(B, n_members, T, N, d) ensemble of an output_std or latent model
    (`ensemble.sample_rollout`), without autograd, its noise from a
    generator on the model's device seeded with `seed`. Inputs are moved
    to the model's device."""
    dev = model.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    with torch.no_grad():
        return sample_rollout(
            model, torch.as_tensor(init_states, device=dev),
            torch.as_tensor(forcing_features, device=dev),
            torch.as_tensor(true_states, device=dev), gen, n_members)


def make_trainer(model, datastore, batch_size: int, ar_steps: int,
                 seed: int = 0, run_dir=None):
    """(Trainer, WeatherDataModule) for training `model` on `datastore`'s
    train split with batches of `batch_size` and `ar_steps` unroll steps."""
    datamodule = WeatherDataModule(datastore, ar_steps_train=ar_steps,
                                   ar_steps_eval=ar_steps,
                                   batch_size=batch_size)
    datamodule.setup("train")
    flags = TrainFlags(seed=seed)
    return Trainer(model, flags, run_dir=run_dir), datamodule


def train_steps(model, datastore, batch_size: int = 4, ar_steps: int = 1,
                steps: int = 10, seed: int = 0, device="cuda",
                remat: bool | None = None):
    """Run `steps` AdamW steps of the model's training loss over the
    datastore's train split (shuffled from `seed`, epochs repeated as
    needed) and return the per-step losses as floats. The model must be
    on `device`, which defaults to CUDA and raises without it. `remat`,
    when given, sets the model's `ModelArgs.remat` (gradient
    checkpointing of the unroll) for these steps only."""
    device = resolve_device(device)
    if model.device != device:
        raise ValueError(f"model is on {model.device}, expected {device}")
    args = model.args
    if remat is not None:
        model.args = dataclasses.replace(args, remat=bool(remat))
    try:
        trainer, datamodule = make_trainer(model, datastore, batch_size,
                                           ar_steps, seed)
        if len(datamodule.train_dataloader()) == 0:
            raise ValueError(f"the train split has fewer than {batch_size} "
                             "samples")
        losses, epoch = [], 0
        while len(losses) < steps:
            for batch in trainer.train_batches(datamodule, epoch):
                if len(losses) == steps:
                    break
                losses.append(float(trainer.train_step(batch)))
            epoch += 1
    finally:
        model.args = args
    return losses
