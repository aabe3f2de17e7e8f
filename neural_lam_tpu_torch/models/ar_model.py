"""Autoregressive model core: statics and the rollout with boundary overwrite.

Counterpart of neural_lam_tpu/models/ar_model.py (ref:
neural_lam/models/ar_model.py:21-267). `ModelArgs` holds the model
hyperparameters, `ARStatics` the non-trainable tensors built from a
datastore, `ARModelBase.unroll_prediction` the rollout, `training_loss`
the loss the trainer differentiates (ref: ar_model.py:287-309) and
`eval_step_metrics` what a validation step computes
(ref: ar_model.py:324-454). `ModelArgs` also holds the latent models'
`latent_dim`, `kl_beta` and `crps_members` (models/graph_efm.py). With
`ModelArgs.remat` each predict step of a differentiated unroll runs under
`torch.utils.checkpoint` (JAX: `jax.checkpoint` in `unroll_prediction`).

As in the JAX package, the grid input width counts the two raw states
(2*num_state_vars) also when `output_std` doubles the output (the
reference's ar_model.py:111-116 mixes the two up).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import metrics
from ..device import resolve_device
from ..loss_weighting import get_state_feature_weighting


@dataclasses.dataclass
class ModelArgs:
    """Model hyperparameters (defaults per ref: neural_lam/train_model.py)."""

    hidden_dim: int = 64
    hidden_layers: int = 1
    processor_layers: int = 4
    mesh_aggr: str = "sum"
    output_std: bool = False
    loss: str = "wmse"
    lr: float = 1e-3
    num_past_forcing_steps: int = 1
    num_future_forcing_steps: int = 1
    val_steps_to_log: tuple = (1, 2, 3, 5, 10, 15, 19)
    # test metrics (by name, e.g. "test_rmse") whose values are logged for
    # the variables and lead times of var_leads_metrics_watch
    metrics_watch: tuple = ()
    var_leads_metrics_watch: dict = dataclasses.field(default_factory=dict)
    n_example_pred: int = 1
    # None = fp32 everywhere; "bfloat16" = the JAX package's bf16 path:
    # fp32 parameters, activations (and their gradients) stored in bf16
    compute_dtype: str | None = None
    # latent-variable models (graph_efm, hi_efm): latent width per mesh
    # node, the ELBO's KL weight, and the members per training sample of
    # --loss crps_ens
    latent_dim: int = 32
    kl_beta: float = 1e-3
    crps_members: int = 4
    # gradient-checkpoint each predict step of the unroll: the backward
    # recomputes a step's activations instead of keeping them (training
    # memory O(T + step) instead of O(T * step), ~one extra forward a step)
    remat: bool = False


@dataclasses.dataclass(frozen=True)
class ARStatics:
    """Non-trainable tensors the model reads (ref: ar_model.py:40-151)."""

    grid_static_features: torch.Tensor  # (N_grid, d_static)
    state_mean: torch.Tensor  # (d_state,)
    state_std: torch.Tensor
    diff_mean: torch.Tensor
    diff_std: torch.Tensor
    feature_weights: torch.Tensor  # (d_state,)
    boundary_mask: torch.Tensor  # (N_grid, 1), 1 = boundary
    interior_mask: torch.Tensor  # (N_grid, 1)
    per_var_std: torch.Tensor  # (d_state,) = diff_std / sqrt(w)


def build_statics(config, datastore, device="cuda") -> ARStatics:
    """Assemble ARStatics from a datastore (ref: ar_model.py:40-131)."""
    device = resolve_device(device)
    da_static = datastore.get_dataarray(category="static", split=None)
    arr_static = np.asarray(da_static.values, np.float32)  # (N, d_static)

    stats = datastore.get_standardization_dataarray(category="state")
    diff_std = np.asarray(stats["state_diff_std"], np.float32)
    weights = np.asarray(
        get_state_feature_weighting(config=config, datastore=datastore),
        np.float32,
    )
    boundary = np.asarray(datastore.boundary_mask.values,
                          np.float32).reshape(-1, 1)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return ARStatics(
        grid_static_features=t(arr_static),
        state_mean=t(stats["state_mean"]),
        state_std=t(stats["state_std"]),
        diff_mean=t(stats["state_diff_mean"]),
        diff_std=t(diff_std),
        feature_weights=t(weights),
        boundary_mask=t(boundary),
        interior_mask=t(1.0 - boundary),
        per_var_std=t(diff_std / np.sqrt(weights)),
    )


class ARModelBase(nn.Module):
    """Rollout over an abstract predict_step. Parameters are submodules;
    graph and statics are plain tensors on `self.device`."""

    def __init__(self, args: ModelArgs, config, datastore, device="cuda"):
        super().__init__()
        if args.compute_dtype not in (None, "bfloat16"):
            raise ValueError(f"compute_dtype={args.compute_dtype!r}: None "
                             "(fp32) or 'bfloat16'")
        self.args = args
        # the dtype node, edge and grid representations are stored in;
        # None = fp32
        self.compute_dtype = (torch.bfloat16
                              if args.compute_dtype == "bfloat16" else None)
        self.device = resolve_device(device)
        self.datastore = datastore
        self.statics = build_statics(config, datastore, self.device)

        self.num_state_vars = datastore.get_num_data_vars(category="state")
        self.num_forcing_vars = datastore.get_num_data_vars(category="forcing")
        self.num_grid_nodes, self.grid_static_dim = (
            self.statics.grid_static_features.shape
        )
        self.output_std = bool(args.output_std)
        self.grid_output_dim = (
            2 * self.num_state_vars if self.output_std else self.num_state_vars
        )
        self.grid_dim = (
            2 * self.num_state_vars
            + self.grid_static_dim
            + self.num_forcing_vars
            * (args.num_past_forcing_steps + args.num_future_forcing_steps + 1)
        )
        self.loss_fn = metrics.get_metric(args.loss)

    def predict_step(self, prev_state, prev_prev_state, forcing, ctx=None):
        """X_{t-1}, X_t -> X_{t+1} (ref: ar_model.py:211-218).
        ctx: rollout-invariant tensors from `precompute_rollout_ctx`."""
        raise NotImplementedError

    def precompute_rollout_ctx(self):
        """Rollout-invariant tensors for predict_step (None = none)."""
        return None

    def unroll_prediction(self, init_states, forcing_features, true_states):
        """AR rollout with boundary overwrite (ref: ar_model.py:220-267).

        init_states: (B, 2, N, d); forcing_features: (B, T, N, d_f);
        true_states: (B, T, N, d). Returns prediction (B, T, N, d) and
        pred_std ((B, T, N, d) if output_std else (d,)).
        """
        statics = self.statics
        ctx = self.precompute_rollout_ctx()
        predict = self.predict_step
        if self.args.remat and torch.is_grad_enabled():
            # gradient checkpointing over the unroll, as the JAX package's
            # jax.checkpoint of predict_step: the context is computed once,
            # outside, and passed in, so its gradient flows back to it
            def predict(s, ps, f, c):
                return checkpoint(self.predict_step, s, ps, f, c,
                                  use_reentrant=False)
        prev_prev_state, prev_state = init_states[:, 0], init_states[:, 1]
        preds, stds = [], []
        for t in range(forcing_features.shape[1]):
            pred_state, pred_std = predict(
                prev_state, prev_prev_state, forcing_features[:, t], ctx
            )
            new_state = (
                statics.boundary_mask * true_states[:, t]
                + statics.interior_mask * pred_state
            )
            preds.append(new_state)
            stds.append(pred_std)
            prev_prev_state, prev_state = prev_state, new_state
        prediction = torch.stack(preds, dim=1)
        if self.output_std:
            return prediction, torch.stack(stds, dim=1)
        return prediction, statics.per_var_std

    def interior_mask_bool(self):
        return self.statics.interior_mask[:, 0] > 0.5

    def common_step(self, batch):
        """(prediction, target, pred_std, batch_times) of a batch
        (init_states, target_states, forcing, batch_times)
        (ref: ar_model.py:269-285)."""
        init_states, target_states, forcing_features, batch_times = batch
        prediction, pred_std = self.unroll_prediction(
            init_states, forcing_features, target_states
        )
        return prediction, target_states, pred_std, batch_times

    def training_loss(self, batch, generator=None):
        """Mean loss over batch and unrolled steps, interior nodes only
        (ref: ar_model.py:287-309). With compute_dtype="bfloat16" the
        forward and backward run on the bf16 path (the kernels' bf16
        instances), the loss and the parameter gradients in fp32.
        `generator` (a torch.Generator on the model's device) is the
        noise source of latent models, which draw from it; the trainer
        passes one only to latent models, and the others ignore it."""
        prediction, target, pred_std, _ = self.common_step(batch)
        return torch.mean(self.loss_fn(prediction, target, pred_std,
                                       mask=self.interior_mask_bool()))

    def eval_step_metrics(self, batch):
        """Everything a val/test step computes: time_step_loss (B, T),
        mean_loss (), per-(B, T, d) mse/mae entries and the spatial loss
        (B, T, N) (ref: ar_model.py:324-454)."""
        prediction, target, pred_std, _ = self.common_step(batch)
        mask = self.interior_mask_bool()
        sample_step_loss = self.loss_fn(prediction, target, pred_std,
                                        mask=mask)
        out = {
            "time_step_loss": sample_step_loss,
            "mean_loss": torch.mean(sample_step_loss),
            "mse": metrics.mse(prediction, target, None, mask=mask,
                               sum_vars=False),
            "mae": metrics.mae(prediction, target, None, mask=mask,
                               sum_vars=False),
            "spatial_loss": self.loss_fn(prediction, target, pred_std,
                                         average_grid=False),
        }
        if self.output_std:
            w = mask.to(pred_std.dtype)
            out["output_std"] = (torch.sum(pred_std * w[:, None], dim=-2)
                                 / torch.sum(w))
        return out
