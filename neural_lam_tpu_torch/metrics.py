"""Pointwise error metrics with the reference's masking and reduction.

Counterpart of neural_lam_tpu/metrics.py (ref: neural_lam/metrics.py):
wmse/mse/wmae/mae/nll/crps_gauss, each taking (pred, target, pred_std,
mask, average_grid, sum_vars) where the mask selects grid nodes
(interior), average_grid reduces the grid axis by mean and sum_vars the
feature axis by sum.

As in the JAX package, a masked grid mean is a weighted mean over the full
grid axis (the same value as the reference's boolean indexing); with
average_grid=False a mask zeroes the masked entries.
"""

from __future__ import annotations

import math

import torch


def mask_and_reduce_metric(metric_entry_vals, mask, average_grid: bool,
                           sum_vars: bool):
    """Mask grid nodes and optionally reduce grid (mean) / var (sum) axes.

    metric_entry_vals: (..., N, d_state); mask: (N,) bool or None.
    """
    if mask is not None:
        w = mask.to(metric_entry_vals.dtype)  # (N,)
        if average_grid:
            num = torch.sum(metric_entry_vals * w[:, None], dim=-2)
            metric_entry_vals = num / torch.sum(w)
        else:
            metric_entry_vals = metric_entry_vals * w[:, None]
    elif average_grid:
        metric_entry_vals = torch.mean(metric_entry_vals, dim=-2)
    if sum_vars:
        metric_entry_vals = torch.sum(metric_entry_vals, dim=-1)
    return metric_entry_vals


def wmse(pred, target, pred_std, mask=None, average_grid=True, sum_vars=True):
    """Weighted MSE: squared error / pred_std^2 (ref: metrics.py:56-84)."""
    entry = torch.square(pred - target) / torch.square(pred_std)
    return mask_and_reduce_metric(entry, mask, average_grid, sum_vars)


def mse(pred, target, pred_std=None, mask=None, average_grid=True,
        sum_vars=True):
    """Unweighted MSE (ref: metrics.py:87-108)."""
    entry = torch.square(pred - target)
    return mask_and_reduce_metric(entry, mask, average_grid, sum_vars)


def wmae(pred, target, pred_std, mask=None, average_grid=True, sum_vars=True):
    """Weighted MAE: |error| / pred_std (ref: metrics.py:111-139)."""
    entry = torch.abs(pred - target) / pred_std
    return mask_and_reduce_metric(entry, mask, average_grid, sum_vars)


def mae(pred, target, pred_std=None, mask=None, average_grid=True,
        sum_vars=True):
    """Unweighted MAE (ref: metrics.py:142-163)."""
    entry = torch.abs(pred - target)
    return mask_and_reduce_metric(entry, mask, average_grid, sum_vars)


_LOG_SQRT_2PI = float(0.5 * math.log(2.0 * math.pi))


def nll(pred, target, pred_std, mask=None, average_grid=True, sum_vars=True):
    """Gaussian negative log likelihood (ref: metrics.py:166-190)."""
    z = (target - pred) / pred_std
    entry = 0.5 * torch.square(z) + torch.log(pred_std) + _LOG_SQRT_2PI
    return mask_and_reduce_metric(entry, mask, average_grid, sum_vars)


def crps_gauss(pred, target, pred_std, mask=None, average_grid=True,
               sum_vars=True):
    """Closed-form Gaussian CRPS, negated as in the reference
    (ref: metrics.py:193-227)."""
    z = (target - pred) / pred_std
    pdf = torch.exp(-0.5 * torch.square(z)) / math.sqrt(2.0 * math.pi)
    cdf = 0.5 * (1.0 + torch.erf(z / math.sqrt(2.0)))
    entry = -pred_std * (math.pi ** (-0.5) - 2.0 * pdf
                         - z * (2.0 * cdf - 1.0))
    return mask_and_reduce_metric(entry, mask, average_grid, sum_vars)


DEFINED_METRICS = {
    "mse": mse,
    "mae": mae,
    "wmse": wmse,
    "wmae": wmae,
    "nll": nll,
    "crps_gauss": crps_gauss,
}


def get_metric(metric_name: str):
    """Look up a metric by (case-insensitive) name (ref: metrics.py:5-18)."""
    name = metric_name.lower()
    if name not in DEFINED_METRICS:
        raise ValueError(f"Unknown metric: {metric_name}")
    return DEFINED_METRICS[name]
