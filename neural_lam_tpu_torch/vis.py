"""Matplotlib visualization (ref: neural_lam/vis.py:13-182).

Counterpart of neural_lam_tpu/vis.py. It imports matplotlib when it is
imported; the trainer imports it only inside the functions that draw, so
the trainer runs where matplotlib is absent as long as nothing is drawn.

cartopy is unavailable in this environment, so spatial maps are drawn as
2D imshows in the datastore's projected xy coordinates, with a geographic
lon/lat graticule + degree axis labels overlaid from the datastore's
projection descriptor via hand-rolled transforms (`projections.py`) —
the equivalent of the reference's cartopy GeoAxes (ref: vis.py:68-126),
minus coastlines (no offline coastline data in this environment)."""

from __future__ import annotations

import shutil

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from . import projections  # noqa: E402


def fractional_plot_bundle(fraction):
    """Publication plot styling with figure width a fraction of the page
    width (ref: utils.py:217-233). The reference pulls this from tueplots'
    neurips2023 bundle (unavailable here); these rc values reproduce it:
    5.5 in text width, golden-ratio height, serif family, LaTeX text when
    a latex binary exists."""
    width = 5.5 / fraction
    height = 5.5 * 0.618
    usetex = shutil.which("latex") is not None
    return {
        "figure.figsize": (width, height),
        "figure.constrained_layout.use": True,
        "font.family": "serif",
        "text.usetex": usetex,
        "font.size": 10,
        "axes.labelsize": 10,
        "axes.titlesize": 10,
        "legend.fontsize": 8,
        "xtick.labelsize": 8,
        "ytick.labelsize": 8,
        "savefig.bbox": "tight",
    }


@matplotlib.rc_context(fractional_plot_bundle(1))
def plot_error_map(errors, datastore, title=None, step_length=None):
    """Heatmap of error per variable (y) and lead time (x)
    (ref: vis.py:13-65)."""
    errors = np.asarray(errors)  # (pred_steps, d_f)
    step_length = step_length or datastore.step_length
    d_f, pred_steps = errors.shape[1], errors.shape[0]

    fig, ax = plt.subplots(figsize=(15, 10))
    height = errors.T  # (d_f, pred_steps)
    im = ax.imshow(
        height, cmap="OrRd", aspect="auto", interpolation="none",
        origin="upper",
    )
    fig.colorbar(im, ax=ax)

    ax.set_xticks(np.arange(pred_steps))
    pred_hor_i = np.arange(pred_steps) + 1
    ax.set_xticklabels(pred_hor_i * step_length)
    ax.set_xlabel("Lead time (h)")

    var_names = datastore.get_vars_names(category="state")
    var_units = datastore.get_vars_units(category="state")
    y_ticklabels = [
        f"{name} ({unit})" for name, unit in zip(var_names, var_units)
    ]
    ax.set_yticks(np.arange(d_f))
    ax.set_yticklabels(y_ticklabels)
    if title:
        ax.set_title(title, size=15)
    return fig


def _to_2d(field, datastore):
    """(N_grid,) -> (Nx, Ny) via the regular-grid unstacking convention."""
    return datastore.unstack_grid_coords(np.asarray(field))


@matplotlib.rc_context(fractional_plot_bundle(1))
def plot_prediction(da_prediction, da_target, datastore, title=None,
                    vrange=None):
    """Side-by-side prediction/target maps with faded boundary
    (ref: vis.py:68-125)."""
    pred = np.asarray(da_prediction.values if hasattr(da_prediction, "values")
                      else da_prediction)
    target = np.asarray(da_target.values if hasattr(da_target, "values")
                        else da_target)
    if vrange is None:
        vmin = min(pred.min(), target.min())
        vmax = max(pred.max(), target.max())
    else:
        vmin, vmax = float(vrange[0]), float(vrange[1])

    extent = datastore.get_xy_extent("state")
    mask = 1.0 - np.asarray(datastore.boundary_mask.values).reshape(-1)
    pixel_alpha = np.clip(_to_2d(mask, datastore).T * 0.9 + 0.1, 0, 1)

    fig, axes = plt.subplots(1, 2, figsize=(13, 7))
    for ax, field, name in zip(axes, (pred, target), ("Prediction", "Ground Truth")):
        im = ax.imshow(
            _to_2d(field, datastore).T, origin="lower", extent=extent,
            alpha=pixel_alpha, vmin=vmin, vmax=vmax, cmap="plasma",
            interpolation="none",
        )
        ax.set_title(name, size=15)
        if not projections.add_graticule(ax, datastore):
            ax.set_xticks([])
            ax.set_yticks([])
    cbar = fig.colorbar(im, ax=axes.ravel().tolist(), aspect=30)
    cbar.ax.tick_params(labelsize=10)
    if title:
        fig.suptitle(title, size=20)
    return fig


@matplotlib.rc_context(fractional_plot_bundle(1))
def plot_spatial_error(error, datastore, title=None, vrange=None):
    """Per-gridpoint error map (ref: vis.py:128-182)."""
    error = np.asarray(error)
    if vrange is None:
        vmin, vmax = error.min(), error.max()
    else:
        vmin, vmax = float(vrange[0]), float(vrange[1])
    extent = datastore.get_xy_extent("state")
    mask = 1.0 - np.asarray(datastore.boundary_mask.values).reshape(-1)
    pixel_alpha = np.clip(_to_2d(mask, datastore).T * 0.9 + 0.1, 0, 1)

    fig, ax = plt.subplots(figsize=(5, 4.8))
    im = ax.imshow(
        _to_2d(error, datastore).T, origin="lower", extent=extent,
        alpha=pixel_alpha, vmin=vmin, vmax=vmax, cmap="OrRd",
        interpolation="none",
    )
    if not projections.add_graticule(ax, datastore):
        ax.set_xticks([])
        ax.set_yticks([])
    cbar = fig.colorbar(im, aspect=30)
    cbar.ax.tick_params(labelsize=10)
    if title:
        fig.suptitle(title, size=10)
    return fig
