"""Faceted plot of datastore fields + CLI
(ref: neural_lam/datastore/plot_example.py:8-189).

Counterpart of neural_lam_tpu/datastore/plot_example.py over the port's
datastores:

    python -m neural_lam_tpu_torch.datastore.plot_example \\
        --config_path config.yaml --category state --save example.png
"""

from __future__ import annotations

from argparse import ArgumentParser

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


def plot_example_from_datastore(category, datastore, col_dim, split="train",
                                standardize=True, selection=None,
                                index_selection=None):
    """Plot a faceted grid of fields from a datastore category.

    col_dim: which dim to facet over (e.g. "{category}_feature").
    selection / index_selection: coord-value / integer selections applied
    first (ref: plot_example.py:8-88).
    """
    da = datastore.get_dataarray(
        category=category, split=split if category != "static" else None
    )
    if selection:
        da = da.sel(**selection)
    if index_selection:
        da = da.isel(**index_selection)
    if standardize and category != "static":
        stats = datastore.get_standardization_dataarray(category)
        vals = (np.asarray(da.values) - stats[f"{category}_mean"]) / stats[
            f"{category}_std"
        ]
    else:
        vals = np.asarray(da.values)

    col_dim = col_dim.format(category=category)
    facet_axis = da.dims.index(col_dim)
    n_facets = vals.shape[facet_axis]
    names = datastore.get_vars_names(category)

    n_cols = min(4, n_facets)
    n_rows = -(-n_facets // n_cols)
    fig, axes = plt.subplots(
        n_rows, n_cols, figsize=(4 * n_cols, 3.5 * n_rows), squeeze=False
    )
    for i in range(n_facets):
        ax = axes[i // n_cols][i % n_cols]
        field = np.take(vals, i, axis=facet_axis)
        field = field.reshape(-1)[: datastore.num_grid_points]
        img = datastore.unstack_grid_coords(field)
        im = ax.imshow(img.T, origin="lower", cmap="viridis",
                       interpolation="none")
        ax.set_title(names[i] if i < len(names) else str(i), fontsize=9)
        ax.set_xticks([])
        ax.set_yticks([])
        fig.colorbar(im, ax=ax)
    for i in range(n_facets, n_rows * n_cols):
        axes[i // n_cols][i % n_cols].axis("off")
    return fig


def _parse_dict(arg_str):
    """key=value with int/float coercion
    (ref: plot_example.py:95-103)."""
    key, value = arg_str.split("=")
    for op in (int, float):
        try:
            value = op(value)
            break
        except ValueError:
            pass
    return key, value


def main(input_args=None):
    from ..config import load_config_and_datastore

    parser = ArgumentParser(description="Plot example from datastore")
    parser.add_argument("--config_path", type=str, default=None,
                        help="neural-lam config selecting the datastore")
    parser.add_argument("--datastore_kind", type=str, default=None,
                        help="directly init a datastore of this kind "
                             "(ref: plot_example.py:108-114)")
    parser.add_argument("--datastore_config_path", type=str, default=None,
                        help="per-datastore config for --datastore_kind")
    parser.add_argument("--category", type=str, default="state")
    parser.add_argument("--split", type=str, default="train")
    parser.add_argument("--col_dim", type=str, default="{category}_feature")
    parser.add_argument("--time_idx", type=int, default=0)
    parser.add_argument("--disable_standardize", dest="standardize",
                        action="store_false",
                        help="disable standardization of the data")
    parser.add_argument("--selection", nargs="+", default=[],
                        type=_parse_dict,
                        help="coord-value selections, e.g. "
                             "time='1990-09-03T00:00'")
    parser.add_argument("--index_selection", nargs="+", default=[],
                        type=_parse_dict,
                        help="integer selections, e.g. time=0")
    parser.add_argument("--save", type=str, default="example.png")
    args = parser.parse_args(input_args)

    if args.datastore_kind is not None:
        from . import init_datastore

        assert args.datastore_config_path is not None, (
            "Specify your datastore config with --datastore_config_path"
        )
        datastore = init_datastore(args.datastore_kind,
                                   args.datastore_config_path)
    else:
        assert args.config_path is not None, (
            "Specify --config_path (or --datastore_kind + "
            "--datastore_config_path)"
        )
        _, datastore = load_config_and_datastore(
            config_path=args.config_path
        )
    selection = dict(args.selection)
    index_selection = dict(args.index_selection)
    col_dim = args.col_dim.format(category=args.category)
    if col_dim in selection:
        raise ValueError(
            f"Column dimension {col_dim} cannot be in the selection "
            f"({selection}). Adjust the column dimension and/or selection."
        )
    if not index_selection:
        da_dims = datastore.expected_dim_order(args.category)
        if "time" in da_dims:
            index_selection["time"] = args.time_idx
        if "analysis_time" in da_dims:
            index_selection["analysis_time"] = args.time_idx
            index_selection["elapsed_forecast_duration"] = 0
        if "ensemble_member" in da_dims:
            index_selection["ensemble_member"] = 0
    fig = plot_example_from_datastore(
        args.category, datastore, col_dim=args.col_dim, split=args.split,
        standardize=args.standardize, selection=selection or None,
        index_selection=index_selection,
    )
    fig.savefig(args.save, dpi=150, bbox_inches="tight")
    print(f"Saved example figure to {args.save}")


if __name__ == "__main__":
    main()
