"""MDP datastore: "training-ready" zarr datasets from mllam-data-prep.

Counterpart of neural_lam_tpu/datastore/mdp.py.

ref: neural_lam/datastore/mdp.py — a single zarr dataset containing
per-category stacked arrays (`state` (time, grid_index, state_feature),
`forcing`, `static`), feature-name/units/long-name coordinate arrays,
train/val/test time ranges in a `splits` array, and precomputed
standardization statistics as `{category}__train__{mean,std}` (+
`state__train__diff_{mean,std}`) variables (ref: mdp.py:288-320). The
boundary mask is an `n_boundary_points`-wide frame (ref: mdp.py:322-351);
projection comes from the config's `extra` section (ref: mdp.py:353-406).

Like the JAX package, the port creates a missing archive from the
config's raw inputs on first use, through its own `create_dataset`
(datastore/create_dataset.py), where the reference calls into the external
`mllam_data_prep` package (ref: mdp.py:70-72). Reading uses the port's
zarr reader (datastore/zarr_reader.py); time-varying arrays are loaded
lazily per time-chunk. PyYAML is imported only here, when the datastore is
built.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

from .base import BaseRegularGridDatastore, CartesianGridShape, FieldArray
from .zarr_reader import LazyZarrLeading, ZarrGroup, decode_cf_time


class MDPDatastore(BaseRegularGridDatastore):
    SHORT_NAME = "mdp"

    def __init__(self, config_path, n_boundary_points=30):
        self._config_path = Path(config_path)
        self._root_path = self._config_path.parent
        import yaml

        with open(self._config_path) as f:
            self._config = yaml.safe_load(f)
        fp_ds = self._root_path / self._config_path.name.replace(
            ".yaml", ".zarr"
        )
        if not fp_ds.exists():
            # create on first use from the config's raw inputs, like the
            # reference's call into mllam-data-prep (ref: mdp.py:70-72)
            from .create_dataset import create_dataset

            try:
                create_dataset(self._config_path)
            except FileExistsError:
                pass  # another process created it meanwhile
            except (KeyError, FileNotFoundError, ValueError) as e:
                raise FileNotFoundError(
                    f"MDP zarr dataset not found at {fp_ds} and it could "
                    f"not be created from the config's inputs ({e}). Point "
                    "the config's input paths at local raw zarr sources, "
                    "or create the dataset explicitly with `python -m "
                    "neural_lam_tpu_torch.datastore.create_dataset "
                    "<config>`."
                ) from e
        self._ds = ZarrGroup(fp_ds)
        self._n_boundary_points = n_boundary_points

        required_splits = ["train", "val", "test"]
        available = list(self._split_names)
        if not all(s in available for s in required_splits):
            raise ValueError(
                f"Missing required splits: {required_splits} in available "
                f"splits: {available}"
            )

        # stacking order of the spatial dims (ref: mdp.py:99-111)
        dim_order = None
        for input_dataset in (self._config.get("inputs") or {}).values():
            mapping = input_dataset.get("dim_mapping", {}).get("grid_index", {})
            dims = mapping.get("dims")
            if dims:
                if dim_order is None:
                    dim_order = dims
                else:
                    assert dim_order == dims, (
                        "all inputs must have the same dimension order"
                    )
        self.CARTESIAN_COORDS = list(dim_order or ["x", "y"])

    # --- splits ---

    @functools.cached_property
    def _split_names(self):
        arr = self._ds["splits"]
        names = arr.attrs.get("split_names")
        if names is None:
            names = [str(v) for v in self._coord_values("split_name")]
        return list(names)

    def _coord_values(self, name):
        arr = self._ds[name]
        vals = arr.read_full()
        units = arr.attrs.get("units", "")
        if "since" in units:
            return decode_cf_time(vals, units)
        return vals

    def _split_time_range(self, split):
        """(t_start, t_end) datetime64 bounds for a split (inclusive)."""
        splits = self._ds["splits"].read_full()  # (n_splits, 2) strings
        names = self._split_names
        parts = [str(v) for v in self._coord_values("split_part")]
        i = names.index(split)
        start = np.datetime64(str(splits[i, parts.index("start")]), "ns")
        end = np.datetime64(str(splits[i, parts.index("end")]), "ns")
        return start, end

    # --- metadata (ref: mdp.py:147-219) ---

    def get_vars_units(self, category: str) -> list:
        if category not in self._ds and category == "forcing":
            return []
        return [str(v) for v in self._ds[f"{category}_feature_units"].read_full()]

    def get_vars_names(self, category: str) -> list:
        if category not in self._ds and category == "forcing":
            return []
        return [str(v) for v in self._ds[f"{category}_feature"].read_full()]

    def get_vars_long_names(self, category: str) -> list:
        if category not in self._ds and category == "forcing":
            return []
        return [
            str(v)
            for v in self._ds[f"{category}_feature_long_name"].read_full()
        ]

    @property
    def root_path(self) -> Path:
        return self._root_path

    @property
    def config(self):
        return self._config

    @functools.cached_property
    def step_length(self) -> int:
        """Hours between consecutive time steps (ref: mdp.py:139-146)."""
        times = self._coord_values("time")
        dt = times[1] - times[0]
        return int(dt / np.timedelta64(1, "h"))

    # --- data (ref: mdp.py:221-286) ---

    def get_dataarray(self, category: str, split) -> FieldArray | None:
        if category not in self._ds:
            if category == "forcing":
                return None
            raise KeyError(category)
        arr = self._ds[category]
        dims = arr.dims
        feat = f"{category}_feature"
        coords = {feat: np.array(self.get_vars_names(category))}

        if "time" in dims:
            assert dims[0] == "time", f"expected time-leading dims, got {dims}"
            times = self._coord_values("time")
            if split is not None:
                t_start, t_end = self._split_time_range(split)
                lo = int(np.searchsorted(times, t_start, side="left"))
                hi = int(np.searchsorted(times, t_end, side="right"))
            else:
                lo, hi = 0, len(times)
            data = LazyZarrLeading(arr, lo, hi)
            coords["time"] = times[lo:hi]
            fa = FieldArray(data, dims, coords)
        else:
            fa = FieldArray(arr.read_full(), dims, coords)

        expected = self.expected_dim_order(category=category)
        if fa.dims != expected:
            fa = FieldArray(np.asarray(fa.data[:]), fa.dims, fa.coords)
            fa = fa.transpose(*expected)
        return fa

    # --- standardization (ref: mdp.py:288-320) ---

    def get_standardization_dataarray(self, category: str) -> dict:
        split = "train"
        out = {}
        for op in ("mean", "std"):
            out[f"{category}_{op}"] = self._ds[
                f"{category}__{split}__{op}"
            ].read_full()
        if category == "state":
            for op in ("mean", "std"):
                out[f"state_diff_{op}"] = self._ds[
                    f"state__{split}__diff_{op}"
                ].read_full()
        return out

    # --- grid (ref: mdp.py:322-351, 408-467) ---

    @functools.cached_property
    def grid_shape_state(self) -> CartesianGridShape:
        x = np.unique(self._ds["x"].read_full())
        y = np.unique(self._ds["y"].read_full())
        return CartesianGridShape(x=x.size, y=y.size)

    def get_xy(self, category: str, stacked: bool = True) -> np.ndarray:
        xs = self._ds["x"].read_full()
        ys = self._ds["y"].read_full()
        xy = np.stack([xs, ys], axis=-1)  # (N_grid, 2) in grid_index order
        if stacked:
            return xy
        gs = self.grid_shape_state
        return xy.reshape(gs.x, gs.y, 2)

    @functools.cached_property
    def boundary_mask(self) -> FieldArray:
        """n_boundary_points-wide frame of ones (ref: mdp.py:322-351)."""
        gs = self.grid_shape_state
        nb = self._n_boundary_points
        mask = np.ones((gs.x, gs.y), dtype=np.float32)
        mask[nb:-nb, nb:-nb] = 0.0
        return FieldArray(mask.reshape(-1), ("grid_index",))

    @functools.cached_property
    def coords_projection(self) -> dict:
        extra = self._config.get("extra") or {}
        if "projection" not in extra:
            raise ValueError(
                "projection information not found in the configuration file "
                f"({self._config_path}). Please add the projection "
                "information to the `extra` section of the config."
            )
        info = extra["projection"]
        for key in ("class_name", "kwargs"):
            if key not in info:
                raise ValueError(
                    f"{key} not found in the projection information."
                )
        return {"name": info["class_name"], **info["kwargs"]}
