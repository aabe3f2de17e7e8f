"""MEPS npy-files datastore (the neural-lam v0.1.0 on-disk format).

Counterpart of neural_lam_tpu/datastore/npyfilesmeps.py.

ref: neural_lam/datastore/npyfilesmeps/store.py — forecast-type ensemble
data stored as per-analysis-time numpy files:

  samples/{split}/nwp_{YYYYMMDDHH}_mbr{NNN}.npy          [T, y, x, d_state']
  samples/{split}/nwp_toa_downwelling_shortwave_flux_{YYYYMMDDHH}.npy [T,y,x]
  samples/{split}/wtr_{YYYYMMDDHH}.npy                   [y, x]
  static/{surface_geopotential,border_mask,nwp_xy}.npy
  static/{parameter_mean,parameter_std,diff_mean,diff_std,flux_stats}.pt

Forcing = TOA flux + open water + 4 datetime features (sin/cos of hour and
day-of-year, rescaled to [0,1]; ref: store.py:540-561). The reference loads
lazily with dask.delayed; here a small per-analysis-time lazy stack does the
same without dask (files are np.load-ed on first access of their analysis
time and memoized with a bounded LRU).
"""

from __future__ import annotations

import dataclasses
import functools
import re
import warnings
from pathlib import Path
from typing import Any, Dict, List

import numpy as np
import torch

from .base import BaseRegularGridDatastore, CartesianGridShape, FieldArray

STATE_FILENAME_RE = re.compile(r"nwp_(\d{10})_mbr(\d{3})\.npy$")
STATE_FILENAME_FORMAT = "nwp_{atime}_mbr{member:03d}.npy"
TOA_FLUX_FILENAME_FORMAT = "nwp_toa_downwelling_shortwave_flux_{atime}.npy"
OPEN_WATER_FILENAME_FORMAT = "wtr_{atime}.npy"


@dataclasses.dataclass
class Projection:
    """Projection descriptor (ref: npyfilesmeps/config.py:10-25)."""

    class_name: str
    kwargs: Dict[str, Any]


@dataclasses.dataclass
class Dataset:
    """Dataset metadata (ref: npyfilesmeps/config.py:28-50)."""

    name: str
    var_names: List[str]
    var_units: List[str]
    var_longnames: List[str]
    num_forcing_features: int
    num_timesteps: int
    step_length: int
    num_ensemble_members: int
    remove_state_features_with_index: List[int] = dataclasses.field(
        default_factory=list
    )


@dataclasses.dataclass
class NpyDatastoreConfig:
    """Top-level YAML schema (ref: npyfilesmeps/config.py:53-66)."""

    dataset: Dataset
    grid_shape_state: List[int]
    projection: Projection

    @classmethod
    def from_yaml_file(cls, path) -> "NpyDatastoreConfig":
        import yaml

        with open(path) as f:
            d = yaml.safe_load(f)
        known = {f.name for f in dataclasses.fields(Dataset)}
        ds_kwargs = {k: v for k, v in d["dataset"].items() if k in known}
        return cls(
            dataset=Dataset(**ds_kwargs),
            grid_shape_state=list(d["grid_shape_state"]),
            projection=Projection(**d["projection"]),
        )


def _atime_str(t: np.datetime64) -> str:
    s = np.datetime_as_string(t, unit="h")  # YYYY-MM-DDTHH
    return s.replace("-", "").replace("T", "")


class _LazyAnalysisStack:
    """Lazy (analysis_time, ...) array: per-analysis blocks built on access."""

    def __init__(self, n_analysis, block_shape, build_block, dtype=np.float32):
        self._n = n_analysis
        self._block_shape = tuple(block_shape)
        self._build = functools.lru_cache(maxsize=8)(build_block)
        self.dtype = dtype

    @property
    def shape(self):
        return (self._n,) + self._block_shape

    def __getitem__(self, idx):
        if isinstance(idx, (int, np.integer)):
            if idx < 0:
                idx += self._n
            return self._build(int(idx))
        indices = range(*idx.indices(self._n))
        return np.stack([self._build(int(i)) for i in indices])


class NpyFilesDatastoreMEPS(BaseRegularGridDatastore):
    SHORT_NAME = "npyfilesmeps"

    is_ensemble = True
    is_forecast = True

    def __init__(self, config_path):
        self._config_path = Path(config_path)
        self._root_path = self._config_path.parent
        self._config = NpyDatastoreConfig.from_yaml_file(self._config_path)
        self._num_ensemble_members = self.config.dataset.num_ensemble_members
        self._num_timesteps = self.config.dataset.num_timesteps
        self._step_length = self.config.dataset.step_length
        self._remove_state_features_with_index = (
            self.config.dataset.remove_state_features_with_index
        )

    @property
    def root_path(self) -> Path:
        return self._root_path

    @property
    def config(self) -> NpyDatastoreConfig:
        return self._config

    @property
    def step_length(self) -> int:
        return self._step_length

    # --- variable metadata (ref: store.py:563-618) ---

    def get_vars_names(self, category: str) -> list:
        if category == "state":
            return self.config.dataset.var_names
        if category == "forcing":
            return [
                "toa_downwelling_shortwave_flux",
                "open_water_fraction",
                "sin_hour",
                "cos_hour",
                "sin_year",
                "cos_year",
            ]
        if category == "static":
            return ["surface_geopotential", "border_mask", "x", "y"]
        raise NotImplementedError(f"Category {category} not supported")

    def get_vars_units(self, category: str) -> list:
        if category == "state":
            return self.config.dataset.var_units
        if category == "forcing":
            return ["W/m^2", "1", "1", "1", "1", "1"]
        if category == "static":
            return ["m^2/s^2", "1", "m", "m"]
        raise NotImplementedError(f"Category {category} not supported")

    def get_vars_long_names(self, category: str) -> list:
        if category == "state":
            return self.config.dataset.var_longnames
        return self.get_vars_names(category=category)

    # --- grid geometry (ref: store.py:600-670) ---

    @functools.cached_property
    def grid_shape_state(self) -> CartesianGridShape:
        ny, nx = self.config.grid_shape_state
        return CartesianGridShape(x=nx, y=ny)

    def get_xy(self, category: str, stacked: bool = True) -> np.ndarray:
        # on disk: [2, N_y, N_x] with [x, y] pairs along dim 0
        arr = np.load(self.root_path / "static" / "nwp_xy.npy")
        assert arr.shape[0] == 2, "Expected 2D array"
        gs = self.grid_shape_state
        assert arr.shape[1:] == (gs.y, gs.x), "Unexpected shape"
        arr = arr.transpose(2, 1, 0)  # (N_x, N_y, 2)
        if stacked:
            return arr.reshape(-1, 2)
        return arr

    @functools.cached_property
    def boundary_mask(self) -> FieldArray:
        values = np.load(self.root_path / "static" / "border_mask.npy")
        # file is (y, x); stack to x-major grid_index
        stacked = values.T.reshape(-1).astype(np.float32)
        return FieldArray(stacked, ("grid_index",))

    # --- analysis times (ref: store.py:508-538) ---

    @functools.lru_cache
    def _get_analysis_times(self, split) -> tuple:
        sample_dir = self.root_path / "samples" / split
        times = set()
        for fp in sample_dir.glob("nwp_*_mbr*.npy"):
            m = STATE_FILENAME_RE.match(fp.name)
            if m:
                s = m.group(1)
                times.add(
                    np.datetime64(
                        f"{s[:4]}-{s[4:6]}-{s[6:8]}T{s[8:10]}", "ns"
                    )
                )
        if not times:
            raise ValueError(f"No files found in {sample_dir}")
        return tuple(sorted(times))

    def _stack_yx(self, arr):
        """(..., y, x[, f]) file layout -> (..., grid_index[, f]) x-major."""
        gs = self.grid_shape_state
        # find the (y, x) axis pair
        for ax in range(arr.ndim - 1):
            if arr.shape[ax] == gs.y and arr.shape[ax + 1] == gs.x:
                arr = np.swapaxes(arr, ax, ax + 1)  # -> (..., x, y, ...)
                return arr.reshape(
                    arr.shape[:ax] + (gs.x * gs.y,) + arr.shape[ax + 2:]
                )
        raise ValueError(f"no (y={gs.y}, x={gs.x}) axes in shape {arr.shape}")

    # --- data arrays (ref: store.py:202-306) ---

    def get_dataarray(self, category: str, split) -> FieldArray:
        if category == "static":
            geo = np.load(
                self.root_path / "static" / "surface_geopotential.npy"
            )  # (y, x)
            border = np.load(self.root_path / "static" / "border_mask.npy")
            xy = self.get_xy("static", stacked=True)  # (N, 2)
            feats = np.concatenate(
                [
                    self._stack_yx(geo)[:, None],
                    self._stack_yx(border.astype(np.float32))[:, None],
                    xy,
                ],
                axis=1,
            ).astype(np.float32)
            return FieldArray(
                feats, ("grid_index", "static_feature"),
                {"static_feature": np.array(self.get_vars_names("static"))},
            )

        atimes = np.array(self._get_analysis_times(split))
        T = self._num_timesteps
        efd = (
            self.step_length * np.arange(T) * np.timedelta64(1, "h")
        ).astype("timedelta64[ns]")
        n_grid = self.num_grid_points
        sample_dir = self.root_path / "samples" / split

        if category == "state":
            d_state = len(self.get_vars_names("state"))
            n_members = self._num_ensemble_members
            drop = self._remove_state_features_with_index
            mask = None
            if drop:
                mask = np.ones(d_state + len(drop), dtype=bool)
                mask[drop] = False

            def build_state(a_idx):
                blocks = []
                for member in range(n_members):
                    fp = sample_dir / STATE_FILENAME_FORMAT.format(
                        atime=_atime_str(atimes[a_idx]), member=member
                    )
                    arr = np.load(fp)  # (T, y, x, d')
                    if mask is not None:
                        arr = arr[..., mask]
                    blocks.append(self._stack_yx(arr))  # (T, N, d)
                out = np.stack(blocks, axis=1)  # (T, M, N, d)
                return out.astype(np.float32)

            data = _LazyAnalysisStack(
                len(atimes), (T, n_members, n_grid, d_state), build_state
            )
            return FieldArray(
                data,
                ("analysis_time", "elapsed_forecast_duration",
                 "ensemble_member", "grid_index", "state_feature"),
                {"analysis_time": atimes,
                 "elapsed_forecast_duration": efd,
                 "state_feature": np.array(self.get_vars_names("state"))},
            )

        if category == "forcing":
            def build_forcing(a_idx):
                ats = _atime_str(atimes[a_idx])
                flux = np.load(
                    sample_dir / TOA_FLUX_FILENAME_FORMAT.format(atime=ats)
                )  # (T, y, x)
                water = np.load(
                    sample_dir / OPEN_WATER_FILENAME_FORMAT.format(atime=ats)
                )  # (y, x)
                flux = self._stack_yx(flux)[..., None]  # (T, N, 1)
                water = np.broadcast_to(
                    self._stack_yx(water)[None, :, None], flux.shape
                )
                dtf = self._datetime_forcing(atimes[a_idx], efd)  # (T, 4)
                dtf = np.broadcast_to(dtf[:, None, :], (T, n_grid, 4))
                return np.concatenate(
                    [flux, water, dtf], axis=-1
                ).astype(np.float32)

            data = _LazyAnalysisStack(
                len(atimes), (T, n_grid, 6), build_forcing
            )
            return FieldArray(
                data,
                ("analysis_time", "elapsed_forecast_duration", "grid_index",
                 "forcing_feature"),
                {"analysis_time": atimes,
                 "elapsed_forecast_duration": efd,
                 "forcing_feature": np.array(self.get_vars_names("forcing"))},
            )

        raise NotImplementedError(category)

    @staticmethod
    def _datetime_forcing(analysis_time, efd):
        """sin/cos hour + day-of-year features in [0,1]
        (ref: store.py:540-561)."""
        times = analysis_time + efd  # (T,) datetime64[ns]
        t_days = times.astype("datetime64[D]")
        years = times.astype("datetime64[Y]")
        dayofyear = (t_days - years.astype("datetime64[D]")).astype(int) + 1
        hours = (times.astype("datetime64[h]") - t_days).astype(int)
        hour_angle = hours / 12 * np.pi
        year_angle = dayofyear / 365 * 2 * np.pi
        feats = np.stack(
            [np.sin(hour_angle), np.cos(hour_angle),
             np.sin(year_angle), np.cos(year_angle)], axis=-1,
        )
        return ((feats + 1) / 2).astype(np.float32)

    # --- standardization (ref: store.py:699-773) ---

    def get_standardization_dataarray(self, category: str) -> dict:
        def load_pt(fn):
            return torch.load(
                self.root_path / "static" / fn, weights_only=True
            ).numpy()

        if category == "state":
            mean_values = load_pt("parameter_mean.pt")
            std_values = load_pt("parameter_std.pt")
            try:
                diff_mean = load_pt("diff_mean.pt")
                diff_std = load_pt("diff_std.pt")
            except FileNotFoundError:
                warnings.warn(f"Could not load diff mean/std for {category}")
                diff_mean = np.empty_like(mean_values)
                diff_std = np.empty_like(std_values)
            return {
                "state_mean": mean_values, "state_std": std_values,
                "state_diff_mean": diff_mean, "state_diff_std": diff_std,
            }
        if category == "forcing":
            flux_mean, flux_std = load_pt("flux_stats.pt")
            return {
                "forcing_mean": np.array(
                    [flux_mean, 0.0, 0.0, 0.0, 0.0, 0.0], np.float32
                ),
                "forcing_std": np.array(
                    [flux_std, 1.0, 1.0, 1.0, 1.0, 1.0], np.float32
                ),
            }
        if category == "static":
            da = self.get_dataarray(category="static", split="train")
            vals = da.values
            return {
                "static_mean": vals.mean(axis=0),
                "static_std": vals.std(axis=0),
            }
        raise NotImplementedError(f"Category {category} not supported")

    @functools.cached_property
    def coords_projection(self) -> dict:
        return {
            "name": self.config.projection.class_name,
            **self.config.projection.kwargs,
        }
