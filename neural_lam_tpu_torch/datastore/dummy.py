"""In-memory random-data datastore for tests, examples and benchmarks.

Counterpart of the reference's test fixture (ref: tests/dummy_datastore.py:
22-449): a regular-grid analysis-type datastore with random state/forcing/
static data, here with a proper frame boundary mask and self-consistent
standardization statistics. Registered as a first-class datastore (the
reference registers it into DATASTORES in tests/conftest.py:97).
"""

from __future__ import annotations

import functools
import tempfile
from pathlib import Path

import numpy as np

from .base import BaseRegularGridDatastore, CartesianGridShape, FieldArray


class DummyDatastore(BaseRegularGridDatastore):
    SHORT_NAME = "dummydata"

    T0 = np.datetime64("2021-01-01T00:00", "ns")
    N_FEATURES = {"state": 5, "forcing": 2, "static": 1}

    def __init__(self, config_path=None, n_grid_points=None, n_points_1d=10,
                 n_timesteps=15, boundary_width=1, seed=916, grid_shape=None,
                 n_features=None, root=None):
        """config_path may point at a YAML overriding the keyword defaults.

        grid_shape: optional (nx, ny) for rectangular grids; n_features:
        optional {category: n} override (e.g. MEPS-shaped benches); root:
        optional persistent root dir (relative paths resolve against the
        config file) so graphs built by one CLI process are visible to the
        next — without it each instance gets a throwaway tempdir.
        """
        if config_path is not None and Path(config_path).exists():
            import yaml

            with open(config_path) as f:
                cfg = yaml.safe_load(f) or {}
            n_points_1d = cfg.get("n_points_1d", n_points_1d)
            n_timesteps = cfg.get("n_timesteps", n_timesteps)
            boundary_width = cfg.get("boundary_width", boundary_width)
            seed = cfg.get("seed", seed)
            grid_shape = cfg.get("grid_shape", grid_shape)
            n_features = cfg.get("n_features", n_features)
            root = cfg.get("root", root)
            if root is not None and not Path(root).is_absolute():
                root = Path(config_path).parent / root
        if n_grid_points is not None:
            n_points_1d = int(round(n_grid_points**0.5))
            assert n_points_1d**2 == n_grid_points, "n_grid_points must be square"
        if grid_shape is None:
            grid_shape = (n_points_1d, n_points_1d)
        if n_features is not None:
            self.N_FEATURES = {**self.N_FEATURES, **n_features}

        self._config = {
            "n_points_1d": n_points_1d,
            "n_timesteps": n_timesteps,
            "boundary_width": boundary_width,
            "seed": seed,
        }
        self._nx, self._ny = grid_shape
        self._n_timesteps = n_timesteps
        rng = np.random.default_rng(seed)

        nx, ny = grid_shape
        # x-major grid_index convention: g = ix*Ny + iy
        x = np.linspace(0.0, 10e3 * nx, nx)
        y = np.linspace(0.0, 10e3 * ny, ny)
        self._xy = np.stack(np.meshgrid(x, y, indexing="ij"), axis=-1)  # (nx, ny, 2)

        n_grid = nx * ny
        self._times = self.T0 + np.arange(n_timesteps) * np.timedelta64(
            self.step_length, "h"
        ).astype("timedelta64[ns]")

        self._data = {}
        for category, n_feats in self.N_FEATURES.items():
            if category == "static":
                vals = rng.normal(size=(n_grid, n_feats))
            else:
                # smooth-ish random walk in time so diff stats are non-trivial
                steps = rng.normal(
                    size=(n_timesteps, n_grid, n_feats), scale=0.3
                )
                vals = rng.normal(size=(1, n_grid, n_feats)) + np.cumsum(
                    steps, axis=0
                )
            self._data[category] = vals.astype(np.float32)

        mask2d = np.zeros((nx, ny), dtype=np.float32)
        bw = boundary_width
        if bw > 0:
            mask2d[:bw, :] = 1
            mask2d[-bw:, :] = 1
            mask2d[:, :bw] = 1
            mask2d[:, -bw:] = 1
        self._boundary_mask = mask2d.reshape(n_grid)

        if root is not None:
            self._tempdir = None
            self._root_path = Path(root)
            self._root_path.mkdir(parents=True, exist_ok=True)
        else:
            self._tempdir = tempfile.TemporaryDirectory()
            self._root_path = Path(self._tempdir.name)

        # train/val/test time ranges (contiguous thirds, ≥ 4 steps each)
        n_train = max(n_timesteps - 2 * max(4, n_timesteps // 5), 4)
        n_eval = (n_timesteps - n_train) // 2
        self._split_slices = {
            "train": slice(0, n_train),
            "val": slice(n_train, n_train + n_eval),
            "test": slice(n_train + n_eval, n_timesteps),
        }

    @property
    def root_path(self) -> Path:
        return self._root_path

    @property
    def config(self):
        return self._config

    @property
    def step_length(self) -> int:
        return 1

    def get_vars_names(self, category: str) -> list:
        return [f"{category}_feat_{i}" for i in range(self.N_FEATURES[category])]

    def get_vars_units(self, category: str) -> list:
        return ["-"] * self.N_FEATURES[category]

    def get_vars_long_names(self, category: str) -> list:
        return [f"Long name for {n}" for n in self.get_vars_names(category)]

    @functools.lru_cache
    def get_standardization_dataarray(self, category: str) -> dict:
        if category == "static":
            raise KeyError("no standardization for static")
        train = self._data[category][self._split_slices["train"]]
        mean = train.mean(axis=(0, 1))
        std = train.std(axis=(0, 1))
        stats = {f"{category}_mean": mean, f"{category}_std": std}
        if category == "state":
            diffs = np.diff(train, axis=0)
            stats["state_diff_mean"] = diffs.mean(axis=(0, 1))
            stats["state_diff_std"] = diffs.std(axis=(0, 1))
        return stats

    def get_dataarray(self, category: str, split) -> FieldArray:
        feat_coord = {f"{category}_feature": np.array(self.get_vars_names(category))}
        if category == "static":
            return FieldArray(
                self._data["static"], ("grid_index", "static_feature"), feat_coord
            )
        sl = self._split_slices[split] if split else slice(None)
        return FieldArray(
            self._data[category][sl],
            ("time", "grid_index", f"{category}_feature"),
            {"time": self._times[sl], **feat_coord},
        )

    @property
    def boundary_mask(self) -> FieldArray:
        return FieldArray(self._boundary_mask, ("grid_index",))

    @property
    def grid_shape_state(self) -> CartesianGridShape:
        return CartesianGridShape(x=self._nx, y=self._ny)

    def get_xy(self, category: str, stacked: bool = True) -> np.ndarray:
        if stacked:
            return self._xy.reshape(-1, 2)
        return self._xy

    @property
    def coords_projection(self) -> dict:
        # reference uses a Lambert azimuthal equal-area over Denmark
        # (ref: tests/dummy_datastore.py:407-423); plain metadata here.
        return {"name": "laea", "lat_0": 56.0, "lon_0": 10.0}
