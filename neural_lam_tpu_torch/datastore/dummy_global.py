"""Global lat-lon dummy datastore for the spherical / icosahedral-mesh
configuration.

Counterpart of neural_lam_tpu/datastore/dummy_global.py. The synthetic
data machinery of DummyDatastore, but the grid covers the whole sphere:
grid point g = ilon*Nlat + ilat (x-major convention, x=lon) at cell-center
longitudes [0, 360) and latitudes (-90, 90), `get_xy` returns [lon, lat]
in DEGREES, and there is no LAM boundary (boundary_mask all zeros: a
global model has nothing to relax toward, so the AR rollout's boundary
overwrite becomes a no-op).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .dummy import DummyDatastore


class DummyGlobalDatastore(DummyDatastore):
    SHORT_NAME = "dummydata_global"

    def __init__(self, config_path=None, n_lon=36, n_lat=18, n_timesteps=15,
                 seed=916, n_features=None, root=None, **kwargs):
        if config_path is not None and Path(config_path).exists():
            import yaml

            with open(config_path) as f:
                cfg = yaml.safe_load(f) or {}
            n_lon = cfg.get("n_lon", n_lon)
            n_lat = cfg.get("n_lat", n_lat)
            n_timesteps = cfg.get("n_timesteps", n_timesteps)
            seed = cfg.get("seed", seed)
            n_features = cfg.get("n_features", n_features)
            root = cfg.get("root", root)
            if root is not None and not Path(root).is_absolute():
                root = Path(config_path).parent / root
        super().__init__(
            config_path=None, grid_shape=(n_lon, n_lat),
            n_timesteps=n_timesteps, boundary_width=0, seed=seed,
            n_features=n_features, root=root,
        )
        # cell-center global coordinates (degrees), x-major (lon-major)
        lon = (np.arange(n_lon) + 0.5) * (360.0 / n_lon)
        lat = -90.0 + (np.arange(n_lat) + 0.5) * (180.0 / n_lat)
        self._xy = np.stack(
            np.meshgrid(lon, lat, indexing="ij"), axis=-1
        )  # (n_lon, n_lat, 2) [lon, lat]
        self._config = {"n_lon": n_lon, "n_lat": n_lat,
                        "n_timesteps": n_timesteps, "seed": seed}

    @property
    def is_global(self) -> bool:
        return True

    @property
    def coords_projection(self) -> dict:
        return {"name": "platecarree"}
