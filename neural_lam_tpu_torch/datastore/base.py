"""Datastore contract: categories, splits, dims, and a minimal labeled array.

Mirrors the reference's data-access contract (ref: neural_lam/datastore/
base.py:17-391): three categories (state/forcing/static), three splits
(train/val/test), a flattened spatial `grid_index` dimension, per-category
feature dimensions named `{category}_feature`, `is_forecast`/`is_ensemble`
flags, and an `expected_dim_order`. The reference builds on xarray; this
environment has none, so `FieldArray` provides the minimal labeled-array
surface the pipeline needs (dims + coords + lazy-capable values + isel),
keeping everything else plain numpy.
"""

from __future__ import annotations

import abc
import dataclasses
import functools
from typing import Union

import numpy as np


@dataclasses.dataclass
class FieldArray:
    """Minimal labeled array: numpy (or lazy) data + dim names + coords.

    `data` is either an ndarray or a lazy object exposing `.shape`, `.dtype`
    and `__getitem__` over the *leading* axis (used for on-demand loading of
    time steps). Coordinates are optional 1-D arrays keyed by dim name.
    """

    data: object
    dims: tuple
    coords: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.dims = tuple(self.dims)
        assert len(self.shape) == len(self.dims), (self.shape, self.dims)

    @property
    def shape(self):
        return tuple(self.data.shape)

    def sizes(self):
        return dict(zip(self.dims, self.shape))

    @property
    def values(self) -> np.ndarray:
        """Materialize to numpy (loads lazy data)."""
        if isinstance(self.data, np.ndarray):
            return self.data
        return np.asarray(self.data[:])

    def to_xarray(self):
        """Convert to an `xr.DataArray` when xarray is installed
        (interop shim for third-party consumers of the reference's
        xarray-valued datastore API, ref: datastore/base.py:189-229;
        xarray is absent from this environment so in-repo code never
        depends on it)."""
        try:
            import xarray as xr
        except ImportError as e:
            raise ImportError(
                "FieldArray.to_xarray() requires xarray (pip install "
                "xarray); in-repo consumers use FieldArray directly"
            ) from e
        return xr.DataArray(self.values, dims=self.dims,
                            coords=self.coords)

    def isel(self, **sel) -> "FieldArray":
        """Integer/slice selection by dim name; int selections drop the dim.

        Lazy data may only be sliced on its leading dim (slicing any other
        dim first materializes).
        """
        index = []
        new_dims = []
        data = self.data
        if not isinstance(data, np.ndarray):
            lead = self.dims[0]
            lead_sel = sel.get(lead, slice(None))
            data = data[lead_sel]
            if isinstance(lead_sel, (int, np.integer)):
                # leading dim dropped by lazy getitem
                rest = {k: v for k, v in sel.items() if k != lead}
                coords = self._sel_coords({**rest}, drop=[lead])
                fa = FieldArray(np.asarray(data), self.dims[1:], coords)
                return fa.isel(**rest) if rest else fa
            sel = {k: v for k, v in sel.items() if k != lead}
            coords = dict(self.coords)
            if lead in coords:
                coords[lead] = np.asarray(coords[lead])[lead_sel]
            fa = FieldArray(np.asarray(data), self.dims, coords)
            return fa.isel(**sel) if sel else fa

        for d in self.dims:
            s = sel.get(d, slice(None))
            index.append(s)
            if not isinstance(s, (int, np.integer)):
                new_dims.append(d)
        coords = self._sel_coords(sel)
        return FieldArray(data[tuple(index)], tuple(new_dims), coords)

    def _sel_coords(self, sel, drop=()):
        coords = {}
        for name, c in self.coords.items():
            if name in drop:
                continue
            if name in sel:
                s = sel[name]
                if isinstance(s, (int, np.integer)):
                    continue  # scalar coords dropped
                coords[name] = np.asarray(c)[s]
            else:
                coords[name] = c
        return coords

    def sel(self, **sel) -> "FieldArray":
        """Coord-VALUE selection by dim name (xarray .sel analogue).

        Each value is matched against the dim's coordinate array; time
        coordinates accept ISO strings (parsed as np.datetime64). Exact
        match required — raises KeyError otherwise."""
        isel = {}
        for dim, value in sel.items():
            if dim not in self.coords:
                raise KeyError(
                    f"no coordinate for dim {dim!r} (have "
                    f"{sorted(self.coords)})"
                )
            coord = np.asarray(self.coords[dim])
            if np.issubdtype(coord.dtype, np.datetime64):
                value = np.datetime64(value)
            matches = np.nonzero(coord == value)[0]
            if matches.size == 0:
                raise KeyError(f"{value!r} not found in coords of {dim!r}")
            isel[dim] = int(matches[0])
        return self.isel(**isel)

    def transpose(self, *dims) -> "FieldArray":
        axes = [self.dims.index(d) for d in dims]
        return FieldArray(np.transpose(self.values, axes), dims, dict(self.coords))


FIELD_CATEGORIES = ("state", "forcing", "static")
SPLITS = ("train", "val", "test")


class BaseDatastore(abc.ABC):
    """Abstract datastore (ref: neural_lam/datastore/base.py:17-391).

    Categories: state (forecast target), forcing (known inputs), static
    (time-invariant per-gridpoint). Splits: train/val/test. Spatial dims are
    flattened into `grid_index`.
    """

    is_ensemble: bool = False
    is_forecast: bool = False

    @property
    @abc.abstractmethod
    def root_path(self):
        """Root path under which derived artifacts (graphs) live."""

    @property
    @abc.abstractmethod
    def config(self):
        """The datastore's configuration object/mapping."""

    @property
    @abc.abstractmethod
    def step_length(self) -> int:
        """Time step length in hours."""

    @abc.abstractmethod
    def get_vars_units(self, category: str) -> list:
        ...

    @abc.abstractmethod
    def get_vars_names(self, category: str) -> list:
        ...

    @abc.abstractmethod
    def get_vars_long_names(self, category: str) -> list:
        ...

    def get_num_data_vars(self, category: str) -> int:
        return len(self.get_vars_names(category))

    @abc.abstractmethod
    def get_standardization_dataarray(self, category: str) -> dict:
        """Per-feature stats: {category}_mean/{category}_std (d,) arrays, and
        for state also state_diff_mean/state_diff_std
        (ref: base.py:161-188)."""

    @abc.abstractmethod
    def get_dataarray(self, category: str, split: Union[str, None]) -> FieldArray:
        """Return the FieldArray for a category/split in expected_dim_order,
        or None when the category is absent (ref: base.py:189-230)."""

    @property
    @abc.abstractmethod
    def boundary_mask(self) -> FieldArray:
        """(grid_index, 1) mask, 1=boundary node (ref: base.py:231-247)."""

    @abc.abstractmethod
    def get_xy(self, category: str) -> np.ndarray:
        """(n_grid_points, 2) xy coordinates (ref: base.py:248-264)."""

    @property
    def coords_projection(self) -> dict:
        """Projection metadata for plotting (reference returns a cartopy CRS,
        ref: base.py:265-279; we return a plain descriptor dict since
        cartopy is unavailable)."""
        return {"name": "none"}

    def get_xy_extent(self, category: str) -> list:
        """[xmin, xmax, ymin, ymax] (ref: base.py:280-306)."""
        xy = self.get_xy(category)
        return [
            float(xy[:, 0].min()), float(xy[:, 0].max()),
            float(xy[:, 1].min()), float(xy[:, 1].max()),
        ]

    @property
    @abc.abstractmethod
    def num_grid_points(self) -> int:
        ...

    @functools.cached_property
    def state_feature_weights_values(self) -> list:
        """Default per-state-feature weights (1.0 each)
        (ref: base.py:320-336)."""
        return [1.0] * self.get_num_data_vars(category="state")

    def expected_dim_order(self, category: str = None) -> tuple:
        """[time dims..., grid_index, {category}_feature]
        (ref: base.py:337-391)."""
        dim_order = []
        if category != "static":
            if self.is_forecast:
                dim_order.extend(["analysis_time", "elapsed_forecast_duration"])
            else:
                dim_order.append("time")
            if self.is_ensemble and category == "state":
                dim_order.append("ensemble_member")
        dim_order.append("grid_index")
        if category is not None:
            dim_order.append(f"{category}_feature")
        return tuple(dim_order)


@dataclasses.dataclass
class CartesianGridShape:
    """2D grid shape (ref: base.py:394-399)."""

    x: int
    y: int


class BaseRegularGridDatastore(BaseDatastore):
    """Adds 2D-grid semantics over the flattened grid_index
    (ref: base.py:402-558).

    Stacking convention: grid_index = ix * Ny + iy ("x"-major — xarray's
    stack(("x", "y"))), consistently used by the graph builder too.
    """

    CARTESIAN_COORDS = ["x", "y"]

    @property
    @abc.abstractmethod
    def grid_shape_state(self) -> CartesianGridShape:
        ...

    @abc.abstractmethod
    def get_xy(self, category: str, stacked: bool = True) -> np.ndarray:
        """stacked=True: (N_x*N_y, 2); stacked=False: (N_x, N_y, 2)."""

    def stack_grid_coords(self, arr: np.ndarray) -> np.ndarray:
        """(..., Nx, Ny[, f]) -> (..., Nx*Ny[, f]) following x-major order."""
        shape = self.grid_shape_state
        arr = np.asarray(arr)
        ax = next(
            i for i in range(arr.ndim - 1)
            if arr.shape[i] == shape.x and arr.shape[i + 1] == shape.y
        )
        return arr.reshape(arr.shape[:ax] + (shape.x * shape.y,) + arr.shape[ax + 2:])

    def unstack_grid_coords(self, arr: np.ndarray) -> np.ndarray:
        """(..., Nx*Ny, ...) -> (..., Nx, Ny, ...) (x-major order)."""
        shape = self.grid_shape_state
        arr = np.asarray(arr)
        n = shape.x * shape.y
        ax = next(i for i in range(arr.ndim) if arr.shape[i] == n)
        return arr.reshape(arr.shape[:ax] + (shape.x, shape.y) + arr.shape[ax + 1:])

    @property
    def num_grid_points(self) -> int:
        return self.grid_shape_state.x * self.grid_shape_state.y
