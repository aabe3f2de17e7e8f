"""Hand-rolled map projections for geographic plotting.

Counterpart of neural_lam_tpu/projections.py (numpy only).

The reference draws spatial maps on a cartopy GeoAxes built from the
datastore's CRS (ref: neural_lam/vis.py:68-126, datastore/base.py:265-279
returns a `cartopy.crs`). cartopy is unavailable in this environment, so
this module implements the forward (lon/lat deg -> projected x/y) and
inverse transforms for the projection families weather datastores use,
on a spherical earth — for PLOTTING (graticule overlay, geographic axis
labels), where sub-kilometre ellipsoidal corrections are invisible.

Supported `coords_projection` descriptor dicts (cartopy class names and
proj.4-style aliases both accepted, kwargs in cartopy's degree
conventions with lon_0/lat_0 aliases):

- {"name": "LambertConformal", "central_longitude": .., "central_latitude": ..,
   "standard_parallels": [.., ..]}            # MEPS (ref npy config)
- {"name": "laea", "lat_0": .., "lon_0": ..}  # dummy datastore
- {"name": "Stereographic", ...}
- {"name": "PlateCarree"} / {"name": "latlon"}  (x=lon deg, y=lat deg)
- {"name": "Mercator", ...}
- {"name": "none"}  -> None (no geographic interpretation)
"""

from __future__ import annotations

import numpy as np

# HARMONIE/HIRLAM (the MEPS model) spherical earth radius, metres
EARTH_RADIUS = 6_371_000.0


def _get(info: dict, *names, default=None):
    for n in names:
        if n in info:
            return info[n]
    return default


class Projection:
    """forward(lon, lat) -> (x, y); inverse(x, y) -> (lon, lat).

    All angles in degrees, x/y in the projection's native units
    (metres except PlateCarree's degrees)."""

    def forward(self, lon, lat):
        raise NotImplementedError

    def inverse(self, x, y):
        raise NotImplementedError


class PlateCarree(Projection):
    def __init__(self, central_longitude=0.0):
        self.lon0 = float(central_longitude)

    def forward(self, lon, lat):
        lon = (np.asarray(lon, np.float64) - self.lon0 + 180.0) % 360.0 - 180.0
        return lon, np.asarray(lat, np.float64)

    def inverse(self, x, y):
        return np.asarray(x, np.float64) + self.lon0, np.asarray(y, np.float64)


class Mercator(Projection):
    def __init__(self, central_longitude=0.0, radius=EARTH_RADIUS):
        self.lon0, self.R = float(central_longitude), float(radius)

    def forward(self, lon, lat):
        lam = np.radians(
            (np.asarray(lon, np.float64) - self.lon0 + 180.0) % 360.0 - 180.0
        )
        phi = np.radians(np.clip(np.asarray(lat, np.float64), -89.99, 89.99))
        return self.R * lam, self.R * np.log(np.tan(np.pi / 4 + phi / 2))

    def inverse(self, x, y):
        lon = np.degrees(np.asarray(x, np.float64) / self.R) + self.lon0
        lat = np.degrees(
            2 * np.arctan(np.exp(np.asarray(y, np.float64) / self.R))
            - np.pi / 2
        )
        return lon, lat


class LambertConformal(Projection):
    """Lambert conformal conic, 1 or 2 standard parallels (spherical
    formulas: Snyder 1987, eq. 15-1..15-5)."""

    def __init__(self, central_longitude=0.0, central_latitude=0.0,
                 standard_parallels=None, radius=EARTH_RADIUS,
                 false_easting=0.0, false_northing=0.0):
        if standard_parallels is None:
            standard_parallels = (central_latitude, central_latitude)
        sp = np.atleast_1d(np.asarray(standard_parallels, np.float64))
        p1 = np.radians(sp[0])
        p2 = np.radians(sp[-1])
        if abs(p1 - p2) < 1e-12:
            self.n = np.sin(p1)
        else:
            self.n = (np.log(np.cos(p1) / np.cos(p2))
                      / np.log(np.tan(np.pi / 4 + p2 / 2)
                               / np.tan(np.pi / 4 + p1 / 2)))
        self.F = np.cos(p1) * np.tan(np.pi / 4 + p1 / 2) ** self.n / self.n
        self.R = float(radius)
        self.lon0 = float(central_longitude)
        phi0 = np.radians(float(central_latitude))
        self.rho0 = self.R * self.F / np.tan(np.pi / 4 + phi0 / 2) ** self.n
        self.x0, self.y0 = float(false_easting), float(false_northing)

    def forward(self, lon, lat):
        lam = np.radians(
            (np.asarray(lon, np.float64) - self.lon0 + 180.0) % 360.0 - 180.0
        )
        phi = np.radians(np.clip(np.asarray(lat, np.float64), -89.99, 89.99))
        rho = self.R * self.F / np.tan(np.pi / 4 + phi / 2) ** self.n
        x = rho * np.sin(self.n * lam) + self.x0
        y = self.rho0 - rho * np.cos(self.n * lam) + self.y0
        return x, y

    def inverse(self, x, y):
        x = np.asarray(x, np.float64) - self.x0
        y = np.asarray(y, np.float64) - self.y0
        sgn = np.sign(self.n) or 1.0
        rho = sgn * np.hypot(x, self.rho0 - y)
        theta = np.arctan2(sgn * x, sgn * (self.rho0 - y))
        lon = np.degrees(theta / self.n) + self.lon0
        with np.errstate(divide="ignore"):
            phi = 2 * np.arctan(
                (self.R * self.F / np.where(rho == 0, np.nan, rho))
                ** (1.0 / self.n)
            ) - np.pi / 2
        return lon, np.degrees(phi)


class _Azimuthal(Projection):
    """Shared machinery for LAEA / stereographic (both azimuthal about
    (lat_0, lon_0); only the radial scale factor k differs)."""

    def __init__(self, central_longitude=0.0, central_latitude=0.0,
                 radius=EARTH_RADIUS):
        self.lon0 = float(central_longitude)
        self.phi0 = np.radians(float(central_latitude))
        self.R = float(radius)

    def _k(self, cos_c):
        raise NotImplementedError

    def forward(self, lon, lat):
        lam = np.radians(
            (np.asarray(lon, np.float64) - self.lon0 + 180.0) % 360.0 - 180.0
        )
        phi = np.radians(np.asarray(lat, np.float64))
        s0, c0 = np.sin(self.phi0), np.cos(self.phi0)
        cos_c = s0 * np.sin(phi) + c0 * np.cos(phi) * np.cos(lam)
        k = self._k(cos_c)
        x = self.R * k * np.cos(phi) * np.sin(lam)
        y = self.R * k * (c0 * np.sin(phi) - s0 * np.cos(phi) * np.cos(lam))
        return x, y


class LambertAzimuthalEqualArea(_Azimuthal):
    """Snyder eq. 24-2: k' = sqrt(2 / (1 + cos c))."""

    def _k(self, cos_c):
        return np.sqrt(2.0 / np.maximum(1.0 + cos_c, 1e-12))

    def inverse(self, x, y):
        x = np.asarray(x, np.float64) / self.R
        y = np.asarray(y, np.float64) / self.R
        rho = np.hypot(x, y)
        c = 2 * np.arcsin(np.clip(rho / 2.0, -1.0, 1.0))
        return self._inv_common(x, y, rho, c)

    def _inv_common(self, x, y, rho, c):
        s0, c0 = np.sin(self.phi0), np.cos(self.phi0)
        sin_c, cos_c = np.sin(c), np.cos(c)
        safe_rho = np.where(rho == 0, 1.0, rho)
        phi = np.arcsin(np.clip(
            cos_c * s0 + y * sin_c * c0 / safe_rho, -1.0, 1.0
        ))
        lam = np.arctan2(x * sin_c, safe_rho * c0 * cos_c - y * s0 * sin_c)
        phi = np.where(rho == 0, self.phi0, phi)
        lam = np.where(rho == 0, 0.0, lam)
        return np.degrees(lam) + self.lon0, np.degrees(phi)


class Stereographic(_Azimuthal):
    """Snyder eq. 21-4: k = 2 / (1 + cos c)."""

    def _k(self, cos_c):
        return 2.0 / np.maximum(1.0 + cos_c, 1e-12)

    def inverse(self, x, y):
        x = np.asarray(x, np.float64) / self.R
        y = np.asarray(y, np.float64) / self.R
        rho = np.hypot(x, y)
        c = 2 * np.arctan(rho / 2.0)
        return LambertAzimuthalEqualArea._inv_common(self, x, y, rho, c)


_ALIASES = {
    "lambertconformal": LambertConformal, "lcc": LambertConformal,
    "lambertazimuthalequalarea": LambertAzimuthalEqualArea,
    "laea": LambertAzimuthalEqualArea,
    "stereographic": Stereographic, "stere": Stereographic,
    "platecarree": PlateCarree, "latlon": PlateCarree,
    "equirectangular": PlateCarree,
    "mercator": Mercator, "merc": Mercator,
}

_KW_ALIASES = {
    "lon_0": "central_longitude", "lat_0": "central_latitude",
    "lat_1": None, "lat_2": None,  # folded into standard_parallels below
}


def from_descriptor(info: dict | None) -> Projection | None:
    """Build a Projection from a datastore's `coords_projection` dict.

    Returns None for missing/unknown/"none" descriptors — callers fall
    back to bare projected-xy plotting."""
    if not info:
        return None
    name = str(info.get("name", "none")).lower()
    cls = _ALIASES.get(name)
    if cls is None:
        return None
    kwargs = {}
    sp = []
    for key, val in info.items():
        if key == "name":
            continue
        if key in ("lat_1", "lat_2"):
            sp.append(float(val))
            continue
        key = _KW_ALIASES.get(key, key)
        if key is not None:
            kwargs[key] = val
    if sp and cls is LambertConformal:
        kwargs.setdefault("standard_parallels", sp)
    if "globe" in kwargs:  # cartopy Globe objects/dicts: keep the radius
        globe = kwargs.pop("globe")
        radius = None
        if isinstance(globe, dict):
            radius = globe.get("semimajor_axis") or globe.get("radius")
        if radius:
            kwargs["radius"] = float(radius)
    try:
        return cls(**{k: v for k, v in kwargs.items()
                      if k in cls.__init__.__code__.co_varnames})
    except Exception:
        return None


def _nice_step(span: float) -> float:
    """Graticule spacing: the largest of the standard steps giving >= 3
    lines across `span` degrees."""
    for step in (30.0, 20.0, 10.0, 5.0, 2.0, 1.0, 0.5, 0.25, 0.1):
        if span / step >= 3.0:
            return step
    return 0.05


def graticule(proj: Projection, extent, n_samples: int = 181):
    """Lon/lat grid lines covering a projected extent.

    extent: [xmin, xmax, ymin, ymax] in projected coords. Returns
    (meridians, parallels): lists of (value_deg, xs, ys) polylines
    clipped to the extent, plus tick label positions along the bottom /
    left edges as (x_or_y, value_deg) lists in a dict."""
    xmin, xmax, ymin, ymax = [float(v) for v in extent]
    # geographic bounding box: invert a dense boundary sampling
    bx = np.concatenate([
        np.linspace(xmin, xmax, 50), np.full(50, xmax),
        np.linspace(xmax, xmin, 50), np.full(50, xmin),
    ])
    by = np.concatenate([
        np.full(50, ymin), np.linspace(ymin, ymax, 50),
        np.full(50, ymax), np.linspace(ymax, ymin, 50),
    ])
    lon_b, lat_b = proj.inverse(bx, by)
    lon_b = lon_b[np.isfinite(lon_b)]
    lat_b = lat_b[np.isfinite(lat_b)]
    if lon_b.size == 0 or lat_b.size == 0:
        return [], [], {"bottom": [], "left": []}
    lon_lo, lon_hi = float(lon_b.min()), float(lon_b.max())
    lat_lo, lat_hi = float(lat_b.min()), float(lat_b.max())
    lon_step = _nice_step(lon_hi - lon_lo)
    lat_step = _nice_step(lat_hi - lat_lo)

    def _levels(lo, hi, step):
        start = np.ceil(lo / step) * step
        return np.arange(start, hi + step * 1e-6, step)

    meridians, parallels = [], []
    ticks = {"bottom": [], "left": []}
    lats = np.linspace(lat_lo, lat_hi, n_samples)
    for lon in _levels(lon_lo, lon_hi, lon_step):
        xs, ys = proj.forward(np.full_like(lats, lon), lats)
        keep = (xs >= xmin) & (xs <= xmax) & (ys >= ymin) & (ys <= ymax)
        if keep.any():
            meridians.append((float(lon), xs[keep], ys[keep]))
            # bottom-edge crossing for the tick label
            i = int(np.argmin(ys[keep]))
            ticks["bottom"].append((float(xs[keep][i]), float(lon)))
    lons = np.linspace(lon_lo, lon_hi, n_samples)
    for lat in _levels(lat_lo, lat_hi, lat_step):
        xs, ys = proj.forward(lons, np.full_like(lons, lat))
        keep = (xs >= xmin) & (xs <= xmax) & (ys >= ymin) & (ys <= ymax)
        if keep.any():
            parallels.append((float(lat), xs[keep], ys[keep]))
            i = int(np.argmin(xs[keep]))
            ticks["left"].append((float(ys[keep][i]), float(lat)))
    return meridians, parallels, ticks


def _fmt_deg(value: float, kind: str) -> str:
    suffix = ("E" if value >= 0 else "W") if kind == "lon" else (
        "N" if value >= 0 else "S")
    v = abs(value)
    txt = f"{v:.2f}".rstrip("0").rstrip(".")
    return f"{txt}\N{DEGREE SIGN}{suffix}"


def add_graticule(ax, datastore, category: str = "state",
                  color: str = "0.35", lw: float = 0.5):
    """Overlay lon/lat grid lines + degree tick labels on a projected-xy
    axes, from the datastore's `coords_projection` descriptor. No-op
    (returns False) when the projection is unknown."""
    proj = from_descriptor(getattr(datastore, "coords_projection", None))
    if proj is None:
        return False
    extent = datastore.get_xy_extent(category)
    meridians, parallels, ticks = graticule(proj, extent)
    for _, xs, ys in meridians + parallels:
        ax.plot(xs, ys, color=color, lw=lw, ls=":", zorder=3)
    ax.set_xticks([x for x, _ in ticks["bottom"]])
    ax.set_xticklabels(
        [_fmt_deg(v, "lon") for _, v in ticks["bottom"]], fontsize=7
    )
    ax.set_yticks([y for y, _ in ticks["left"]])
    ax.set_yticklabels(
        [_fmt_deg(v, "lat") for _, v in ticks["left"]], fontsize=7
    )
    ax.set_xlim(extent[0], extent[1])
    ax.set_ylim(extent[2], extent[3])
    return True
