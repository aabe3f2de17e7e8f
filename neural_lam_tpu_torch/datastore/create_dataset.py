"""Create a training-ready MDP zarr dataset from raw zarr sources.

Counterpart of neural_lam_tpu/datastore/create_dataset.py, the native
equivalent of the external `mllam-data-prep` pipeline the reference shells
out to on first use (ref: neural_lam/datastore/mdp.py:70-72). Reads the
same config schema (ref: tests/datastore_examples/mdp/danra_100m_winds/
danra.datastore.yaml):

    output:
      variables: {state: [time, grid_index, state_feature], ...}
      coord_ranges: {time: {start, end, step}}
      chunking: {time: N}
      compression: lz4 | zstd | none
      splitting:
        dim: time
        splits: {train: {start, end, compute_statistics: {ops, dims}}, ...}
    inputs:
      <name>:
        path: <local zarr path>          # http(s) and s3 need egress -> error
        dims: [time, x, y, ...]
        variables: [name, ...] | {name: {coord: {values: [...], units}}}
        dim_mapping:
          time: {method: rename, dim: time}
          grid_index: {method: stack, dims: [x, y]}
          <cat>_feature: {method: stack_variables_by_var_name,
                          dims: [coord...], name_format: "{var_name}..."}
        target_output_variable: state | forcing | static
    extra: ...   (copied through untouched, e.g. projection)

and writes the layout `MDPDatastore` consumes: per-category stacked arrays,
feature/units/long-name coordinates, x/y per grid_index, the `splits`
table, and `{category}__{split}__{mean,std,diff_mean,diff_std}` statistics
variables (ref: neural_lam/datastore/mdp.py:288-320). Grid stacking follows
the listed `dims` order row-major: `dims: [x, y]` gives the x-major
`grid_index = ix*Ny + iy`.

Two differences from the JAX package's tool:

* Under `compression: none` every array is written raw, `time`, `x`, `y`
  and the statistics too (the JAX tool writes those blosc-lz4 whatever the
  choice): the values are the same, and a machine without the system
  `libblosc` can create and read the archive. A blosc choice on such a
  machine raises, naming `--compression none`.
* The archive is written into a directory private to the process beside
  `<config>.zarr` and renamed into place once its consolidated metadata is
  written, so a failed or concurrent creation never leaves a half-written
  `<config>.zarr` for `MDPDatastore` to open; when two processes create
  one archive at once, the first rename wins and the other discards its
  copy.

All IO goes through the port's zarr reader and writer (zarr_reader.py).
PyYAML is imported only when a config is read.

CLI: python -m neural_lam_tpu_torch.datastore.create_dataset <config>
     [--force] [--compression {lz4,zstd,none}]
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
from pathlib import Path

import numpy as np

from . import zarr_reader
from .zarr_reader import ZarrGroup, consolidate_metadata, decode_cf_time

CATEGORIES = ("state", "forcing", "static")


def _parse_duration(s: str) -> np.timedelta64:
    """ISO8601 duration subset: P{n}D, PT{n}H, PT{n}M, PT{n}S, P{n}DT{m}H."""
    m = re.fullmatch(
        r"P(?:(\d+)D)?(?:T(?:(\d+)H)?(?:(\d+)M)?(?:(\d+)S)?)?", s.strip()
    )
    if not m or not any(m.groups()):
        raise ValueError(f"unsupported ISO8601 duration: {s!r}")
    d, h, mi, sec = (int(g) if g else 0 for g in m.groups())
    total_s = ((d * 24 + h) * 60 + mi) * 60 + sec
    return np.timedelta64(total_s, "s").astype("timedelta64[ns]")


def _as_dt64(v) -> np.datetime64:
    return np.datetime64(str(v), "ns")


def _coord_of(src: ZarrGroup, name: str) -> np.ndarray:
    arr = src[name]
    vals = arr.read_full()
    units = arr.attrs.get("units", "")
    if "since" in units:
        vals = decode_cf_time(vals, units)
    return vals


class _InputResult:
    """One input dataset reduced to (feature_names, units, long_names,
    per-feature arrays with dims (time?, grid_index))."""

    def __init__(self):
        self.names: list[str] = []
        self.units: list[str] = []
        self.long_names: list[str] = []
        self.columns: list[np.ndarray] = []  # each (T, N_grid) or (N_grid,)
        self.times: np.ndarray | None = None
        self.xy: np.ndarray | None = None  # (N_grid, 2)


def _process_input(name: str, spec: dict, category: str) -> _InputResult:
    path = Path(spec["path"])
    if str(spec["path"]).startswith(("http://", "https://", "s3://")):
        raise ValueError(
            f"input {name!r} has remote path {spec['path']} — this "
            "environment has no egress; download the source zarr and point "
            "`path` at the local copy."
        )
    if not path.exists():
        raise FileNotFoundError(f"input {name!r}: {path} does not exist")
    src = ZarrGroup(path)

    dim_mapping = spec["dim_mapping"]
    feat_map = dim_mapping.get(f"{category}_feature", {})
    stack_dims = list(feat_map.get("dims", []))
    name_format = feat_map.get("name_format", "{var_name}")
    grid_map = dim_mapping.get("grid_index")
    if grid_map is None or grid_map.get("method") != "stack":
        raise ValueError(
            f"input {name!r}: dim_mapping.grid_index must use method: stack"
        )
    grid_dims = list(grid_map["dims"])

    time_dim = None
    if "time" in dim_mapping:
        time_dim = dim_mapping["time"].get("dim", "time")

    variables = spec["variables"]
    if isinstance(variables, dict):
        var_items = list(variables.items())
    else:
        var_items = [(v, None) for v in variables]

    res = _InputResult()

    # grid coordinate values (for the output x/y arrays): row-major over
    # the listed grid dims, matching the stacking below; the output's
    # columns are (x, y) whatever the listed order
    gcoords = [_coord_of(src, d) for d in grid_dims]
    by_name = dict(zip(grid_dims, np.meshgrid(*gcoords, indexing="ij")))
    res.xy = np.stack(
        [by_name[d].reshape(-1) for d in ("x", "y")], axis=-1
    ).astype(np.float64)
    n_grid = int(np.prod([len(c) for c in gcoords]))

    for var_name, selection in var_items:
        arr = src[var_name]
        dims = list(arr.dims) or list(spec["dims"])
        data = arr.read_full()

        # coordinate selections ({altitude: {values: [100], units: m}})
        sel_values: dict[str, list] = {}
        for coord, sel in (selection or {}).items():
            coord_vals = _coord_of(src, coord).astype(np.float64)
            idxs = []
            for want in sel["values"]:
                hits = np.nonzero(np.isclose(coord_vals, float(want)))[0]
                if len(hits) == 0:
                    raise ValueError(
                        f"{var_name}: value {want} not found in "
                        f"coordinate {coord!r} of {path}"
                    )
                idxs.append(int(hits[0]))
            data = np.take(data, idxs, axis=dims.index(coord))
            sel_values[coord] = list(sel["values"])

        # move time first (if any), then grid dims, then stacked feat dims
        has_time = time_dim is not None and time_dim in dims
        order = [dims.index(time_dim)] if has_time else []
        order += [dims.index(d) for d in grid_dims]
        order += [dims.index(d) for d in stack_dims]
        if len(order) != len(dims):
            leftover = [d for i, d in enumerate(dims) if i not in order]
            raise ValueError(
                f"{var_name}: dims {leftover} not consumed by dim_mapping"
            )
        data = np.transpose(data, order)
        # (time?, *grid, *stacked) -> (time?, n_grid[, n_stacked])
        lead = (data.shape[0], n_grid) if has_time else (n_grid,)
        data = data.reshape(lead + ((-1,) if stack_dims else ()))

        units = arr.attrs.get("units", "-") or "-"
        long_name = arr.attrs.get("long_name", var_name) or var_name
        if stack_dims:
            combos = [()]
            for d in stack_dims:
                vals = sel_values.get(d)
                if vals is None:
                    vals = list(_coord_of(src, d))
                combos = [c + (v,) for c in combos for v in vals]
            for j, combo in enumerate(combos):
                res.names.append(name_format.format(
                    var_name=var_name, **dict(zip(stack_dims, combo))))
                res.units.append(units)
                res.long_names.append(long_name)
                res.columns.append(data[..., j])
        else:
            res.names.append(name_format.format(var_name=var_name))
            res.units.append(units)
            res.long_names.append(long_name)
            res.columns.append(data)

        if has_time and res.times is None:
            res.times = _coord_of(src, time_dim)
    return res


# codec choices for the big category arrays. "none" writes raw chunks:
# ~4x larger on disk, no decode in the training loader, and no libblosc
# needed (every array of the archive is then raw)
_COMPRESSORS = {
    "lz4": {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1},
    "zstd": {"id": "blosc", "cname": "zstd", "clevel": 3, "shuffle": 1},
    "none": None,
}


def _check_blosc(comp_name: str):
    """Raise, naming the way out, when the blosc codec `comp_name` needs
    cannot be loaded here."""
    try:
        zarr_reader._get_blosc()
    except OSError as e:
        raise OSError(
            f"compression {comp_name!r} is blosc-{comp_name}, and the "
            f"system libblosc cannot be opened on this machine ({e}); "
            "create the archive with `--compression none` (or "
            "`output.compression: none` in the config)"
        ) from e


def _write_archive(out_path, config, comp_name):
    """Gather the config's inputs and write the archive into out_path."""
    output = config["output"]
    cat_compressor = _COMPRESSORS[comp_name]
    # time, x, y and the statistics: blosc-lz4 (the writer's default) as
    # the JAX tool writes them, raw under "none"
    small = "default" if cat_compressor is not None else None
    out_vars = output["variables"]
    chunking = output.get("chunking", {})
    splitting = output.get("splitting", {})
    if splitting and splitting.get("dim", "time") != "time":
        raise ValueError("only time splitting is supported")

    def write(name, arr, dims, **kw):
        zarr_reader.write_zarr_array(out_path, name, arr, dims=dims, **kw)

    # --- gather inputs per category (config order) ---
    per_cat: dict[str, list[_InputResult]] = {c: [] for c in CATEGORIES}
    for in_name, spec in (config.get("inputs") or {}).items():
        cat = spec["target_output_variable"]
        if cat not in out_vars:
            raise ValueError(
                f"input {in_name!r} targets {cat!r} which is not in "
                f"output.variables"
            )
        per_cat[cat].append(_process_input(in_name, spec, cat))
    results = [r for rs in per_cat.values() for r in rs]

    # --- common time axis + coord_ranges slice ---
    times = None
    for r in results:
        if r.times is None:
            continue
        if times is None:
            times = r.times
        elif not np.array_equal(times, r.times):
            raise ValueError("inputs disagree on the time coordinate")
    tr = (output.get("coord_ranges") or {}).get("time")
    lo, hi = 0, None if times is None else len(times)
    if tr is not None and times is not None:
        lo = int(np.searchsorted(times, _as_dt64(tr["start"]), side="left"))
        hi = int(np.searchsorted(times, _as_dt64(tr["end"]), side="right"))
        if "step" in tr:
            step = _parse_duration(tr["step"])
            actual = times[lo + 1] - times[lo] if hi - lo > 1 else step
            if actual != step:
                raise ValueError(
                    f"source time step {actual} != requested {tr['step']}"
                )
        times = times[lo:hi]

    # --- grid consistency ---
    if not results:
        raise ValueError("no inputs provided")
    xy = results[0].xy
    if any(not np.allclose(xy, r.xy) for r in results[1:]):
        raise ValueError("inputs disagree on the grid coordinates")

    # --- assemble + write ---
    out_path.mkdir(parents=True)
    if times is not None:
        write("time", times.astype("datetime64[ns]"), ["time"],
              compressor=small)
    write("x", xy[:, 0], ["grid_index"], compressor=small)
    write("y", xy[:, 1], ["grid_index"], compressor=small)

    cat_arrays: dict[str, np.ndarray] = {}
    for cat, rs in per_cat.items():
        if not rs:
            continue
        dims = list(out_vars[cat])
        has_time = "time" in dims
        cols, names, units, longs = [], [], [], []
        for r in rs:
            for col in r.columns:
                cols.append(col[lo:hi] if has_time and col.ndim == 2 else col)
            names += r.names
            units += r.units
            longs += r.long_names
        data = np.stack(cols, axis=-1).astype(np.float32)
        want = (["time"] if has_time else []) + ["grid_index", f"{cat}_feature"]
        if dims != want:
            raise ValueError(
                f"output.variables.{cat} must be {want}, got {dims}"
            )
        t_chunk = int(chunking.get("time", 1)) if has_time else None
        chunks = ([min(t_chunk, data.shape[0])] if has_time else []) + list(
            data.shape[1 if has_time else 0:]
        )
        write(cat, data, dims, chunks=chunks, compressor=cat_compressor)
        feat = f"{cat}_feature"
        for suffix, vals in (("", names), ("_units", units),
                             ("_long_name", longs)):
            write(feat + suffix, np.array(vals, dtype=object), [feat],
                  compressor=None)
        cat_arrays[cat] = data

    # --- splits + statistics ---
    splits = splitting.get("splits", {})
    if not splits:
        return
    if times is None:
        raise ValueError("splitting requires time-dependent inputs")
    split_names = list(splits)
    table = np.array(
        [[str(splits[s]["start"]), str(splits[s]["end"])]
         for s in split_names],
        dtype=object,
    )
    write("splits", table, ["split_name", "split_part"], compressor=None)
    write("split_name", np.array(split_names, dtype=object), ["split_name"],
          compressor=None)
    write("split_part", np.array(["start", "end"], dtype=object),
          ["split_part"], compressor=None)

    for split_name, spec in splits.items():
        stats = spec.get("compute_statistics")
        if not stats:
            continue
        ops = list(stats.get("ops", ["mean", "std"]))
        s_lo = int(np.searchsorted(times, _as_dt64(spec["start"]), "left"))
        s_hi = int(np.searchsorted(times, _as_dt64(spec["end"]), "right"))
        for cat, data in cat_arrays.items():
            if data.ndim != 3:
                continue  # static: no time axis, no stats
            window = data[s_lo:s_hi].astype(np.float64)
            diffs = np.diff(window, axis=0)
            for op in ops:
                if op == "mean":
                    val = window.mean(axis=(0, 1))
                elif op == "std":
                    val = window.std(axis=(0, 1))
                elif op == "diff_mean":
                    val = diffs.mean(axis=(0, 1))
                elif op == "diff_std":
                    val = diffs.std(axis=(0, 1))
                else:
                    raise ValueError(f"unknown statistics op {op!r}")
                write(f"{cat}__{split_name}__{op}", val.astype(np.float32),
                      [f"{cat}_feature"], compressor=small)


def _publish(tmp: Path, out_path: Path, force: bool):
    """Rename the finished archive `tmp` to out_path. With force, an
    archive already there is moved aside first and deleted after; without
    it, an archive another process renamed into place first is kept and
    ours discarded."""
    old = None
    if force and out_path.exists():
        old = out_path.with_name(f".{out_path.name}.old{os.getpid()}")
        try:
            os.rename(out_path, old)
        except FileNotFoundError:  # another process moved it first
            old = None
    try:
        os.rename(tmp, out_path)
    except OSError:  # another process renamed its archive first
        shutil.rmtree(tmp, ignore_errors=True)
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)


def create_dataset(config_path, force: bool = False,
                   compression: str | None = None) -> Path:
    """Run the pipeline; returns the path of the written zarr.

    compression overrides the config's `output.compression` ("lz4"
    default, "zstd", or "none": raw chunks for every array, which needs no
    libblosc).
    """
    import yaml

    config_path = Path(config_path)
    with open(config_path) as f:
        config = yaml.safe_load(f)
    out_path = config_path.parent / config_path.name.replace(".yaml", ".zarr")
    if out_path.exists() and not force:
        raise FileExistsError(
            f"{out_path} already exists (pass --force to overwrite)"
        )
    comp_name = compression or config["output"].get("compression", "lz4")
    if comp_name not in _COMPRESSORS:
        raise ValueError(
            f"unknown compression {comp_name!r} "
            f"(choices: {sorted(_COMPRESSORS)})"
        )
    if _COMPRESSORS[comp_name] is not None:
        _check_blosc(comp_name)

    tmp = out_path.with_name(f".{out_path.name}.tmp{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        _write_archive(tmp, config, comp_name)
        consolidate_metadata(tmp)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _publish(tmp, out_path, force)
    return out_path


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Create a training-ready MDP zarr from raw zarr sources "
        "(native mllam-data-prep equivalent)"
    )
    parser.add_argument("config_path", help="datastore config yaml")
    parser.add_argument("--force", action="store_true",
                        help="overwrite an existing output zarr")
    parser.add_argument("--compression", choices=sorted(_COMPRESSORS),
                        default=None,
                        help="override output.compression: lz4 (default), "
                             "zstd, or none (raw chunks for every array: "
                             "~4x disk, no decode in the loader, no "
                             "libblosc needed)")
    args = parser.parse_args(argv)
    out = create_dataset(args.config_path, force=args.force,
                         compression=args.compression)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
