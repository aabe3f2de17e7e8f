"""The port's datastore tools against the JAX package's.

* `create_dataset` on the same raw zarr sources writes the same archive
  as the JAX tool under lz4, zstd and none: every array's decoded values,
  dims, attrs and chunks, and under lz4 and zstd its compressor; under
  none no array carries a compressor, and no libblosc is needed. The
  same configs fail the same way; a failed creation leaves no archive,
  two processes creating one archive both end with it, and
  `MDPDatastore` creates a missing archive on first use.
* `compute_standardization_stats` on the same MEPS fixture writes the
  JAX tool's five `.pt` files bit for bit, serially and with workers;
  sharded, the JAX tool's sharded files, within fp tolerance of the
  serial pass.
* Both `python -m` entry points run.
"""

import copy
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from neural_lam_tpu.dataset import WeatherDataset as JWeatherDataset
from neural_lam_tpu.datastore import zarr_reader as jzr
from neural_lam_tpu.datastore.compute_standardization_stats import (
    main as j_stats_main,
)
from neural_lam_tpu.datastore.create_dataset import (
    create_dataset as j_create_dataset,
)
from neural_lam_tpu.datastore.mdp import MDPDatastore as JMDPDatastore
from neural_lam_tpu_torch.dataset import WeatherDataset
from neural_lam_tpu_torch.datastore import create_dataset as tcd
from neural_lam_tpu_torch.datastore import zarr_reader as tzr
from neural_lam_tpu_torch.datastore.compute_standardization_stats import (
    main as stats_main,
)
from neural_lam_tpu_torch.datastore.mdp import MDPDatastore

from .meps_fixture import make_meps_dataset

ROOT = Path(__file__).resolve().parent.parent
NX, NY, N_T = 8, 6, 20
ALTS = [50.0, 100.0, 200.0]
ZLIB = {"id": "zlib", "level": 1}
STATS_FILES = ("parameter_mean.pt", "parameter_std.pt", "flux_stats.pt",
               "diff_mean.pt", "diff_std.pt")
CONFIG = "danra.datastore.yaml"


def _write_sources(root, seed=0):
    """Raw source zarrs shaped like the DANRA example, zlib chunks:
    height-level u, v and t over altitude, single-level radiation and
    2 m temperature, and a static mask and orography."""
    rng = np.random.default_rng(seed)
    times = np.datetime64("2020-01-01T00", "ns") + np.arange(
        N_T) * np.timedelta64(3, "h")
    x = np.arange(NX, dtype=np.float64) * 1000.0
    y = np.arange(NY, dtype=np.float64) * 1000.0

    def store(name, arrays):
        """arrays: (name, values, dims[, write_zarr_array kwargs])."""
        path = root / name
        for key, arr, dims, *kw in [("x", x, ["x"]), ("y", y, ["y"])] + arrays:
            tzr.write_zarr_array(path, key, arr, dims=dims, compressor=ZLIB,
                                 **(kw[0] if kw else {}))
        tzr.consolidate_metadata(path)

    def field(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    store("height_levels.zarr", [
        ("time", times, ["time"]), ("altitude", np.array(ALTS), ["altitude"]),
        *[(v, field(N_T, NX, NY, len(ALTS)), ["time", "x", "y", "altitude"],
           {"chunks": [5, NX, NY, len(ALTS)],
            "attrs": {"units": "m/s", "long_name": f"{v}-wind"}})
          for v in ("u", "v")],
        ("t", field(N_T, NX, NY, len(ALTS)), ["time", "x", "y", "altitude"],
         {"chunks": [7, NX, NY, len(ALTS)], "attrs": {"units": "K"}})])
    store("single_levels.zarr", [
        ("time", times, ["time"]),
        ("swavr0m", field(N_T, NX, NY), ["time", "x", "y"],
         {"chunks": [5, NX, NY], "attrs": {"units": "W/m^2"}}),
        ("t2m", field(N_T, NX, NY), ["time", "x", "y"],
         {"chunks": [4, NX, NY]})])
    store("static.zarr", [
        ("lsm", (field(NX, NY) > 0).astype(np.float32), ["x", "y"],
         {"attrs": {"units": "-", "long_name": "land-sea mask"}}),
        ("orography", field(NX, NY), ["x", "y"])])
    return times


def _config(src, times):
    """A datastore config over the sources in `src`: coord_ranges, two
    inputs stacked into state (one with coordinate selections, one over
    every altitude), splits with statistics on train."""
    def tstr(i):
        return str(times[i].astype("datetime64[s]"))

    grid = {"method": "stack", "dims": ["x", "y"]}
    rename = {"method": "rename", "dim": "time"}

    def stack(dims=None, fmt="{var_name}"):
        out = {"method": "stack_variables_by_var_name", "name_format": fmt}
        if dims:
            out["dims"] = dims
        return out

    return {
        "schema_version": "v0.5.0",
        "dataset_version": "v0.1.0",
        "output": {
            "variables": {
                "static": ["grid_index", "static_feature"],
                "state": ["time", "grid_index", "state_feature"],
                "forcing": ["time", "grid_index", "forcing_feature"],
            },
            "coord_ranges": {
                "time": {"start": tstr(2), "end": tstr(17), "step": "PT3H"},
            },
            "chunking": {"time": 4},
            "splitting": {
                "dim": "time",
                "splits": {
                    "train": {
                        "start": tstr(2), "end": tstr(7),
                        "compute_statistics": {
                            "ops": ["mean", "std", "diff_mean", "diff_std"],
                            "dims": ["grid_index", "time"],
                        },
                    },
                    "val": {"start": tstr(8), "end": tstr(12)},
                    "test": {"start": tstr(13), "end": tstr(17)},
                },
            },
        },
        "inputs": {
            "danra_height_levels": {
                "path": str(src / "height_levels.zarr"),
                "dims": ["time", "x", "y", "altitude"],
                "variables": {
                    "u": {"altitude": {"values": [100, 200], "units": "m"}},
                    "v": {"altitude": {"values": [100], "units": "m"}},
                },
                "dim_mapping": {
                    "time": rename, "grid_index": grid,
                    "state_feature": stack(["altitude"],
                                           "{var_name}{altitude}m")},
                "target_output_variable": "state",
            },
            "danra_temperature": {
                "path": str(src / "height_levels.zarr"),
                "dims": ["time", "x", "y", "altitude"],
                "variables": ["t"],
                "dim_mapping": {
                    "time": rename, "grid_index": grid,
                    "state_feature": stack(["altitude"],
                                           "{var_name}_{altitude}")},
                "target_output_variable": "state",
            },
            "danra_surface_state": {
                "path": str(src / "single_levels.zarr"),
                "dims": ["time", "x", "y"],
                "variables": ["t2m"],
                "dim_mapping": {"time": rename, "grid_index": grid,
                                "state_feature": stack()},
                "target_output_variable": "state",
            },
            "danra_surface": {
                "path": str(src / "single_levels.zarr"),
                "dims": ["time", "x", "y"],
                "variables": ["swavr0m"],
                "dim_mapping": {"time": rename, "grid_index": grid,
                                "forcing_feature": stack()},
                "target_output_variable": "forcing",
            },
            "danra_static": {
                "path": str(src / "static.zarr"),
                "dims": ["x", "y"],
                "variables": ["lsm", "orography"],
                "dim_mapping": {"grid_index": grid,
                                "static_feature": stack()},
                "target_output_variable": "static",
            },
        },
        "extra": {
            "projection": {
                "class_name": "LambertConformal",
                "kwargs": {"central_longitude": 25.0,
                           "central_latitude": 56.7},
            },
        },
    }


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    src = tmp_path_factory.mktemp("sources")
    return src, _config(src, _write_sources(src))


def _write_config(d, config):
    d.mkdir(parents=True, exist_ok=True)
    path = d / CONFIG
    path.write_text(yaml.safe_dump(config))
    return path


def _archives_equal(port, jax, codec):
    """Every array of the two archives: decoded values, dims, attrs and
    chunks equal; compressors equal (lz4, zstd) or absent (none)."""
    t, j = tzr.ZarrGroup(port), jzr.ZarrGroup(jax)
    assert sorted(t.arrays) == sorted(j.arrays)
    assert t.attrs == j.attrs
    for name in sorted(j.arrays):
        a, b = t[name], j[name]
        assert (a.dims, a.attrs, a.chunks, a.shape) == (
            b.dims, b.attrs, b.chunks, b.shape), name
        va, vb = a.read_full(), b.read_full()
        assert va.dtype == vb.dtype, name
        np.testing.assert_array_equal(va, vb, name)
        if codec == "none":
            assert a.compressor is None, name
        else:
            assert a.compressor == b.compressor, name
    return t


@pytest.mark.parametrize("codec", ["lz4", "zstd", "none"])
def test_create_dataset_matches_jax(codec, sources, tmp_path):
    src, config = sources
    cfg_p = _write_config(tmp_path / "port", config)
    cfg_j = _write_config(tmp_path / "jax", config)
    out = tcd.create_dataset(cfg_p, compression=codec)
    assert out == cfg_p.with_suffix(".zarr")
    g = _archives_equal(out, j_create_dataset(cfg_j, compression=codec),
                        codec)
    assert sorted(p.name for p in out.parent.iterdir()) == [
        CONFIG, "danra.datastore.zarr"]
    assert [str(s) for s in g["state_feature"].read_full()] == [
        "u100m", "u200m", "v100m", "t2m", "t_50.0", "t_100.0", "t_200.0"]
    assert g["state"].shape == (16, NX * NY, 7)
    assert g["state"].chunks == (4, NX * NY, 7)
    blosc = {"lz4": "lz4", "zstd": "zstd"}.get(codec)
    assert g["state"].compressor == (
        None if blosc is None else dict(tcd._COMPRESSORS[codec]))


def test_compression_from_config_and_force(sources, tmp_path):
    """output.compression picks the codec when none is passed; an
    existing archive raises without --force and is replaced with it."""
    _, config = sources
    config = copy.deepcopy(config)
    config["output"]["compression"] = "none"
    cfg = _write_config(tmp_path, config)
    out = tcd.create_dataset(cfg)
    assert tzr.ZarrGroup(out)["state"].compressor is None
    with pytest.raises(FileExistsError, match="--force"):
        tcd.create_dataset(cfg)
    (out / "stale").write_text("from the earlier archive")
    assert tcd.create_dataset(cfg, force=True, compression="lz4") == out
    g = tzr.ZarrGroup(out)
    assert g["state"].compressor["cname"] == "lz4"
    assert not (out / "stale").exists()
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        CONFIG, "danra.datastore.zarr"]


def _bad(kind, config, tmp_path):
    """A config that must fail, and the compression to pass."""
    config = copy.deepcopy(config)
    out = config["output"]
    inputs = config["inputs"]
    if kind == "step":
        out["coord_ranges"]["time"]["step"] = "PT6H"
    elif kind == "duration":
        out["coord_ranges"]["time"]["step"] = "3 hours"
    elif kind in ("https", "s3"):
        inputs["danra_surface"]["path"] = f"{kind}://example.com/x.zarr"
    elif kind == "missing":
        inputs["danra_surface"]["path"] = str(tmp_path / "nowhere.zarr")
    elif kind == "selection":
        inputs["danra_height_levels"]["variables"]["v"]["altitude"][
            "values"] = [150]
    elif kind == "op":
        out["splitting"]["splits"]["train"]["compute_statistics"][
            "ops"] = ["mean", "median"]
    elif kind == "dims":
        out["variables"]["forcing"] = ["grid_index", "time",
                                       "forcing_feature"]
    elif kind == "target":
        del out["variables"]["static"]
    elif kind == "leftover":
        inputs["danra_temperature"]["dim_mapping"]["state_feature"].pop(
            "dims")
    elif kind == "split_dim":
        out["splitting"]["dim"] = "grid_index"
    return config, "gzip9" if kind == "codec" else None


@pytest.mark.parametrize("kind", [
    "step", "duration", "https", "s3", "missing", "selection", "op", "dims",
    "target", "leftover", "split_dim", "codec"])
def test_bad_configs_fail_as_in_jax(kind, sources, tmp_path):
    """The same bad config raises the same exception with the same message
    in both tools, and the port leaves nothing beside the config."""
    config, codec = _bad(kind, sources[1], tmp_path)
    raised = []
    for name, fn in (("port", tcd.create_dataset),
                     ("jax", j_create_dataset)):
        cfg = _write_config(tmp_path / name, config)
        with pytest.raises(Exception) as e:
            fn(cfg, compression=codec)
        raised.append((type(e.value), str(e.value)))
    assert raised[0] == raised[1]
    assert raised[0][0] in (ValueError, FileNotFoundError)
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == [CONFIG]


def test_failed_creation_leaves_no_archive(sources, tmp_path, monkeypatch):
    """A write that fails after the category arrays are on disk (here at
    the first statistics array) leaves neither the archive nor the
    private directory it was written in."""
    cfg = _write_config(tmp_path, sources[1])
    real = tzr.write_zarr_array
    written = []

    def write_zarr_array(group, name, *args, **kwargs):
        if "__" in name:
            assert {"state", "forcing", "static"} <= set(written)
            raise OSError("disk full")
        written.append(name)
        assert Path(group) != cfg.with_suffix(".zarr")
        return real(group, name, *args, **kwargs)

    monkeypatch.setattr(tzr, "write_zarr_array", write_zarr_array)
    with pytest.raises(OSError, match="disk full"):
        tcd.create_dataset(cfg, compression="none")
    assert sorted(p.name for p in tmp_path.iterdir()) == [CONFIG]
    with pytest.raises(OSError, match="disk full"):
        MDPDatastore(cfg)
    assert sorted(p.name for p in tmp_path.iterdir()) == [CONFIG]


def test_no_libblosc(sources, tmp_path, monkeypatch):
    """Where libblosc cannot be opened, a blosc codec raises before
    anything is written, naming the codec and `--compression none`; under
    none the whole archive is written and read without it."""
    cfg = _write_config(tmp_path, sources[1])

    def no_blosc():
        raise OSError("libblosc.so.1: cannot open shared object file")

    monkeypatch.setattr(tzr, "_get_blosc", no_blosc)
    for codec in ("lz4", "zstd"):
        with pytest.raises(OSError, match=f"'{codec}'.*--compression none"):
            tcd.create_dataset(cfg, compression=codec)
        assert sorted(p.name for p in tmp_path.iterdir()) == [CONFIG]
    g = tzr.ZarrGroup(tcd.create_dataset(cfg, compression="none"))
    tzr._chunk_cache.clear()
    for name in g.arrays:
        assert g[name].compressor is None, name
        for idx in np.ndindex(*(-(-s // c) for s, c in
                                zip(g[name].shape, g[name].chunks))):
            g[name]._read_chunk_nocache(idx)


@pytest.mark.parametrize("race", ["alone", "lost"])
def test_creation_goes_through_a_private_directory(race, sources, tmp_path,
                                                   monkeypatch):
    """The archive is written into a directory of its own beside the
    final one and renamed into place; when another process has renamed
    its archive first, ours is discarded and theirs kept."""
    cfg = _write_config(tmp_path, sources[1])
    final = cfg.with_suffix(".zarr")
    real = tcd._write_archive
    paths = []

    def write_archive(out_path, config, comp_name):
        paths.append(out_path)
        assert out_path != final and out_path.parent == final.parent
        real(out_path, config, comp_name)
        assert not final.exists()
        if race == "lost":  # a concurrent creation renames its copy first
            real(final, config, "none")
            tzr.consolidate_metadata(final)

    monkeypatch.setattr(tcd, "_write_archive", write_archive)
    assert tcd.create_dataset(cfg, compression="lz4") == final
    assert len(paths) == 1
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        CONFIG, "danra.datastore.zarr"]
    compressor = tzr.ZarrGroup(final)["state"].compressor
    assert (compressor is None) == (race == "lost")


_RACE = textwrap.dedent("""
    import sys, time
    from pathlib import Path
    sys.path.insert(0, {repo!r})
    import numpy as np
    from neural_lam_tpu_torch.datastore.mdp import MDPDatastore
    go = Path({root!r}) / "go"
    while not go.exists():
        time.sleep(0.005)
    ds = MDPDatastore({cfg!r}, n_boundary_points=1)
    state = ds.get_dataarray("state", "train").values
    print(repr((ds.get_vars_names("state"), float(np.asarray(
        state, np.float64).sum()), state.shape)))
""")


def test_archive_created_by_two_processes(sources, tmp_path):
    """Two processes open one config whose archive is missing at once:
    both read the same whole archive, the one left on disk, and no
    private directory is left behind."""
    config = copy.deepcopy(sources[1])
    config["output"]["compression"] = "none"
    cfg = _write_config(tmp_path, config)
    code = _RACE.format(repo=str(ROOT), root=str(tmp_path), cfg=str(cfg))
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    (tmp_path / "go").touch()
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        outs.append(out.strip().splitlines()[-1])
    (tmp_path / "go").unlink()
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        CONFIG, "danra.datastore.zarr"]
    ds = MDPDatastore(cfg, n_boundary_points=1)
    state = ds.get_dataarray("state", "train").values
    want = repr((ds.get_vars_names("state"),
                 float(np.asarray(state, np.float64).sum()), state.shape))
    assert outs == [want] * 2


def test_mdp_datastore_creates_missing_archive(sources, tmp_path):
    """MDPDatastore on a config without its archive creates it, and the
    WeatherDataset items over it equal the JAX package's over the archive
    the JAX package created."""
    cfg_p = _write_config(tmp_path / "port", sources[1])
    cfg_j = _write_config(tmp_path / "jax", sources[1])
    t = MDPDatastore(cfg_p, n_boundary_points=1)
    j = JMDPDatastore(cfg_j, n_boundary_points=1)
    assert cfg_p.with_suffix(".zarr").is_dir()
    _archives_equal(cfg_p.with_suffix(".zarr"), cfg_j.with_suffix(".zarr"),
                    "lz4")
    for split in ("train", "val", "test"):
        dt = WeatherDataset(t, split=split, ar_steps=1)
        dj = JWeatherDataset(j, split=split, ar_steps=1)
        assert len(dt) == len(dj) > 0
        for idx in range(len(dt)):
            for a, b in zip(dt[idx], dj[idx]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def _stats(config_path):
    return {name: torch.load(config_path.parent / "static" / name,
                             weights_only=True) for name in STATS_FILES}


def _bit_equal(a, b):
    for name in STATS_FILES:
        assert a[name].dtype == b[name].dtype == torch.float32, name
        assert torch.equal(a[name], b[name]), name


@pytest.mark.filterwarnings("ignore:only using first ensemble member")
@pytest.mark.parametrize("n_workers", [1, 4])
def test_stats_match_jax(n_workers, tmp_path):
    """Serial and with workers, the port's five files equal the JAX
    tool's bit for bit; the worker count changes no bit."""
    cfg_p = make_meps_dataset(tmp_path / "port", seed=3)
    cfg_j = make_meps_dataset(tmp_path / "jax", seed=3)
    stats_main(cfg_p, step_length=2, n_workers=n_workers)
    j_stats_main(cfg_j, step_length=2, n_workers=n_workers)
    got = _stats(cfg_p)
    _bit_equal(got, _stats(cfg_j))
    if n_workers > 1:
        stats_main(cfg_p, step_length=2)
        _bit_equal(got, _stats(cfg_p))


@pytest.mark.filterwarnings("ignore:only using first ensemble member")
@pytest.mark.parametrize("order", [(1, 0, 2), (2, 1, 0)])
def test_stats_sharded_match_jax(order, tmp_path):
    """Three shards finishing in any order: the last one merges; the
    merged files equal the JAX tool's sharded ones bit for bit and the
    serial pass within rtol 2e-5 / atol 2e-6; before the last shard,
    no statistics file exists."""
    cfg_p = make_meps_dataset(tmp_path / "port", seed=5)
    cfg_j = make_meps_dataset(tmp_path / "jax", seed=5)
    cfg_s = make_meps_dataset(tmp_path / "serial", seed=5)
    for i, shard in enumerate(order):
        stats_main(cfg_p, step_length=2, num_shards=3, shard_id=shard,
                   job_tag="t1")
        j_stats_main(cfg_j, step_length=2, num_shards=3, shard_id=shard,
                     job_tag="t1")
        merged = (cfg_p.parent / "static" / STATS_FILES[0]).exists()
        assert merged == (i == len(order) - 1)
    stats_main(cfg_s, step_length=2)
    got, serial = _stats(cfg_p), _stats(cfg_s)
    _bit_equal(got, _stats(cfg_j))
    for name in STATS_FILES:
        np.testing.assert_allclose(got[name].numpy(), serial[name].numpy(),
                                   rtol=2e-5, atol=2e-6, err_msg=name)
    parts = sorted(p.name for p in (cfg_p.parent / "static").glob(
        "stats_part_*"))
    assert parts == [f"stats_part_{i}of3.t1.npz" for i in range(3)]


@pytest.mark.filterwarnings("ignore:only using first ensemble member")
def test_stats_pass_two_reads_pass_one(tmp_path):
    """Pass 2 standardizes with the files pass 1 has just written, through
    the datastore opened before they existed: stale files from another
    dataset are replaced and do not reach the diff statistics."""
    cfg = make_meps_dataset(tmp_path / "a", seed=3)
    other = make_meps_dataset(tmp_path / "b", seed=4)
    stats_main(other, step_length=2)
    want = _stats(other)
    for name in STATS_FILES:
        shutil.copy(other.parent / "static" / name, cfg.parent / "static")
    stats_main(cfg, step_length=2)
    fresh = make_meps_dataset(tmp_path / "c", seed=3)
    stats_main(fresh, step_length=2)
    _bit_equal(_stats(cfg), _stats(fresh))
    assert not torch.equal(_stats(cfg)["diff_std.pt"], want["diff_std.pt"])


def test_entry_points_run(sources, tmp_path):
    """`python -m` on both tools: an archive under none, then the MEPS
    statistics."""
    cfg = _write_config(tmp_path / "mdp", sources[1])
    meps = make_meps_dataset(tmp_path / "meps", seed=1)
    for argv, says in (
            (["neural_lam_tpu_torch.datastore.create_dataset", str(cfg),
              "--compression", "none"], "wrote"),
            (["neural_lam_tpu_torch.datastore.compute_standardization_stats",
              "--datastore_config_path", str(meps), "--step_length", "2",
              "--n_workers", "2"], "Saved diff_mean/std.pt")):
        run = subprocess.run([sys.executable, "-m", *argv], cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
        assert run.returncode == 0, run.stderr
        assert says in run.stdout
    g = tzr.ZarrGroup(cfg.with_suffix(".zarr"))
    assert all(g[n].compressor is None for n in g.arrays)
    assert all((meps.parent / "static" / n).exists() for n in STATS_FILES)
