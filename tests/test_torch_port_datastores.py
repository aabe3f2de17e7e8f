"""The port's datastores and zarr I/O against the JAX package's.

* Zarr archives cross-read: the port reads what the JAX writer wrote and
  the JAX reader what the port's writer wrote (blosc, zlib and raw chunks,
  partial chunks, vlen-utf8 strings, CF times, consolidated metadata),
  bit for bit.
* On the MDP and MEPS fixtures, every `BaseDatastore` method of the port's
  `MDPDatastore` and `NpyFilesDatastoreMEPS` equals the JAX one exactly,
  and so do the `WeatherDataset` items over them.
* The registry, a missing MDP archive whose inputs do not exist, and the
  graph built by two processes at once.
"""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import yaml

from neural_lam_tpu.dataset import WeatherDataset as JWeatherDataset
from neural_lam_tpu.datastore import zarr_reader as jzr
from neural_lam_tpu.datastore.compute_standardization_stats import (
    main as meps_stats_main,
)
from neural_lam_tpu.datastore.mdp import MDPDatastore as JMDPDatastore
from neural_lam_tpu.datastore.npyfilesmeps import (
    NpyFilesDatastoreMEPS as JNpyFilesDatastoreMEPS,
)
from neural_lam_tpu_torch.config import load_config_and_datastore
from neural_lam_tpu_torch.dataset import WeatherDataset
from neural_lam_tpu_torch.datastore import (
    DATASTORES,
    MDPDatastore,
    NpyFilesDatastoreMEPS,
    init_datastore,
)
from neural_lam_tpu_torch.datastore import zarr_reader as tzr

from .mdp_fixture import make_mdp_dataset
from .meps_fixture import make_meps_dataset

ROOT = Path(__file__).resolve().parent.parent
BLOSC = {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1}
ZLIB = {"id": "zlib", "level": 5}


def _arrays():
    """(name, array, chunks, dims) covering the reader's cases."""
    rng = np.random.default_rng(0)
    times = np.datetime64("2021-03-01T00", "ns") + np.arange(11) * \
        np.timedelta64(3, "h")
    return [
        ("state", rng.standard_normal((11, 7, 3)).astype(np.float32),
         [4, 7, 3], ["time", "grid_index", "state_feature"]),
        ("coords", rng.standard_normal(37), [10], ["grid_index"]),
        ("counts", rng.integers(-2**40, 2**40, (5, 6)), [2, 4],
         ["a", "b"]),
        ("time", times, [4], ["time"]),
        ("names", np.array([f"var_{i}_ü" for i in range(5)], dtype=object),
         [5], ["state_feature"]),
    ]


@pytest.mark.parametrize("compressor", ["blosc", "zlib", "raw"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_zarr_cross_read(writer, compressor, tmp_path):
    """An archive written by one package reads back bit-equal through the
    other's reader: every array whole, sliced along its leading axis and
    through LazyZarrLeading, its dims and attrs, and the group's
    consolidated metadata."""
    comp = {"blosc": BLOSC, "zlib": ZLIB, "raw": None}[compressor]
    write, read = (jzr, tzr) if writer == "jax" else (tzr, jzr)
    group = tmp_path / "g.zarr"
    for name, arr, chunks, dims in _arrays():
        write.write_zarr_array(group, name, arr, dims=dims, chunks=chunks,
                               attrs={"long_name": name},
                               compressor=None if arr.dtype == object
                               else comp)
    write.consolidate_metadata(group)
    assert json.loads((group / ".zmetadata").read_text())[
        "zarr_consolidated_format"] == 1
    g = read.ZarrGroup(group)
    assert sorted(g.arrays) == sorted(a[0] for a in _arrays())
    for name, arr, _, dims in _arrays():
        za = g[name]
        assert za.dims == tuple(dims)
        assert za.attrs["long_name"] == name
        got = za.read_full()
        if arr.dtype.kind == "M":
            assert za.attrs["units"] == "nanoseconds since 1970-01-01"
            got = read.decode_cf_time(got, za.attrs["units"])
        if arr.dtype == object:
            assert list(got) == list(arr)
            continue
        assert got.dtype == arr.dtype and got.shape == arr.shape
        np.testing.assert_array_equal(got, arr)
        np.testing.assert_array_equal(za[2:9], za.read_full()[2:9])
        np.testing.assert_array_equal(za[-1], za.read_full()[-1])
        lazy = read.LazyZarrLeading(za, 1, arr.shape[0] - 1)
        assert lazy.shape == (arr.shape[0] - 2,) + arr.shape[1:]
        np.testing.assert_array_equal(lazy[1:3], za.read_full()[2:4])
    # the same bytes on disk from both writers
    other = tmp_path / "h.zarr"
    for name, arr, chunks, dims in _arrays():
        read.write_zarr_array(other, name, arr, dims=dims, chunks=chunks,
                              attrs={"long_name": name},
                              compressor=None if arr.dtype == object
                              else comp)
    read.consolidate_metadata(other)
    for f in sorted(p.relative_to(group) for p in group.rglob("*")
                    if p.is_file()):
        assert (group / f).read_bytes() == (other / f).read_bytes(), f


def test_decode_cf_time_matches():
    vals = np.array([0, 5, 17], np.int64)
    for units in ("hours since 2020-01-01", "minutes since 2020-01-01 06:00",
                  "seconds since 1970-01-01T00:00:00Z",
                  "days since 2000-03-01"):
        np.testing.assert_array_equal(tzr.decode_cf_time(vals, units),
                                      jzr.decode_cf_time(vals, units))


def _equal(a, b, what):
    """Bit-equal numpy values, lists or dicts of them."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            _equal(a[k], b[k], f"{what}[{k}]")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                       b.dtype)
    np.testing.assert_array_equal(a, b, what)


def _field_equal(fa, fb, what):
    if fa is None or fb is None:
        assert fa is None and fb is None, what
        return
    assert fa.dims == fb.dims, what
    _equal(fa.values, fb.values, what)
    _equal(fa.coords, fb.coords, f"{what} coords")


def _datastore_equal(t, j):
    """Every BaseDatastore method of the port's datastore equals the JAX
    one's exactly."""
    for cat in ("state", "forcing", "static"):
        assert t.get_vars_names(cat) == j.get_vars_names(cat)
        assert t.get_vars_units(cat) == j.get_vars_units(cat)
        assert t.get_vars_long_names(cat) == j.get_vars_long_names(cat)
        assert t.get_num_data_vars(cat) == j.get_num_data_vars(cat)
        assert t.expected_dim_order(cat) == j.expected_dim_order(cat)
        for split in ("train", "val", "test") if cat != "static" else (
                None, "train"):
            _field_equal(t.get_dataarray(cat, split),
                         j.get_dataarray(cat, split), f"{cat}/{split}")
        try:
            want = j.get_standardization_dataarray(cat)
        except KeyError:
            with pytest.raises(KeyError):
                t.get_standardization_dataarray(cat)
        else:
            _equal(t.get_standardization_dataarray(cat), want, f"{cat} stats")
    _field_equal(t.boundary_mask, j.boundary_mask, "boundary_mask")
    for stacked in (True, False):
        _equal(t.get_xy("state", stacked=stacked),
               j.get_xy("state", stacked=stacked), f"xy {stacked}")
    assert t.get_xy_extent("state") == j.get_xy_extent("state")
    assert (t.grid_shape_state.x, t.grid_shape_state.y) == (
        j.grid_shape_state.x, j.grid_shape_state.y)
    assert t.num_grid_points == j.num_grid_points
    assert t.step_length == j.step_length
    assert t.coords_projection == j.coords_projection
    assert (t.is_forecast, t.is_ensemble) == (j.is_forecast, j.is_ensemble)
    assert t.state_feature_weights_values == j.state_feature_weights_values
    assert t.root_path == j.root_path


@pytest.fixture(scope="module")
def mdp_path(tmp_path_factory):
    return make_mdp_dataset(tmp_path_factory.mktemp("mdp"))


@pytest.fixture(scope="module")
def meps_path(tmp_path_factory):
    """The MEPS fixture with its statistics files, written by the JAX
    package's statistics tool."""
    config_path = make_meps_dataset(tmp_path_factory.mktemp("meps"))
    meps_stats_main(config_path, step_length=2)
    return config_path


def _pair(kind, mdp_path, meps_path):
    if kind == "mdp":
        return (MDPDatastore(mdp_path, n_boundary_points=2),
                JMDPDatastore(mdp_path, n_boundary_points=2))
    return (NpyFilesDatastoreMEPS(meps_path),
            JNpyFilesDatastoreMEPS(meps_path))


@pytest.mark.parametrize("kind", ["mdp", "npyfilesmeps"])
def test_datastore_matches_jax(kind, mdp_path, meps_path):
    t, j = _pair(kind, mdp_path, meps_path)
    _datastore_equal(t, j)


@pytest.mark.filterwarnings("ignore:only using first ensemble member")
@pytest.mark.parametrize("kind", ["mdp", "npyfilesmeps"])
def test_weather_dataset_items_match_jax(kind, mdp_path, meps_path):
    """Items of every split (the first, the last through index -1, and
    one inside), with and without standardization and with a wider
    forcing window, equal the JAX package's array for array."""
    t, j = _pair(kind, mdp_path, meps_path)
    for split in ("train", "val", "test"):
        for kw in (dict(ar_steps=2), dict(ar_steps=1, standardize=False),
                   dict(ar_steps=1, num_past_forcing_steps=2,
                        num_future_forcing_steps=2)):
            dt = WeatherDataset(t, split=split, **kw)
            dj = JWeatherDataset(j, split=split, **kw)
            assert len(dt) == len(dj) > 0
            for idx in sorted({0, len(dt) // 2, -1}):
                for a, b in zip(dt[idx], dj[idx]):
                    _equal(a, b, f"{kind} {split} {kw} item {idx}")


def test_registry_and_config(mdp_path, tmp_path):
    """The registry holds the four datastores (the global dummy one
    builds from its defaults without a config file), and a neural-lam
    config selecting mdp loads it with the datastore path resolved against
    the config's directory."""
    assert sorted(DATASTORES) == ["dummydata", "dummydata_global", "mdp",
                                  "npyfilesmeps"]
    glob = init_datastore("dummydata_global", tmp_path / "x.yaml")
    assert glob.is_global and glob.num_grid_points == 36 * 18
    with pytest.raises(NotImplementedError):
        init_datastore("nonsense", tmp_path / "x.yaml")
    cfg = mdp_path.parent / "config.yaml"
    cfg.write_text(yaml.safe_dump({"datastore": {
        "kind": "mdp", "config_path": mdp_path.name}}))
    config, ds = load_config_and_datastore(cfg)
    assert isinstance(ds, MDPDatastore)
    assert config.datastore.kind == "mdp"
    assert ds.root_path == mdp_path.parent


def test_missing_mdp_zarr_raises(mdp_path, tmp_path):
    """A config without its archive whose inputs do not exist raises
    FileNotFoundError in both packages; the port's names its own
    `create_dataset` and leaves nothing beside the config."""
    config = yaml.safe_load(mdp_path.read_text())
    config["output"] = {"variables": {
        "forcing": ["time", "grid_index", "forcing_feature"]}}
    config["inputs"]["danra_surface"].update(
        path=str(tmp_path / "missing.zarr"), variables=["swavr0m"],
        target_output_variable="forcing")
    for name, cls in (("port", MDPDatastore), ("jax", JMDPDatastore)):
        cfg = tmp_path / name / "other.datastore.yaml"
        cfg.parent.mkdir()
        cfg.write_text(yaml.safe_dump(config))
        with pytest.raises(FileNotFoundError, match="missing.zarr") as e:
            cls(cfg)
        assert sorted(p.name for p in cfg.parent.iterdir()) == [cfg.name]
        if name == "port":
            assert ("python -m neural_lam_tpu_torch.datastore.create_dataset"
                    in str(e.value))


_FINGERPRINT = textwrap.dedent("""
    def fingerprint(g):
        \"\"\"Level sizes, real edges and a feature checksum of every edge
        set of a loaded graph.\"\"\"
        sets = (g.g2m, g.m2g) + g.m2m + g.up + g.down
        return repr((g.level_sizes, [int(e.mask.sum()) for e in sets],
                     [float(e.features.double().sum()) for e in sets]))
""")
exec(_FINGERPRINT)

_RACE = textwrap.dedent("""
    import sys, time
    from pathlib import Path
    sys.path.insert(0, {repo!r})
    from neural_lam_tpu_torch.datastore.dummy import DummyDatastore
    from neural_lam_tpu_torch.graph.storage import load_or_build_graph
    ds = DummyDatastore(grid_shape=(40, 36), root={root!r})
    go = Path({root!r}) / "go"
    while not go.exists():
        time.sleep(0.005)
    g = load_or_build_graph(ds, {name!r}, "cpu")
    print(fingerprint(g))
""")


@pytest.mark.parametrize("name", ["multiscale", "hierarchical"])
def test_graph_built_by_two_processes(name, tmp_path):
    """Two processes build the same missing graph at once: each loads one
    whole bundle, the one on disk, and no temporary directory is left."""
    from neural_lam_tpu_torch.datastore.dummy import DummyDatastore
    from neural_lam_tpu_torch.graph.storage import load_or_build_graph

    code = _FINGERPRINT + _RACE.format(repo=str(ROOT), root=str(tmp_path),
                                       name=name)
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    (tmp_path / "go").touch()
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        outs.append(out.strip().splitlines()[-1])
    ds = DummyDatastore(grid_shape=(40, 36), root=tmp_path)
    g = load_or_build_graph(ds, name, "cpu")
    assert outs == [fingerprint(g)] * 2
    assert sorted(p.name for p in (tmp_path / "graph").iterdir()) == [name]
    assert sorted(p.name for p in (tmp_path / "graph" / name).iterdir()) == [
        "graph.npz", "meta.json"]


@pytest.mark.parametrize("race", ["alone", "lost"])
def test_graph_build_goes_through_a_private_directory(race, tmp_path,
                                                      monkeypatch):
    """The builder writes a directory of its own, never the final one,
    and renames it into place; when another process has renamed its
    build first, the loser discards its own and loads the winner's."""
    from neural_lam_tpu_torch.datastore.dummy import DummyDatastore
    from neural_lam_tpu_torch.graph import build
    from neural_lam_tpu_torch.graph.storage import load_or_build_graph

    ds = DummyDatastore(grid_shape=(20, 18), root=tmp_path)
    final = tmp_path / "graph" / "multiscale"
    real = build.create_graph
    paths = []

    def create_graph(path, *args, **kwargs):
        paths.append(Path(path))
        assert Path(path) != final and not final.exists()
        bundle = real(path, *args, **kwargs)
        assert not final.exists()
        if race == "lost":  # a concurrent builder renames its copy first
            real(str(final), *args, **kwargs)
        return bundle

    monkeypatch.setattr(build, "create_graph", create_graph)
    g = load_or_build_graph(ds, "multiscale", "cpu")
    assert len(paths) == 1 and paths[0].parent == final.parent
    assert sorted(p.name for p in final.parent.iterdir()) == ["multiscale"]
    assert sorted(p.name for p in final.iterdir()) == ["graph.npz",
                                                       "meta.json"]
    monkeypatch.setattr(build, "create_graph", real)
    assert fingerprint(g) == fingerprint(
        load_or_build_graph(ds, "multiscale", "cpu"))
