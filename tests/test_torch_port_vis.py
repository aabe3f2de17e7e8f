"""The port's `projections`, `vis` and `datastore/plot_example` against the
JAX package's, on the CPU.

* Every projection `from_descriptor` builds (each alias), forward
  transforms and graticule lines within 1e-12.
* The three figures of `vis` (error map, prediction, spatial error) on
  the MDP fixture and on a dummydata datastore, drawn from the same
  arrays by both packages: the same image arrays, extents and colour
  limits, line data (the graticule), tick labels and titles.
* `plot_example_from_datastore` and the `plot_example` CLI drawn alike.
* The trainer imports, and `Trainer.test` runs without plots, where
  matplotlib cannot be imported.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

from neural_lam_tpu import projections as j_projections
from neural_lam_tpu import vis as j_vis
from neural_lam_tpu.datastore import plot_example as j_plot_example
from neural_lam_tpu.datastore.dummy import DummyDatastore as JDummyDatastore
from neural_lam_tpu.datastore.mdp import MDPDatastore as JMDPDatastore
from neural_lam_tpu_torch import projections, vis
from neural_lam_tpu_torch.datastore import plot_example
from neural_lam_tpu_torch.datastore.dummy import DummyDatastore
from neural_lam_tpu_torch.datastore.mdp import MDPDatastore

from .mdp_fixture import make_mdp_dataset

ROOT = Path(__file__).resolve().parent.parent

DESCRIPTORS = [
    {"name": "LambertConformal", "central_longitude": 15.0,
     "central_latitude": 63.3, "standard_parallels": [63.3, 63.3]},
    {"name": "lcc", "lon_0": -96.0, "lat_0": 23.0, "lat_1": 33.0,
     "lat_2": 45.0},
    {"name": "LambertAzimuthalEqualArea", "central_longitude": 10.0,
     "central_latitude": 56.0},
    {"name": "laea", "lat_0": 56.0, "lon_0": 10.0,
     "globe": {"semimajor_axis": 6_378_137.0}},
    {"name": "Stereographic", "central_longitude": 0.0,
     "central_latitude": 90.0},
    {"name": "stere", "lon_0": -45.0, "lat_0": -90.0},
    {"name": "PlateCarree"}, {"name": "latlon"},
    {"name": "equirectangular", "central_longitude": 20.0},
    {"name": "Mercator", "central_longitude": 5.0}, {"name": "merc"},
]


@pytest.mark.parametrize("info", DESCRIPTORS,
                         ids=[d["name"] + str(i)
                              for i, d in enumerate(DESCRIPTORS)])
def test_projections_match_jax(info):
    got, want = (m.from_descriptor(dict(info))
                 for m in (projections, j_projections))
    assert type(got).__name__ == type(want).__name__
    lon, lat = np.meshgrid(np.linspace(-30, 40, 15), np.linspace(30, 75, 13))
    for a, b in zip(got.forward(lon, lat), want.forward(lon, lat)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    x, y = want.forward(lon, lat)
    for a, b in zip(got.inverse(x, y), want.inverse(x, y)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    extent = [float(x.min()), float(x.max()), float(y.min()), float(y.max())]
    g_mer, g_par, g_ticks = projections.graticule(got, extent)
    j_mer, j_par, j_ticks = j_projections.graticule(want, extent)
    assert g_ticks == j_ticks
    assert len(g_mer) == len(j_mer) > 0 and len(g_par) == len(j_par) > 0
    for (gv, gx, gy), (jv, jx, jy) in zip(g_mer + g_par, j_mer + j_par):
        assert gv == jv
        np.testing.assert_allclose(gx, jx, rtol=0, atol=1e-12)
        np.testing.assert_allclose(gy, jy, rtol=0, atol=1e-12)


def test_unknown_descriptors_give_none():
    for info in (None, {}, {"name": "none"}, {"name": "robinson"}):
        assert projections.from_descriptor(info) is None
        assert j_projections.from_descriptor(info) is None


def _figure(fig):
    """What a figure shows, as plain data: per axes its title, images
    (array, mask, extent, colour limits, alpha), lines and tick labels,
    and the figure's suptitle."""
    axes = []
    for ax in fig.axes:
        axes.append({
            "title": ax.get_title(),
            "images": [(np.ma.getdata(im.get_array()).copy(),
                        np.ma.getmaskarray(im.get_array()).copy(),
                        tuple(im.get_extent()), im.get_clim(),
                        None if im.get_alpha() is None
                        else np.asarray(im.get_alpha()).copy())
                       for im in ax.images],
            "lines": [line.get_xydata().copy() for line in ax.lines],
            "xticks": [t.get_text() for t in ax.get_xticklabels()],
            "yticks": [t.get_text() for t in ax.get_yticklabels()],
            "xlim": ax.get_xlim(), "ylim": ax.get_ylim(),
        })
    suptitle = fig._suptitle.get_text() if fig._suptitle else None
    return axes, suptitle


def _assert_same(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    else:
        assert a == b


def _datastores(kind, root):
    if kind == "mdp":
        cfg = make_mdp_dataset(root)
        return (MDPDatastore(cfg, n_boundary_points=2),
                JMDPDatastore(cfg, n_boundary_points=2))
    (root / "dummy.yaml").write_text(yaml.safe_dump(
        dict(n_points_1d=12, n_timesteps=20)))
    return (DummyDatastore(root / "dummy.yaml"),
            JDummyDatastore(root / "dummy.yaml"))


@pytest.mark.parametrize("kind", ["mdp", "dummy"])
def test_vis_figures_match_jax(kind, tmp_path):
    ds, jds = _datastores(kind, tmp_path)
    rng = np.random.default_rng(0)
    n, d = ds.num_grid_points, ds.get_num_data_vars("state")
    errors = rng.random((3, d)).astype(np.float32)
    pred, target, err = (rng.standard_normal(n).astype(np.float32)
                         for _ in range(3))
    cases = [
        (lambda m, s: m.plot_error_map(errors, s, title="errors")),
        (lambda m, s: m.plot_error_map(errors, s, step_length=6)),
        (lambda m, s: m.plot_prediction(pred, target, s, title="pred")),
        (lambda m, s: m.plot_prediction(pred, target, s, vrange=(-1, 2))),
        (lambda m, s: m.plot_spatial_error(err, s, title="spatial")),
        (lambda m, s: m.plot_spatial_error(err, s, vrange=(0, 1))),
    ]
    for draw in cases:
        got, want = draw(vis, ds), draw(j_vis, jds)
        _assert_same(_figure(got), _figure(want))
        assert any(ax.images for ax in got.axes)
        vis.plt.close("all")


@pytest.mark.filterwarnings("ignore:only using first ensemble member")
@pytest.mark.parametrize("kind", ["mdp", "dummy"])
def test_plot_example_matches_jax(kind, tmp_path):
    ds, jds = _datastores(kind, tmp_path)
    for category, sel in (("state", {"time": 1}), ("forcing", {"time": 0}),
                          ("static", None)):
        kw = dict(col_dim="{category}_feature", index_selection=sel)
        got = plot_example.plot_example_from_datastore(category, ds, **kw)
        want = j_plot_example.plot_example_from_datastore(category, jds,
                                                          **kw)
        _assert_same(_figure(got), _figure(want))
        plot_example.plt.close("all")

    if kind == "mdp":
        cfg = tmp_path / "config.yaml"
        cfg.write_text(yaml.safe_dump({"datastore": {
            "kind": "mdp", "config_path": "danra.datastore.yaml"}}))
        for main, out in ((plot_example.main, "port.png"),
                          (j_plot_example.main, "jax.png")):
            main(["--config_path", str(cfg), "--category", "state",
                  "--time_idx", "2", "--disable_standardize",
                  "--save", str(tmp_path / out)])
        from matplotlib.image import imread

        np.testing.assert_array_equal(imread(tmp_path / "port.png"),
                                      imread(tmp_path / "jax.png"))


def test_train_runs_test_without_matplotlib(tmp_path):
    """With matplotlib unimportable, the trainer imports and evaluates
    the test split without plots; drawing raises."""
    code = f"""
import sys
sys.modules["matplotlib"] = None
from pathlib import Path
from neural_lam_tpu_torch import train
from neural_lam_tpu_torch.dataset import WeatherDataModule
from neural_lam_tpu_torch.entry import build_model
model, ds = build_model(nx=9, ny=9, hidden_dim=8, processor_layers=1,
                        n_timesteps=40, device="cpu")
dm = WeatherDataModule(ds, ar_steps_eval=2, batch_size=2)
trainer = train.Trainer(model, train.TrainFlags(),
                        run_dir=Path({str(tmp_path)!r}) / "run")
out = trainer.test(dm, make_plots=False)
assert sorted(p.name for p in trainer.run_dir.iterdir()) == [
    "mean_spatial_loss.npy", "metrics.jsonl", "spatial_loss_t1.npy",
    "spatial_loss_t2.npy", "test_mae.csv", "test_rmse.csv"], list(
    trainer.run_dir.iterdir())
try:
    trainer.test(dm, make_plots=True)
except ImportError:
    print("ok", out["test_mean_loss"])
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1].startswith("ok ")
