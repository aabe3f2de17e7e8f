"""The port's graph figures (`plot_graph.py`, `graph/html_viz.py`, the
graph CLI's `--plot`) against the JAX package's.

Each package builds its own graph of the same DummyDatastore and loads it
in its dense layout (what both `plot_graph.main`s draw); the scenes must
be bit-equal (names, colours, sizes, widths, arrays and dtypes), the
interactive pages byte-equal, and the figures' 3D edge segments equal.
"""

import sys

import numpy as np
import pytest
import yaml

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from mpl_toolkits.mplot3d.art3d import Line3DCollection  # noqa: E402

from neural_lam_tpu import plot_graph as jplot  # noqa: E402
from neural_lam_tpu.datastore.dummy import DummyDatastore as JDummy  # noqa: E402
from neural_lam_tpu.graph.build import create_graph as j_create_graph  # noqa: E402
from neural_lam_tpu.graph.html_viz import (  # noqa: E402
    save_interactive_html as j_save_html,
)
from neural_lam_tpu.graph.storage import load_graph as j_load_graph  # noqa: E402
from neural_lam_tpu_torch import plot_graph as tplot  # noqa: E402
from neural_lam_tpu_torch.datastore.dummy import DummyDatastore  # noqa: E402
from neural_lam_tpu_torch.graph import build as tbuild  # noqa: E402
from neural_lam_tpu_torch.graph.build import create_graph  # noqa: E402
from neural_lam_tpu_torch.graph.html_viz import save_interactive_html  # noqa: E402

GRAPHS = {"multiscale": (16, False), "hierarchical": (27, True)}


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def scenes(request, tmp_path_factory):
    """(JAX graph, port graph, grid xy) of one graph kind."""
    nx, hier = GRAPHS[request.param]
    jds = JDummy(grid_shape=(nx, nx), n_timesteps=10)
    tds = DummyDatastore(grid_shape=(nx, nx), n_timesteps=10)
    jdir = str(tmp_path_factory.mktemp("jg"))
    tdir = str(tmp_path_factory.mktemp("tg"))
    j_create_graph(jdir, jds.get_xy("state", stacked=False),
                   n_max_levels=None, hierarchical=hier)
    create_graph(tdir, tds.get_xy("state", stacked=False),
                 n_max_levels=None, hierarchical=hier)
    grid_xy = tds.get_xy("state")
    np.testing.assert_array_equal(grid_xy, jds.get_xy("state"))
    return j_load_graph(jdir)[1], tplot.load_plot_graph(tdir), grid_xy


def _assert_sets_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k])
            else:
                assert g[k] == w[k], (k, g[k], w[k])


@pytest.mark.parametrize("mesh_only", [False, True])
def test_graph_scene_matches_jax(scenes, mesh_only):
    """Every point and edge set bit-equal to the JAX package's."""
    jgraph, tgraph, grid_xy = scenes
    j_pts, j_edges = jplot.graph_scene(jgraph, grid_xy, mesh_only)
    t_pts, t_edges = tplot.graph_scene(tgraph, grid_xy, mesh_only)
    _assert_sets_equal(t_pts, j_pts)
    _assert_sets_equal(t_edges, j_edges)


def test_html_page_matches_jax(scenes, tmp_path):
    """The interactive page byte for byte the JAX package's."""
    jgraph, tgraph, grid_xy = scenes
    j_save_html(*jplot.graph_scene(jgraph, grid_xy), tmp_path / "j.html",
                title="g")
    save_interactive_html(*tplot.graph_scene(tgraph, grid_xy),
                          tmp_path / "t.html", title="g")
    assert ((tmp_path / "t.html").read_bytes()
            == (tmp_path / "j.html").read_bytes())


def _segments(fig):
    return [(c.get_label(), np.asarray(c._segments3d))
            for c in fig.axes[0].collections
            if isinstance(c, Line3DCollection)]


def test_figure_segments_match_jax(scenes):
    """make_graph_figure's Line3DCollections: labels and 3D segments equal
    to the JAX figure's."""
    jgraph, tgraph, grid_xy = scenes
    jfig = jplot.make_graph_figure(jgraph, grid_xy)
    tfig = tplot.make_graph_figure(tgraph, grid_xy)
    try:
        got, want = _segments(tfig), _segments(jfig)
        assert [g[0] for g in got] == [w[0] for w in want]
        for (_, g), (_, w) in zip(got, want):
            np.testing.assert_array_equal(g, w)
    finally:
        plt.close(jfig)
        plt.close(tfig)


def test_figure_without_matplotlib_names_it(scenes, monkeypatch):
    """Where matplotlib is missing, the PNG path raises naming it, and the
    scene and the page still work."""
    _, tgraph, grid_xy = scenes
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        tplot.make_graph_figure(tgraph, grid_xy)
    assert tplot.graph_scene(tgraph, grid_xy)[1]


def test_graph_cli_plot_and_plot_graph_cli(tmp_path, monkeypatch):
    """The graph CLI's --plot writes graph.png beside the graph;
    `plot_graph.main` writes the PNG and, with --html, the page."""
    monkeypatch.chdir(tmp_path)
    with open("dummy.yaml", "w") as f:
        yaml.safe_dump({"n_points_1d": 10, "n_timesteps": 10,
                        "root": "dsroot"}, f)
    with open("config.yaml", "w") as f:
        yaml.safe_dump({"datastore": {"kind": "dummydata",
                                      "config_path": "dummy.yaml"}}, f)
    tbuild.cli(["--config_path", "config.yaml", "--name", "g1",
                "--levels", "1", "--plot"])
    png = tmp_path / "dsroot" / "graph" / "g1" / "graph.png"
    assert png.read_bytes()[:4] == b"\x89PNG"
    tplot.main(["--config_path", "config.yaml", "--graph", "g1",
                "--save", "p.png", "--html", "p.html"])
    assert (tmp_path / "p.png").stat().st_size > 0
    assert "<canvas" in (tmp_path / "p.html").read_text()
    plt.close("all")
