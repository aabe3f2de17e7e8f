"""The port's global configuration against the JAX package's: the global
lat-lon dummy datastore, the icosahedral mesh graphs, the graph CLI, the
graph a CLI builds on its own, and the g2m fold at the poles.

Everything here is numpy/scipy on both sides and held bit for bit, but
for the fold's fp32 sums (1e-6 relative: the two sides' sums of the same
rows in the same order, on the CPU they agree exactly here).

* `DummyGlobalDatastore`: coordinates, data, boundary mask (all zeros),
  statistics and projection.
* `create_global_graph` at 2 refinements on a 24x12 grid, flat (the
  multiscale union, 162 nodes) and hierarchical (3 levels): every array
  of the bundle, and the dense EdgeSet layouts built from it.
* `python -m ...graph.build --mesh global_icosahedral`: the same
  graph.npz arrays and meta.json as the JAX CLI's.
* `load_or_build_graph` on a global datastore builds what the JAX
  package's models build there (two levels for a "hierarchical" name).
* A 96x16 grid at 1 refinement crowds 192 grid points into the polar
  vertices' g2m radius: 24 virtual rows a receiver, past the JAX flat
  route's gather-fold limit of 16, so a bf16 fold sums in bf16 as JAX's
  `segment_sum` does (bit for bit against JAX's `_fold_virt_flat`), and
  an fp32 fold equals JAX's.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from neural_lam_tpu.datastore.dummy_global import (
    DummyGlobalDatastore as JDummyGlobalDatastore,
)
from neural_lam_tpu.graph import build as j_build
from neural_lam_tpu.graph.global_mesh import (
    create_global_graph as j_create_global_graph,
)
from neural_lam_tpu.graph.storage import graph_from_bundle as j_graph_from_bundle
from neural_lam_tpu.graph.storage import load_graph_bundle as j_load_bundle
from neural_lam_tpu.ops import message_passing as jmp
from neural_lam_tpu_torch.config import load_config_and_datastore
from neural_lam_tpu_torch.datastore import DATASTORES, init_datastore
from neural_lam_tpu_torch.datastore.dummy_global import DummyGlobalDatastore
from neural_lam_tpu_torch.graph import build
from neural_lam_tpu_torch.graph.global_mesh import create_global_graph
from neural_lam_tpu_torch.graph.storage import (
    graph_from_bundle,
    load_graph_bundle,
    load_or_build_graph,
)
from neural_lam_tpu_torch.ops import message_passing as tmp

FIELDS = ("m2m_edge_index", "m2m_features", "mesh_static_features",
          "mesh_up_edge_index", "mesh_up_features", "mesh_down_edge_index",
          "mesh_down_features", "g2m_edge_index", "g2m_features",
          "m2g_edge_index", "m2g_features")


def _equal_bundles(got, want):
    assert got.hierarchical == want.hierarchical
    for field in FIELDS:
        a, b = getattr(got, field), getattr(want, field)
        if isinstance(b, list):
            assert len(a) == len(b), field
            for x, y in zip(a, b):
                assert x.dtype == y.dtype, field
                np.testing.assert_array_equal(x, y, field)
        else:
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, field)


def test_dummy_global_datastore_matches_jax(tmp_path):
    """Coordinates ([lon, lat] degrees, lon-major), data of every split,
    the all-zeros boundary mask, statistics and the projection are the
    JAX datastore's, from the keywords and from a YAML config; the
    registry builds it by its short name."""
    cfg = tmp_path / "g.yaml"
    cfg.write_text(yaml.safe_dump(dict(n_lon=8, n_lat=6, n_timesteps=12,
                                       seed=3, root="dsroot")))
    pairs = [(DummyGlobalDatastore(n_lon=24, n_lat=12, n_timesteps=10,
                                   n_features={"state": 3}),
              JDummyGlobalDatastore(n_lon=24, n_lat=12, n_timesteps=10,
                                    n_features={"state": 3})),
             (DummyGlobalDatastore(config_path=cfg),
              JDummyGlobalDatastore(config_path=cfg))]
    for t, j in pairs:
        assert t.is_global and t.coords_projection == {"name": "platecarree"}
        assert t.config == j.config
        np.testing.assert_array_equal(t.get_xy("state"), j.get_xy("state"))
        np.testing.assert_array_equal(t.get_xy("state", stacked=False),
                                      j.get_xy("state", stacked=False))
        np.testing.assert_array_equal(t.boundary_mask.values,
                                      j.boundary_mask.values)
        assert not t.boundary_mask.values.any()
        for cat in ("state", "forcing"):
            for split in ("train", "val", "test"):
                np.testing.assert_array_equal(
                    t.get_dataarray(cat, split).values,
                    j.get_dataarray(cat, split).values)
            for k, v in j.get_standardization_dataarray(cat).items():
                np.testing.assert_array_equal(
                    t.get_standardization_dataarray(cat)[k], v)
        np.testing.assert_array_equal(t.get_dataarray("static", None).values,
                                      j.get_dataarray("static", None).values)
    assert pairs[1][0].root_path == tmp_path / "dsroot"
    assert DATASTORES["dummydata_global"] is DummyGlobalDatastore
    ds = init_datastore("dummydata_global", cfg)
    assert isinstance(ds, DummyGlobalDatastore) and ds.num_grid_points == 48


@pytest.mark.parametrize("hierarchical", [False, True])
def test_global_graph_matches_jax(hierarchical):
    """The bundle, array for array and bit for bit, and the dense layouts
    of the loaded graph (m2g exactly 4 slots a grid point, so virt
    identity)."""
    xy = JDummyGlobalDatastore(n_lon=24, n_lat=12).get_xy("state")
    levels = 3 if hierarchical else None
    want = j_create_global_graph("", xy, refinements=2, n_levels=levels,
                                 hierarchical=hierarchical)
    got = create_global_graph("", xy, refinements=2, n_levels=levels,
                              hierarchical=hierarchical)
    _equal_bundles(got, want)
    assert got.level_sizes == ([162, 42, 12] if hierarchical else [162])
    tg = graph_from_bundle(got, device="cpu")
    jg = j_graph_from_bundle(want)
    assert tg.num_grid_nodes == 288 and tg.level_sizes == jg.level_sizes
    assert tg.m2g.dense_k == 4 and tg.m2g.virt_identity
    sets = [("g2m", tg.g2m, jg.g2m), ("m2g", tg.m2g, jg.m2g)] + [
        (f"{k}{i}", a, b) for k in ("m2m", "up", "down")
        for i, (a, b) in enumerate(zip(getattr(tg, k), getattr(jg, k)))]
    for name, a, b in sets:
        assert (a.dense_k, a.num_virt, a.virt_identity) == (
            b.dense_k, b.num_virt, b.virt_identity), name
        np.testing.assert_array_equal(a.senders.numpy(), np.asarray(b.senders))
        np.testing.assert_array_equal(a.features.numpy(),
                                      np.asarray(b.features))
        np.testing.assert_array_equal(a.mask.numpy(), np.asarray(b.mask))


def _global_config(root, n_lon=24, n_lat=12):
    (root / "g.yaml").write_text(yaml.safe_dump(
        dict(n_lon=n_lon, n_lat=n_lat, n_timesteps=10, root="dsroot")))
    cfg = root / "config.yaml"
    cfg.write_text(yaml.safe_dump({"datastore": {
        "kind": "dummydata_global", "config_path": "g.yaml"}}))
    return cfg


def test_graph_cli_global_matches_jax(tmp_path):
    """`graph.build.cli --mesh global_icosahedral` writes the JAX CLI's
    graph (every array of graph.npz, and meta.json); an unknown mesh, and
    the icosahedral one on a LAM datastore, raise."""
    cfg = _global_config(tmp_path)
    flags = ["--config_path", str(cfg), "--hierarchical", "--mesh",
             "global_icosahedral", "--refinements", "2", "--levels", "2"]
    j_build.cli(flags + ["--name", "jax"])
    build.cli(flags + ["--name", "port"])
    gdir = tmp_path / "dsroot" / "graph"
    assert (json.loads((gdir / "port" / "meta.json").read_text())
            == json.loads((gdir / "jax" / "meta.json").read_text())
            == {"n_levels": 2, "hierarchical": True})
    a, b = np.load(gdir / "port" / "graph.npz"), np.load(gdir / "jax" /
                                                          "graph.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in b.files:
        np.testing.assert_array_equal(a[k], b[k], k)
    _equal_bundles(load_graph_bundle(str(gdir / "port")),
                   j_load_bundle(str(gdir / "jax")))
    _, ds = load_config_and_datastore(cfg)
    with pytest.raises(ValueError, match="unknown mesh"):
        build.create_graph_from_datastore(ds, "", mesh="nonsense")
    lam = tmp_path / "lam"
    lam.mkdir()
    (lam / "d.yaml").write_text(yaml.safe_dump(dict(n_points_1d=10)))
    (lam / "config.yaml").write_text(yaml.safe_dump({"datastore": {
        "kind": "dummydata", "config_path": "d.yaml"}}))
    _, lam_ds = load_config_and_datastore(lam / "config.yaml")
    with pytest.raises(ValueError, match="global datastore"):
        build.create_graph_from_datastore(lam_ds, "",
                                          mesh="global_icosahedral")


@pytest.mark.parametrize("name", ["hierarchical", "multiscale"])
def test_load_or_build_graph_on_a_global_datastore(tmp_path, name):
    """A CLI's missing graph on a global datastore is an icosahedral mesh
    at the JAX models' defaults (3 refinements; 2 levels when the name
    holds "hier", else every level merged), bit for bit."""
    _, ds = load_config_and_datastore(_global_config(tmp_path))
    g = load_or_build_graph(ds, name, device="cpu")
    want = j_create_global_graph("", ds.get_xy("state"), refinements=3,
                                 n_levels=2 if "hier" in name else None,
                                 hierarchical="hier" in name)
    _equal_bundles(load_graph_bundle(str(ds.root_path / "graph" / name)),
                   want)
    assert g.hierarchical == ("hier" in name)
    assert g.level_sizes == ((642, 162) if "hier" in name else (642,))
    assert not (ds.root_path / "graph" / f".{name}.tmp").exists()


def test_polar_g2m_fold_follows_jax_segment_sum():
    """At the poles of a 96x16 grid (1 refinement) g2m receivers own 24
    virtual rows: past `_JAX_GATHER_FOLD_MAX`, the port's flat fold of a
    bf16 virt sums in bf16 (JAX's `segment_sum` fold, bit for bit), and
    an fp32 virt folds as JAX's within 1e-6 relative; below the limit
    (the 24x12 grid) a bf16 virt folds in fp32, as JAX's gather fold."""
    xy = JDummyGlobalDatastore(n_lon=96, n_lat=16).get_xy("state")
    bundle = create_global_graph("", xy, refinements=1, hierarchical=False)
    tg = graph_from_bundle(bundle, device="cpu").g2m
    jg = j_graph_from_bundle(j_create_global_graph(
        "", xy, refinements=1, hierarchical=False)).g2m
    assert tg.rec_slots.shape[1] == 24 > tmp._JAX_GATHER_FOLD_MAX
    assert jg.rec_slots is None  # JAX folds this set by segment_sum
    rng = np.random.default_rng(0)
    # virtual rows of real slots; the all-masked padding rows sum to 0, as
    # the edge kernels give them
    real = tg.mask.view(tg.num_virt, tg.dense_k).sum(dim=1).numpy() > 0
    virt = (rng.standard_normal((tg.num_virt, 128))
            * real[:, None]).astype(np.float32)
    v16 = torch.as_tensor(virt).to(torch.bfloat16)
    got16 = tmp._fold_virt_flat(tg, v16)
    want16 = jmp._fold_virt_flat(jg, jnp.asarray(virt).astype(jnp.bfloat16))
    assert got16.dtype == torch.bfloat16
    np.testing.assert_array_equal(got16.float().numpy(),
                                  np.asarray(want16.astype(jnp.float32)))
    # the fp32-sum fold rounds differently: the branch matters
    assert not torch.equal(tmp._fold_virt(tg, v16).to(torch.bfloat16),
                           got16)
    got32 = tmp._fold_virt_flat(tg, torch.as_tensor(virt)).numpy()
    want32 = np.asarray(jmp._fold_virt_flat(jg, jnp.asarray(virt)))
    assert np.abs(got32 - want32).max() <= 1e-6 * np.abs(want32).max()

    small = JDummyGlobalDatastore(n_lon=24, n_lat=12).get_xy("state")
    tg = graph_from_bundle(create_global_graph("", small, refinements=2),
                           device="cpu").g2m
    assert tg.rec_slots.shape[1] <= tmp._JAX_GATHER_FOLD_MAX
    v16 = torch.as_tensor(rng.standard_normal(
        (tg.num_virt, 128)).astype(np.float32)).to(torch.bfloat16)
    assert tmp._fold_virt_flat(tg, v16).dtype == torch.float32
