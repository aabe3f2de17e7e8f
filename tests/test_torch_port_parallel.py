"""The pieces of the port's data parallelism and grid scheme that need no
second process, against the JAX package on the CPU.

* `EdgeSet.from_local` with `dense_force_k` and `dense_min_virt=0`: the
  JAX package's layout, array for array, and a virtual-row fold that sums
  nothing for a receiver without rows (also when such receivers come last
  and the rows fill their tile exactly, where a gather past the end would
  read out of bounds).
* `build_grid_shard`: each rank's sets equal the JAX package's stacked
  per-shard sets at that rank's index (its `_unstack_edgeset` input), for
  2 and 3 shards on a flat and a hierarchical graph, and the grid block of
  the static features.
* `WeatherDataLoader(shard=...)`: the JAX loader's batches bit for bit for
  2 and 3 shards, shuffled training and evaluation splits, with 0 and 2
  worker threads.
* What raises: an unknown spatial scheme, a sharded model with mean
  aggregation under each scheme, the train CLI asked for spatial shards
  in one process (with either scheme), and a world asked for nccl on the
  CPU or without its ranks or its address.
"""

import jax
import numpy as np
import pytest
import torch

from neural_lam_tpu.dataset import (
    WeatherDataLoader as JWeatherDataLoader,
    WeatherDataset as JWeatherDataset,
)
from neural_lam_tpu.datastore.dummy import DummyDatastore as JDummyDatastore
from neural_lam_tpu.graph.build import create_graph as j_create_graph
from neural_lam_tpu.graph.storage import graph_from_bundle as j_graph_from_bundle
from neural_lam_tpu.ops.message_passing import EdgeSet as JEdgeSet
from neural_lam_tpu.parallel.grid_sharded import (
    build_grid_shard as j_build_grid_shard,
)
from neural_lam_tpu_torch import entry, train
from neural_lam_tpu_torch.dataset import WeatherDataLoader, WeatherDataset
from neural_lam_tpu_torch.datastore.dummy import DummyDatastore
from neural_lam_tpu_torch.graph.build import create_graph
from neural_lam_tpu_torch.graph.storage import graph_from_bundle
from neural_lam_tpu_torch.ops import message_passing as tmp
from neural_lam_tpu_torch.parallel.grid_sharded import (
    build_grid_shard,
    spatialize,
    spatialize_scheme,
)
from neural_lam_tpu_torch.parallel.mesh import Mesh, grid_block

FIELDS = ("senders", "receivers", "features", "mask", "virt_to_rec")
STATIC = ("num_send", "num_rec", "dense_k", "num_virt", "virt_identity")


def _assert_set(t, j, what, fields=FIELDS, index=None):
    for f in STATIC:
        assert getattr(t, f) == getattr(j, f), (what, f)
    for f in fields:
        want = np.asarray(getattr(j, f))
        if index is not None:
            want = want[index]
        got = getattr(t, f).cpu().numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"{what}.{f}")


def _edges(rng, num_send, num_rec, degrees):
    recv = np.repeat(np.arange(num_rec), degrees)
    send = rng.integers(0, num_send, recv.size)
    feat = rng.standard_normal((recv.size, 3)).astype(np.float32)
    return send, recv, feat


@pytest.mark.parametrize("min_virt", [0, 1])
@pytest.mark.parametrize("case", ["scattered", "trailing"])
def test_from_local_force_k_min_virt(case, min_virt):
    """The layout of `dense_force_k` and `dense_min_virt` equals the JAX
    package's; the fold of random virtual-row sums (zero on all-masked
    rows, as the kernels leave them) equals a segment sum over the rows'
    receivers, 0 for a receiver of degree 0."""
    rng = np.random.default_rng(0)
    if case == "scattered":  # zero-degree receivers between the others
        degrees = rng.integers(0, 13, 90) * (rng.random(90) < 0.7)
        K = 4
    else:  # 64 one-row receivers fill the tile, 16 empty ones follow
        degrees = np.concatenate([rng.integers(1, 5, 64), np.zeros(16, int)])
        K = 4
    send, recv, feat = _edges(rng, 50, degrees.size, degrees)
    t = tmp.EdgeSet.from_local(send, recv, feat, num_send=50,
                               num_rec=degrees.size, dense_force_k=K,
                               dense_min_virt=min_virt, device="cpu")
    j = JEdgeSet.from_local(send, recv, feat, num_send=50,
                            num_rec=degrees.size, dense=True,
                            dense_force_k=K, dense_min_virt=min_virt)
    _assert_set(t, j, case)
    if case == "trailing" and min_virt == 0:
        assert t.num_virt == 64  # the rows fill their tile exactly
    rows_real = t.mask.view(t.num_virt, K).sum(1) > 0
    virt = torch.randn(t.num_virt, 6, generator=torch.Generator()
                       .manual_seed(1)) * rows_real[:, None]
    want = np.zeros((degrees.size, 6), np.float64)
    np.add.at(want, t.virt_to_rec.numpy(), virt.double().numpy())
    got = tmp._fold_virt(t, virt).double().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.all(got[degrees == 0] == 0)


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """(port graph, JAX graph, grid static features) of a flat multiscale
    and a two-level hierarchical graph on a 30x28 grid."""
    tds = DummyDatastore(grid_shape=(30, 28), n_timesteps=10)
    jds = JDummyDatastore(grid_shape=(30, 28), n_timesteps=10)
    out = {}
    for name, kw in (("flat", dict(n_max_levels=None, hierarchical=False)),
                     ("hier", dict(n_max_levels=2, hierarchical=True))):
        tb = create_graph(str(tmp_path_factory.mktemp("t" + name)),
                          tds.get_xy("state", stacked=False), **kw)
        jb = j_create_graph(str(tmp_path_factory.mktemp("j" + name)),
                            jds.get_xy("state", stacked=False), **kw)
        stat = np.asarray(tds.get_dataarray("static", None).values,
                          np.float32)
        out[name] = (graph_from_bundle(tb, device="cpu"),
                     j_graph_from_bundle(jb), stat)
    return out


@pytest.mark.parametrize("n_shards", [2, 3])
@pytest.mark.parametrize("kind", ["flat", "hier"])
def test_grid_shard_matches_jax(kind, n_shards, graphs):
    """Rank s's sets of `build_grid_shard` (built alone, padded to the
    common sizes) equal index s of the JAX package's stacked sets, their
    transposed layouts too; its static block is rows [s*block,
    (s+1)*block) of the zero-padded grid."""
    tg, jg, stat = graphs[kind]
    jp = j_build_grid_shard(jg, n_shards, stat)
    for s in range(n_shards):
        tp = build_grid_shard(tg, n_shards, stat, s, device="cpu")
        assert (tp.block, tp.num_grid) == (jp.block, jp.num_grid)
        pairs = [("g2m", tp.g2m, jp.g2m), ("m2g", tp.m2g, jp.m2g)]
        for kind_ in ("m2m", "up", "down"):
            pairs += [(f"{kind_}[{i}]", t, j) for i, (t, j) in enumerate(
                zip(getattr(tp, kind_), getattr(jp, kind_)))]
        assert len(pairs) == 2 + len(jg.m2m) + len(jg.up) + len(jg.down)
        for what, t, j in pairs:
            _assert_set(t, j, f"shard {s} {what}", index=s)
            _assert_set(t.transposed, j.transposed,
                        f"shard {s} {what}.transposed",
                        fields=("senders", "mask", "virt_to_rec"), index=s)
        np.testing.assert_array_equal(tp.grid_static.numpy(),
                                      np.asarray(jp.grid_static)[
                                          s * jp.block:(s + 1) * jp.block])


def test_grid_block_pads_the_last_block():
    x = torch.arange(2 * 7 * 3, dtype=torch.float32).view(2, 7, 3)
    blocks = [grid_block(x, Mesh(1, 3, 0, s), 7) for s in range(3)]
    assert [b.shape[1] for b in blocks] == [3, 3, 3]
    np.testing.assert_array_equal(torch.cat(blocks, 1)[:, :7].numpy(),
                                  x.numpy())
    assert float(blocks[2][:, 1:].abs().sum()) == 0.0


@pytest.fixture(scope="module")
def loader_stores():
    return (DummyDatastore(grid_shape=(6, 5), n_timesteps=70),
            JDummyDatastore(grid_shape=(6, 5), n_timesteps=70))


@pytest.mark.parametrize("num_workers", [0, 2])
@pytest.mark.parametrize("n_shards", [2, 3])
def test_loader_shards_match_jax(n_shards, num_workers, loader_stores):
    """Each shard's batches equal the JAX loader's for that shard, in
    order and bit for bit: the shuffled training split (drop_last, equal
    batch counts) and the validation split (shard 0 takes the leftovers
    and the partial batch); the shards' rows together are the split."""
    tds, jds = loader_stores
    for split, ar, loader_kw in (
            ("train", 2, dict(batch_size=3, shuffle=True, seed=5)),
            ("val", 1, dict(batch_size=2, drop_last=False))):
        dt = WeatherDataset(tds, split=split, ar_steps=ar)
        dj = JWeatherDataset(jds, split=split, ar_steps=ar)
        seen = []
        for k in range(n_shards):
            lt = WeatherDataLoader(dt, shard=(n_shards, k),
                                   num_workers=num_workers, **loader_kw)
            lj = JWeatherDataLoader(dj, shard=(n_shards, k),
                                    num_workers=num_workers, **loader_kw)
            lt.set_epoch(1)
            lj.set_epoch(1)
            bt, bj = list(lt), list(lj)
            assert len(bt) == len(bj) == len(lt) == len(lj), (split, k)
            for a, b in zip(bt, bj):
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y)
            seen += [tuple(map(int, t)) for b in bt for t in b[3]]
        if split == "val":
            assert len(seen) == len(dt)
        assert len(set(seen)) == len(seen)


def test_unported_schemes_and_mean_aggregation_raise(tmp_path):
    """An unknown scheme raises; a sharded model with mesh_aggr="mean"
    raises under grid, mesh_rs and mesh_halo, as the JAX package's
    asserts; the CLI does not run spatial shards in one process."""
    model, _ = entry.build_model(nx=10, ny=10, hidden_dim=8,
                                 processor_layers=1, device="cpu")
    mesh = Mesh(1, 1, 0, 0)
    with pytest.raises(ValueError, match="unknown spatial scheme"):
        spatialize_scheme(model, mesh, "mesh_psum")
    model.args.mesh_aggr = "mean"
    with pytest.raises(ValueError, match="mesh_aggr"):
        spatialize(model, mesh)
    for scheme in ("grid", "mesh_rs", "mesh_halo"):
        with pytest.raises(ValueError, match="mesh_aggr"):
            spatialize_scheme(model, mesh, scheme)
    cfg = tmp_path / "config.yaml"
    cfg.write_text("datastore:\n  kind: dummydata\n  config_path: d.yaml\n")
    (tmp_path / "d.yaml").write_text("n_points_1d: 10\nn_timesteps: 20\n")
    base = ["--config_path", str(cfg), "--device", "cpu"]
    with pytest.raises(ValueError, match="one process a shard"):
        train.main(base + ["--spatial_shards", "2"])
    for scheme in ("mesh_rs", "mesh_halo"):
        with pytest.raises(ValueError, match="one process a shard"):
            train.main(base + ["--spatial_shards", "2", "--spatial_scheme",
                               scheme])
    assert jax.device_count() == 8  # the JAX side's virtual devices


def test_world_setup_raises_before_joining():
    """No silent switch of backend or of process count: nccl on the CPU,
    a world without ranks or without an address, raise before any
    process group exists."""
    from neural_lam_tpu_torch.parallel import distributed

    with pytest.raises(ValueError, match="nccl backend needs CUDA"):
        distributed.init_multihost("127.0.0.1:1", 2, 0, backend="nccl",
                                   device="cpu")
    with pytest.raises(ValueError, match="--node_rank"):
        distributed.init_multihost("127.0.0.1:1", 2, None, device="cpu")
    with pytest.raises(ValueError, match="--coordinator_address"):
        distributed.init_multihost(None, 2, 0, device="cpu")
    assert distributed.world() is None
    assert distributed.init_multihost(None, 1, None) == (0, 1)
