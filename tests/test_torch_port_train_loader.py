"""The port's input pipeline for training against the JAX package's, on
the CPU.

* `WeatherDataLoader`'s batches (the slab cache, `write_item`, the
  caller's thread and the worker pool) equal the JAX loader's bit for bit,
  for every `num_workers`, `prefetch` and cache setting
  (`NLT_STD_CACHE_MB=0` turns the cache off in both packages), shuffled
  training batches and a partial last validation batch, on the MDP and
  MEPS fixtures.
* The chunk cache's in-flight dedup: four threads reading the same
  windows at once decode each chunk once (`native.decoded_chunks`).
* `train.DevicePrefetcher` (its CPU placement): the loader's order, a
  loader error raised again in the consumer, and `close()` in the middle
  of an epoch leaving no thread behind, the loader's own threads too.
"""

import threading
import time

import numpy as np
import pytest

from neural_lam_tpu.dataset import (
    WeatherDataLoader as JWeatherDataLoader,
    WeatherDataset as JWeatherDataset,
)
from neural_lam_tpu.datastore.compute_standardization_stats import (
    main as meps_stats_main,
)
from neural_lam_tpu.datastore.mdp import MDPDatastore as JMDPDatastore
from neural_lam_tpu.datastore.npyfilesmeps import (
    NpyFilesDatastoreMEPS as JNpyFilesDatastoreMEPS,
)
from neural_lam_tpu_torch import native
from neural_lam_tpu_torch.dataset import WeatherDataLoader, WeatherDataset
from neural_lam_tpu_torch.datastore import MDPDatastore, NpyFilesDatastoreMEPS
from neural_lam_tpu_torch.datastore import zarr_reader as tzr
from neural_lam_tpu_torch.train import DevicePrefetcher

from .mdp_fixture import make_mdp_dataset
from .meps_fixture import make_meps_dataset


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """Config paths of the MDP fixture and of the MEPS fixture with its
    statistics (written by the JAX package's tool)."""
    mdp = make_mdp_dataset(tmp_path_factory.mktemp("mdp"))
    meps = make_meps_dataset(tmp_path_factory.mktemp("meps"))
    meps_stats_main(meps, step_length=2)
    return {"mdp": mdp, "npyfilesmeps": meps}


def _pair(kind, stores):
    if kind == "mdp":
        return (MDPDatastore(stores[kind], n_boundary_points=2),
                JMDPDatastore(stores[kind], n_boundary_points=2))
    return (NpyFilesDatastoreMEPS(stores[kind]),
            JNpyFilesDatastoreMEPS(stores[kind]))


@pytest.mark.filterwarnings("ignore:only using first ensemble member")
@pytest.mark.parametrize("cache", ["on", "off"])
@pytest.mark.parametrize("num_workers,prefetch",
                         [(0, 0), (0, 2), (3, 0), (3, 2)])
@pytest.mark.parametrize("kind", ["mdp", "npyfilesmeps"])
def test_loader_batches_match_jax(kind, num_workers, prefetch, cache,
                                  stores, monkeypatch):
    """Batches of the port's loader equal the JAX loader's in the same
    setting, array for array and in the same order: the shuffled training
    split (epoch 1, a wider forcing window) and the validation split with
    its partial last batch."""
    if cache == "off":
        monkeypatch.setenv("NLT_STD_CACHE_MB", "0")
    t, j = _pair(kind, stores)
    for split, kw, loader_kw in (
            ("train", dict(ar_steps=2, num_past_forcing_steps=2),
             dict(batch_size=2, shuffle=True, seed=5)),
            ("val", dict(ar_steps=1), dict(batch_size=3, drop_last=False))):
        dt, dj = (WeatherDataset(t, split=split, **kw),
                  JWeatherDataset(j, split=split, **kw))
        assert dt._std_cache_on == dj._std_cache_on == (
            cache == "on" and kind == "mdp")
        lt = WeatherDataLoader(dt, prefetch=prefetch,
                               num_workers=num_workers, **loader_kw)
        lj = JWeatherDataLoader(dj, prefetch=prefetch,
                                num_workers=num_workers, **loader_kw)
        lt.set_epoch(1)
        lj.set_epoch(1)
        got, want = list(lt), list(lj)
        assert len(got) == len(want) == len(lt) > 0
        if split == "val":  # 1 (MEPS) or 2 (MDP) samples of 3
            assert got[-1][0].shape[0] == len(dt) % 3 > 0
        for n, (bt, bj) in enumerate(zip(got, want)):
            for a, b in zip(bt, bj):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b, f"{split} batch {n}")


def test_chunk_decoded_once_under_four_threads(tmp_path):
    """Four threads read the same overlapping time windows of a zlib array
    at once: every chunk is decoded once (the others wait for it), and
    every read is right."""
    rng = np.random.default_rng(0)
    data = rng.standard_normal((48, 40, 3)).astype(np.float32)
    tzr.write_zarr_array(tmp_path, "a", data, dims=["t", "g", "f"],
                         chunks=[1, 40, 3],
                         compressor={"id": "zlib", "level": 1})
    arr = tzr.ZarrGroup(tmp_path)["a"]
    native.library()  # built before the threads start
    tzr._chunk_cache.clear()
    before = native.decoded_chunks
    barrier = threading.Barrier(4)
    errors = []

    def reader():
        try:
            barrier.wait()
            for s in range(0, 44, 2):
                np.testing.assert_array_equal(arr.read_slice0(s, s + 4),
                                              data[s:s + 4])
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=reader) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors, errors
    assert native.decoded_chunks - before == 46  # rows 0..45, once each


def test_failed_decode_releases_its_claim(tmp_path, monkeypatch):
    """A decode that raises releases the chunks it claimed: a later read
    decodes them, and nothing waits forever."""
    data = np.arange(24, dtype=np.float32).reshape(6, 4)
    tzr.write_zarr_array(tmp_path, "a", data, dims=["t", "g"],
                         chunks=[2, 4], compressor={"id": "zlib",
                                                    "level": 1})
    arr = tzr.ZarrGroup(tmp_path)["a"]
    tzr._chunk_cache.clear()
    real = tzr.ZarrArray._decode_list

    def broken(self, idx_list):
        raise OSError("disk gone")

    monkeypatch.setattr(tzr.ZarrArray, "_decode_list", broken)
    with pytest.raises(OSError):
        arr.read_slice0(0, 6)
    assert not tzr._chunk_cache._inflight
    monkeypatch.setattr(tzr.ZarrArray, "_decode_list", real)
    np.testing.assert_array_equal(arr.read_slice0(0, 6), data)


def _batches(n, fail_at=None, delay=0.0):
    for i in range(n):
        if i == fail_at:
            raise ValueError(f"bad batch {i}")
        time.sleep(delay)
        yield (np.full((2, 3), i, np.float32), np.array([i], np.int64))


def test_prefetcher_keeps_order_and_raises_loader_errors():
    got = list(DevicePrefetcher(_batches(7), "cpu", depth=2))
    assert [int(b[1][0]) for b in got] == list(range(7))
    assert all(b[0].dtype.is_floating_point and b[0].device.type == "cpu"
               for b in got)
    seen = []
    with pytest.raises(ValueError, match="bad batch 3"):
        for b in DevicePrefetcher(_batches(7, fail_at=3), "cpu", depth=2):
            seen.append(int(b[1][0]))
    assert seen == [0, 1, 2]


def test_prefetcher_close_mid_epoch_stops_every_thread(stores):
    """close() after two batches of a pooled loader's epoch (and again:
    idempotent) leaves no prefetcher or pool thread running."""
    before = set(threading.enumerate())
    t = MDPDatastore(stores["mdp"], n_boundary_points=2)
    for num_workers in (0, 3):
        loader = WeatherDataLoader(WeatherDataset(t, split="train",
                                                  ar_steps=1),
                                   batch_size=1, prefetch=2,
                                   num_workers=num_workers)
        pre = DevicePrefetcher(loader, "cpu", depth=2)
        it = iter(pre)
        for _ in range(2):
            next(it)
        pre.close()
        pre.close()
        it.close()
        assert set(threading.enumerate()) <= before
    slow = DevicePrefetcher(_batches(100, delay=0.01), "cpu", depth=1)
    next(iter(slow))
    slow.close()
    assert set(threading.enumerate()) <= before
