"""Weather dataset: time slicing, forcing windowing, standardization, batching.

Counterpart of neural_lam_tpu/dataset.py (ref:
neural_lam/weather_dataset.py:16-496). A sample at index `idx` is

    init_states   (2, N_grid, d_state)          -- X_{t-1}, X_t
    target_states (ar_steps, N_grid, d_state)   -- X_{t+1} ...
    forcing       (ar_steps, N_grid, d_forcing * (past + future + 1))
    target_times  (ar_steps,) int64 epoch-ns

with forcing windowed around each target step and flattened feature-major
(feature outer, window inner, ref: weather_dataset.py:416-421). Handles
analysis data (a `time` dim) and forecast data (`analysis_time` x
`elapsed_forecast_duration`, one sample per analysis time, first ensemble
member only). Items equal the JAX package's array for array.

`WeatherDataLoader` fills fixed-shape numpy batches with seeded
shuffling, as the JAX package's loader does: each sample is written
straight into its batch row (`WeatherDataset.write_item`), standardized
per time step once and served from an LRU slab cache
(`NLT_STD_CACHE_MB`, analysis data), in the caller's thread or by a
pool of `num_workers` threads (at least one) that fills the rows of up
to `prefetch` + 1 batches at once. Batches come in order, and
every setting gives the same arrays bit for bit.
"""

from __future__ import annotations

import os
import queue
import threading
import warnings
from collections import OrderedDict

import numpy as np

from .datastore.base import BaseDatastore


class WeatherDataset:
    """Dataset over a datastore split (ref: weather_dataset.py:16-117)."""

    def __init__(self, datastore: BaseDatastore, split="train", ar_steps=3,
                 num_past_forcing_steps=1, num_future_forcing_steps=1,
                 standardize=True):
        self.split = split
        self.ar_steps = ar_steps
        self.datastore = datastore
        self.num_past_forcing_steps = num_past_forcing_steps
        self.num_future_forcing_steps = num_future_forcing_steps

        self.da_state = datastore.get_dataarray(category="state", split=split)
        self.da_forcing = datastore.get_dataarray(category="forcing",
                                                  split=split)
        if self.__len__() <= 0:
            raise ValueError(
                "The provided datastore only provides "
                f"{self._n_time_total()} total time steps, which is too few "
                "to create a single sample for the WeatherDataset "
                f"configuration used in the `{split}` split. You could try "
                "either reducing the number of autoregressive steps "
                "(`ar_steps`) and/or the forcing window size "
                "(`num_past_forcing_steps` and `num_future_forcing_steps`)"
            )
        # dim-order contract check (ref: weather_dataset.py:80-95)
        parts = {"state": self.da_state}
        if self.da_forcing is not None:
            parts["forcing"] = self.da_forcing
        for part, da in parts.items():
            expected = datastore.expected_dim_order(category=part)
            if da.dims != expected:
                raise ValueError(
                    f"The dimension order of the `{part}` data ({da.dims}) "
                    f"does not match the expected dimension order "
                    f"({expected})."
                )

        self.standardize = standardize
        if standardize:
            stats = datastore.get_standardization_dataarray(category="state")
            self.da_state_mean = np.asarray(stats["state_mean"], np.float32)
            self._state_inv_std = (
                1.0 / np.asarray(stats["state_std"], np.float32)
            ).astype(np.float32)
            if self.da_forcing is not None:
                fstats = datastore.get_standardization_dataarray(
                    category="forcing")
                self.da_forcing_mean = np.asarray(fstats["forcing_mean"],
                                                  np.float32)
                self._forcing_inv_std = (
                    1.0 / np.asarray(fstats["forcing_std"], np.float32)
                ).astype(np.float32)

        # Per-time-step standardized slab cache (analysis data):
        # consecutive samples share all but one time step and epochs repeat
        # them, so each step is standardized once and served by plain
        # copies. LRU; NLT_STD_CACHE_MB (default 768) bounds it, 0 turns it
        # off.
        self._std_cache_on = standardize and not datastore.is_forecast
        self._std_lock = threading.Lock()
        self._std_cache: OrderedDict = OrderedDict()
        self._std_bytes = 0
        self._std_max_bytes = int(
            os.environ.get("NLT_STD_CACHE_MB", "768")) * (1 << 20)
        if self._std_max_bytes <= 0:
            self._std_cache_on = False

    def _std_step(self, kind: str, t: int) -> np.ndarray:
        """Standardized (N_grid, d) slab of absolute time index `t` ("s" =
        state, "f" = forcing). A thread racing another for the same step
        may compute it twice (the same values), never sees a partial
        entry. The arrays are shared: callers must not change them."""
        key = (kind, t)
        with self._std_lock:
            row = self._std_cache.get(key)
            if row is not None:
                self._std_cache.move_to_end(key)
                return row
        if kind == "s":
            raw = self.da_state.isel(time=slice(t, t + 1)).values[0]
            row = (np.asarray(raw, np.float32) - self.da_state_mean) \
                * self._state_inv_std
        else:
            raw = self.da_forcing.isel(time=slice(t, t + 1)).values[0]
            row = (np.asarray(raw, np.float32) - self.da_forcing_mean) \
                * self._forcing_inv_std
        with self._std_lock:
            if key in self._std_cache:
                return self._std_cache[key]
            self._std_cache[key] = row
            self._std_bytes += row.nbytes
            while (self._std_bytes > self._std_max_bytes
                   and len(self._std_cache) > 1):
                _, old = self._std_cache.popitem(last=False)
                self._std_bytes -= old.nbytes
        return row

    # --- length (ref: weather_dataset.py:117-161) ---

    def _n_time_total(self):
        if self.datastore.is_forecast:
            return self.da_state.sizes()["elapsed_forecast_duration"]
        return self.da_state.sizes()["time"]

    def __len__(self):
        if self.datastore.is_forecast:
            if self.datastore.is_ensemble:
                warnings.warn(
                    "only using first ensemble member, so dataset size is "
                    "effectively reduced by the number of ensemble members "
                    f"({self.da_state.sizes().get('ensemble_member')})",
                    UserWarning,
                )
            n_forecast_steps = self.da_state.sizes()[
                "elapsed_forecast_duration"]
            if n_forecast_steps < 2 + self.ar_steps:
                raise ValueError(
                    "The number of forecast steps available "
                    f"({n_forecast_steps}) is less than the required "
                    f"2+ar_steps (2+{self.ar_steps}={2 + self.ar_steps}) for "
                    "creating a sample with initial and target states."
                )
            return self.da_state.sizes()["analysis_time"]
        return (
            self.da_state.sizes()["time"]
            - self.ar_steps
            - max(2, self.num_past_forcing_steps)
            - self.num_future_forcing_steps
        )

    # --- slicing (ref: weather_dataset.py:163-331) ---

    def _state_slice(self, idx):
        """(2 + ar_steps, N, d) state window and its times."""
        init_steps = 2
        past = self.num_past_forcing_steps
        start_off = max(0, past - init_steps)
        end_off = max(init_steps, past) + self.ar_steps
        if self.datastore.is_forecast:
            da = self.da_state.isel(analysis_time=idx)
            if self.datastore.is_ensemble:
                da = da.isel(ensemble_member=0)
            vals = da.values[start_off:end_off]
            atime = np.asarray(self.da_state.coords["analysis_time"])[idx]
            efd = np.asarray(
                self.da_state.coords["elapsed_forecast_duration"]
            )[start_off:end_off]
            times = atime + efd
        else:
            start, end = idx + start_off, idx + end_off
            vals = self.da_state.isel(time=slice(start, end)).values
            times = np.asarray(self.da_state.coords["time"])[start:end]
        return np.asarray(vals, np.float32), times

    def _state_range(self, idx):
        """[start, end) absolute state time range (analysis data)."""
        past = self.num_past_forcing_steps
        return (idx + max(0, past - 2),
                idx + max(2, past) + self.ar_steps)

    def _forcing_range(self, idx):
        """[lo, hi) absolute forcing time range covering every window
        (analysis data)."""
        offset = idx + max(2, self.num_past_forcing_steps)
        return (offset - self.num_past_forcing_steps,
                offset + self.ar_steps + self.num_future_forcing_steps)

    def _forcing_rows_std(self, idx):
        """The standardized (N, d_f) slabs of `_forcing_range` (cached)."""
        lo, hi = self._forcing_range(idx)
        return [self._std_step("f", t) for t in range(lo, hi)]

    def _forcing_buf(self, idx):
        """Raw (ar_steps + W - 1, N, d_f) forcing covering every window;
        may be a view of datastore or cache memory: not to be changed."""
        past = self.num_past_forcing_steps
        n = self.ar_steps + self.num_future_forcing_steps
        if self.datastore.is_forecast:
            offset = max(2, past)
            da = self.da_forcing.isel(analysis_time=idx)
            return np.asarray(da.values[offset - past:offset + n],
                              np.float32)
        lo, hi = self._forcing_range(idx)
        return np.asarray(self.da_forcing.isel(time=slice(lo, hi)).values,
                          np.float32)

    def _forcing_windows(self, idx):
        """(ar_steps, N, d_f * W) windowed forcing, feature-major."""
        n_steps = self.ar_steps
        W = self.num_past_forcing_steps + self.num_future_forcing_steps + 1
        if self._std_cache_on:
            buf = np.stack(self._forcing_rows_std(idx))
        else:
            buf = self._forcing_buf(idx)
            if self.standardize:
                buf = buf - self.da_forcing_mean
                buf *= self._forcing_inv_std
        n_grid, d_f = buf.shape[1], buf.shape[2]
        win = np.stack([buf[w:w + n_steps] for w in range(W)], axis=-1)
        return win.reshape(n_steps, n_grid, d_f * W)

    def __getitem__(self, idx):
        """Sample tuple (init_states, target_states, forcing, target_times)
        (ref: weather_dataset.py:443-496)."""
        if idx < 0:
            idx += len(self)
        if not 0 <= idx < len(self):
            raise IndexError(idx)
        if self._std_cache_on:
            start, end = self._state_range(idx)
            state = np.stack([self._std_step("s", t)
                              for t in range(start, end)])
            times = np.asarray(self.da_state.coords["time"])[start:end]
        else:
            state, times = self._state_slice(idx)
            if self.standardize:
                state = state - self.da_state_mean
                state *= self._state_inv_std
        target_times = times[2:].astype("datetime64[ns]").astype(np.int64)
        if self.da_forcing is not None:
            forcing = self._forcing_windows(idx)
        else:
            forcing = np.empty((self.ar_steps, state.shape[1], 0),
                               dtype=np.float32)
        return (state[:2], state[2:], forcing, target_times)

    def write_item(self, idx, out_init, out_target, out_forcing):
        """Write sample `idx` into preallocated batch rows: out_init (2, N,
        d_state), out_target (ar_steps, N, d_state), out_forcing (ar_steps,
        N, d_f * W), C-contiguous. The same arithmetic as __getitem__, in
        one copy (no per-sample array for a batch stack to copy again).
        Returns target_times (ar_steps,) int64 epoch-ns."""
        if idx < 0:
            idx += len(self)
        if not 0 <= idx < len(self):
            raise IndexError(idx)
        if self._std_cache_on:
            start, end = self._state_range(idx)
            out_init[0] = self._std_step("s", start)
            out_init[1] = self._std_step("s", start + 1)
            for i, t in enumerate(range(start + 2, end)):
                out_target[i] = self._std_step("s", t)
            times = np.asarray(self.da_state.coords["time"])[start:end]
        else:
            state, times = self._state_slice(idx)
            if self.standardize:
                np.subtract(state[:2], self.da_state_mean, out=out_init)
                out_init *= self._state_inv_std
                np.subtract(state[2:], self.da_state_mean, out=out_target)
                out_target *= self._state_inv_std
            else:
                out_init[...] = state[:2]
                out_target[...] = state[2:]

        if self.da_forcing is not None and out_forcing.shape[-1]:
            n_steps = self.ar_steps
            W = (self.num_past_forcing_steps
                 + self.num_future_forcing_steps + 1)
            # feature-major (index f * W + w), written through a 4-d view:
            # a reshape of a non-contiguous row would be a copy, and every
            # write would be lost
            if not out_forcing.flags["C_CONTIGUOUS"]:
                raise ValueError("write_item needs a C-contiguous "
                                 "out_forcing row")
            if self._std_cache_on:
                rows = self._forcing_rows_std(idx)
                n_grid, d_f = rows[0].shape
                out4 = out_forcing.reshape(n_steps, n_grid, d_f, W)
                for w in range(W):
                    for s in range(n_steps):
                        out4[s, :, :, w] = rows[w + s]
            else:
                buf = self._forcing_buf(idx)
                if self.standardize:
                    # a fresh array: buf may be datastore or cache memory
                    buf = buf - self.da_forcing_mean
                    buf *= self._forcing_inv_std
                n_grid, d_f = buf.shape[1], buf.shape[2]
                out4 = out_forcing.reshape(n_steps, n_grid, d_f, W)
                for w in range(W):
                    out4[..., w] = buf[w:w + n_steps]
        return times[2:].astype("datetime64[ns]").astype(np.int64)


def collate(samples):
    """Stack samples into fixed-shape numpy batch arrays."""
    return tuple(np.stack(parts, axis=0) for parts in zip(*samples))


class BackgroundIterator:
    """Iterate `items` on a daemon thread up to `depth` items ahead of the
    consumer, in their order. An error raised while producing is raised
    again in the consumer. `close()` (idempotent) stops and joins the
    thread; the thread closes `items` (a generator's cleanup runs) when it
    ends."""

    def __init__(self, items, depth):
        self._q = queue.Queue(maxsize=max(int(depth), 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, args=(items,),
                                        daemon=True)
        self._thread.start()

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _work(self, items):
        try:
            for x in items:
                if not self._put(("item", x)):
                    return
            self._put(("end", None))
        except BaseException as e:  # raised again in the consumer
            self._put(("err", e))
        finally:
            close = getattr(items, "close", None)
            if close is not None:
                close()

    def __iter__(self):
        while True:
            kind, val = self._q.get()
            if kind == "err":
                raise val
            if kind == "end":
                return
            yield val

    def close(self):
        self._stop.set()
        while self._thread.is_alive():
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.1)


_malloc_tuned = False


def _tune_malloc():
    """Raise glibc's mmap threshold so that batch buffers of ~100 MB come
    from the reusable heap, not from fresh mmaps whose zeroed pages fault
    in on every batch. NLT_NO_MALLOC_TUNE turns it off."""
    global _malloc_tuned
    if _malloc_tuned or os.environ.get("NLT_NO_MALLOC_TUNE"):
        return
    _malloc_tuned = True
    try:
        import ctypes

        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        m_mmap_threshold = -3
        libc.mallopt(m_mmap_threshold, 1 << 30)
    except OSError:  # not glibc
        pass


class WeatherDataLoader:
    """Batch iterator with seeded shuffling (ref: weather_dataset.py:665-696).

    Shuffled order is numpy's `default_rng((seed, epoch)).permutation`, as
    in the JAX package, so both packages see the same batches. drop_last
    keeps every training batch the same shape; evaluation loaders keep the
    last partial batch. Each batch is allocated and its rows filled in
    place by `WeatherDataset.write_item`: in the caller's thread
    (`prefetch` 0 and `num_workers` <= 1), else by a pool of
    `num_workers` threads (at least one), one task a row, over
    `prefetch` + 1 batches in flight (the chunk decoder and
    numpy's large loops release the GIL; the threads share the chunk and
    slab caches). Batches come in order either way. Leaving the iteration
    early (closing the generator) stops its threads.

    `shard` = (num_shards, shard_id) gives each data-parallel group a
    disjoint strided subset of the batches, as the JAX package's loader
    does: shard k takes full batches k, k + num_shards, ..., truncated to
    the same count on every shard (the training steps run in lockstep);
    with drop_last off (evaluation) shard 0 also takes the leftover full
    batches and the partial one.
    """

    def __init__(self, dataset: WeatherDataset, batch_size=4, shuffle=False,
                 seed=0, drop_last=True, prefetch=2, num_workers=0,
                 shard=(1, 0)):
        _tune_malloc()
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.num_workers = num_workers
        self.num_shards, self.shard_id = (int(v) for v in shard)
        self.epoch = 0

    def __len__(self):
        n_full = len(self.dataset) // self.batch_size
        n = n_full // self.num_shards
        if not self.drop_last and self.shard_id == 0:
            remainder = len(self.dataset) - n_full * self.batch_size
            n += n_full - n * self.num_shards + (1 if remainder else 0)
        return n

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _batch_indices(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng((self.seed, self.epoch)).permutation(n)
        n_batches = n // self.batch_size
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(n_batches)]
        n_even = n_batches // self.num_shards * self.num_shards
        mine = batches[self.shard_id:n_even:self.num_shards]
        if not self.drop_last and self.shard_id == 0:
            mine += batches[n_even:]
            remainder = order[n_batches * self.batch_size:]
            if remainder.size:
                mine.append(remainder)
        return mine

    def _alloc_batch(self, n_rows):
        """Empty batch arrays for `n_rows` samples."""
        ds = self.dataset
        sz = ds.da_state.sizes()
        n_grid, d_state, ar = sz["grid_index"], sz["state_feature"], \
            ds.ar_steps
        d_fw = 0
        if ds.da_forcing is not None:
            d_fw = ds.da_forcing.sizes()["forcing_feature"] * (
                ds.num_past_forcing_steps + ds.num_future_forcing_steps + 1)
        return (np.empty((n_rows, 2, n_grid, d_state), np.float32),
                np.empty((n_rows, ar, n_grid, d_state), np.float32),
                np.empty((n_rows, ar, n_grid, d_fw), np.float32),
                np.empty((n_rows, ar), np.int64))

    def _fill_batch(self, b):
        batch = self._alloc_batch(len(b))
        init, tgt, forc, tms = batch
        for j, i in enumerate(b):
            tms[j] = self.dataset.write_item(int(i), init[j], tgt[j],
                                             forc[j])
        return batch

    def __iter__(self):
        batches = self._batch_indices()
        if self.prefetch <= 0 and self.num_workers <= 1:
            for b in batches:
                yield self._fill_batch(b)
            return
        yield from self._iter_pooled(batches)

    def _iter_pooled(self, batches):
        """Each row of a batch is a task of a pool of `num_workers` threads
        (at least one), with `prefetch` + 1 batches in flight (2 at
        `prefetch` 0); batches come in order."""
        from concurrent.futures import ThreadPoolExecutor

        window = max(self.prefetch, 1) + 1
        it = iter(batches)
        pending = []
        with ThreadPoolExecutor(max_workers=max(self.num_workers, 1)) as ex:

            def submit_next():
                b = next(it, None)
                if b is None:
                    return
                batch = self._alloc_batch(len(b))
                init, tgt, forc, tms = batch

                def fill_row(j):
                    tms[j] = self.dataset.write_item(
                        int(b[j]), init[j], tgt[j], forc[j])

                pending.append(
                    (batch, [ex.submit(fill_row, j) for j in range(len(b))]))

            try:
                for _ in range(window):
                    submit_next()
                while pending:
                    batch, futs = pending.pop(0)
                    for f in futs:
                        f.result()
                    submit_next()
                    yield batch
            finally:
                for _, futs in pending:
                    for f in futs:
                        f.cancel()


class WeatherDataModule:
    """Train/val/test datasets and loaders (ref: weather_dataset.py:603-696)."""

    def __init__(self, datastore: BaseDatastore, ar_steps_train=3,
                 ar_steps_eval=25, standardize=True, num_past_forcing_steps=1,
                 num_future_forcing_steps=1, batch_size=4, num_workers=0,
                 shard=(1, 0)):
        self._datastore = datastore
        self.shard = shard
        self.ar_steps_train = ar_steps_train
        self.ar_steps_eval = ar_steps_eval
        self.standardize = standardize
        self.num_past_forcing_steps = num_past_forcing_steps
        self.num_future_forcing_steps = num_future_forcing_steps
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.train_dataset = None
        self.val_dataset = None
        self.test_dataset = None

    def setup(self, stage=None):
        """Build the datasets of `stage`: "fit" (train and val), "train"
        (train only), "test", or None (all three)."""
        common = dict(
            datastore=self._datastore,
            standardize=self.standardize,
            num_past_forcing_steps=self.num_past_forcing_steps,
            num_future_forcing_steps=self.num_future_forcing_steps,
        )
        if stage in ("fit", "train", None):
            self.train_dataset = WeatherDataset(
                split="train", ar_steps=self.ar_steps_train, **common)
        if stage in ("fit", None):
            self.val_dataset = WeatherDataset(
                split="val", ar_steps=self.ar_steps_eval, **common)
        if stage in ("test", None):
            self.test_dataset = WeatherDataset(
                split="test", ar_steps=self.ar_steps_eval, **common)

    def train_dataloader(self, seed=0):
        return WeatherDataLoader(self.train_dataset,
                                 batch_size=self.batch_size, shuffle=True,
                                 seed=seed, num_workers=self.num_workers,
                                 shard=self.shard)

    def val_dataloader(self):
        return WeatherDataLoader(self.val_dataset, batch_size=self.batch_size,
                                 drop_last=False,
                                 num_workers=self.num_workers,
                                 shard=self.shard)

    def test_dataloader(self):
        return WeatherDataLoader(self.test_dataset,
                                 batch_size=self.batch_size, drop_last=False,
                                 num_workers=self.num_workers,
                                 shard=self.shard)
