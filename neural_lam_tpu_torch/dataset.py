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

`WeatherDataLoader` collates fixed-shape numpy batches in the caller's
thread, with seeded shuffling; the JAX package's standardized-slab cache,
prefetch threads and worker pool are host tuning, not semantics, and are
not copied.
"""

from __future__ import annotations

import warnings

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

    def _forcing_windows(self, idx):
        """(ar_steps, N, d_f * W) windowed forcing, feature-major."""
        init_steps = 2
        past = self.num_past_forcing_steps
        future = self.num_future_forcing_steps
        n_steps = self.ar_steps
        W = past + future + 1
        if self.datastore.is_forecast:
            offset = max(init_steps, past)
            da = self.da_forcing.isel(analysis_time=idx)
            buf = da.values[offset - past:offset + n_steps + future]
        else:
            offset = idx + max(init_steps, past)
            buf = self.da_forcing.isel(
                time=slice(offset - past, offset + n_steps + future)).values
        buf = np.asarray(buf, np.float32)
        if self.standardize:
            buf = (buf - self.da_forcing_mean) * self._forcing_inv_std
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
        state, times = self._state_slice(idx)
        if self.standardize:
            state = (state - self.da_state_mean) * self._state_inv_std
        target_times = times[2:].astype("datetime64[ns]").astype(np.int64)
        if self.da_forcing is not None:
            forcing = self._forcing_windows(idx)
        else:
            forcing = np.empty((self.ar_steps, state.shape[1], 0),
                               dtype=np.float32)
        return (state[:2], state[2:], forcing, target_times)


def collate(samples):
    """Stack samples into fixed-shape numpy batch arrays."""
    return tuple(np.stack(parts, axis=0) for parts in zip(*samples))


class WeatherDataLoader:
    """Batch iterator with seeded shuffling (ref: weather_dataset.py:665-696).

    Shuffled order is numpy's `default_rng((seed, epoch)).permutation`, as
    in the JAX package, so both packages see the same batches. drop_last
    keeps every training batch the same shape; evaluation loaders keep the
    last partial batch.
    """

    def __init__(self, dataset: WeatherDataset, batch_size=4, shuffle=False,
                 seed=0, drop_last=True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _batch_indices(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng((self.seed, self.epoch)).permutation(n)
        return [order[i:i + self.batch_size]
                for i in range(0, len(self) * self.batch_size,
                               self.batch_size)]

    def __iter__(self):
        for b in self._batch_indices():
            yield collate([self.dataset[int(i)] for i in b])


class WeatherDataModule:
    """Train/val/test datasets and loaders (ref: weather_dataset.py:603-696)."""

    def __init__(self, datastore: BaseDatastore, ar_steps_train=3,
                 ar_steps_eval=25, standardize=True, num_past_forcing_steps=1,
                 num_future_forcing_steps=1, batch_size=4):
        self._datastore = datastore
        self.ar_steps_train = ar_steps_train
        self.ar_steps_eval = ar_steps_eval
        self.standardize = standardize
        self.num_past_forcing_steps = num_past_forcing_steps
        self.num_future_forcing_steps = num_future_forcing_steps
        self.batch_size = batch_size
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
                                 seed=seed)

    def val_dataloader(self):
        return WeatherDataLoader(self.val_dataset, batch_size=self.batch_size,
                                 drop_last=False)

    def test_dataloader(self):
        return WeatherDataLoader(self.test_dataset,
                                 batch_size=self.batch_size, drop_last=False)
