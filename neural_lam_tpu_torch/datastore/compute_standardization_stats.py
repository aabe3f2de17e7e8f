"""Pre-compute standardization statistics for the MEPS npy datastore.

Counterpart of neural_lam_tpu/datastore/compute_standardization_stats.py,
over the port's `WeatherDataset` and `NpyFilesDatastoreMEPS`: for the same
files it writes the same five `.pt` files, bit for bit. Host code: it
takes no device.

ref: neural_lam/datastore/npyfilesmeps/compute_standardization_stats.py —
two passes over the train split:

1. raw pass: per-feature mean/std of the state and of the TOA flux
   (saved as parameter_mean.pt / parameter_std.pt / flux_stats.pt);
2. standardized pass: mean/std of one-step differences of the *standardized*
   state, with subsample-stride handling (ref: :302-325) — diffs taken at
   `--step_length` strides starting from every offset.

Stats are saved with torch.save for byte-format parity with the reference
(the datastore reads them back with torch.load). The reference optionally
distributes this over SLURM ranks with NCCL/Gloo (ref: :53-91); here:

* `--n_workers N` maps samples over a thread pool on one machine — the
  per-sample work is npy mmap reads + numpy reductions, both of which
  release the GIL — reduced in sample order, so the outputs are
  bit-identical for any worker count (the reference's rank-merge is
  order-dependent instead);
* `--num_shards N --shard_id i` is the multi-NODE mode (one process per
  node, e.g. `--shard_id $SLURM_PROCID --num_shards $SLURM_NTASKS`):
  each shard reduces its strided sample subset to float64 partial sums
  in `static/stats_part_<i>of<N>.npz`, and whichever shard finds all
  partials present performs the merge — no process group or network
  backend needed, matching the reference's SLURM use case.

CLI: python -m neural_lam_tpu_torch.datastore.compute_standardization_stats
     --datastore_config_path <data_config.yaml> [--n_workers N]
     [--num_shards N --shard_id i [--job_tag TAG]]
"""

from __future__ import annotations

import os
from argparse import ArgumentParser
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..dataset import WeatherDataset
from .npyfilesmeps import NpyFilesDatastoreMEPS


def _map_samples(ds, fn, n_workers: int):
    """Map fn over dataset samples, yielding results in index order."""
    if n_workers <= 1:
        for i in range(len(ds)):
            yield fn(ds[i])
        return
    with ThreadPoolExecutor(max_workers=n_workers) as pool:
        yield from pool.map(lambda i: fn(ds[i]), range(len(ds)))


def _train_dataset(datastore, standardize):
    """The train split as whole forecasts (ar_steps = T - 2), without
    forcing windows."""
    return WeatherDataset(
        datastore=datastore, split="train",
        ar_steps=datastore.config.dataset.num_timesteps - 2,
        standardize=standardize, num_past_forcing_steps=0,
        num_future_forcing_steps=0,
    )


def _raw_moments(item):
    """Per-feature mean and mean square of a sample's states, and the mean
    and mean square of its TOA flux."""
    init_states, target_states, forcing, _ = item
    sample = np.concatenate([init_states, target_states], axis=0)
    flux = forcing[:, :, 0]
    return (sample.mean(axis=(0, 1)), (sample**2).mean(axis=(0, 1)),
            flux.mean(), (flux**2).mean())


def _diff_moments(step_length, T):
    """fn(item) -> [(mean, mean square) of one-step differences] for each
    subsample offset: strided subsampling from every offset
    (ref: :316-324)."""
    used_subsample_len = (T // step_length) * step_length

    def fn(item):
        init_states, target_states, _, _ = item
        sample = np.concatenate([init_states, target_states], axis=0)
        out = []
        for ss_i in range(step_length):
            sub = sample[ss_i:used_subsample_len:step_length]
            diffs = sub[1:] - sub[:-1]
            out.append((diffs.mean(axis=(0, 1)),
                        (diffs**2).mean(axis=(0, 1))))
        return out

    return fn


def _shard_indices(n, num_shards, shard_id):
    return range(shard_id, n, num_shards)


def _map_shard(ds, fn, n_workers, num_shards, shard_id):
    """Like _map_samples but over this shard's strided sample subset."""
    idxs = list(_shard_indices(len(ds), num_shards, shard_id))
    if n_workers <= 1:
        for i in idxs:
            yield fn(ds[i])
        return
    with ThreadPoolExecutor(max_workers=n_workers) as pool:
        yield from pool.map(lambda i: fn(ds[i]), idxs)


def _part_path(static_dir_path, shard_id, num_shards, job_tag):
    return static_dir_path / (
        f"stats_part_{shard_id}of{num_shards}.{job_tag}.npz"
    )


def _atomic_torch_save(tensor, path):
    # pid-unique tmp: with strided shards, several processes may reach the
    # merge simultaneously; a shared tmp path would let a second writer
    # truncate the first mid-write and publish a corrupt .pt via os.replace
    tmp = path.with_suffix(path.suffix + f".tmp.{os.getpid()}")
    torch.save(tensor, tmp)
    os.replace(tmp, path)


def _merge_parts(static_dir_path, num_shards, job_tag):
    """Combine all shard partials (float64 sums + counts) and write the
    final .pt stats — the filesystem-based analogue of the reference's
    rank-merge (ref: compute_standardization_stats.py:223-260
    all_gather_object + rank-0 reduce). Partials are tagged with the
    job's `job_tag` so a re-run never mixes another run's leftovers, and
    the final files are written atomically (pid-unique tmp + os.replace),
    so concurrent merges are safe: each merger writes its own tmp and the
    last os.replace wins with identical content."""
    parts = [_part_path(static_dir_path, i, num_shards, job_tag)
             for i in range(num_shards)]
    if not all(p.exists() for p in parts):
        done = sum(p.exists() for p in parts)
        print(f"{done}/{num_shards} shard partials present (tag "
              f"{job_tag}); merge will run when the last shard finishes")
        return False
    acc = None
    for p in parts:
        with np.load(p) as z:
            d = {k: z[k] for k in z.files}
        acc = d if acc is None else {k: acc[k] + d[k] for k in acc}
    mean = acc["mean_sum"] / acc["n"]
    std = np.sqrt(acc["sq_sum"] / acc["n"] - mean**2)
    flux_mean = float(acc["flux_mean_sum"] / acc["n"])
    flux_std = float(np.sqrt(acc["flux_sq_sum"] / acc["n"]
                             - flux_mean**2))
    # shards accumulate RAW one-step-difference moments; diffs of
    # standardized data are raw diffs / std (the mean cancels), so the
    # standardization is applied here with the MERGED std
    diff_mean = acc["diff_mean_sum"] / acc["n_diff"] / std
    diff_second = acc["diff_sq_sum"] / acc["n_diff"] / std**2
    diff_std = np.sqrt(diff_second - diff_mean**2)

    _atomic_torch_save(torch.tensor(mean, dtype=torch.float32),
                       static_dir_path / "parameter_mean.pt")
    _atomic_torch_save(torch.tensor(std, dtype=torch.float32),
                       static_dir_path / "parameter_std.pt")
    _atomic_torch_save(torch.tensor([flux_mean, flux_std],
                                    dtype=torch.float32),
                       static_dir_path / "flux_stats.pt")
    _atomic_torch_save(torch.tensor(diff_mean, dtype=torch.float32),
                       static_dir_path / "diff_mean.pt")
    _atomic_torch_save(torch.tensor(diff_std, dtype=torch.float32),
                       static_dir_path / "diff_std.pt")
    print(f"Merged {num_shards} shard partials into final stats at "
          f"{static_dir_path}")
    return True


def _main_sharded(datastore, static_dir_path, step_length, n_workers,
                  num_shards, shard_id, job_tag):
    """Multi-node mode: each shard reduces its strided sample subset to
    float64 partial sums, writes stats_part_<i>of<N>.<tag>.npz, and
    whichever shard finds all partials present performs the merge. Launch
    one process per node (e.g. SLURM: --shard_id $SLURM_PROCID
    --num_shards $SLURM_NTASKS); no process group needed. The tag
    (default: $SLURM_JOB_ID, else "0") isolates runs from each other's
    leftover partials — use a fresh tag per run."""
    T = datastore.config.dataset.num_timesteps
    ds = _train_dataset(datastore, standardize=False)

    n_feat = datastore.get_num_data_vars("state")
    part = {
        "mean_sum": np.zeros(n_feat, np.float64),
        "sq_sum": np.zeros(n_feat, np.float64),
        "flux_mean_sum": np.zeros((), np.float64),
        "flux_sq_sum": np.zeros((), np.float64),
        "n": np.zeros((), np.float64),
        "diff_mean_sum": np.zeros(n_feat, np.float64),
        "diff_sq_sum": np.zeros(n_feat, np.float64),
        "n_diff": np.zeros((), np.float64),
    }
    for m, sq, fm, fsq in _map_shard(ds, _raw_moments, n_workers,
                                     num_shards, shard_id):
        part["mean_sum"] += m
        part["sq_sum"] += sq
        part["flux_mean_sum"] += fm
        part["flux_sq_sum"] += fsq
        part["n"] += 1

    # pass 2 would need the GLOBAL pass-1 std to standardize, which no
    # shard has before the merge. Diffs of standardized data are exactly
    # raw diffs / std (the mean cancels), so shards accumulate RAW diff
    # moments and _merge_parts applies the merged std.
    for per_offset in _map_shard(ds, _diff_moments(step_length, T),
                                 n_workers, num_shards, shard_id):
        for dm, dsq in per_offset:
            part["diff_mean_sum"] += dm
            part["diff_sq_sum"] += dsq
            part["n_diff"] += 1

    os.makedirs(static_dir_path, exist_ok=True)
    out = _part_path(static_dir_path, shard_id, num_shards, job_tag)
    tmp = out.with_suffix(".tmp.npz")
    np.savez(tmp, **part)
    os.replace(tmp, out)
    print(f"Wrote shard partial {out}")
    _merge_parts(static_dir_path, num_shards, job_tag)


def main(datastore_config_path, step_length=3, n_workers=1, num_shards=1,
         shard_id=0, job_tag=None):
    datastore = NpyFilesDatastoreMEPS(config_path=datastore_config_path)
    static_dir_path = Path(datastore_config_path).parent / "static"
    os.makedirs(static_dir_path, exist_ok=True)

    if num_shards > 1:
        if job_tag is None:
            job_tag = os.environ.get("SLURM_JOB_ID", "0")
        return _main_sharded(datastore, static_dir_path, step_length,
                             n_workers, num_shards, shard_id, job_tag)

    T = datastore.config.dataset.num_timesteps

    # --- pass 1: raw state / flux moments (ref: :201-268) ---
    ds = _train_dataset(datastore, standardize=False)
    means, squares, flux_means, flux_squares = [], [], [], []
    for m, sq, fm, fsq in _map_samples(ds, _raw_moments, n_workers):
        means.append(m)
        squares.append(sq)
        flux_means.append(fm)
        flux_squares.append(fsq)

    mean = np.stack(means).mean(axis=0)
    second = np.stack(squares).mean(axis=0)
    std = np.sqrt(second - mean**2)
    flux_mean = np.mean(flux_means)
    flux_second = np.mean(flux_squares)
    flux_std = np.sqrt(flux_second - flux_mean**2)

    torch.save(torch.tensor(mean, dtype=torch.float32),
               static_dir_path / "parameter_mean.pt")
    torch.save(torch.tensor(std, dtype=torch.float32),
               static_dir_path / "parameter_std.pt")
    torch.save(torch.tensor([flux_mean, flux_std], dtype=torch.float32),
               static_dir_path / "flux_stats.pt")
    print(f"Saved parameter_mean/std.pt and flux_stats.pt to {static_dir_path}")

    # --- pass 2: one-step-difference moments on standardized data
    # (ref: :275-331) ---
    # the datastore reads the .pt files just written: standardize with them
    ds_standard = _train_dataset(datastore, standardize=True)
    diff_means, diff_squares = [], []
    for per_offset in _map_samples(ds_standard, _diff_moments(step_length, T),
                                   n_workers):
        for dm, dsq in per_offset:
            diff_means.append(dm)
            diff_squares.append(dsq)

    diff_mean = np.stack(diff_means).mean(axis=0)
    diff_second = np.stack(diff_squares).mean(axis=0)
    diff_std = np.sqrt(diff_second - diff_mean**2)
    torch.save(torch.tensor(diff_mean, dtype=torch.float32),
               static_dir_path / "diff_mean.pt")
    torch.save(torch.tensor(diff_std, dtype=torch.float32),
               static_dir_path / "diff_std.pt")
    print(f"Saved diff_mean/std.pt to {static_dir_path}")


def cli(input_args=None):
    parser = ArgumentParser(
        description="Compute standardization statistics for npyfilesmeps"
    )
    parser.add_argument("--datastore_config_path", type=str, required=True)
    parser.add_argument("--step_length", type=int, default=3,
                        help="subsample step length (hours)")
    parser.add_argument("--n_workers", type=int, default=1,
                        help="thread-pool workers for the sample sweep")
    parser.add_argument("--num_shards", type=int, default=1,
                        help="multi-node mode: total number of shards; "
                             "each process reduces a strided sample "
                             "subset to a float64 partial and the last "
                             "one to finish merges (the reference's "
                             "SLURM rank-merge equivalent, ref: "
                             "compute_standardization_stats.py:53-91, "
                             "without a process group)")
    parser.add_argument("--shard_id", type=int, default=0,
                        help="this process's shard id (e.g. SLURM_PROCID)")
    parser.add_argument("--job_tag", type=str, default=None,
                        help="run tag embedded in partial filenames so a "
                             "re-run never merges another run's leftover "
                             "partials (default: $SLURM_JOB_ID, else 0; "
                             "use a fresh tag per run)")
    args = parser.parse_args(input_args)
    main(args.datastore_config_path, step_length=args.step_length,
         n_workers=args.n_workers, num_shards=args.num_shards,
         shard_id=args.shard_id, job_tag=args.job_tag)


if __name__ == "__main__":
    cli()
