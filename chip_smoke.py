#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero, and no
result line is printed), each printing its seconds:

1. Build every CUDA kernel of the forecast and training paths from `csrc/`
   with nvcc (one process per source, all started together); print the
   build time and each source's ptxas registers and spills (per kernel
   for K1's three (d_in up to 64, up to 128, above), K2's, K3's, P1's,
   P2's and P3's per K, with the registers and spill of K2/K3/P1/P2/P3's
   `edge_tc_kernel` instances summed per kernel, and the backward sources
   with two passes or two kernels: B2's and B3/B4's chain kernels of
   `edge_flat_bwd` per K, the decoder backward's and `xtd_sum`'s, and
   B1's two, for d_in up to 64 and above), and, where the toolkit has
   `cuobjdump`, the shared-memory loads by width, the FFMAs, the
   tensor-core products (HMMA) and the async copies (LDGSTS) in the SASS
   of B3/B4's K=8 chain kernel, of K3's, K2's, P3's, P2's and P1's K=8
   kernels and P1's K=1 kernel, of K1's kernel for d_in up to 64, of K4's K=4 kernel
   (`grid_update_kernel<4>`), of `xtd_sum`'s main kernel and of B1's
   kernel for d_in up to 64.
2. Build the bench-width GraphLAM and HiLAM through
   `neural_lam_tpu_torch.entry` (268x238 grid, 17 state / 6x3 forcing / 4
   static features, hidden 64, 4 processor layers, fp32, weights from a
   seeded generator; HiLAM on the 4-level hierarchical graph).
3. For each forward kernel, at the shapes those models give it: hold the
   kernel against its plain PyTorch version on the card (TF32 off), and
   time both with CUDA events beside the least time the card could take
   (for K1, K2, K3, P1, P2 and P3, whose products run on tensor cores in
   3xTF32, max(bytes, 3 x FLOP / TF32 peak), with the fp32 CUDA-core
   bound printed beside it, and their products as `torch.mm` calls, TF32
   off, as their library time); K1, K2, K3, P1, P2 and P3 also give
   bit-identical outputs in two calls. K1-K4 at GraphLAM's batch-4
   shapes; K1 also at d_in 23, 100 and 160 on a row count that is not a
   multiple of 16; K3 also at HiLAM's K=1 down[0] and non-identity up[0]
   sets (batch 4); K2, K3 and K4 (batch 4) and P1 and P2 (with and
   without messages) and P3 (batch 1 and 4) at every K from 1 to 8 on
   seeded local graphs (K = 3, 5, 6, 7 do not divide their 16-row tiles);
   K4 also at HiLAM's batch-4 m2g; P1-P3 (the batched route) at HiLAM's
   batch-1 shapes (P3 on m2m[0], P2 on m2g with and without messages and
   on g2m, P1 on down[0], down[1] and down[2] with and without messages)
   and at one batch-4 shape each (P1 on the top down set).
4. The same for each backward kernel (B1, B2, B3/B4, B5/B6) against its
   `*_bwd_plain` version: every output tensor within 1e-4 + 1e-4 * its
   plain version's max abs; B1 at the training step's call (no dx, as
   x_f is data) and with dx, and at d_in 23 (x rows not a multiple of 16
   bytes) and 100 (two x column blocks) with and without dx, two calls
   bit-identical, its bound max(bytes, 3 x FLOP / TF32 peak) (its
   products run on tensor cores in 3xTF32; the fp32 bound printed beside
   it) and its products as `torch.mm` calls its library time; B3/B4 also
   at HiLAM's K=1 down[0] and folded up[0] sets (batch 4); B2, B3/B4 and
   B5/B6 also at every K from 1 to 8 on phase 3's seeded local graphs
   (batch 4). B2, B3/B4 and B5/B6 run in two passes, a chain kernel and `xtd_sum` (the weight
   gradients): both passes' device times are printed apart, with their
   sum. `xtd_sum` is also held against
   `xtd_sum_plain` at the decoder's nine pairs, at B3/B4's two and at
   B2's one (same limit; two calls must give bit-identical outputs), with
   `torch.mm(X.t(), D)` over the same pairs timed as its library call,
   and swept over its blocks per SM at all three (1 up to what is resident,
   each value checked against `xtd_sum_plain`, then timed in three
   interleaved rounds); its reduce kernel (`xtd_reduce`) is held against
   `xtd_reduce_plain` at the decoder's partials, with one `index_add`
   of the same partials into their pairs' rows timed as its library
   call.
5. The forecast paths, each a 4-step rollout through `entry.forecast` with
   every launch counter set to 0 just before it, asserting the launches
   per predict step and finite output; then the time per predict step,
   the mesh-node updates/s (bench.py's metric: all levels' mesh nodes x
   processor layers x batch / step time), a torch.profiler breakdown of
   device time by kernel with the device's idle share, and the gap
   between one kernel-path and one plain-path predict step on the card:
   a. GraphLAM, batch 4 (flat route): K1/K2/K3/K4 1/1/4/1 per step;
   b. HiLAM, batch 4 (mixed route): K1/K2/K3/K4 1/1/31/1, P1/P3 1/30;
   c. HiLAM, batch 1 (batched route): P1/P2/P3 3/2/59;
   d. GraphLAM, batch 1 (batched route): P2/P3 2/4 (no profile, no gap).
6. Small models built on the CPU and on the card from one seed: the card's
   rollout (kernels) agrees with the CPU's (plain versions): GraphLAM
   16x16 on both routes (the dispatch as it is: batched; and its
   `_FLAT_MIN_VIRT` lowered to 1: flat), HiLAM 30x30 (2 levels) at batch
   1 and 2.
7. The training path at bench width, batch 4, for GraphLAM and then
   HiLAM: one AdamW step through `entry.train_steps` with every counter
   set to 0 just before it, asserting the launches and a finite loss;
   one step's parameter gradients on the kernel path against the plain
   path within 1e-3 * max abs; the training-step time (host clock around
   a synchronised step, median of 7 after warm-up), samples/s, peak
   device memory and a profiler breakdown of a step. Launches: GraphLAM
   1/1/4/1 of K1-K4 and of B1/B2/B3/B5, six of `xtd_sum`'s main kernel
   and six of its reduce kernel (the decoder's, B2's and one per
   processor layer); HiLAM (mixed route) the forward's of 5b, K1/K2/K3/K4
   1/1/31/1 and P1/P3 1/30, a backward kernel for each flat launch
   (B1/B2/B3/B5 1/1/31/1) and 33 of `xtd_sum`'s two kernels each (the
   decoder's, B2's and one per B3/B4 call); P1-P3 have no backward
   kernel, so this step runs P1's backward (the plain recompute) on the
   card.
8. Small models trained 3 AdamW steps on the card and on the CPU: the
   16x16 GraphLAM on both routes, the 30x30 HiLAM (2 levels) at batch 1
   (batched route) and at batch 2 with `_FLAT_MIN_VIRT` at 100 (mixed
   route): the loss trajectories agree within rtol 1e-4.
9. Serving and evaluation at full width through the entry points a user
   calls. The native chunk decoder is built with g++ (its time printed);
   a blosc chunk must raise. An MDP datastore (268x238 grid, 17 state / 6
   forcing / 4 static features, 3-hourly, splits of 12/6/10 time steps,
   zlib chunks) is written with the port's zarr writer in a temporary
   directory; `train.main` trains GraphLAM 2 steps at batch 4 (hidden 64,
   4 processor layers; it builds the multiscale graph under the
   datastore's root) and writes its `last` checkpoint; a HiLAM with
   seeded weights is saved through `checkpoint.save_checkpoint` (the
   hierarchical graph built the same way).
   Evaluation, with every counter set to 0 just before each call:
   `train.main --eval val` (batch 4, `--ar_steps_eval` 2: one partial
   batch of 1, P2/P3 4/8 and every other counter 0), its val_mean_loss
   finite and within 1e-4 relative of the same call through the plain
   versions; `train.main --eval test` for GraphLAM and HiLAM (5 test
   samples: a batch of 4 on the flat or mixed route and a partial batch
   of 1 on the batched route, 2 steps each; launches asserted), its files
   asserted, its csv error maps within 1e-3 x state_std, spatial maps
   within 1e-4 of their largest value and losses within 1e-4 relative of
   the same call through the plain versions; the CLI draws its figures
   (GraphLAM's with one example forecast) where matplotlib imports (the
   phase and the CLI say whether it does). Serving: `predict.main` forecasts 4 steps from
   the test split's last sample for each model, with every counter set to
   0 just before it: launches per step GraphLAM P2/P3 2/4, HiLAM P1/P2/P3
   3/2/59, every other counter 0. The written zarr reads back through the
   port's reader with shape (4, 63784, 17), finite values, the sample's
   valid times and the state feature names; standardized, it is within
   1e-3 of the same rollout through the plain versions on the card.
   Prints the CLI's init and rollout seconds, a warm rollout's time per
   step, the sample's read taken cold (chunk cache emptied; the native
   decoder must decode chunks) and warm, and the peak device memory of
   the CLI's forecast.

10. Datastores built by the port's tools, at full width. a. Raw source
   zarrs in the DANRA example's shape at the bench grid (height-level
   variables over an altitude coordinate, 4 of 5 altitudes selected;
   single-level state and forcing; a static mask; 30 3-hourly times,
   zlib chunks) and a datastore config (coord_ranges keeping 28 times,
   splits 12/6/10 with statistics on train, `output.compression: none`);
   `create_dataset(compression="lz4")` on a copy of the config must
   raise naming `--compression none` where libblosc is missing (and
   leave nothing), else write; `train.main` trains GraphLAM 2 steps on
   the config with its archive missing, so that `MDPDatastore` creates
   it (its seconds and MB printed; K1-K4, B1-B6 and `xtd_sum` must
   launch); the archive's state, forcing and static equal the sources
   restacked with numpy, its statistics are within 1e-6 relative of
   float64 numpy over the train window, and no array is blosc;
   `predict.main` forecasts 4 steps at batch 1 from the trained
   checkpoint (P2/P3 2/4 a step), finite, and, standardized, within
   1e-3 of the plain path. b. A MEPS npy datastore on its 268x238 grid
   (18 raw state features, one removed; 2 members; 3/1/1 analysis
   times; num_timesteps cut to 7): `compute_standardization_stats.cli`
   serially, with `--n_workers 4` (bit-identical) and with `--num_shards
   2`, shard 1 then 0 (within rtol 2e-5 / atol 2e-6 of the serial
   files), each timed; a seeded GraphLAM saved through
   `checkpoint.save_checkpoint` forecasts 4 steps at batch 1 through
   `predict.main` on it, as in a.

The last three lines are the `kernels` JSON, the card's name and power
limit as nvidia-smi reports them, and {"ok": true, "device": {...}}.
Imports nothing of JAX or of the JAX package.
"""

import contextlib
import functools
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

BENCH = dict(nx=268, ny=238, hidden_dim=64, processor_layers=4,
             n_features={"state": 17, "forcing": 6, "static": 4},
             n_timesteps=20)
BATCH = 4
STEPS = 4
WIDTH = ("--hidden_dim", "64", "--processor_layers", "4")
H = 64
FWD = ("embed_grid_flat", "edge_tail_sum_flat", "edge_layer_flat",
       "grid_update_flat")
BATCHED = ("edge_tail", "edge_tail_sum", "edge_layer")  # P1, P2, P3
SLEEP_CYCLES = 200_000_000  # ~0.1 s at the H100's 1.98 GHz boost clock
TRAIN_ONLY = ("xtd_sum", "xtd_reduce")  # kernels of the backward alone
PALLAS_EDGE = "neural_lam_tpu/ops/pallas_edge.py"
# K2, K3, P1, P2, P3: instances of the kernel template in csrc/edge_tc.cuh
TC_EDGE = ("edge_tail_sum_flat", "edge_layer_flat", "edge_tail",
           "edge_tail_sum", "edge_layer")


def fail(msg):
    raise RuntimeError(msg)


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def peaks(device_name):
    """(fp32 FLOP/s without tensor cores, TF32 FLOP/s on tensor cores
    (dense), memory bytes/s, label) from the data sheet of the named
    card."""
    if "H100" in device_name and "PCIe" in device_name:
        return (51.2e12, 378e12, 2.0e12,
                "H100 PCIe: 51.2 TFLOP/s fp32, 378 TFLOP/s TF32, 2.0 TB/s")
    if "H100" in device_name and "NVL" in device_name:
        return (60e12, 417.5e12, 3.9e12,
                "H100 NVL: 60 TFLOP/s fp32, 417.5 TFLOP/s TF32, 3.9 TB/s")
    return (67e12, 495e12, 3.35e12,
            "H100 SXM: 67 TFLOP/s fp32, 495 TFLOP/s TF32, 3.35 TB/s")


def cuda_ms(torch, fn, reps, queued=True):
    """Mean ms per call over `reps` calls, from CUDA events, after a
    warm-up call.

    queued: the calls are queued behind a sleep kernel (`torch.cuda._sleep`)
    long enough for the host to enqueue all of them, so the events time the
    device work alone; fails if the host did not finish in time. Without
    it, a call whose host side (argument checks, ctypes, allocation) takes
    longer than its kernel is timed at its host cost."""
    fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    t0 = time.perf_counter()
    if queued:
        events[0].record()
        torch.cuda._sleep(SLEEP_CYCLES)
    events[1].record()
    for _ in range(reps):
        fn()
    events[2].record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    if queued and host_ms >= events[0].elapsed_time(events[1]):
        fail(f"the host took {host_ms:.1f} ms to queue {reps} calls, longer "
             "than the sleep kernel in front of them")
    return events[1].elapsed_time(events[2]) / reps


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def unique_nbytes(tensors):
    """Bytes of the distinct tensors among `tensors`: a tensor passed
    more than once (the same storage and size) is read once."""
    return nbytes(*{(t.data_ptr(), t.numel()): t for t in tensors}.values())


def xtd_sweep(torch, weight_grad, pairs, what, rounds=3):
    """xtd_sum's two kernels at each count of blocks per SM from 1 up to
    what is resident, on `pairs` (`what` names them): each held against
    xtd_sum_plain (1e-4 + 1e-4 * max|plain|), then timed in `rounds`
    interleaved rounds (queued, 10 calls each); prints each value's grid,
    segments, times and median."""
    dev = pairs[0][0].device
    ns = [x.shape[0] for x, _ in pairs]
    widths = [d.shape[1] for _, d in pairs]
    resident = weight_grad._occupancy(dev)[1]
    values = range(1, resident + 1)

    def run(v):
        return weight_grad.xtd_reduce(*weight_grad.xtd_partials(
            pairs, weight_grad.n_blocks(ns, dev, v)), widths)

    want = weight_grad.xtd_sum_plain(pairs)
    for v in values:
        for a, b in zip(run(v), want):
            if not bool(((a - b).abs() <= 1e-4 + 1e-4 * b.abs().max()).all()):
                fail(f"xtd_sum at {v} blocks per SM disagrees with plain")
    times = {v: [] for v in values}
    for _ in range(rounds):
        for v in values:
            times[v].append(cuda_ms(torch, lambda: run(v), 10))
    print(f"xtd_sum blocks per SM at {what} (shipped: "
          f"{weight_grad.BLOCKS_PER_SM}; {resident} resident; {rounds} "
          "interleaved rounds, ms):")
    for v, ts in times.items():
        blocks = weight_grad.n_blocks(ns, dev, v)
        n_seg = len(weight_grad.segments(ns, blocks))
        print(f"  {v}: {blocks} blocks, {n_seg} segments; "
              f"{', '.join(f'{t:.4f}' for t in ts)}; median "
              f"{sorted(ts)[len(ts) // 2]:.4f}")


def read_yardstick(torch, pairs, what):
    """The card's read rate on xtd_sum's bytes at `pairs`: one torch.sum
    per distinct tensor, timed queued (10 rounds)."""
    distinct = list({(t.data_ptr(), t.numel()): t
                     for p in pairs for t in p}.values())
    ms = cuda_ms(torch, lambda: [t.sum() for t in distinct], 10)
    print(f"read yardstick at {what}: torch.sum over its {len(distinct)} "
          f"distinct tensors ({nbytes(*distinct) / 1e6:.1f} MB) {ms:.4f} ms, "
          f"{nbytes(*distinct) / ms / 1e9:.3f} TB/s")


def kernel_name(mangled):
    """`name<args>` of a mangled kernel entry name (its integer and bool
    template arguments), tagged K1, K2, K3, B1, P1, P2, P3, or as B2's or
    B3/B4's chain kernel of edge_flat_bwd."""
    for m in re.finditer(r"(?=(\d+)([a-z]\w*))", mangled):
        n = int(m.group(1))
        name, rest = m.group(2)[:n], m.group(2)[n:]
        if len(name) == n and name.endswith("_kernel"):
            break
    else:
        return mangled[:60]
    args = re.findall(r"L[ib](\d+)E", re.match(r"I?(?:L[ib]\d+E)*",
                                              rest).group(0))
    tag = {"edge_tail_bwd_kernel": "B2 chain ",
           "edge_layer_bwd_kernel": "B3/B4 chain ", "embed_kernel": "K1 ",
           "embed_bwd_kernel": "B1 ",
           # <K, kMode (TAIL_SUM 0, LAYER 1, X0 2), kBatched>
           "edge_tc_kernel": {("1", "0"): "K3 ", ("0", "0"): "K2 ",
                              ("1", "1"): "P3 ", ("0", "1"): "P2 ",
                              ("2", "1"): "P1 "}.get(tuple(args[1:]), ""),
           }.get(name, "")
    return f"{tag}{name}" + (f"<{', '.join(args)}>" if args else "")


@functools.lru_cache(maxsize=None)
def sass_of(tool, lib):
    """The SASS of every kernel of `lib`, by cuobjdump."""
    return subprocess.run([tool, "-sass", str(lib)], check=True,
                          capture_output=True, text=True,
                          timeout=120).stdout


def sass_counts(_build, lib, fn_part):
    """Shared-memory loads by width (LDS, LDS.64, LDS.128), FFMAs,
    tensor-core products (HMMA) and async copies to shared memory (LDGSTS)
    in the SASS of the kernel of `lib` whose mangled name holds `fn_part`,
    read with the toolkit's cuobjdump; says so where there is none."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        print(f"  SASS of {fn_part}: no cuobjdump beside nvcc")
        return
    sass = sass_of(tool, lib)
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        if fn_part in part.split("\n", 1)[0]:
            ops = re.findall(r"\b(LDS(?:\.U)?(?:\.\d+)?|FFMA"
                             r"|HMMA(?:\.\w+)*|LDGSTS(?:\.\w+)*)\b", part)
            n = {k: ops.count(k) for k in sorted(set(ops))}
            print(f"  SASS of {kernel_name(part.split()[0])}: {n}")
            return
    print(f"  SASS of {fn_part}: no such function in {lib}")


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def profile(torch, step, what, steps=3, top=12):
    """Device time by kernel over `steps` calls of `step` (torch.profiler),
    and the device's busy share of the profiled window's wall time (the
    profiler's own host overhead lengthens that window)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    step()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps

    def dev_us(e):
        v = getattr(e, "self_device_time_total", None)
        return v if v is not None else getattr(e, "self_cuda_time_total", 0)

    # device-side kernel events only: a host op's row, and a user
    # annotation's device range (e.g. "Optimizer.step#AdamW.step"), repeat
    # the time of the kernels inside them (kernel names may hold "#" too,
    # as in "{lambda(float)#1}")
    def annotation(e):
        return (getattr(e, "is_user_annotation", False)
                or re.fullmatch(r"[\w.]+#[\w.]+", e.key) is not None)

    rows = sorted(((dev_us(e), e.count, e.key) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not annotation(e) and dev_us(e) > 0), reverse=True)
    if not rows:
        print(f"profile of {what}: the profiler recorded no device time "
              "(device busy share not measured)")
        return
    busy_ms = sum(r[0] for r in rows) / 1e3 / steps
    print(f"profile of {steps} {what}s: device busy {busy_ms:.3f} "
          f"ms/{what} of {wall_ms:.3f} ms wall/{what} under the profiler "
          f"(idle share {1 - busy_ms / wall_ms:.3f})")
    for us, count, key in rows[:top]:
        print(f"  {us / 1e3 / steps:.4f} ms/{what}  {count / steps:g} "
              f"calls/{what}  {key[:90]}")


def write_mdp_datastore(root, np, nx=268, ny=238, n_t=28, seed=0):
    """An MDP ("training-ready" zarr) datastore laid out as the repo's test
    fixture lays it out, at the bench grid: 17 state, 6 forcing and 4
    static features, 3-hourly times split 12/6/10 into train/val/test,
    statistics over the train split, chunks zlib-compressed (level 1).
    Writes <root>/mdp.datastore.{yaml,zarr} and <root>/config.yaml (JSON,
    which YAML readers take); returns the config's path."""
    from neural_lam_tpu_torch.datastore.zarr_reader import (
        consolidate_metadata,
        write_zarr_array,
    )

    zlib = {"id": "zlib", "level": 1}
    rng = np.random.default_rng(seed)
    zarr = root / "mdp.datastore.zarr"
    n_grid = nx * ny
    feats = {"state": 17, "forcing": 6, "static": 4}
    times = np.datetime64("2020-01-01T00", "ns") + np.arange(n_t) \
        * np.timedelta64(3, "h")
    xx, yy = np.meshgrid(np.arange(nx) * 2500.0, np.arange(ny) * 2500.0,
                         indexing="ij")
    state = np.cumsum(0.2 * rng.standard_normal(
        (n_t, n_grid, feats["state"]), dtype=np.float32), axis=0) \
        + rng.standard_normal((1, n_grid, feats["state"]),
                              dtype=np.float32)
    forcing = rng.standard_normal((n_t, n_grid, feats["forcing"]),
                                  dtype=np.float32)
    write_zarr_array(zarr, "time", times, dims=["time"], compressor=zlib)
    write_zarr_array(zarr, "x", xx.reshape(-1), dims=["grid_index"],
                     compressor=zlib)
    write_zarr_array(zarr, "y", yy.reshape(-1), dims=["grid_index"],
                     compressor=zlib)
    for cat, arr in (("state", state), ("forcing", forcing)):
        write_zarr_array(zarr, cat, arr,
                         dims=["time", "grid_index", f"{cat}_feature"],
                         chunks=[2, n_grid, feats[cat]], compressor=zlib)
    write_zarr_array(zarr, "static", rng.standard_normal(
        (n_grid, feats["static"]), dtype=np.float32),
        dims=["grid_index", "static_feature"], compressor=zlib)
    for cat, n in feats.items():
        names = np.array([f"{cat}_var_{i}" for i in range(n)], dtype=object)
        for suffix, vals in (("", names), ("_units", ["-"] * n),
                             ("_long_name", [f"long {v}" for v in names])):
            write_zarr_array(zarr, f"{cat}_feature{suffix}",
                             np.array(vals, dtype=object),
                             dims=[f"{cat}_feature"], compressor=None)
    bounds = [(0, 11), (12, 17), (18, n_t - 1)]
    write_zarr_array(zarr, "splits", np.array(
        [[str(times[i].astype("datetime64[s]")) for i in b] for b in bounds],
        dtype=object), dims=["split_name", "split_part"], compressor=None)
    write_zarr_array(zarr, "split_name", np.array(
        ["train", "val", "test"], dtype=object), dims=["split_name"],
        compressor=None)
    write_zarr_array(zarr, "split_part", np.array(
        ["start", "end"], dtype=object), dims=["split_part"],
        compressor=None)
    train = state[:12]
    diffs = np.diff(train, axis=0)
    for name, arr, dim in (
            ("state__train__mean", train.mean(axis=(0, 1)), "state"),
            ("state__train__std", train.std(axis=(0, 1)), "state"),
            ("state__train__diff_mean", diffs.mean(axis=(0, 1)), "state"),
            ("state__train__diff_std", diffs.std(axis=(0, 1)), "state"),
            ("forcing__train__mean", forcing[:12].mean(axis=(0, 1)),
             "forcing"),
            ("forcing__train__std", forcing[:12].std(axis=(0, 1)),
             "forcing")):
        write_zarr_array(zarr, name, arr, dims=[f"{dim}_feature"],
                         compressor=zlib)
    consolidate_metadata(zarr)
    (root / "mdp.datastore.yaml").write_text(json.dumps({
        "schema_version": "v0.5.0", "dataset_version": "v0.1.0",
        "inputs": {"danra_surface": {
            "path": "unused://", "dims": ["time", "x", "y"],
            "dim_mapping": {"grid_index": {"method": "stack",
                                           "dims": ["x", "y"]}}}},
        "extra": {"projection": {
            "class_name": "LambertConformal",
            "kwargs": {"central_longitude": 25.0,
                       "central_latitude": 56.7}}}}))
    config = root / "config.yaml"
    config.write_text(json.dumps({"datastore": {
        "kind": "mdp", "config_path": "mdp.datastore.yaml"}}))
    return config


def median_ms(torch, fn, n=3):
    """Median host ms of n synchronised calls of fn."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sorted(times)[n // 2] * 1e3


def quiet(fn, *args):
    """fn(*args) with its standard output printed after it, each line
    prefixed (the CLIs print JSON lines of their own), also when it
    raises."""
    import io

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            return fn(*args)
    finally:
        for line in buf.getvalue().splitlines():
            print(f"  | {line}")


def eval_phase(torch, np, root, cfg, width, counts, reset_counts,
               plain_kernels, zero):
    """Phase 9's evaluation through the CLI: `train.main --eval val` on
    the trained GraphLAM, then `train.main --eval test` for it and for the
    seeded HiLAM at batch 4 and `--ar_steps_eval` 2, each through the
    kernels (launches counted) and through the plain versions, their
    outputs compared."""
    import importlib.util

    from neural_lam_tpu_torch import train
    from neural_lam_tpu_torch.config import load_config_and_datastore
    from neural_lam_tpu_torch.dataset import WeatherDataset

    L = 4
    paths = (("kernels", contextlib.nullcontext), ("plain", plain_kernels))
    # the val split (6 steps) gives one sample at --ar_steps_eval 2: one
    # partial batch of 1, on the batched route (P2/P3 2/4 a step)
    argv = ["--config_path", str(cfg), *width, "--batch_size", "4",
            "--ar_steps_eval", "2", "--val_steps_to_log", "1", "2",
            "--save_dir", str(root / "models")]
    val_argv = argv + ["--model", "graph_lam", "--graph", "multiscale",
                       "--load", str(root / "models" / "graph_lam" / "last"),
                       "--eval", "val"]
    val = {}
    for path, ctx in paths:
        reset_counts()
        t0 = time.time()
        with ctx():
            val[path] = quiet(train.main,
                              val_argv + ["--run_name", f"val_{path}"])
        torch.cuda.synchronize()
        got = counts()
        print(f"train.main --eval val ({path}): {time.time() - t0:.2f} s; "
              f"val_mean_loss {val[path]['val_mean_loss']!r}; launches "
              f"{ {k: n for k, n in got.items() if n} }")
        if path == "kernels":
            want = dict(zero, edge_tail_sum=2 * 2, edge_layer=2 * L)
            if got != want:
                fail(f"train.main --eval val: launch counts {got}, want "
                     f"{want}")
    v, w = val["kernels"]["val_mean_loss"], val["plain"]["val_mean_loss"]
    print(f"train.main --eval val: kernels within {abs(v - w) / abs(w):.3e} "
          "relative of the plain path (limit 1e-4)")
    if not (math.isfinite(v) and abs(v - w) <= 1e-4 * abs(w)):
        fail("train.main --eval val: kernels and plain path disagree")

    config, ds = load_config_and_datastore(cfg)
    std = ds.get_standardization_dataarray("state")["state_std"]
    n_vars = len(std)
    n_samples = len(WeatherDataset(ds, split="test", ar_steps=2))
    n_batches = -(-n_samples // 4)
    plots = importlib.util.find_spec("matplotlib") is not None
    print("matplotlib " + ("imports: the test CLI draws its figures"
                           if plots else "is not installed: the test CLI "
                           "draws no figures"))
    # the test split (10 steps) gives 5 samples: a batch of 4 on the flat
    # route (K1-K4 1/1/4/1 a step; HiLAM's mixed route 1/1/31/1 and P1/P3
    # 1/30) and a partial batch of 1 on the batched route (GraphLAM P2/P3
    # 2/4, HiLAM P1/P2/P3 3/2/59 a step), 2 steps each; with figures, the
    # example forecast runs the batch of 4 once more
    full_g = {"embed_grid_flat": 2, "edge_tail_sum_flat": 2,
              "edge_layer_flat": 2 * L, "grid_update_flat": 2}
    for model, graph, ckpt, examples, full, part in (
            ("graph_lam", "multiscale", "graph_lam/last", 1, full_g,
             {"edge_tail_sum": 4, "edge_layer": 2 * L}),
            ("hi_lam", "hierarchical", "hi_lam", 0,
             dict(full_g, edge_layer_flat=2 * (3 + 7 * L), edge_tail=2,
                  edge_layer=2 * (2 + 7 * L)),
             {"edge_tail": 6, "edge_tail_sum": 4,
              "edge_layer": 2 * (3 + 14 * L)})):
        want = dict(zero)
        for part_counts in (full, part) + ((full,) if plots else ()):
            for k, n in part_counts.items():
                want[k] += n
        test_argv = argv + [
            "--model", model, "--graph", graph, "--load",
            str(root / "models" / ckpt), "--eval", "test",
            "--n_example_pred", str(examples)]
        out, dirs = {}, {}
        for path, ctx in paths:
            run = f"test_{model}_{path}"
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            with ctx():
                out[path] = quiet(train.main, test_argv + ["--run_name", run])
            torch.cuda.synchronize()
            dt = time.time() - t0
            got = counts()
            print(f"train.main --eval test {model} ({path}): {dt:.2f} s for "
                  f"{n_samples} samples in {n_batches} batches, "
                  f"{dt * 1e3 / n_batches:.1f} ms a batch (host clock; the "
                  "graph, model and checkpoint set-up, the batches' reads "
                  "and the files' writes included"
                  + (", and the figures" if plots else "") + f"); launches "
                  f"{ {k: n for k, n in got.items() if n} }")
            if path == "kernels" and got != want:
                fail(f"train.main --eval test {model}: launch counts {got}, "
                     f"want {want}")
            dirs[path] = root / "models" / run
            files = sorted(f.name for f in dirs[path].iterdir())
            expect = ["mean_spatial_loss.npy", "metrics.jsonl",
                      "spatial_loss_t1.npy", "spatial_loss_t2.npy",
                      "test_mae.csv", "test_rmse.csv"]
            if plots:
                expect += ["spatial_loss_t1.pdf", "spatial_loss_t2.pdf",
                           "test_mae.pdf", "test_rmse.pdf"]
            if plots and examples:
                expect += ["example_pred_1.npy", "example_target_1.npy"] + [
                    f"example_1_{v}_t{t}.png"
                    for v in ds.get_vars_names("state") for t in (1, 2)]
            if files != sorted(expect):
                fail(f"train.main --eval test {model} ({path}): files "
                     f"{files}, want {sorted(expect)}")
        gaps = {}
        for name in ("test_rmse.csv", "test_mae.csv"):
            a, b = (np.loadtxt(d / name, delimiter=",", ndmin=2)
                    for d in (dirs["kernels"], dirs["plain"]))
            if a.shape != (2, n_vars) or not np.isfinite(a).all():
                fail(f"train.main --eval test {model}: {name} {a.shape}, "
                     f"finite {np.isfinite(a).all()}")
            gaps[name] = float((np.abs(a - b) / std).max())
            if not gaps[name] <= 1e-3:
                fail(f"train.main --eval test {model}: {name} differs from "
                     "the plain path by more than 1e-3 x state_std")
        for name in ("mean_spatial_loss.npy", "spatial_loss_t1.npy",
                     "spatial_loss_t2.npy"):
            a, b = (np.load(d / name) for d in (dirs["kernels"],
                                                 dirs["plain"]))
            gaps[name] = float(np.abs(a - b).max() / np.abs(b).max())
            if not (np.isfinite(a).all() and gaps[name] <= 1e-4):
                fail(f"train.main --eval test {model}: {name} differs from "
                     "the plain path by more than 1e-4 of its largest value")
        for k, v in out["kernels"].items():
            if k.startswith("test_mean_loss") or k.startswith("test_loss"):
                w = float(out["plain"][k])
                gaps[k] = abs(float(v) - w) / abs(w)
                if not (math.isfinite(float(v)) and gaps[k] <= 1e-4):
                    fail(f"train.main --eval test {model}: {k} {v} differs "
                         f"from the plain path's {w} by more than 1e-4 "
                         "relative")
        print(f"train.main --eval test {model}: test_mean_loss "
              f"{float(out['kernels']['test_mean_loss'])!r}; kernels vs "
              f"plain path: " + ", ".join(f"{k} {g:.3e}"
                                           for k, g in gaps.items())
              + " (limits: csv 1e-3 x state_std, maps 1e-4 x max, losses "
              "1e-4 relative)")
        gc.collect()
        torch.cuda.empty_cache()


def serving_phase(torch, np, counts, reset_counts, plain_kernels, zero):
    """Phase 9: train GraphLAM 2 steps through `train.main` and save a
    seeded HiLAM on an MDP datastore at full width, then forecast with
    each through `predict.main`, counting the launches, reading the zarr
    back, and holding it against the plain path on the card."""
    import tempfile
    from pathlib import Path

    from neural_lam_tpu_torch import native, predict, train
    from neural_lam_tpu_torch.checkpoint import save_checkpoint
    from neural_lam_tpu_torch.config import load_config_and_datastore
    from neural_lam_tpu_torch.dataset import WeatherDataset
    from neural_lam_tpu_torch.datastore.zarr_reader import (
        ZarrGroup,
        _chunk_cache,
    )
    from neural_lam_tpu_torch.graph.storage import load_or_build_graph
    from neural_lam_tpu_torch.models import MODELS
    from neural_lam_tpu_torch.models.ar_model import ModelArgs

    width = ["--hidden_dim", "64", "--processor_layers", "4"]
    built = native.lib_path().exists()
    t0 = time.time()
    native.library()
    print(f"chunk decoder {native.lib_path().name} "
          f"{'found' if built else 'built with g++'} and loaded in "
          f"{time.time() - t0:.2f} s")
    # a blosc chunk raises: on a machine without libblosc because the
    # library cannot be opened, else because these bytes are no blosc
    # frame
    try:
        native.decode_chunks_parallel([bytes(16)] * 2,
                                      [native.CODEC_BLOSC] * 2, 16)
    except ValueError as e:
        print(f"a blosc chunk: {e}")
    else:
        fail("the chunk decoder took 16 zero bytes for a blosc chunk")
    with tempfile.TemporaryDirectory(prefix="nlt_serving_") as tmp:
        root = Path(tmp)
        t0 = time.time()
        cfg = write_mdp_datastore(root, np)
        mb = sum(f.stat().st_size for f in root.rglob("*") if f.is_file())
        print(f"MDP datastore written in {time.time() - t0:.1f} s "
              f"({mb / 1e6:.1f} MB on disk, zlib level 1)")

        t0 = time.time()
        reset_counts()
        quiet(train.main, ["--config_path", str(cfg), "--model", "graph_lam",
                           "--graph", "multiscale", *width, "--batch_size",
                           "4", "--ar_steps_train", "1", "--ar_steps_eval",
                           "2", "--val_steps_to_log", "1", "2",
                           "--max_steps", "2", "--seed", "0",
                           "--save_dir", str(root / "models"),
                           "--run_name", "graph_lam"])
        torch.cuda.synchronize()
        got = counts()
        print(f"train.main: 2 steps and validation in "
              f"{time.time() - t0:.1f} s; launches {got}")
        if not all(got[k] for k in FWD) or not all(
                got[k + "_bwd"] for k in FWD) or not got["xtd_sum"]:
            fail(f"train.main did not run every training kernel: {got}")

        t0 = time.time()
        config, ds = load_config_and_datastore(cfg)
        hilam = MODELS["hi_lam"](
            ModelArgs(hidden_dim=64, processor_layers=4), config, ds,
            load_or_build_graph(ds, "hierarchical", "cuda"), device="cuda",
            generator=torch.Generator().manual_seed(0))
        save_checkpoint(root / "models", "hi_lam", hilam.state_dict(),
                        meta={"step": 0})
        del hilam
        print(f"HiLAM (seeded weights) saved in {time.time() - t0:.1f} s")

        eval_phase(torch, np, root, cfg, width, counts, reset_counts,
                   plain_kernels, zero)

        L = 4
        stats = ds.get_standardization_dataarray("state")
        mean, std = stats["state_mean"], stats["state_std"]
        want_times = WeatherDataset(ds, split="test", ar_steps=STEPS)[-1][3]
        names = ds.get_vars_names("state")
        for model, graph, ckpt, want in (
                ("graph_lam", "multiscale", "graph_lam/last",
                 {"edge_tail_sum": 2, "edge_layer": L}),
                ("hi_lam", "hierarchical", "hi_lam",
                 {"edge_tail": 3, "edge_tail_sum": 2,
                  "edge_layer": 3 + 14 * L})):
            out = root / f"{model}.zarr"
            argv = ["--config_path", str(cfg), "--model", model, "--graph",
                    graph, *width, "--load", str(root / "models" / ckpt),
                    "--split", "test", "--sample_idx", "-1", "--ar_steps",
                    str(STEPS), "--out", str(out)]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            live = torch.cuda.memory_allocated()
            reset_counts()
            summary = quiet(predict.main, argv)
            torch.cuda.synchronize()
            got = counts()
            peak = torch.cuda.max_memory_allocated()
            want = dict(zero, **want)
            print(f"predict.main {model}: init {summary['init_s']:.2f} s, "
                  f"rollout {summary['rollout_s']:.3f} s for {STEPS} steps "
                  f"({summary['rollout_s'] * 1e3 / STEPS:.1f} ms a step, "
                  f"first calls included); peak device memory "
                  f"{peak / 2**30:.3f} GiB ({live / 2**30:.3f} GiB live "
                  f"before it); launches per step "
                  f"{ {k: got[k] / STEPS for k in want if got[k]} }")
            if got != {k: n * STEPS for k, n in want.items()}:
                fail(f"predict.main {model}: launch counts {got}, want "
                     f"{want} per step")
            g = ZarrGroup(out)
            pred = g["state"].read_full()
            times = g["time"].read_full()
            if pred.shape != (STEPS, 268 * 238, 17):
                fail(f"predict.main {model}: forecast shape {pred.shape}")
            if not np.isfinite(pred).all():
                fail(f"predict.main {model}: forecast is not finite")
            if not np.array_equal(times, want_times):
                fail(f"predict.main {model}: valid times {times}, want "
                     f"{want_times}")
            if list(g["state_feature"].read_full()) != names:
                fail(f"predict.main {model}: feature names differ")

            args = predict.parse_args(argv)
            net, net_ds, _ = predict.prepare(args)
            pred_k, _ = predict.rollout(net, net_ds, args)  # warm-up
            warm_ms = median_ms(
                torch, lambda: predict.rollout(net, net_ds, args)) / STEPS

            def sample_in():
                """The test sample read, standardized and on the card."""
                item = WeatherDataset(net_ds, split="test",
                                      ar_steps=STEPS)[-1]
                return [torch.as_tensor(b, device="cuda")[None]
                        for b in item[:3]]

            cold = []
            for _ in range(3):
                _chunk_cache.clear()
                before = native.decoded_chunks
                cold.append(median_ms(torch, sample_in, n=1))
                decoded = native.decoded_chunks - before
                if not decoded:
                    fail(f"predict.main {model}: the cold sample read "
                         "decoded no chunk in the native decoder")
            cold_ms = sorted(cold)[1]
            before = native.decoded_chunks
            sample_ms = median_ms(torch, sample_in)
            warm_decoded = native.decoded_chunks - before
            init, true, forcing = sample_in()
            with torch.no_grad():
                unroll_ms = median_ms(torch, lambda: net.unroll_prediction(
                    init, forcing, true)) / STEPS
            with plain_kernels():
                pred_p, _ = predict.rollout(net, net_ds, args)
            gap = float(np.abs((pred - mean) / std - pred_p).max())
            gap_k = float(np.abs(pred_k - pred_p).max())
            print(f"predict.main {model}: forecast {pred.shape} finite, "
                  f"valid times {times.astype('datetime64[ns]')[[0, -1]]}; "
                  f"standardized, within {gap:.3e} of the plain path on "
                  f"the card (limit 1e-3; a warm kernel rollout "
                  f"{gap_k:.3e}); warm rollout {warm_ms:.1f} ms a step "
                  f"(host clock, median of 3, the sample's read and copies "
                  f"included); the sample read, standardized and copied to "
                  f"the card: cold (chunk cache emptied) {cold_ms:.1f} ms "
                  f"(median of {', '.join(f'{c:.1f}' for c in cold)}; "
                  f"{decoded} chunks decoded natively), warm "
                  f"{sample_ms:.1f} ms ({warm_decoded} decoded); the "
                  f"model's unroll alone {unroll_ms:.1f} ms a step")
            if not gap <= 1e-3:
                fail(f"predict.main {model}: forecast and plain path "
                     "disagree")
            del net, net_ds, pred_k, pred_p, init, true, forcing
            torch.cuda.empty_cache()


def write_raw_sources(root, np, nx=268, ny=238, n_t=30, seed=0):
    """Raw source zarrs in the DANRA example's shape at the bench grid,
    zlib chunks (level 1), and a datastore config over them for
    `create_dataset`: height-level u, v, t and r over 5 altitudes (4 of
    them selected, named "{var}{altitude}m") and single-level t2m as the
    17 state features, 6 single-level forcing fields, 4 static fields
    (the land-sea mask among them); 30 3-hourly times, of which the
    config's coord_ranges keep 28, split 12/6/10 with statistics over
    train; output.compression none. Writes <root>/sources/*.zarr,
    <root>/mdp.datastore.yaml and <root>/config.yaml (JSON, which YAML
    readers take); returns the config's path and the restacked state,
    forcing and static arrays the archive must hold."""
    from neural_lam_tpu_torch.datastore.zarr_reader import (
        consolidate_metadata,
        write_zarr_array,
    )

    zlib = {"id": "zlib", "level": 1}
    rng = np.random.default_rng(seed)
    times = np.datetime64("2020-01-01T00", "ns") + np.arange(n_t) \
        * np.timedelta64(3, "h")
    alts = [30.0, 100.0, 200.0, 300.0, 500.0]
    keep = alts[1:]
    height_vars = ("u", "v", "t", "r")
    forcing_vars = ("swavr0m", "lwavr0m", "tcc", "mslp", "pres0m", "sst")
    static_vars = ("lsm", "orography", "lake_fraction", "roughness")

    def field(*shape):
        return rng.standard_normal(shape, dtype=np.float32)

    def store(name, arrays, with_time=True):
        """(name, values, dims, chunks or None) -> a consolidated zarr."""
        path = root / "sources" / name
        coords = [("x", np.arange(nx) * 2500.0, ["x"], None),
                  ("y", np.arange(ny) * 2500.0, ["y"], None)]
        if with_time:
            coords.append(("time", times, ["time"], None))
        for key, arr, dims, chunks in coords + arrays:
            write_zarr_array(path, key, arr, dims=dims, chunks=chunks,
                             attrs={"units": "-", "long_name": key},
                             compressor=zlib)
        consolidate_metadata(path)
        return str(path)

    hl = {v: field(n_t, nx, ny, len(alts)) for v in height_vars}
    sl = {v: field(n_t, nx, ny) for v in ("t2m",) + forcing_vars}
    st = {v: field(nx, ny) for v in static_vars}
    st["lsm"] = (st["lsm"] > 0).astype(np.float32)
    hl_path = store("height_levels.zarr", [
        ("altitude", np.array(alts), ["altitude"], None)] + [
        (v, a, ["time", "x", "y", "altitude"], [3, nx, ny, len(alts)])
        for v, a in hl.items()])
    sl_path = store("single_levels.zarr", [
        (v, a, ["time", "x", "y"], [3, nx, ny]) for v, a in sl.items()])
    st_path = store("static.zarr", [
        (v, a, ["x", "y"], None) for v, a in st.items()], with_time=False)

    def tstr(i):
        return str(times[i].astype("datetime64[s]"))

    grid = {"method": "stack", "dims": ["x", "y"]}
    rename = {"method": "rename", "dim": "time"}

    def inp(path, src_dims, variables, cat, **stack):
        mapping = {"grid_index": grid, f"{cat}_feature": dict(
            method="stack_variables_by_var_name", **stack)}
        if "time" in src_dims:
            mapping["time"] = rename
        return {"path": path, "dims": src_dims, "variables": variables,
                "dim_mapping": mapping, "target_output_variable": cat}

    config = {
        "schema_version": "v0.5.0", "dataset_version": "v0.1.0",
        "output": {
            "variables": {
                "static": ["grid_index", "static_feature"],
                "state": ["time", "grid_index", "state_feature"],
                "forcing": ["time", "grid_index", "forcing_feature"]},
            "coord_ranges": {"time": {"start": tstr(1), "end": tstr(28),
                                      "step": "PT3H"}},
            "chunking": {"time": 2},
            "compression": "none",
            "splitting": {"dim": "time", "splits": {
                "train": {"start": tstr(1), "end": tstr(12),
                          "compute_statistics": {
                              "ops": ["mean", "std", "diff_mean",
                                      "diff_std"],
                              "dims": ["grid_index", "time"]}},
                "val": {"start": tstr(13), "end": tstr(18)},
                "test": {"start": tstr(19), "end": tstr(28)}}}},
        "inputs": {
            "danra_height_levels": inp(
                hl_path, ["time", "x", "y", "altitude"],
                {v: {"altitude": {"values": keep, "units": "m"}}
                 for v in height_vars}, "state", dims=["altitude"],
                name_format="{var_name}{altitude:g}m"),
            "danra_surface_state": inp(sl_path, ["time", "x", "y"], ["t2m"],
                                       "state", name_format="{var_name}"),
            "danra_surface": inp(sl_path, ["time", "x", "y"],
                                 list(forcing_vars), "forcing",
                                 name_format="{var_name}"),
            "danra_static": inp(st_path, ["x", "y"], list(static_vars),
                                "static", name_format="{var_name}")},
        "extra": {"projection": {
            "class_name": "LambertConformal",
            "kwargs": {"central_longitude": 25.0,
                       "central_latitude": 56.7}}}}
    (root / "mdp.datastore.yaml").write_text(json.dumps(config))
    cfg = root / "config.yaml"
    cfg.write_text(json.dumps({"datastore": {
        "kind": "mdp", "config_path": "mdp.datastore.yaml"}}))
    n_grid = nx * ny
    sel = [alts.index(a) for a in keep]
    want = {
        "state": np.concatenate(
            [hl[v][1:29][..., sel].reshape(28, n_grid, len(sel))
             for v in height_vars]
            + [sl["t2m"][1:29].reshape(28, n_grid, 1)], axis=-1),
        "forcing": np.stack([sl[v][1:29].reshape(28, n_grid)
                             for v in forcing_vars], axis=-1),
        "static": np.stack([st[v].reshape(n_grid) for v in static_vars],
                           axis=-1)}
    return cfg, want


def write_meps_datastore(root, np, nx=238, ny=268, n_t=7, seed=0):
    """A datastore in the MEPS npy layout (as the repo's MEPS test fixture
    lays it out) on MEPS's own 268x238 grid: 18 raw state features, of
    which `remove_state_features_with_index` drops one, leaving 17; 2
    ensemble members; the TOA flux, open-water, static and nwp_xy files;
    3 train, 1 val and 1 test analysis times. num_timesteps is cut from
    the reference's 65 to 7: 2 initial states, a 4-step forecast and its
    one future forcing step. Writes <root>/data_config.yaml and
    <root>/config.yaml; returns the config's path."""
    rng = np.random.default_rng(seed)
    times = {"train": ["2022040100", "2022040112", "2022040200"],
             "val": ["2022060500"], "test": ["2022090100"]}
    n_raw, drop, members = 18, [7], 2
    for split, atimes in times.items():
        d = root / "samples" / split
        d.mkdir(parents=True)
        for at in atimes:
            for member in range(members):
                np.save(d / f"nwp_{at}_mbr{member:03d}.npy",
                        rng.standard_normal((n_t, ny, nx, n_raw),
                                            dtype=np.float32))
            np.save(d / f"nwp_toa_downwelling_shortwave_flux_{at}.npy",
                    rng.uniform(0, 100, (n_t, ny, nx)).astype(np.float32))
            np.save(d / f"wtr_{at}.npy",
                    rng.uniform(0, 1, (ny, nx)).astype(np.float32))
    static = root / "static"
    static.mkdir()
    np.save(static / "surface_geopotential.npy",
            rng.standard_normal((ny, nx), dtype=np.float32))
    border = np.ones((ny, nx), np.float32)
    border[10:-10, 10:-10] = 0
    np.save(static / "border_mask.npy", border)
    np.save(static / "nwp_xy.npy", np.stack(np.meshgrid(
        np.arange(nx) * 2500.0, np.arange(ny) * 2500.0, indexing="xy"))
        .astype(np.float32))
    names = [f"var_{i}" for i in range(n_raw - len(drop))]
    (root / "data_config.yaml").write_text(json.dumps({
        "dataset": {"name": "meps_example", "var_names": names,
                    "var_units": ["-"] * len(names),
                    "var_longnames": [f"long {v}" for v in names],
                    "num_forcing_features": 6, "num_timesteps": n_t,
                    "step_length": 3, "num_ensemble_members": members,
                    "remove_state_features_with_index": drop},
        "grid_shape_state": [ny, nx],
        "projection": {"class_name": "LambertConformal", "kwargs": {
            "central_longitude": 15.0, "central_latitude": 63.3,
            "standard_parallels": [63.3, 63.3]}}}))
    cfg = root / "config.yaml"
    cfg.write_text(json.dumps({"datastore": {
        "kind": "npyfilesmeps", "config_path": "data_config.yaml"}}))
    return cfg


def forecast_check(torch, np, argv, want, counts, reset_counts,
                   plain_kernels, zero, what):
    """`predict.main` with every counter at 0 just before it: the launches
    per step, a finite forecast of the bench's shape, and, standardized,
    within 1e-3 of the same rollout through the plain versions; prints
    the CLI's seconds and a warm rollout's ms a step."""
    from neural_lam_tpu_torch import predict
    from neural_lam_tpu_torch.datastore.zarr_reader import ZarrGroup

    reset_counts()
    summary = quiet(predict.main, argv)
    torch.cuda.synchronize()
    got = counts()
    want = dict(zero, **want)
    if got != {k: n * STEPS for k, n in want.items()}:
        fail(f"predict.main {what}: launch counts {got}, want {want} per "
             "step")
    pred = ZarrGroup(argv[argv.index("--out") + 1])["state"].read_full()
    if pred.shape != (STEPS, 268 * 238, 17) or not np.isfinite(pred).all():
        fail(f"predict.main {what}: forecast {pred.shape}, finite "
             f"{np.isfinite(pred).all()}")
    args = predict.parse_args(argv)
    net, ds, _ = predict.prepare(args)
    stats = ds.get_standardization_dataarray("state")
    predict.rollout(net, ds, args)  # warm-up
    warm_ms = median_ms(torch, lambda: predict.rollout(net, ds, args)) / STEPS
    with plain_kernels():
        pred_p, _ = predict.rollout(net, ds, args)
    gap = float(np.abs((pred - stats["state_mean"]) / stats["state_std"]
                       - pred_p).max())
    print(f"predict.main {what}: init {summary['init_s']:.2f} s, rollout "
          f"{summary['rollout_s'] * 1e3 / STEPS:.1f} ms a step (first calls "
          f"included), warm rollout {warm_ms:.1f} ms a step (host clock, "
          f"median of 3, the sample's read included); launches per step "
          f"{ {k: got[k] / STEPS for k in want if got[k]} }; forecast "
          f"{pred.shape} finite, standardized within {gap:.3e} of the "
          "plain path (limit 1e-3)")
    if not gap <= 1e-3:
        fail(f"predict.main {what}: forecast and plain path disagree")
    del net, ds, pred_p
    torch.cuda.empty_cache()


def mdp_tool_phase(torch, np, root, counts, reset_counts, plain_kernels,
                   zero):
    """Phase 10a: the MDP archive created from raw sources by
    MDPDatastore on first use inside `train.main`, held against the
    sources, then forecast from."""
    from neural_lam_tpu_torch import train
    from neural_lam_tpu_torch.datastore import create_dataset as cd
    from neural_lam_tpu_torch.datastore.zarr_reader import ZarrGroup

    t0 = time.time()
    cfg, want = write_raw_sources(root, np)
    print(f"raw source zarrs written in {time.time() - t0:.1f} s "
          f"({disk_mb(root / 'sources'):.1f} MB on disk, zlib level 1)")
    archive = root / "mdp.datastore.zarr"

    # a blosc codec where libblosc may be missing, on a copy of the
    # config: it raises naming --compression none and leaves nothing, or
    # writes its archive
    lz4 = root / "lz4.datastore.yaml"
    shutil.copy(root / "mdp.datastore.yaml", lz4)
    before = sorted(p.name for p in root.iterdir())
    t0 = time.time()
    try:
        cd.create_dataset(lz4, compression="lz4")
    except OSError as e:
        print(f"create_dataset(compression='lz4'): {e}")
        if "--compression none" not in str(e):
            fail("the libblosc error does not name --compression none")
        if sorted(p.name for p in root.iterdir()) != before:
            fail("a failed lz4 creation left files behind")
    else:
        print(f"create_dataset(compression='lz4'): libblosc is present; "
              f"written in {time.time() - t0:.1f} s "
              f"({disk_mb(lz4.with_suffix('.zarr')):.1f} MB)")
        shutil.rmtree(lz4.with_suffix(".zarr"))

    # train.main on the config with the archive missing: MDPDatastore
    # creates it, timed through the module's create_dataset
    created = []
    real = cd.create_dataset

    def timed(*args, **kwargs):
        t = time.time()
        out = real(*args, **kwargs)
        created.append(time.time() - t)
        return out

    cd.create_dataset = timed
    reset_counts()
    t0 = time.time()
    try:
        quiet(train.main, [
            "--config_path", str(cfg), "--model", "graph_lam", "--graph",
            "multiscale", *WIDTH, "--batch_size", "4", "--ar_steps_train",
            "1", "--ar_steps_eval", "2", "--val_steps_to_log", "1", "2",
            "--max_steps", "2", "--seed", "0", "--save_dir",
            str(root / "models"), "--run_name", "graph_lam"])
    finally:
        cd.create_dataset = real
    torch.cuda.synchronize()
    got = counts()
    print(f"train.main: the archive created on first use in "
          f"{sum(created):.1f} s ({disk_mb(archive):.1f} MB on disk, raw "
          f"chunks), then 2 steps and validation, {time.time() - t0:.1f} s "
          f"in all; launches {got}")
    if len(created) != 1:
        fail(f"MDPDatastore created the archive {len(created)} times")
    if not all(got[k] for k in FWD) or not all(
            got[k + "_bwd"] for k in FWD) or not got["xtd_sum"]:
        fail(f"train.main did not run every training kernel: {got}")

    g = ZarrGroup(archive)
    blosc = [n for n in g.arrays
             if (g[n].compressor or {}).get("id") == "blosc"]
    if blosc:
        fail(f"arrays with a blosc compressor: {blosc}")
    for cat, arr in want.items():
        if not np.array_equal(g[cat].read_full(), arr):
            fail(f"the archive's {cat} differs from the restacked sources")
    gap = 0.0
    for cat in ("state", "forcing"):
        window = want[cat][:12].astype(np.float64)
        diffs = np.diff(window, axis=0)
        for op, ref in (("mean", window.mean(axis=(0, 1))),
                        ("std", window.std(axis=(0, 1))),
                        ("diff_mean", diffs.mean(axis=(0, 1))),
                        ("diff_std", diffs.std(axis=(0, 1)))):
            got_op = g[f"{cat}__train__{op}"].read_full()
            gap = max(gap, float((np.abs(got_op - ref) / np.abs(ref)).max()))
    print(f"archive: state/forcing/static equal the sources restacked with "
          f"numpy, bit for bit; statistics within {gap:.3e} relative of "
          f"float64 numpy over the train window (limit 1e-6); "
          f"{len(g.arrays)} arrays, none blosc")
    if not gap <= 1e-6:
        fail("the archive's statistics disagree with numpy")
    forecast_check(
        torch, np, ["--config_path", str(cfg), "--model", "graph_lam",
                    "--graph", "multiscale", *WIDTH, "--load",
                    str(root / "models" / "graph_lam" / "last"), "--split",
                    "test", "--sample_idx", "-1", "--ar_steps", str(STEPS),
                    "--out", str(root / "forecast.zarr")],
        {"edge_tail_sum": 2, "edge_layer": 4}, counts, reset_counts,
        plain_kernels, zero, "GraphLAM on the created MDP archive")


def meps_tool_phase(torch, np, root, counts, reset_counts, plain_kernels,
                    zero):
    """Phase 10b: a MEPS datastore given its statistics by the port's
    tool serially, with 4 workers and in 2 shards, then forecast from."""
    from neural_lam_tpu_torch.checkpoint import save_checkpoint
    from neural_lam_tpu_torch.config import load_config_and_datastore
    from neural_lam_tpu_torch.datastore import compute_standardization_stats
    from neural_lam_tpu_torch.graph.storage import load_or_build_graph
    from neural_lam_tpu_torch.models import MODELS
    from neural_lam_tpu_torch.models.ar_model import ModelArgs

    t0 = time.time()
    cfg = write_meps_datastore(root, np)
    print(f"MEPS datastore written in {time.time() - t0:.1f} s "
          f"({disk_mb(root):.1f} MB on disk; num_timesteps cut from 65 to "
          "7; 2 members; 3/1/1 analysis times)")
    static = root / "static"
    files = ("parameter_mean.pt", "parameter_std.pt", "flux_stats.pt",
             "diff_mean.pt", "diff_std.pt")

    def run(*flags):
        t = time.time()
        quiet(compute_standardization_stats.cli, [
            "--datastore_config_path", str(root / "data_config.yaml"),
            *flags])
        return time.time() - t

    def load():
        return {f: torch.load(static / f, weights_only=True) for f in files}

    serial_s = run()
    serial = load()
    workers_s = run("--n_workers", "4")
    if not all(torch.equal(serial[f], t) for f, t in load().items()):
        fail("compute_standardization_stats --n_workers 4 differs from the "
             "serial pass")
    for f in files:
        (static / f).unlink()
    shard_s = [run("--num_shards", "2", "--shard_id", str(i), "--job_tag",
                   "phase10") for i in (1, 0)]
    sharded = load()
    print(f"compute_standardization_stats: serial {serial_s:.2f} s, "
          f"--n_workers 4 {workers_s:.2f} s (bit-identical), --num_shards 2 "
          f"shard 1 {shard_s[0]:.2f} s then shard 0 {shard_s[1]:.2f} s "
          f"(merged); sharded vs serial max abs " + ", ".join(
              f"{f} {float((sharded[f] - serial[f]).abs().max()):.3e}"
              for f in files) + " (limit rtol 2e-5, atol 2e-6)")
    for f in files:
        if not torch.allclose(sharded[f], serial[f], rtol=2e-5, atol=2e-6):
            fail(f"sharded {f} differs from the serial pass")

    t0 = time.time()
    config, ds = load_config_and_datastore(cfg)
    net = MODELS["graph_lam"](
        ModelArgs(hidden_dim=64, processor_layers=4), config, ds,
        load_or_build_graph(ds, "multiscale", "cuda"), device="cuda",
        generator=torch.Generator().manual_seed(0))
    save_checkpoint(root / "models", "graph_lam", net.state_dict(),
                    meta={"step": 0})
    del net
    print(f"GraphLAM (seeded weights) on the MEPS grid saved in "
          f"{time.time() - t0:.1f} s, its multiscale graph built")
    forecast_check(
        torch, np, ["--config_path", str(cfg), "--model", "graph_lam",
                    "--graph", "multiscale", *WIDTH, "--load",
                    str(root / "models" / "graph_lam"), "--split", "test",
                    "--sample_idx", "-1", "--ar_steps", str(STEPS), "--out",
                    str(root / "forecast.zarr")],
        {"edge_tail_sum": 2, "edge_layer": 4}, counts, reset_counts,
        plain_kernels, zero, "GraphLAM on MEPS")


def disk_mb(path):
    """MB of the files under path."""
    return sum(f.stat().st_size for f in path.rglob("*")
               if f.is_file()) / 1e6


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from neural_lam_tpu_torch import entry
    from neural_lam_tpu_torch.ops import (
        _build,
        edge,
        edge_flat,
        embed,
        grid_update,
        message_passing,
        weight_grad,
    )
    from neural_lam_tpu_torch.ops.message_passing import EdgeSet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    print(smi)
    name = torch.cuda.get_device_name(0)
    peak_flops, peak_tf32, peak_bw, peak_label = peaks(name)
    print(f"device: {name}; peaks used for bounds: {peak_label}")
    mods = {"embed_grid_flat": embed, "edge_tail_sum_flat": edge_flat,
            "edge_layer_flat": edge_flat, "grid_update_flat": grid_update}
    wrappers = {}
    for k, m in mods.items():
        wrappers[k] = getattr(m, k)
        wrappers[k + "_bwd"] = getattr(m, k + "_bwd")
    mods.update({k: edge for k in BATCHED})
    wrappers.update({k: getattr(edge, k) for k in BATCHED})
    wrappers["xtd_sum"] = weight_grad.xtd_sum
    wrappers["xtd_reduce"] = weight_grad.xtd_reduce

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0

    def counts():
        return {k: w.launches for k, w in wrappers.items()}

    @contextlib.contextmanager
    def plain_kernels():
        """The model's kernel calls go to the plain versions (autograd
        through the plain forward) while inside."""
        for k, m in mods.items():
            plain = getattr(m, k + "_plain")
            setattr(m, k, lambda *a, fold=None, _p=plain, **kw: _p(*a, **kw))
        try:
            yield
        finally:
            for k, m in mods.items():
                setattr(m, k, wrappers[k])

    phase_t0 = [time.time()]

    def phase_end(what):
        """Print the seconds since the last phase ended."""
        now = time.time()
        print(f"phase {what}: {now - phase_t0[0]:.1f} s")
        phase_t0[0] = now

    # 1. build
    t0 = time.time()
    libs = _build.build_all()
    print(f"kernel build: {time.time() - t0:.1f} s for {len(libs)} sources "
          f"({', '.join(p.name for p in libs.values())})")
    tc_usage = {}  # K2/K3/P1/P2/P3 tag -> [(registers, spill bytes)]
    for src in libs:
        log = _build.build_log(src)
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill", log)]
        print(f"  ptxas[{src}]: {len(regs)} kernels, {min(regs)}-{max(regs)} "
              f"registers, {sum(spills)} bytes of spill stores and loads")
        if src in ("embed", "edge_flat", "edge", "edge_flat_bwd",
                   "grid_update_bwd", "weight_grad", "embed_bwd"):
            for fn, info in sorted(re.findall(
                    r"Compiling entry function '(\w+)'.*?\n(.*?Used \d+ "
                    r"registers[^\n]*)", log, re.S)):
                used = re.search(r"Used [^\n]*", info).group(0)
                spill = ", ".join(re.findall(r"\d+ bytes spill \w+", info))
                kn = kernel_name(fn)
                print(f"    {kn}: {used}; {spill or 'no spill line'}")
                if "edge_tc_kernel" in kn:
                    tc_usage.setdefault(kn[:2], []).append((
                        int(re.search(r"Used (\d+)", used).group(1)),
                        sum(int(b) for b in re.findall(r"(\d+) bytes spill",
                                                       info))))
    for tag, use in sorted(tc_usage.items()):
        print(f"  edge_tc_kernel {tag} ({len(use)} instances): "
              f"{min(r for r, _ in use)}-{max(r for r, _ in use)} registers, "
              f"{sum(s for _, s in use)} bytes of spill")
    sass_counts(_build, libs["edge_flat_bwd"], "edge_layer_bwd_kernelILi8E")
    # edge_tc_kernel<K, kMode, kBatched>: K3, K2 (flat), P3, P2, P1 at K=8
    # and P1 at K=1 (batched)
    sass_counts(_build, libs["edge_flat"], "edge_tc_kernelILi8ELi1ELb0E")
    sass_counts(_build, libs["edge_flat"], "edge_tc_kernelILi8ELi0ELb0E")
    for fn in ("ILi8ELi1ELb1E", "ILi8ELi0ELb1E", "ILi8ELi2ELb1E",
               "ILi1ELi2ELb1E"):
        sass_counts(_build, libs["edge"], "edge_tc_kernel" + fn)
    sass_counts(_build, libs["embed"], "embed_kernelILi0E")  # K1, d_in <= 64
    sass_counts(_build, libs["grid_update"], "grid_update_kernelILi4E")
    sass_counts(_build, libs["weight_grad"], "xtd_sum_kernel")
    sass_counts(_build, libs["embed_bwd"], "embed_bwd_kernelILb0E")  # B1
    phase_end("1 (build)")

    # 2. the bench-width models
    t0 = time.time()
    model, datastore = entry.build_model(**BENCH, device="cuda")
    g = model.graph
    print(f"model built in {time.time() - t0:.1f} s: N_grid="
          f"{g.num_grid_nodes}, N_mesh={model.num_mesh_nodes}, "
          f"g2m K={g.g2m.dense_k} rows={g.g2m.num_virt}, m2m "
          f"K={g.m2m[0].dense_k} rows={g.m2m[0].num_virt}, m2g "
          f"K={g.m2g.dense_k} rows={g.m2g.num_virt}")
    t0 = time.time()
    hilam, _ = entry.build_model(**BENCH, device="cuda", model="hi_lam")
    hg = hilam.graph

    def sets(kind):
        return " ".join(f"({es.dense_k},{es.num_virt}"
                        f"{'' if es.virt_identity else ',fold'})"
                        for es in getattr(hg, kind))

    print(f"HiLAM built in {time.time() - t0:.1f} s: levels "
          f"{hg.level_sizes} (N_mesh={hilam.num_mesh_nodes}); (K, virtual "
          f"rows) m2m {sets('m2m')}, up {sets('up')}, down {sets('down')}")
    phase_end("2 (the bench-width models)")

    # 3-4. every kernel against its plain version at the main path's shapes
    gen = torch.Generator(device="cuda").manual_seed(0)
    W = BATCH * H

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    emb = model.grid_embedder
    d_in = emb.layers[0].w.shape[0]
    n_grid = g.num_grid_nodes
    rows1 = n_grid * BATCH
    m2g = g.m2g
    pp = {k: v.detach() for k, v in
          grid_update.pack_grid_update_params(model).items()}
    d_out = pp["o_w1"].shape[1]
    cases = []  # (name, module, args, replaces, bytes, flops)

    def det(*ts):
        return tuple(t.detach() if isinstance(t, torch.Tensor) else t
                     for t in ts)

    k1 = det(rand(n_grid, BATCH * d_in), emb.layers[0].w, emb.layers[0].b,
             emb.layers[1].w, emb.layers[1].b, emb.ln.scale, emb.ln.bias)
    pe1 = "neural_lam_tpu/ops/pallas_embed.py:99"
    cases.append(("embed_grid_flat", embed, k1 + (BATCH,), pe1,
                  nbytes(*k1) + rows1 * H * 4,
                  2.0 * rows1 * (d_in * H + H * H)))
    # K1 at d_in 23 (x rows not a multiple of 16 bytes), 100 (two x column
    # blocks) and 160 (64-column chunks, W0 from device memory), on one
    # node fewer: a row count that is not a multiple of the 16-row tiles
    for din in (23, 100, 160):
        kx = (rand(n_grid - 1, BATCH * din), 0.2 * rand(din, H),
              0.1 * rand(H), 0.2 * rand(H, H), 0.1 * rand(H),
              1 + 0.1 * rand(H), 0.1 * rand(H))
        rows = (n_grid - 1) * BATCH
        cases.append(("embed_grid_flat", embed, kx + (BATCH,),
                      f"{pe1} (d_in {din}, {rows} rows)",
                      nbytes(*kx) + rows * H * 4,
                      2.0 * rows * (din * H + H * H)))
    del kx
    # B1 at the training step's call (no dx: x_f is data), then with dx,
    # then at d_in 23 (rows not 16-byte multiples) and 100 (two x column
    # blocks); products: t0, y, dt, dW1, dW0 (and dx)
    d_emb = rand(n_grid, W)
    pem = "neural_lam_tpu/ops/pallas_embed.py:111"
    for din, need_dx in ((d_in, False), (d_in, True), (23, False),
                         (23, True), (100, False), (100, True)):
        bk = k1 if din == d_in else (
            rand(n_grid, BATCH * din), 0.2 * rand(din, H), 0.1 * rand(H),
            0.2 * rand(H, H), 0.1 * rand(H), 1 + 0.1 * rand(H),
            0.1 * rand(H))
        label = pem if (din, need_dx) == (d_in, False) else (
            f"{pem} (d_in {din}, {'with' if need_dx else 'no'} dx)")
        cases.append(("embed_grid_flat_bwd", embed,
                      bk + (BATCH, d_emb, need_dx), label,
                      nbytes(*bk) + nbytes(d_emb) + nbytes(*bk[1:])
                      + (nbytes(bk[0]) if need_dx else 0),
                      2.0 * rows1 * ((3 if need_dx else 2) * din * H
                                     + 3 * H * H)))

    def edge_cases(edges, inet, layer):
        n_virt, K = edges.num_virt, edges.dense_k
        mask_p = edges.mask.view(n_virt, K)
        mlp = inet.edge_mlp
        tail = det(mlp.layers[1].w, mlp.layers[1].b, mlp.ln.scale,
                   mlp.ln.bias)
        table = rand(edges.num_send, W)
        rec_rows = rand(n_virt, W)
        M = n_virt * K
        real = float(mask_p.sum())
        if layer:
            w0 = mlp.layers[0].w.detach()
            args = (rand(M, W), table, edges.senders, rec_rows, mask_p,
                    w0[:H], mlp.layers[0].b.detach()) + tail
            par_bytes = nbytes(*args[5:])
            fwd_bytes = nbytes(*args) + M * W * 4 + n_virt * W * 4
            # edge_out is written, and its gradient read, at every slot
            fwd_flops = 2.0 * M * BATCH * 2 * H * H
            bwd_args = args + (rand(M, W), rand(n_virt, W))
            bwd_bytes = (nbytes(*bwd_args) + 2 * M * W * 4
                         + n_virt * W * 4 + par_bytes)
            return ((args, fwd_bytes, fwd_flops),
                    (bwd_args, bwd_bytes, 3 * fwd_flops))
        args = (table, edges.senders, rand(M, H), rec_rows, mask_p) + tail
        fwd_bytes = nbytes(*args) + n_virt * W * 4
        fwd_flops = 2.0 * real * BATCH * H * H
        bwd_args = args + (rand(n_virt, W),)
        # the chain's scratch (X1, DY: (M*B, 64) each) written once
        bwd_bytes = (nbytes(*bwd_args) + M * (W + H) * 4 + n_virt * W * 4
                     + nbytes(*tail) + 2 * M * W * 4)
        return ((args, fwd_bytes, fwd_flops),
                (bwd_args, bwd_bytes, 3 * fwd_flops))

    pef = "neural_lam_tpu/ops/pallas_edge_flat.py"
    for kname, edges, inet, layer, lines in (
            ("edge_tail_sum_flat", g.g2m, model.g2m_gnn, False, (373, 526)),
            ("edge_layer_flat", g.m2m[0], model.processor[0], True,
             (727, 846))):
        (a, b, f), (ab, bb, bf) = edge_cases(edges, inet, layer)
        cases.append((kname, edge_flat, a, f"{pef}:{lines[0]}", b, f))
        cases.append((kname + "_bwd", edge_flat, ab, f"{pef}:{lines[1]}",
                      bb, bf))
        if not layer:
            b2_args = ab  # B2 at g2m
    b3_args = ab  # B3/B4 at m2m[0]

    n_virt, K = m2g.num_virt, m2g.dense_k
    mask_p = m2g.mask.view(n_virt, K)
    a4 = (rand(m2g.num_send, W), m2g.senders, rand(n_virt * K, H),
          rand(n_grid, W), mask_p, pp)
    real4 = float(mask_p.sum())
    node_flops = 2.0 * n_virt * BATCH * (7 * H * H + H * d_out)
    edge_flops4 = 2.0 * real4 * BATCH * H * H
    pgu = "neural_lam_tpu/ops/pallas_grid_update.py"
    in4 = nbytes(*a4[:5], *pp.values())
    cases.append(("grid_update_flat", grid_update, a4, f"{pgu}:174",
                  in4 + n_virt * BATCH * d_out * 4, node_flops + edge_flops4))
    # K4 at HiLAM's batch-4 m2g
    hm2g = hg.m2g
    h_pp = {k: v.detach() for k, v in
            grid_update.pack_grid_update_params(hilam).items()}
    h_mask = hm2g.mask.view(hm2g.num_virt, hm2g.dense_k)
    h_a4 = (rand(hm2g.num_send, W), hm2g.senders,
            rand(hm2g.num_virt * hm2g.dense_k, H),
            rand(hilam.graph.num_grid_nodes, W), h_mask, h_pp)
    cases.append(("grid_update_flat", grid_update, h_a4,
                  f"{pgu}:174 (HiLAM m2g, K={hm2g.dense_k}, "
                  f"{hm2g.num_virt} rows, B=4)",
                  nbytes(*h_a4[:5], *h_pp.values())
                  + hm2g.num_virt * BATCH * d_out * 4,
                  2.0 * hm2g.num_virt * BATCH * (7 * H * H + H * d_out)
                  + 2.0 * float(h_mask.sum()) * BATCH * H * H))
    a5 = a4 + (rand(n_virt, BATCH * d_out),)
    cases.append(("grid_update_flat_bwd", grid_update, a5, f"{pgu}:752",
                  in4 + nbytes(a5[-1]) + n_virt * K * (W + H) * 4
                  + n_grid * W * 4 + nbytes(*pp.values()),
                  3 * (node_flops + edge_flops4)))
    # B5/B6's weight-gradient pass at the pairs its chain pass writes
    xtd_pairs = grid_update.grid_update_bwd_chain(*a5)[4]
    torch.cuda.synchronize()
    # GR and DU0P are in two pairs each: their bytes are read once
    cases.append(("xtd_sum", weight_grad, (xtd_pairs,), f"{pgu}:752",
                  unique_nbytes([t for p in xtd_pairs for t in p])
                  + sum(H * d.shape[1] * 4 for _, d in xtd_pairs),
                  sum(2.0 * x.shape[0] * H * d.shape[1]
                      for x, d in xtd_pairs)))
    # B3/B4's weight-gradient pass at the pairs its chain pass gives
    b3_pairs = edge_flat.edge_layer_bwd_chain(*b3_args)[4]
    torch.cuda.synchronize()
    b3_label = f"{pef}:846 (B3/B4's two pairs at m2m[0])"
    cases.append(("xtd_sum", weight_grad, (b3_pairs,), b3_label,
                  unique_nbytes([t for p in b3_pairs for t in p])
                  + 2 * H * H * 4,
                  sum(2.0 * x.shape[0] * H * H for x, _ in b3_pairs)))
    # B2's weight-gradient pass at the pair its chain pass gives
    b2_pairs = edge_flat.edge_tail_bwd_chain(*b2_args)[4]
    torch.cuda.synchronize()
    b2_label = f"{pef}:526 (B2's pair at g2m)"
    cases.append(("xtd_sum", weight_grad, (b2_pairs,), b2_label,
                  unique_nbytes([t for p in b2_pairs for t in p])
                  + H * H * 4,
                  sum(2.0 * x.shape[0] * H * H for x, _ in b2_pairs)))
    library = {"xtd_sum": lambda pairs: [torch.mm(x.t(), d)
                                         for x, d in pairs]}
    # K1's two products (x @ W0, then its result @ W1) as torch.mm calls
    library["embed_grid_flat"] = lambda x_f, w0, b0, w1, *rest: torch.mm(
        torch.mm(x_f.view(-1, w0.shape[0]), w0), w1)
    # K2's one product (X1 @ W2) on (M*B, 64) rows: the gathered sender
    # rows of g2m stand in for X1 (P2's the same in its layout, below)
    gathered = {}  # (table, senders) -> the gathered rows, (rows, 64)

    def gathered_rows(table, senders, dim):
        key = (table.data_ptr(), senders.data_ptr())
        if key not in gathered:
            gathered.clear()
            gathered[key] = table.index_select(dim, senders).view(-1, H)
        return gathered[key]

    library["edge_tail_sum_flat"] = lambda table, senders, ew, rec, mask, \
        w2, *rest: torch.mm(gathered_rows(table, senders, 0), w2)

    def b1_products(x_f, w0, b0, w1, b1, ls, lb, B, d_out, need_dx):
        """B1's products as torch.mm calls on operands of their shapes:
        t0 = x W0, y = t W1, dt = dy W1^T, dW1 = t^T dy, dW0 = x^T dt0
        (and dx = dt0 W0^T), with d_out's rows standing in for t, dy
        and dt0."""
        x, d = x_f.view(-1, w0.shape[0]), d_out.view(-1, H)
        out = [torch.mm(x, w0), torch.mm(d, w1), torch.mm(d, w1.t()),
               torch.mm(d.t(), d), torch.mm(x.t(), d)]
        return out + [torch.mm(d, w0.t())] if need_dx else out

    library["embed_grid_flat_bwd"] = b1_products
    # K3's two products (edge @ W_e, x1 @ W2) as two torch.mm calls on
    # (M*B, 64) rows: its library time "for its products"
    library["edge_layer_flat"] = lambda edge_rep, table, senders, rec, mask, \
        w_e, b0, w2, *rest: (torch.mm(edge_rep.view(-1, H), w_e),
                             torch.mm(edge_rep.view(-1, H), w2))
    # xtd_sum's reduce kernel at the decoder's partials
    partial, pair_first = weight_grad.xtd_partials(
        xtd_pairs, weight_grad.n_blocks([x.shape[0] for x, _ in xtd_pairs],
                                        xtd_pairs[0][0].device))
    widths = [d.shape[1] for _, d in xtd_pairs]
    red_elems = sum((b - a) * H * w for a, b, w
                    in zip(pair_first, pair_first[1:], widths))
    cases.append(("xtd_reduce", weight_grad, (partial, pair_first, widths),
                  f"{pgu}:752 (the decoder's {pair_first[-1]} partials)",
                  4 * (red_elems + H * sum(widths)), float(red_elems)))
    # its library call: every pair's segments added into the pair's row in
    # one call (over all 64*64 columns of a partial; a pair's result is its
    # first 64*d). torch.segment_reduce computes the same sums but waits
    # for the card on every call, so it cannot be timed queued.
    seg_pair = torch.repeat_interleave(
        torch.arange(len(widths), device="cuda"),
        torch.tensor([b - a for a, b in zip(pair_first, pair_first[1:])],
                     device="cuda"))
    red_zeros = torch.zeros(len(widths), H * H, device="cuda")
    library["xtd_reduce"] = lambda partial, pair_first, widths: (
        red_zeros.index_add(0, seg_pair, partial[:pair_first[-1]]))

    # K3 and B3/B4 at HiLAM's new shapes: K=1 (down[0]) and a virtual-row
    # fold (up[0])
    for lev_set, inet in ((hg.down[0], hilam.mesh_read_gnns[0]),
                          (hg.up[0], hilam.mesh_init_gnns[0])):
        (a, b, f), (ab, bb, bf) = edge_cases(lev_set, inet, True)
        at = (f"HiLAM K={lev_set.dense_k}, {lev_set.num_virt} rows"
              f"{'' if lev_set.virt_identity else ', fold'}, B=4")
        cases.append(("edge_layer_flat", edge_flat, a, f"{pef}:727 ({at})",
                      b, f))
        cases.append(("edge_layer_flat_bwd", edge_flat, ab,
                      f"{pef}:846 ({at})", bb, bf))

    # K2, K3, K4, P1, P2 and P3, and the backward kernels B2, B3/B4 and
    # B5/B6 (each with its xtd_sum pass), at every slot count their
    # kernels are built for, K = 1..8, on seeded local graphs (each of
    # 20,000 receivers takes K senders near it among 6,561): K = 3, 5, 6, 7
    # do not divide the 16-row tiles and sum virt through shared memory,
    # K = 1, 2, 4, 8 by shuffles; the g2m encoder's, the processor's first
    # layer's and the decoder's weights. K2, K3, K4 and their backward
    # kernels at batch 4; P1 and P2 (with and without messages) and P3 at
    # batch 1 and 4
    def k_sweep():
        rng = np.random.default_rng(0)
        n_rec, n_send = 20000, 6561
        centre = (np.arange(n_rec) * n_send // n_rec)[:, None]
        out = []
        for K in range(1, 9):
            send = np.clip(centre + rng.integers(-4, 5, (n_rec, K)), 0,
                           n_send - 1).reshape(-1)
            es = EdgeSet.from_local(
                send, np.repeat(np.arange(n_rec), K),
                rng.standard_normal((K * n_rec, 3)).astype(np.float32),
                n_send, n_rec, device="cuda", build_transpose=False)
            if es.dense_k != K:
                fail(f"local graph of in-degree {K} has K={es.dense_k}")
            at = f"local graph K={K}, {es.num_virt} rows, B=4"
            # K2 and K3, then B2 and B3/B4 (chain and xtd_sum) on the
            # same set
            for kname, inet, layer, lines in (
                    ("edge_tail_sum_flat", model.g2m_gnn, False, (373, 526)),
                    ("edge_layer_flat", model.processor[0], True,
                     (727, 846))):
                for sfx, (a, b, f), line in zip(
                        ("", "_bwd"), edge_cases(es, inet, layer), lines):
                    out.append((kname + sfx, edge_flat, a,
                                f"{pef}:{line} ({at})", b, f))
            # K4 (the m2g decoder) on the same set at batch 4, with
            # GraphLAM's decoder weights, then B5/B6 (chain and xtd_sum)
            a4k = (rand(n_send, W), es.senders, rand(es.num_virt * K, H),
                   rand(n_rec, W), es.mask.view(es.num_virt, K), pp)
            in4k = nbytes(*a4k[:5], *pp.values())
            flops4k = (2.0 * es.num_virt * BATCH * (7 * H * H + H * d_out)
                       + 2.0 * float(es.mask.sum()) * BATCH * H * H)
            out.append(("grid_update_flat", grid_update, a4k,
                        f"{pgu}:174 ({at})",
                        in4k + es.num_virt * BATCH * d_out * 4, flops4k))
            a5k = a4k + (rand(es.num_virt, BATCH * d_out),)
            out.append(("grid_update_flat_bwd", grid_update, a5k,
                        f"{pgu}:752 ({at})",
                        in4k + nbytes(a5k[-1]) + es.num_virt * K * (W + H) * 4
                        + n_rec * W * 4 + nbytes(*pp.values()),
                        3 * flops4k))
            for kname, inet, B, wm in (
                    ("edge_tail", model.g2m_gnn, 1, False),
                    ("edge_tail", model.g2m_gnn, 4, False),
                    ("edge_tail", model.g2m_gnn, 1, True),
                    ("edge_tail", model.g2m_gnn, 4, True),
                    ("edge_tail_sum", model.g2m_gnn, 1, False),
                    ("edge_tail_sum", model.g2m_gnn, 4, False),
                    ("edge_tail_sum", model.g2m_gnn, 1, True),
                    ("edge_tail_sum", model.g2m_gnn, 4, True),
                    ("edge_layer", model.processor[0], 1, False),
                    ("edge_layer", model.processor[0], 4, False)):
                a, out_bytes, f = batched_case(kname, es, inet, B, wm)
                out.append((kname, edge, a,
                            f"{PALLAS_EDGE}:{p_lines[kname]} (local graph "
                            f"K={K}, {es.num_virt} rows, B={B}"
                            f"{', with messages' if wm else ''})",
                            nbytes(*(t for t in a if torch.is_tensor(t)))
                            + out_bytes, f))
        return out

    def batched_case(kind, edges, inet, B, with_messages=False):
        """Args, bytes and FLOPs of one P-kernel call on `edges` at batch
        B: each input read once, each output written once; W2 (and W_e)
        products at every slot whose output is written (real slots only
        for a virt-only tail)."""
        n_virt, K = edges.num_virt, edges.dense_k
        M, n_send = n_virt * K, edges.num_send
        mlp = inet.edge_mlp
        tail = det(mlp.layers[1].w, mlp.layers[1].b, mlp.ln.scale,
                   mlp.ln.bias)
        real = float(edges.mask.sum())
        out_bytes = B * n_virt * H * 4
        if kind == "edge_layer":
            w0 = mlp.layers[0].w.detach()
            args = (rand(B, M, H), rand(B, n_send, H), edges.senders,
                    rand(B, n_virt, H), edges.mask, w0[:H],
                    mlp.layers[0].b.detach()) + tail + (K,)
            return args, out_bytes + B * M * H * 4, 2.0 * B * M * 2 * H * H
        slots = M if with_messages else real
        out_bytes += B * M * H * 4 if with_messages else 0
        if kind == "edge_tail_sum":
            args = (rand(B, n_send, H), edges.senders, rand(M, H),
                    rand(B, n_virt, H)) + tail + (edges.mask, K,
                                                  with_messages)
        else:
            args = (rand(B, M, H),) + tail + (edges.mask, K, with_messages)
        return args, out_bytes, 2.0 * B * slots * H * H

    p_lines = {"edge_tail": 54, "edge_tail_sum": 182, "edge_layer": 304}
    main_p = {}  # kernel -> label of its main-path (HiLAM batch-1) case
    # P1 on each down set of the read-out, with and without messages
    read_out = [("edge_tail", es, hilam.mesh_read_gnns[lv], 1, wm,
                 f"down[{lv}]{', with messages' if wm else ''}")
                for lv, es in enumerate(hg.down) for wm in (False, True)]
    for kname, edges, inet, B, wm, what in (
            ("edge_layer", hg.m2m[0], hilam.mesh_up_same_gnns[0][0], 1,
             False, "m2m[0]"),
            ("edge_tail_sum", hg.m2g, hilam.m2g_gnn, 1, False, "m2g"),
            ("edge_tail_sum", hg.m2g, hilam.m2g_gnn, 1, True,
             "m2g, with messages"),
            ("edge_tail_sum", hg.g2m, hilam.g2m_gnn, 1, False, "g2m"),
            *read_out,
            ("edge_layer", hg.m2m[1], hilam.mesh_up_same_gnns[0][1], 4,
             False, "m2m[1]"),
            ("edge_tail_sum", hg.g2m, hilam.g2m_gnn, 4, False, "g2m"),
            ("edge_tail", hg.down[-1], hilam.mesh_read_gnns[-1], 4, False,
             "top down set")):
        args, out_bytes, flops = batched_case(kname, edges, inet, B, wm)
        label = (f"{PALLAS_EDGE}:{p_lines[kname]} (HiLAM {what}, "
                 f"K={edges.dense_k}, {edges.num_virt} rows, B={B})")
        main_p.setdefault(kname, label)
        cases.append((kname, edge, args, label,
                      nbytes(*(t for t in args if torch.is_tensor(t)))
                      + out_bytes, flops))
    cases += k_sweep()
    # P3's two products (edge @ W_e, x1 @ W2) as two torch.mm calls on
    # (B*M, 64) rows, P2's one (X1 @ W2) with the gathered sender rows
    # standing in for X1, and P1's one (silu(x0) @ W2) on x0's rows: their
    # library time "for their products"
    library["edge_tail"] = lambda x0, w2, *rest: torch.mm(x0.view(-1, H),
                                                          w2)
    library["edge_layer"] = lambda edge_rep, send_t, senders, rec, mask, \
        w_e, b0, w2, *rest: (torch.mm(edge_rep.view(-1, H), w_e),
                             torch.mm(edge_rep.view(-1, H), w2))
    library["edge_tail_sum"] = lambda send_t, senders, ew, rec, w2, \
        *rest: torch.mm(gathered_rows(send_t, senders, 1), w2)

    records = []
    case_ms = {}  # (kernel, replaces) -> device ms
    with torch.no_grad():
        for kname, mod, args, replaces, bytes_, flops in cases:
            kern = getattr(mod, kname)
            plain = getattr(mod, kname + "_plain")
            got = as_tuple(kern(*args))
            want = as_tuple(plain(*args))
            torch.cuda.synchronize()
            if isinstance(got[-1], dict):  # the decoder's parameter grads
                got = got[:-1] + tuple(got[-1][k] for k in sorted(got[-1]))
                want = want[:-1] + tuple(want[-1][k] for k in sorted(want[-1]))
            err = 0.0
            bwd = kname.endswith("_bwd") or kname in TRAIN_ONLY
            if kname in ("xtd_sum", "embed_grid_flat_bwd",
                         "embed_grid_flat") + TC_EDGE:
                again = as_tuple(kern(*args))
                if not all(a is None and b is None or torch.equal(a, b)
                           for a, b in zip(got, again)):
                    fail(f"{kname} at {replaces}: two calls differ")
            for i, (a, b) in enumerate(zip(got, want)):
                if a is None and b is None:
                    continue
                if a.shape != b.shape or not torch.isfinite(a).all():
                    fail(f"{kname}: bad output {i} {tuple(a.shape)}")
                # backward: per output tensor, relative to its max abs
                tol = 1e-4 + 1e-4 * (b.abs().max() if bwd else b.abs())
                gap = (a - b).abs()
                if not bool((gap <= tol).all()):
                    fail(f"{kname}: kernel and plain disagree on output {i}"
                         f", max abs err {float(gap.max()):.3e}")
                err = max(err, float(gap.max()))
            ms = cuda_ms(torch, lambda: kern(*args), 10 if bwd else 20)
            call_ms = cuda_ms(torch, lambda: kern(*args), 10 if bwd else 20,
                              queued=False)
            plain_ms = cuda_ms(torch, lambda: plain(*args), 3 if bwd else 5)
            lib_ms = (cuda_ms(torch, lambda: library[kname](*args), 10)
                      if kname in library else None)
            t_bytes = bytes_ / peak_bw * 1e3
            t_ops = flops / peak_flops * 1e3
            fp32_note = ""
            if kname in ("embed_grid_flat", "embed_grid_flat_bwd") + TC_EDGE:
                # K1's, K2's, K3's, B1's, P1's, P2's and P3's products run
                # on tensor cores in 3xTF32:
                # three TF32 products per term; the fp32 CUDA-core bound
                # printed too
                fp32_note = (f"; fp32 CUDA-core bound "
                             f"{max(t_bytes, t_ops):.4f} ms")
                t_ops = 3 * flops / peak_tf32 * 1e3
            bound_ms = max(t_bytes, t_ops)
            case_ms[kname, replaces] = ms
            rule = ("1e-4 + 1e-4*max|plain| per tensor" if bwd
                    else "1e-4 + 1e-4*|plain|")
            shape = "" if replaces.endswith(tuple("0123456789")) else (
                " at " + replaces[replaces.index("(") + 1:-1])
            print(f"{kname}{shape}: max_abs_err {err:.3e} (tol {rule}); kernel "
                  f"{ms:.4f} ms (back-to-back calls unqueued: {call_ms:.4f} "
                  f"ms), plain {plain_ms:.4f} ms, library "
                  f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
                  f"{bound_ms:.4f} ms ({bytes_ / 1e6:.1f} MB, "
                  f"{flops / 1e9:.2f} GFLOP){fp32_note}")
            if kname in main_p and replaces != main_p[kname]:
                continue
            if any(r["name"] == kname for r in records):
                continue  # other shapes: printed, not recorded
            replaces = replaces.split(" (")[0]
            base = os.path.basename(mod.__file__)[:-3]
            if kname.endswith("_bwd"):
                base += "_bwd"
            source = f"neural_lam_tpu_torch/csrc/{base}.cu"
            if kname in TC_EDGE:
                source = "neural_lam_tpu_torch/csrc/edge_tc.cuh"
            records.append({
                "name": kname, "route": "cuda", "source": source,
                "replaces": replaces, "launches": None,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": lib_ms,
            })
        # the last case's outputs would count in phase 7's peak memory
        del got, want, gap, tol, b
        again = None
        # B2's, B3/B4's and B5/B6's two passes apart (xtd_sum's time from
        # its case above)
        for what, chain, chain_args, xtd_at in (
                ("edge_tail_sum_flat_bwd", edge_flat.edge_tail_bwd_chain,
                 b2_args, b2_label),
                ("edge_layer_flat_bwd", edge_flat.edge_layer_bwd_chain,
                 b3_args, b3_label),
                ("grid_update_flat_bwd", grid_update.grid_update_bwd_chain,
                 a5, f"{pgu}:752")):
            chain_ms = cuda_ms(torch, lambda: chain(*chain_args), 10)
            xtd_ms = case_ms["xtd_sum", xtd_at]
            print(f"{what} in two passes: chain {chain_ms:.4f} ms + xtd_sum "
                  f"{xtd_ms:.4f} ms = {chain_ms + xtd_ms:.4f} ms (device "
                  "time, queued)")
        print("xtd_sum's outputs: two calls bit-identical at its three "
              "callers")
        read_yardstick(torch, xtd_pairs, "the decoder's pairs")
        read_yardstick(torch, b3_pairs, "B3/B4's pairs")
        read_yardstick(torch, b2_pairs, "B2's pair")
        xtd_sweep(torch, weight_grad, b2_pairs, "B2's pair (g2m)")
        xtd_sweep(torch, weight_grad, b3_pairs, "B3/B4's two pairs (m2m[0])")
        xtd_sweep(torch, weight_grad, xtd_pairs, "the decoder's nine pairs")
    del cases, args, a4, a5, h_a4, h_pp, h_mask, hm2g, k1, xtd_pairs
    del b3_args, b3_pairs, b2_args, b2_pairs, partial, library, seg_pair
    del red_zeros, a, d_emb, bk, gathered, read_out, edges, inet
    torch.cuda.empty_cache()
    phase_end("3-4 (every kernel against its plain version)")

    # 5. the forecast paths
    zero = {k: 0 for k in FWD + BATCHED}

    def forecast_phase(net, B, want, what, full=True):
        """4-step rollout with the counters at 0 just before it: assert
        the launches per step (`want`, every other counter 0), finite
        output; predict-step time and updates/s; with `full`, a profile
        and the kernel-vs-plain predict-step gap. Returns the counts."""
        init, forcing, true = entry.make_inputs(net, B, STEPS, seed=0)
        entry.forecast(net, init, forcing[:, :1], true[:, :1])  # warm-up
        reset_counts()
        pred = entry.forecast(net, init, forcing, true)
        torch.cuda.synchronize()
        got = counts()
        n_grid = net.graph.num_grid_nodes
        if tuple(pred.shape) != (B, STEPS, n_grid, 17):
            fail(f"{what}: rollout shape {tuple(pred.shape)}")
        if not bool(torch.isfinite(pred).all()):
            fail(f"{what}: rollout output is not finite")
        want = dict(zero, **want)
        print(f"{what}: {STEPS}-step rollout, output {tuple(pred.shape)} "
              f"finite; launches per step "
              f"{ {k: got[k] / STEPS for k in want} }")
        if any(got[k] != want[k] * STEPS for k in want) or any(
                got[k + "_bwd"] for k in FWD) or any(
                    got[k] for k in TRAIN_ONLY):
            fail(f"{what}: launch counts {got}, want {want} per step and "
                 "no backward launch")

        def rollout_s(steps):
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                entry.forecast(net, init, forcing[:, :steps],
                               true[:, :steps])
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            return sorted(times)[2]

        t1, tn = rollout_s(1), rollout_s(STEPS)
        ms_step = (tn - t1) / (STEPS - 1) * 1e3
        updates = net.num_mesh_nodes * BENCH["processor_layers"] * B \
            * 1e3 / ms_step
        print(f"{what}: predict step {ms_step:.3f} ms (median of 5, "
              f"{STEPS}-step minus 1-step rollout); {updates:.4e} mesh-node "
              f"updates/s ({net.num_mesh_nodes} mesh nodes x "
              f"{BENCH['processor_layers']} layers x batch {B})")
        if not full:
            return got
        with torch.no_grad():
            ctx = net.precompute_rollout_ctx()
            profile(torch, lambda: net.predict_step(
                init[:, 1], init[:, 0], forcing[:, 0], ctx),
                f"{what} predict step")
            step_k, _ = net.predict_step(init[:, 1], init[:, 0],
                                         forcing[:, 0])
            with plain_kernels():
                step_p, _ = net.predict_step(init[:, 1], init[:, 0],
                                             forcing[:, 0])
        gap = float((step_k - step_p).abs().max())
        print(f"{what}: predict step, kernels vs plain versions on the "
              f"card: max abs gap {gap:.3e} (limit 1e-3)")
        if not gap <= 1e-3:
            fail(f"{what}: kernel path and plain path disagree")
        return got

    L = BENCH["processor_layers"]
    want = {"embed_grid_flat": 1, "edge_tail_sum_flat": 1,
            "edge_layer_flat": L, "grid_update_flat": 1}
    fwd_counts = forecast_phase(model, BATCH, want, "GraphLAM batch 4")
    # HiLAM, 4 levels: 3 init rounds over up sets, 14 rounds per layer,
    # 3 read-out rounds over down sets; at batch 4 the sets with >= 512
    # virtual rows (m2m[0], m2m[1], up[0], down[0], down[1]) go flat
    hi_fwd = {"embed_grid_flat": 1, "edge_tail_sum_flat": 1,
              "edge_layer_flat": 1 + 7 * L + 2, "grid_update_flat": 1,
              "edge_tail": 1, "edge_layer": 2 + 7 * L}
    forecast_phase(hilam, BATCH, hi_fwd, "HiLAM batch 4")
    p_counts = forecast_phase(hilam, 1, {
        "edge_tail": 3, "edge_tail_sum": 2, "edge_layer": 3 + 14 * L},
        "HiLAM batch 1")
    forecast_phase(model, 1, {"edge_tail_sum": 2, "edge_layer": L},
                   "GraphLAM batch 1", full=False)
    del hilam, hg
    torch.cuda.empty_cache()
    phase_end("5 (the forecast paths)")

    # 6. small models: card (kernels) against CPU (plain versions)
    def card_vs_cpu(kind, nx, B, min_virt, what):
        message_passing._FLAT_MIN_VIRT = min_virt
        try:
            preds = []
            for dev in ("cpu", "cuda"):
                m, _ = entry.build_model(nx=nx, ny=nx, hidden_dim=64,
                                         processor_layers=2, n_timesteps=20,
                                         device=dev, seed=1, model=kind)
                inputs = entry.make_inputs(m, B, 3, seed=1)
                preds.append(entry.forecast(m, *inputs).cpu())
        finally:
            message_passing._FLAT_MIN_VIRT = FLAT_MIN_VIRT
        small_gap = float((preds[0] - preds[1]).abs().max())
        print(f"{what} rollout, card vs CPU: max abs gap {small_gap:.3e} "
              f"(limit 5e-4)")
        if not small_gap <= 5e-4:
            fail(f"{what}: card and CPU rollouts disagree")

    FLAT_MIN_VIRT = message_passing._FLAT_MIN_VIRT
    card_vs_cpu("graph_lam", 16, 2, FLAT_MIN_VIRT,
                "16x16 GraphLAM batch 2 (batched route)")
    card_vs_cpu("graph_lam", 16, 2, 1, "16x16 GraphLAM batch 2 (flat route)")
    for B in (1, 2):
        card_vs_cpu("hi_lam", 30, B, FLAT_MIN_VIRT,
                    f"30x30 HiLAM (2 levels) batch {B}")
    phase_end("6 (small models, card vs CPU)")

    # 7. the training path at bench width
    def train_phase(net, ds, want, what):
        """One AdamW step at batch 4 with every counter at 0 just before
        it: assert `want` (every other counter 0) and a finite loss; one
        step's parameter gradients, kernel path against plain path within
        1e-3 * max abs; the step time (median of 7), samples/s, peak
        memory and a profile. Returns the counts."""
        entry.train_steps(net, ds, BATCH, 1, steps=1, seed=0,
                          device="cuda")  # warm-up
        reset_counts()
        losses = entry.train_steps(net, ds, BATCH, 1, steps=1, seed=1,
                                   device="cuda")
        torch.cuda.synchronize()
        got = counts()
        want = dict(dict(zero, xtd_sum=0, xtd_reduce=0,
                         **{k + "_bwd": 0 for k in FWD}), **want)
        print(f"{what} training step: loss {losses[0]:.6f}; launches {got}")
        if not all(map(math.isfinite, losses)):
            fail(f"{what} training loss is not finite: {losses}")
        if got != want:
            fail(f"{what} training launch counts {got}, want {want}")

        trainer, dm = entry.make_trainer(net, ds, BATCH, 1, seed=2)
        batch = next(trainer.train_batches(dm, 0))

        def grads():
            net.zero_grad(set_to_none=True)
            net.training_loss(batch).backward()
            return {k: p.grad.detach().clone()
                    for k, p in net.named_parameters()}

        g_k = grads()
        with plain_kernels():
            g_p = grads()
        worst = max((float((g_k[k] - g_p[k]).abs().max())
                     / max(float(g_p[k].abs().max()), 1e-30), k)
                    for k in g_p)
        print(f"{what} training gradients, kernels vs plain versions on "
              f"the card: worst max abs gap / max abs {worst[0]:.3e} "
              f"({worst[1]}; limit 1e-3), {len(g_p)} parameters")
        if not worst[0] <= 1e-3:
            fail(f"{what}: kernel-path and plain-path gradients disagree")
        del g_k, g_p
        net.zero_grad(set_to_none=True)

        times = []
        for i in range(9):
            torch.cuda.synchronize()
            if i == 2:
                torch.cuda.reset_peak_memory_stats()
                live = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            trainer.train_step(batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if i == 2:
                peak = torch.cuda.max_memory_allocated()
        ms_train = sorted(times[2:])[3] * 1e3
        print(f"{what} train step (fwd+bwd+AdamW, ar_steps 1, batch "
              f"{BATCH}): {ms_train:.3f} ms (median of 7 after 2 warm-up "
              f"steps); {BATCH * 1000 / ms_train:.2f} samples/s; peak "
              f"device memory {peak / 2**30:.3f} GiB (max_memory_allocated "
              f"over one step; {live / 2**30:.3f} GiB live before it)")
        profile(torch, lambda: trainer.train_step(batch),
                f"{what} train step")
        return got

    # GraphLAM: K1-K4 1/1/4/1 and their backward kernels B1/B2/B3/B5 once
    # each a forward launch; xtd_sum (and its reduce kernel) once for the
    # decoder, once for B2 and once a B3/B4 call
    train_counts = train_phase(model, datastore, dict(
        want, **{k + "_bwd": n for k, n in want.items()},
        xtd_sum=2 + L, xtd_reduce=2 + L), "GraphLAM")
    for rec in records:
        n = rec["name"]
        rec["launches"] = (train_counts[n]
                           if n.endswith("_bwd") or n in TRAIN_ONLY
                           else p_counts[n] if n in BATCHED
                           else fwd_counts[n])
    del model, datastore
    torch.cuda.empty_cache()
    # HiLAM, batch 4 (mixed route): the forward's launches of phase 5b (K1
    # 1, K2 1, K3 31, K4 1, P1 1, P3 30); a backward kernel for each flat
    # launch (B1 1, B2 1, B3/B4 31, B5 1) and xtd_sum with its reduce
    # kernel once for the decoder, once for B2 and once a B3/B4 call (33);
    # P1-P3 have none (their backward recomputes through the plain
    # versions)
    hilam, hds = entry.build_model(**BENCH, device="cuda", model="hi_lam")
    hi_want = dict(hi_fwd, **{k + "_bwd": n for k, n in hi_fwd.items()
                              if k in FWD},
                   xtd_sum=2 + hi_fwd["edge_layer_flat"],
                   xtd_reduce=2 + hi_fwd["edge_layer_flat"])
    train_phase(hilam, hds, hi_want, "HiLAM")
    del hilam, hds
    torch.cuda.empty_cache()
    phase_end("7 (training at bench width)")

    # 8. small models trained on the card and on the CPU, on both routes
    small = dict(nx=16, ny=16, hidden_dim=64, processor_layers=2,
                 n_timesteps=20)
    for kind, nx, B, min_virt, what in (
            ("graph_lam", 16, 2, FLAT_MIN_VIRT, "16x16 GraphLAM batch 2 "
             "(batched route)"),
            ("graph_lam", 16, 2, 1, "16x16 GraphLAM batch 2 (flat route)"),
            ("hi_lam", 30, 1, FLAT_MIN_VIRT, "30x30 HiLAM (2 levels) batch "
             "1 (batched route)"),
            ("hi_lam", 30, 2, 100, "30x30 HiLAM (2 levels) batch 2 (mixed "
             "route)")):
        message_passing._FLAT_MIN_VIRT = min_virt
        try:
            trajectories = []
            for dev in ("cpu", "cuda"):
                m, ds = entry.build_model(**dict(small, nx=nx, ny=nx),
                                          device=dev, seed=1, model=kind)
                trajectories.append(entry.train_steps(
                    m, ds, B, 1, steps=3, seed=1, device=dev))
        finally:
            message_passing._FLAT_MIN_VIRT = FLAT_MIN_VIRT
        rel = max(abs(a - b) / abs(a) for a, b in zip(*trajectories))
        print(f"{what} training, 3 AdamW steps: CPU losses "
              f"{trajectories[0]}, card losses {trajectories[1]}; max rel "
              f"gap {rel:.3e} (limit 1e-4)")
        if not rel <= 1e-4:
            fail(f"{what}: card and CPU training trajectories disagree")
    phase_end("8 (small models trained on card and CPU)")

    # the bench GraphLAM's graph and decoder weights, still bound here,
    # would count in phase 9's peak memory
    del g, m2g, mask_p, emb, pp, m, ds
    gc.collect()
    torch.cuda.empty_cache()
    serving_phase(torch, np, counts, reset_counts, plain_kernels,
                  dict(zero, xtd_sum=0, xtd_reduce=0,
                       **{k + "_bwd": 0 for k in FWD}))
    phase_end("9 (serving and evaluation through the CLIs)")

    # 10. datastores built by the port's tools
    import tempfile
    from pathlib import Path

    zero_all = dict(zero, xtd_sum=0, xtd_reduce=0,
                    **{k + "_bwd": 0 for k in FWD})
    for part, prefix in ((mdp_tool_phase, "nlt_mdp_"),
                         (meps_tool_phase, "nlt_meps_")):
        with tempfile.TemporaryDirectory(prefix=prefix) as tmp:
            part(torch, np, Path(tmp), counts, reset_counts, plain_kernels,
                 zero_all)
        gc.collect()
        torch.cuda.empty_cache()
    phase_end("10 (datastores built by the port)")

    print(json.dumps({"kernels": records}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
