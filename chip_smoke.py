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
   off, as their library time; K4's products as three `torch.mm` calls,
   TF32 off, its library time); K1, K2, K3, P1, P2 and P3 also give
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
11. The bf16 forecast path (`compute_dtype="bfloat16"`): the bench-width
   GraphLAM and HiLAM built in bf16 through `entry.build_model`. The bf16
   instances of K1-K4, P2 and P3 (bf16 in and out, fp32 math) at their
   main-path shapes (K1-K4 at GraphLAM's batch 4, P2 at HiLAM's m2g and
   P3 at its m2m[0], batch 1) and at every K from 1 to 8 on phase 3's
   seeded local graphs (K2-K4 at batch 4, P2 with messages and P3 at
   batch 1): each must launch its bf16 instance, be within one bf16 ulp
   of its plain version (2^-20 of the largest |plain| where a sum
   cancels), with the share not bit-equal printed, and give
   bit-identical outputs in two calls; at the main-path shapes each is
   timed with its fp32 instance on the same values, its plain version
   and its products as `torch.mm` calls on bf16 operands, beside its
   bound (bf16 bytes, or its TF32 products on tensor cores: three a term,
   two where the A operand is a staged bf16 value, the first products of
   K1, K3 and P3; fp32 FLOP for K4). Then 4-step bf16 rollouts through `entry.forecast` with the
   counters at 0 just before each, asserting the launches per step and
   the dtype each kernel ran in: GraphLAM batch 4 K1/K2/K3/K4 bf16
   1/1/4/1; HiLAM batch 4 K1/K2/K3/K4 1/1/31/1 and P3 30 in bf16, P1 1
   in fp32; HiLAM batch 1 P2/P3 2/59 in bf16, P1 3 in fp32; GraphLAM
   batch 1 P2/P3 2/4 in bf16. For each: the bf16 and fp32 steps' host
   clocks, peak memory and profiles (the fp32 step on the same weights),
   and the size of the kernel path's bf16 error against the fp32 step
   next to the plain bf16 path's: mean abs within 0.9-1.1x, max within
   0.5-1.5x, the kernel path's bf16-vs-fp32 gap at least half the plain
   path's (bf16 storage makes the raw kernel-vs-plain gap of the order
   of the bf16 effect: one fp32 last-bit difference flips a rounding,
   and the flip spreads). Last, `predict.main --precision bf16`
   forecasts 4 steps at batch 1 on a 268x238 MDP datastore for a seeded
   GraphLAM and HiLAM (launches asserted: P2/P3 2/4 in bf16; P2/P3 2/59
   in bf16 and P1 3 in fp32), held the same way against the plain bf16
   path and the fp32 rollout, with the warm ms a step of both dtypes;
   `train.main --eval test --precision bf16` scores each (a batch of 4
   on the flat or mixed route and a partial batch of 1 on the batched
   route, 2 steps each; launches asserted by dtype), its files written
   and its error maps within 1e-3 x state_std and losses within 1e-4
   relative of the plain bf16 path's, the fp32 call's printed beside
   them.
12. bf16 training (`compute_dtype="bfloat16"`, `train.main --precision
   bf16`): a. the bf16 instances of the backward kernels at their
   main-path shapes on the bf16 bench GraphLAM at batch 4 (B1 at the
   training step's call, no dx, and with dx; B2 at g2m; B3/B4 at m2m[0];
   B5/B6 at m2g; `xtd_sum` at B3/B4's and the decoder's pairs, whose X is
   bf16 for dW_e and enc_w0) and, B2, B3/B4, B5/B6 and `xtd_sum` with
   bf16-X pairs, at every K from 1 to 8 on phase 3's seeded local graphs
   (batch 4): each must launch its bf16 instance, give bit-identical
   outputs in two calls, and match its plain version: bf16 outputs within
   one bf16 ulp (2^-20 of the largest |plain| where a sum cancels), under
   0.1% not bit-equal, fp32 gradients within 1e-4 + 1e-4 * max|plain|;
   at the main-path shapes each is timed with its fp32 instance on the
   same values widened, its plain version and (xtd_sum, B1) its products
   as torch calls, beside its bound (bf16 bytes, or operations: fp32 for
   the chains, TF32 products on tensor cores for B1 and xtd_sum, two a
   term where the A operand is a staged bf16 value). b. One AdamW step of
   the bf16 bench GraphLAM and HiLAM at batch 4 through
   `entry.train_steps`, the counters at 0 just before it: phase 7's
   launches on the bf16 counters (P1 fp32; B2's `xtd_sum` launch fp32,
   its one pair being the chain's fp32 X1 and DY); the kernel path's
   bf16-vs-fp32 parameter gradients (each parameter's over its fp32 max
   abs) the size of the plain bf16 path's (`error_size`); the bf16 and
   fp32 steps' host ms (median of 7), peak memory and profiles. c.
   `train.main --precision bf16` trains GraphLAM 2 steps on a 268x238
   MDP datastore (the backward kernels' bf16 instances must launch, none
   of their fp32 ones but B2's `xtd_sum`), and `train.main --eval test
   --precision bf16` scores its checkpoint (finite, files written).

13. The rest of training. a. `--remat`: one AdamW step without and with
   `ModelArgs.remat` on the same weights and batch: the bench GraphLAM
   at ar_steps 4 in fp32 and on the bf16 path (the same weights), the
   bench HiLAM at ar_steps 2 in fp32. The losses within 1e-6 relative;
   the fp32 gradients within 1e-4 + 1e-4 * max abs per tensor, the bf16
   ones held by phase 12's error-size limits against the fp32 gradients;
   with remat each forward kernel launches twice its count without it,
   each backward kernel (and `xtd_sum`) as often. Each way's busy ms (a
   profile), host ms and peak memory above the live set. b. `train.main`
   on a 268x238 MDP datastore (32 train steps: 6 batches of 4) for 6
   steps at ar_steps 2, with `--num_workers 0 --prefetch_batches 0`, with
   `--num_workers 4 --prefetch_batches 2`, and with those and `--remat
   --profile_steps 2`, the chunk cache emptied before each: the same
   batches in the same order as the first run (checksums of every batch
   tensor equal), the first loss equal and the others within 1e-4
   relative; the same number of chunks decoded (each chunk once); the
   launches of the first two equal, and in the third the forward kernels
   twice, the backward ones once as often; its trace written and a port
   kernel among its top device ops; the epoch s, batches/s and input wait
   a step (and the gaps between steps) of each. c. `train.main` in a subprocess on the card gets
   SIGTERM after its first logged epoch: exit code 0 and `last` saved
   with "preempted": true; `train.main --load auto --restore_opt` then
   resumes from its step and one epoch later saves `last` 6 steps on.

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
# the kernels with a bf16 instance (K1-K4, P2, P3, B1, B2, B3/B4, B5/B6
# and xtd_sum with its reduce kernel); P1 runs fp32 in the bf16 path
BF16 = (FWD + ("edge_tail_sum", "edge_layer")
        + tuple(k + "_bwd" for k in FWD) + TRAIN_ONLY)


def fail(msg):
    raise RuntimeError(msg)


def kernel_registry():
    """(reset_counts, counts, counts_bf16, plain_kernels) over every kernel
    wrapper: counts() gives each wrapper's float32 launches (`launches`),
    counts_bf16() the bf16 instances' (`launches_bf16`) of BF16, and
    inside plain_kernels() the model's kernel calls go to the plain
    versions (autograd through the plain forward)."""
    from neural_lam_tpu_torch.ops import (
        edge,
        edge_flat,
        embed,
        grid_update,
        weight_grad,
    )

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
            if hasattr(w, "launches_bf16"):
                w.launches_bf16 = 0

    def counts():
        return {k: w.launches for k, w in wrappers.items()}

    def counts_bf16():
        return {k: wrappers[k].launches_bf16 for k in BF16}

    @contextlib.contextmanager
    def plain_kernels():
        for k, m in mods.items():
            plain = getattr(m, k + "_plain")
            setattr(m, k, lambda *a, fold=None, _p=plain, **kw: _p(*a, **kw))
        try:
            yield
        finally:
            for k, m in mods.items():
                setattr(m, k, wrappers[k])

    return reset_counts, counts, counts_bf16, plain_kernels


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
    bf16 = " [bf16]" if "__nv_bfloat16" in mangled else ""
    return f"{tag}{name}" + (f"<{', '.join(args)}>" if args else "") + bf16


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


def profile(torch, step, what, steps=3, top=12, cpu=True):
    """Device time by kernel over `steps` calls of `step` (torch.profiler),
    and the device's busy share of the profiled window's wall time (the
    profiler's own host overhead lengthens that window; `cpu=False` traces
    the device alone, which costs the host less). Prints the seconds the
    profile took. Returns (busy ms, wall ms) a call, or None when the
    profiler saw no device time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    t_start = time.perf_counter()
    step()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)
    with tprofile(activities=activities) as prof:
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
          f"(idle share {1 - busy_ms / wall_ms:.3f}; "
          f"{'CPU and ' if cpu else ''}CUDA traced; profiled in "
          f"{time.perf_counter() - t_start:.1f} s)")
    for us, count, key in rows[:top]:
        print(f"  {us / 1e3 / steps:.4f} ms/{what}  {count / steps:g} "
              f"calls/{what}  {key[:90]}")
    return busy_ms, wall_ms


def write_mdp_datastore(root, np, nx=268, ny=238, n_t=28, seed=0,
                        n_train=12):
    """An MDP ("training-ready" zarr) datastore laid out as the repo's test
    fixture lays it out, at the bench grid: 17 state, 6 forcing and 4
    static features, 3-hourly times split n_train/6/rest (12/6/10) into
    train/val/test, statistics over the train split, chunks of two time
    steps zlib-compressed (level 1).
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
    bounds = [(0, n_train - 1), (n_train, n_train + 5),
              (n_train + 6, n_t - 1)]
    write_zarr_array(zarr, "splits", np.array(
        [[str(times[i].astype("datetime64[s]")) for i in b] for b in bounds],
        dtype=object), dims=["split_name", "split_part"], compressor=None)
    write_zarr_array(zarr, "split_name", np.array(
        ["train", "val", "test"], dtype=object), dims=["split_name"],
        compressor=None)
    write_zarr_array(zarr, "split_part", np.array(
        ["start", "end"], dtype=object), dims=["split_part"],
        compressor=None)
    train = state[:n_train]
    diffs = np.diff(train, axis=0)
    for name, arr, dim in (
            ("state__train__mean", train.mean(axis=(0, 1)), "state"),
            ("state__train__std", train.std(axis=(0, 1)), "state"),
            ("state__train__diff_mean", diffs.mean(axis=(0, 1)), "state"),
            ("state__train__diff_std", diffs.std(axis=(0, 1)), "state"),
            ("forcing__train__mean", forcing[:n_train].mean(axis=(0, 1)),
             "forcing"),
            ("forcing__train__std", forcing[:n_train].std(axis=(0, 1)),
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


def captured(fn, *args):
    """(fn(*args), its standard output), the output printed after the call
    with each line prefixed (the CLIs print JSON lines of their own), also
    when it raises."""
    import io

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            result = fn(*args)
    finally:
        for line in buf.getvalue().splitlines():
            print(f"  | {line}")
    return result, buf.getvalue()


def quiet(fn, *args):
    """fn(*args), its standard output printed as `captured` prints it."""
    return captured(fn, *args)[0]


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


def bf16_gap(torch, got, want):
    """(share not bit-equal, worst gap over its limit, max abs gap) of a
    bf16 output against its plain version's: the limit is one bf16 ulp of
    the larger magnitude, or 2^-20 of the largest |want| where a sum
    cancels to near zero (the fp32 error of that sum)."""
    if got.dtype != torch.bfloat16 or want.dtype != torch.bfloat16:
        fail(f"bf16 outputs expected, got {got.dtype} and {want.dtype}")
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0**-126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    tol = torch.maximum(ulp, 2.0**-20 * w.abs().max())
    gap = (g - w).abs()
    return (float((g != w).float().mean()), float((gap / tol).max()),
            float(gap.max()))


def error_size(torch, what, k16, ref16, k32):
    """The bf16 error of `k16` (kernels) against the fp32 output `k32`
    against that of `ref16` (the plain bf16 path): mean abs within
    0.9-1.1x, max abs within 0.5-1.5x, and k16's bf16-vs-fp32 gap at
    least half of ref16's; prints them and the gap k16 vs ref16."""
    k16, ref16, k32 = (torch.as_tensor(t).float() for t in (k16, ref16, k32))
    e_k, e_r = (k16 - k32).abs(), (ref16 - k32).abs()
    mean_r = float(e_k.mean() / e_r.mean())
    max_r = float(e_k.max() / e_r.max())
    gap = float((k16 - ref16).abs().max())
    share = float((k16 != ref16).float().mean())
    print(f"{what}: bf16 error against fp32, kernels / plain: mean "
          f"{float(e_k.mean()):.4e} / {float(e_r.mean()):.4e} = {mean_r:.4f} "
          f"(limit 0.9-1.1), max {float(e_k.max()):.4e} / "
          f"{float(e_r.max()):.4e} = {max_r:.4f} (limit 0.5-1.5); kernels "
          f"vs plain bf16: max abs gap {gap:.4e} ({gap / float(e_r.max()):.3f}"
          f" of the bf16-vs-fp32 gap), {share:.4f} of the outputs differ")
    if not (0.9 <= mean_r <= 1.1 and 0.5 <= max_r <= 1.5
            and float(e_k.max()) >= 0.5 * float(e_r.max())):
        fail(f"{what}: the kernel path's bf16 error is not the plain "
             "path's size")


def bf16_eval(torch, np, root, cfg, counts, counts_bf16, reset_counts,
              plain_kernels):
    """Phase 11's evaluation: `train.main --eval test --precision bf16`
    for the seeded GraphLAM and HiLAM under root/models (5 test samples: a
    batch of 4 on the flat or mixed route and a partial batch of 1 on the
    batched route, 2 steps each), through the kernels (bf16 and fp32
    launches asserted) and through the plain versions: its files written,
    its csv error maps within 1e-3 x state_std and its losses within 1e-4
    relative of the plain bf16 path's, phase 9's limits (the two paths'
    outputs differ by a bf16 rounding here and there, see `error_size`,
    but a score averages over the grid), the fp32 call's scores printed
    beside them."""
    import importlib.util

    from neural_lam_tpu_torch import train
    from neural_lam_tpu_torch.config import load_config_and_datastore

    L = BENCH["processor_layers"]
    plots = importlib.util.find_spec("matplotlib") is not None
    _, ds = load_config_and_datastore(cfg)
    std = np.asarray(ds.get_standardization_dataarray("state")["state_std"])
    argv = ["--config_path", str(cfg), *WIDTH, "--batch_size", "4",
            "--ar_steps_eval", "2", "--val_steps_to_log", "1", "2",
            "--save_dir", str(root / "models"), "--eval", "test",
            "--n_example_pred", "0"]
    # a step: the batch of 4 (bf16 instances; P1 fp32) and the batch of 1
    full_g = {"embed_grid_flat": 1, "edge_tail_sum_flat": 1,
              "edge_layer_flat": L, "grid_update_flat": 1}
    for kind, graph, full16, full32, part16, part32 in (
            ("graph_lam", "multiscale", full_g, {},
             {"edge_tail_sum": 2, "edge_layer": L}, {}),
            ("hi_lam", "hierarchical",
             dict(full_g, edge_layer_flat=3 + 7 * L, edge_layer=2 + 7 * L),
             {"edge_tail": 1}, {"edge_tail_sum": 2, "edge_layer": 3 + 14 * L},
             {"edge_tail": 3})):
        want16, want32 = {}, {}
        # 2 steps each; with figures, the CLI runs the batch of 4 once more
        for parts, want in (((full16, part16) + ((full16,) if plots else ()),
                             want16),
                            ((full32, part32) + ((full32,) if plots else ()),
                             want32)):
            for part in parts:
                for k, n in part.items():
                    want[k] = want.get(k, 0) + 2 * n
        out, dirs = {}, {}
        for path, prec, ctx in (
                ("kernels", "bf16", contextlib.nullcontext),
                ("plain", "bf16", plain_kernels),
                ("fp32", "32", contextlib.nullcontext)):
            run = f"bf16_test_{kind}_{path}"
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            with ctx():
                out[path] = quiet(train.main, argv + [
                    "--model", kind, "--graph", graph, "--load",
                    str(root / "models" / kind), "--precision", prec,
                    "--run_name", run])
            torch.cuda.synchronize()
            dt = time.time() - t0
            c16 = {k: n for k, n in counts_bf16().items() if n}
            c32 = {k: n for k, n in counts().items() if n}
            print(f"train.main --eval test {kind} --precision {prec} "
                  f"({path}): {dt:.2f} s (host clock, set-up included); "
                  f"launches bf16 {c16}, fp32 {c32}")
            if path == "kernels" and (c16 != want16 or c32 != want32):
                fail(f"train.main --eval test {kind} --precision bf16: "
                     f"launches {c16} (bf16), {c32} (fp32); want {want16}, "
                     f"{want32}")
            dirs[path] = root / "models" / run
            files = {f.name for f in dirs[path].iterdir()}
            need = {"mean_spatial_loss.npy", "metrics.jsonl",
                    "spatial_loss_t1.npy", "spatial_loss_t2.npy",
                    "test_mae.csv", "test_rmse.csv"}
            if not need <= files:
                fail(f"train.main --eval test {kind} --precision {prec}: "
                     f"files {sorted(files)} lack {sorted(need - files)}")
        gaps, effect = {}, {}
        for name in ("test_rmse.csv", "test_mae.csv"):
            k16, p16, k32 = (np.loadtxt(dirs[p] / name, delimiter=",",
                                        ndmin=2)
                             for p in ("kernels", "plain", "fp32"))
            if k16.shape != (2, len(std)) or not np.isfinite(k16).all():
                fail(f"train.main --eval test {kind} --precision bf16: "
                     f"{name} {k16.shape}, finite {np.isfinite(k16).all()}")
            gaps[name] = float((np.abs(k16 - p16) / std).max())
            effect[name] = float((np.abs(p16 - k32) / std).max())
        for k, v in out["kernels"].items():
            if k.startswith("test_mean_loss") or k.startswith("test_loss"):
                w = float(out["plain"][k])
                if not math.isfinite(float(v)):
                    fail(f"train.main --eval test {kind} --precision bf16: "
                         f"{k} {v}")
                gaps[k] = abs(float(v) - w) / abs(w)
                effect[k] = abs(w - float(out["fp32"][k])) / abs(w)
        print(f"train.main --eval test {kind} --precision bf16: kernels vs "
              "plain bf16 path (bf16 vs fp32 on the plain path): "
              + ", ".join(f"{k} {g:.3e} ({effect[k]:.3e})"
                          for k, g in gaps.items())
              + " (limits: csv 1e-3 x state_std, losses 1e-4 relative)")
        if any(g > (1e-3 if k.endswith(".csv") else 1e-4)
               for k, g in gaps.items()):
            fail(f"train.main --eval test {kind} --precision bf16: the "
                 "kernel path's scores differ from the plain bf16 path's")


def mlp_tail(mlp):
    """An edge MLP's second layer and LayerNorm, detached."""
    return tuple(t.detach() for t in (mlp.layers[1].w, mlp.layers[1].b,
                                      mlp.ln.scale, mlp.ln.bias))


def mlp_first(mlp):
    """A processor edge MLP's W_e (the edge rows of its first layer) and
    b0, detached."""
    w0 = mlp.layers[0].w.detach()
    return w0[:H], mlp.layers[0].b.detach()


def bf16_cases(torch, gm, hm, rand):
    """Phase 11's main-path cases of the bf16 instances, on the bf16
    bench GraphLAM `gm` and HiLAM `hm` with bf16 inputs from `rand`: K1-K4
    at GraphLAM's batch 4, P2 at HiLAM's m2g and P3 at its m2m[0], batch
    1. Each is (kernel, module, args, replaces, source, bytes, FLOP, TF32
    FLOP on tensor cores (None: fp32 CUDA cores), the library call for its
    products on bf16 operands); a 3xTF32 product takes three TF32 products
    a term, two where its A operand is a bf16 value (its small half is
    zero: the first products of K1, K3 and P3)."""
    from neural_lam_tpu_torch.ops import edge, edge_flat, embed, grid_update

    bf = torch.bfloat16
    W = BATCH * H
    tail, first = mlp_tail, mlp_first
    g, hg = gm.graph, hm.graph
    emb = gm.grid_embedder
    d_in = emb.layers[0].w.shape[0]
    n_grid = g.num_grid_nodes
    pp = {k: v.detach() for k, v in
          grid_update.pack_grid_update_params(gm).items()}
    d_out = pp["o_w1"].shape[1]
    pef = "neural_lam_tpu/ops/pallas_edge_flat.py"
    csrc = "neural_lam_tpu_torch/csrc/"
    cases = []
    rows = n_grid * BATCH
    k1 = (rand(n_grid, BATCH * d_in),) + tuple(
        t.detach() for t in (emb.layers[0].w, emb.layers[0].b,
                             emb.layers[1].w, emb.layers[1].b, emb.ln.scale,
                             emb.ln.bias)) + (BATCH,)
    w0b, w1b = k1[1].to(bf), k1[3].to(bf)
    cases.append((
        "embed_grid_flat", embed, k1, "neural_lam_tpu/ops/pallas_embed.py:99",
        csrc + "embed.cu", nbytes(*k1[:7]) + rows * H * 2,
        2.0 * rows * (d_in * H + H * H),
        2.0 * rows * (2 * d_in + 3 * H) * H,
        lambda: torch.mm(torch.mm(k1[0].view(-1, d_in), w0b), w1b)))
    es = g.g2m
    nv, K = es.num_virt, es.dense_k
    mask_p = es.mask.view(nv, K)
    a2 = (rand(es.num_send, W), es.senders, rand(nv * K, H), rand(nv, W),
          mask_p) + tail(gm.g2m_gnn.edge_mlp)
    g2 = a2[0].index_select(0, es.senders).view(-1, H)
    w2b = a2[5].to(bf)
    cases.append((
        "edge_tail_sum_flat", edge_flat, a2, f"{pef}:373",
        csrc + "edge_tc.cuh", nbytes(*a2) + nv * W * 2,
        2.0 * float(mask_p.sum()) * BATCH * H * H,
        3 * 2.0 * float(mask_p.sum()) * BATCH * H * H,
        lambda: torch.mm(g2, w2b)))
    es = g.m2m[0]
    nv, K = es.num_virt, es.dense_k
    mask_p = es.mask.view(nv, K)
    lay = gm.processor[0].edge_mlp
    a3 = (rand(nv * K, W), rand(es.num_send, W), es.senders, rand(nv, W),
          mask_p) + first(lay) + tail(lay)
    e3, web3, w2b3 = a3[0].view(-1, H), a3[5].to(bf), a3[7].to(bf)
    cases.append((
        "edge_layer_flat", edge_flat, a3, f"{pef}:727", csrc + "edge_tc.cuh",
        nbytes(*a3) + nv * K * W * 2 + nv * W * 2,
        2.0 * nv * K * BATCH * 2 * H * H,
        (2 + 3) * 2.0 * nv * K * BATCH * H * H,
        lambda: (torch.mm(e3, web3), torch.mm(e3, w2b3))))
    es = g.m2g
    nv, K = es.num_virt, es.dense_k
    mask_p = es.mask.view(nv, K)
    a4 = (rand(es.num_send, W), es.senders, rand(nv * K, H), rand(n_grid, W),
          mask_p, pp)
    # K4's products as three torch.mm calls: the six 64x64 node products
    # (encoder 2, w_i, aggregation 3 with its 128 inputs as two) in one,
    # the edge product, the output map
    node4 = a4[3].view(-1, H)
    wn4 = torch.cat([pp[k] for k in ("enc_w0", "enc_w1", "w_i", "a_w1",
                                     "o_w0")] + [pp["a_w0"][:H],
                                                 pp["a_w0"][H:]], 1).to(bf)
    g4 = a4[0].index_select(0, es.senders).view(-1, H)
    w24, wo4 = pp["w2"].to(bf), pp["o_w1"].to(bf)
    cases.append((
        "grid_update_flat", grid_update, a4,
        "neural_lam_tpu/ops/pallas_grid_update.py:174",
        csrc + "grid_update.cu",
        nbytes(*a4[:5], *pp.values()) + nv * BATCH * d_out * 2,
        2.0 * nv * BATCH * (7 * H * H + H * d_out)
        + 2.0 * float(mask_p.sum()) * BATCH * H * H, None,
        lambda: (torch.mm(node4, wn4), torch.mm(g4, w24),
                 torch.mm(node4, wo4))))
    es = hg.m2g
    nv, K = es.num_virt, es.dense_k
    mlp = hm.m2g_gnn.edge_mlp
    a5 = (rand(1, es.num_send, H), es.senders, rand(nv * K, H),
          rand(1, nv, H)) + tail(mlp) + (es.mask, K, False)
    g5 = a5[0].index_select(1, es.senders).view(-1, H)
    w2b5 = a5[4].to(bf)
    cases.append((
        "edge_tail_sum", edge, a5, f"{PALLAS_EDGE}:182",
        csrc + "edge_tc.cuh",
        nbytes(*(t for t in a5 if torch.is_tensor(t))) + nv * H * 2,
        2.0 * float(es.mask.sum()) * H * H,
        3 * 2.0 * float(es.mask.sum()) * H * H,
        lambda: torch.mm(g5, w2b5)))
    es = hg.m2m[0]
    nv, K = es.num_virt, es.dense_k
    lay = hm.mesh_up_same_gnns[0][0].edge_mlp
    a6 = (rand(1, nv * K, H), rand(1, es.num_send, H), es.senders,
          rand(1, nv, H), es.mask) + first(lay) + tail(lay) + (K,)
    e6, web6, w2b6 = a6[0].view(-1, H), a6[5].to(bf), a6[7].to(bf)
    cases.append((
        "edge_layer", edge, a6, f"{PALLAS_EDGE}:304", csrc + "edge_tc.cuh",
        nbytes(*(t for t in a6 if torch.is_tensor(t))) + nv * K * H * 2
        + nv * H * 2, 2.0 * nv * K * 2 * H * H,
        (2 + 3) * 2.0 * nv * K * H * H,
        lambda: (torch.mm(e6, web6), torch.mm(e6, w2b6))))

    return cases


def bf16_check(torch, counts_bf16, name, mod, args, what):
    """The bf16 instance of kernel `name` (in `mod`) against its plain
    version (bf16 in and out) within one bf16 ulp, two calls bit-identical;
    returns (share not bit-equal, max abs)."""
    kern, plain = getattr(mod, name), getattr(mod, name + "_plain")
    before = counts_bf16()[name]
    got, again = as_tuple(kern(*args)), as_tuple(kern(*args))
    want = as_tuple(plain(*args))
    torch.cuda.synchronize()
    if counts_bf16()[name] != before + 2:
        fail(f"{name} [bf16] at {what}: its bf16 instance did not run")
    if not all(a is None and b is None or torch.equal(a, b)
               for a, b in zip(got, again)):
        fail(f"{name} [bf16] at {what}: two calls differ")
    share, err = 0.0, 0.0
    for a, b in zip(got, want):
        if a is None and b is None:
            continue
        if a.shape != b.shape or not torch.isfinite(a.float()).all():
            fail(f"{name} [bf16] at {what}: bad output {tuple(a.shape)}")
        s, worst, gap = bf16_gap(torch, a, b)
        if worst > 1.0:
            fail(f"{name} [bf16] at {what}: kernel and plain differ by "
                 f"{worst:.2f} x one bf16 ulp")
        share, err = max(share, s), max(err, gap)
    return share, err


def bf16_phase(torch, np, counts, counts_bf16, reset_counts, plain_kernels,
               records, peak_flops, peak_tf32, peak_bw):
    """Phase 11: the bf16 forecast path on the card (module doc)."""
    import copy
    import tempfile
    from pathlib import Path

    from neural_lam_tpu_torch import entry, predict
    from neural_lam_tpu_torch.checkpoint import save_checkpoint
    from neural_lam_tpu_torch.config import load_config_and_datastore
    from neural_lam_tpu_torch.datastore.zarr_reader import ZarrGroup
    from neural_lam_tpu_torch.graph.storage import load_or_build_graph
    from neural_lam_tpu_torch.models import MODELS
    from neural_lam_tpu_torch.models.ar_model import ModelArgs
    from neural_lam_tpu_torch.ops import edge, edge_flat, grid_update
    from neural_lam_tpu_torch.ops.message_passing import EdgeSet

    bf = torch.bfloat16
    t0 = time.time()
    gm, gds = entry.build_model(**BENCH, device="cuda",
                                compute_dtype="bfloat16")
    hm, _ = entry.build_model(**BENCH, device="cuda",
                              compute_dtype="bfloat16", model="hi_lam")
    print(f"bf16 GraphLAM and HiLAM (the bench configuration, "
          f"compute_dtype='bfloat16') built in {time.time() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(11)
    W = BATCH * H

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(bf)

    tail, first = mlp_tail, mlp_first
    n_grid = gm.graph.num_grid_nodes
    pp = {k: v.detach() for k, v in
          grid_update.pack_grid_update_params(gm).items()}
    cases = bf16_cases(torch, gm, hm, rand)

    def check(name, mod, args, what):
        return bf16_check(torch, counts_bf16, name, mod, args, what)

    with torch.no_grad():
        for (name, mod, args, replaces, source, bytes_, flops, tf32,
             lib) in cases:
            share, err = check(name, mod, args, "its main-path shape")
            kern, plain = getattr(mod, name), getattr(mod, name + "_plain")
            a32 = tuple(a.float() if torch.is_tensor(a) and a.dtype == bf
                        else a for a in args)
            ms16 = cuda_ms(torch, lambda: kern(*args), 20)
            ms32 = cuda_ms(torch, lambda: kern(*a32), 20)
            plain_ms = cuda_ms(torch, lambda: plain(*args), 5)
            lib_ms = cuda_ms(torch, lib, 10)
            t_bytes = bytes_ / peak_bw * 1e3
            t_ops = 1e3 * (tf32 / peak_tf32 if tf32 is not None
                           else flops / peak_flops)
            bound = max(t_bytes, t_ops)
            print(f"{name} [bf16] at its main-path shape: within one bf16 ulp "
                  f"of its plain version ({share:.5f} of the outputs not "
                  f"bit-equal, max abs {err:.3e}), two calls bit-identical; "
                  f"kernel {ms16:.4f} ms (fp32 instance {ms32:.4f} ms, "
                  f"{ms16 / ms32:.3f}x), plain {plain_ms:.4f} ms, library "
                  f"{lib_ms:.4f} ms (torch.mm on bf16 operands), bound "
                  f"{bound:.4f} ms (bf16 bytes {bytes_ / 1e6:.1f} MB: "
                  f"{t_bytes:.4f} ms; {flops / 1e9:.2f} GFLOP"
                  + (f" as {tf32 / flops:.2f} TF32 products a term on "
                     "tensor cores" if tf32 is not None else " fp32")
                  + f": {t_ops:.4f} ms)")
            records.append({
                "name": name + "[bf16]", "route": "cuda", "source": source,
                "replaces": replaces, "launches": None, "max_abs_err": err,
                "ms": ms16, "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": lib_ms})
        del cases

        # K = 1..8 on seeded local graphs (20,000 receivers, K senders each
        # near it among 6,561): K2, K3 and K4 at batch 4, P2 (with
        # messages) and P3 at batch 1
        rng = np.random.default_rng(0)
        n_rec, n_send = 20000, 6561
        centre = (np.arange(n_rec) * n_send // n_rec)[:, None]
        for K in range(1, 9):
            send = np.clip(centre + rng.integers(-4, 5, (n_rec, K)), 0,
                           n_send - 1).reshape(-1)
            es = EdgeSet.from_local(
                send, np.repeat(np.arange(n_rec), K),
                rng.standard_normal((K * n_rec, 3)).astype(np.float32),
                n_send, n_rec, device="cuda", build_transpose=False)
            nv, M = es.num_virt, es.num_virt * K
            mask_p = es.mask.view(nv, K)
            lay = gm.processor[0].edge_mlp
            shares = []
            for name, mod, args in (
                    ("edge_tail_sum_flat", edge_flat,
                     (rand(n_send, W), es.senders, rand(M, H), rand(nv, W),
                      mask_p) + tail(gm.g2m_gnn.edge_mlp)),
                    ("edge_layer_flat", edge_flat,
                     (rand(M, W), rand(n_send, W), es.senders, rand(nv, W),
                      mask_p) + first(lay) + tail(lay)),
                    ("grid_update_flat", grid_update,
                     (rand(n_send, W), es.senders, rand(M, H),
                      rand(n_rec, W), mask_p, pp)),
                    ("edge_tail_sum", edge,
                     (rand(1, n_send, H), es.senders, rand(M, H),
                      rand(1, nv, H)) + tail(gm.g2m_gnn.edge_mlp)
                     + (es.mask, K, True)),
                    ("edge_layer", edge,
                     (rand(1, M, H), rand(1, n_send, H), es.senders,
                      rand(1, nv, H), es.mask) + first(lay) + tail(lay)
                     + (K,))):
                shares.append(check(name, mod, args,
                                    f"local graph K={K}")[0])
            print(f"bf16 instances at K={K} ({nv} rows; K2, K3, K4 at batch "
                  f"4, P2 with messages and P3 at batch 1): each within one "
                  f"bf16 ulp of its plain version, two calls bit-identical; "
                  f"shares not bit-equal "
                  f"{', '.join(f'{s:.5f}' for s in shares)}")

    L = BENCH["processor_layers"]

    def step_check(net, B, want16, want32, what):
        """A 4-step bf16 rollout through `entry.forecast` with the counters
        at 0 just before it (bf16 launches `want16`, fp32 `want32`, a
        step); then the bf16 and fp32 steps' host clocks, peak memory and
        profiles, and the error size of the kernel path against the plain
        path (`error_size`). Returns the bf16 counts."""
        init, forcing, true = entry.make_inputs(net, B, STEPS, seed=0)
        entry.forecast(net, init, forcing[:, :1], true[:, :1])  # warm-up
        reset_counts()
        pred = entry.forecast(net, init, forcing, true)
        torch.cuda.synchronize()
        c16, c32 = counts_bf16(), counts()
        if tuple(pred.shape) != (B, STEPS, n_grid, 17) or not bool(
                torch.isfinite(pred).all()):
            fail(f"{what}: bf16 rollout {tuple(pred.shape)}, not finite")
        print(f"{what}: bf16 {STEPS}-step rollout, output "
              f"{tuple(pred.shape)} {pred.dtype} finite; launches per step, "
              f"bf16 instances {({k: n / STEPS for k, n in c16.items() if n})}"
              f", fp32 {({k: n / STEPS for k, n in c32.items() if n})}")
        if c16 != {k: want16.get(k, 0) * STEPS for k in c16} or c32 != {
                k: want32.get(k, 0) * STEPS for k in c32}:
            fail(f"{what}: launches {c16} (bf16), {c32} (fp32); want "
                 f"{want16}, {want32} a step")
        net32 = copy.copy(net)  # the same weights, fp32 path
        net32.compute_dtype = None
        line = []
        for m, tag in ((net, "bf16"), (net32, "fp32")):
            times = []
            for steps in (1, STEPS):
                ts = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    entry.forecast(m, init, forcing[:, :steps],
                                   true[:, :steps])
                    torch.cuda.synchronize()
                    ts.append(time.perf_counter() - t0)
                times.append(sorted(ts)[1])
            ms = (times[1] - times[0]) / (STEPS - 1) * 1e3
            with torch.no_grad():
                ctx = m.precompute_rollout_ctx()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                live = torch.cuda.memory_allocated()
                m.predict_step(init[:, 1], init[:, 0], forcing[:, 0], ctx)
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated()
                gib = [b / 2**30 for b in (peak, peak - live, live)]
                line.append(f"{tag} {ms:.3f} ms a step (host clock, median "
                            f"of 3, 4-step minus 1-step rollout), peak "
                            f"{gib[0]:.3f} GiB ({gib[1]:.3f} GiB above the "
                            f"{gib[2]:.3f} live)")
                profile(torch, lambda: m.predict_step(
                    init[:, 1], init[:, 0], forcing[:, 0], ctx),
                    f"{what} {tag} predict step", top=8)
        print(f"{what}: {'; '.join(line)}")
        with torch.no_grad():
            k16 = net.predict_step(init[:, 1], init[:, 0], forcing[:, 0])[0]
            k32 = net32.predict_step(init[:, 1], init[:, 0], forcing[:, 0])[0]
            with plain_kernels():
                p16 = net.predict_step(init[:, 1], init[:, 0],
                                       forcing[:, 0])[0]
        error_size(torch, f"{what} predict step", k16, p16, k32)
        return c16

    c16 = step_check(gm, BATCH, {"embed_grid_flat": 1,
                                 "edge_tail_sum_flat": 1,
                                 "edge_layer_flat": L,
                                 "grid_update_flat": 1}, {},
                     "bf16 GraphLAM batch 4")
    step_check(hm, BATCH, {"embed_grid_flat": 1, "edge_tail_sum_flat": 1,
                           "edge_layer_flat": 1 + 7 * L + 2,
                           "grid_update_flat": 1, "edge_layer": 2 + 7 * L},
               {"edge_tail": 1}, "bf16 HiLAM batch 4")
    p16 = step_check(hm, 1, {"edge_tail_sum": 2, "edge_layer": 3 + 14 * L},
                     {"edge_tail": 3}, "bf16 HiLAM batch 1")
    step_check(gm, 1, {"edge_tail_sum": 2, "edge_layer": L}, {},
               "bf16 GraphLAM batch 1")
    for rec in records:
        if rec["name"].endswith("[bf16]"):
            n = rec["name"][:-len("[bf16]")]
            rec["launches"] = p16[n] if n in BATCHED else c16[n]

    del gm, hm, gds
    torch.cuda.empty_cache()

    # the predict CLI, --precision bf16, batch 1 on an MDP datastore
    with tempfile.TemporaryDirectory(prefix="nlt_bf16_") as tmp:
        root = Path(tmp)
        t0 = time.time()
        cfg = write_mdp_datastore(root, np)
        config, ds = load_config_and_datastore(cfg)
        for kind, graph in (("graph_lam", "multiscale"),
                            ("hi_lam", "hierarchical")):
            net = MODELS[kind](
                ModelArgs(hidden_dim=64, processor_layers=L), config, ds,
                load_or_build_graph(ds, graph, "cuda"), device="cuda",
                generator=torch.Generator().manual_seed(0))
            save_checkpoint(root / "models", kind, net.state_dict(),
                            meta={"step": 0})
        del net
        print(f"MDP datastore and seeded GraphLAM and HiLAM checkpoints "
              f"written in {time.time() - t0:.1f} s")
        for kind, graph, want16, want32 in (
                ("graph_lam", "multiscale",
                 {"edge_tail_sum": 2, "edge_layer": L}, {}),
                ("hi_lam", "hierarchical",
                 {"edge_tail_sum": 2, "edge_layer": 3 + 14 * L},
                 {"edge_tail": 3})):
            out = root / f"{kind}.zarr"
            argv = ["--config_path", str(cfg), "--model", kind, "--graph",
                    graph, *WIDTH, "--load", str(root / "models" / kind),
                    "--split", "test", "--sample_idx", "-1", "--ar_steps",
                    str(STEPS), "--precision", "bf16", "--out", str(out)]
            reset_counts()
            summary = quiet(predict.main, argv)
            torch.cuda.synchronize()
            c16, c32 = counts_bf16(), counts()
            if c16 != {k: want16.get(k, 0) * STEPS for k in c16} or c32 != {
                    k: want32.get(k, 0) * STEPS for k in c32}:
                fail(f"predict.main {kind} --precision bf16: launches {c16} "
                     f"(bf16), {c32} (fp32); want {want16}, {want32} a step")
            pred = ZarrGroup(out)["state"].read_full()
            if pred.shape != (STEPS, 268 * 238, 17) or not np.isfinite(
                    pred).all():
                fail(f"predict.main {kind} --precision bf16: forecast "
                     f"{pred.shape}, finite {np.isfinite(pred).all()}")
            args = predict.parse_args(argv)
            net, nds, _ = predict.prepare(args)
            net32 = copy.copy(net)
            net32.compute_dtype = None
            predict.rollout(net, nds, args)  # warm-up
            ms16 = median_ms(torch, lambda: predict.rollout(net, nds, args))
            ms32 = median_ms(torch, lambda: predict.rollout(net32, nds, args))
            stats = nds.get_standardization_dataarray("state")
            k16 = (pred - stats["state_mean"]) / stats["state_std"]
            p32, _ = predict.rollout(net32, nds, args)
            with plain_kernels():
                pp16, _ = predict.rollout(net, nds, args)
            print(f"predict.main {kind} --precision bf16: init "
                  f"{summary['init_s']:.2f} s, launches per step bf16 "
                  f"{({k: n / STEPS for k, n in c16.items() if n})}, fp32 "
                  f"{({k: n / STEPS for k, n in c32.items() if n})}; "
                  f"forecast {pred.shape} finite; warm rollout "
                  f"{ms16 / STEPS:.1f} ms a step (fp32 {ms32 / STEPS:.1f}; "
                  "host clock, median of 3, the sample's read included)")
            error_size(torch, f"predict.main {kind} --precision bf16 "
                       "(standardized)", k16, pp16, p32)
            del net, net32, nds
            torch.cuda.empty_cache()
        bf16_eval(torch, np, root, cfg, counts, counts_bf16, reset_counts,
                  plain_kernels)


def flat_outputs(out):
    """A wrapper's outputs as a flat tuple: a trailing dict (the decoder's
    parameter gradients) by sorted key."""
    out = as_tuple(out)
    if isinstance(out[-1], dict):
        out = out[:-1] + tuple(out[-1][k] for k in sorted(out[-1]))
    return out


def bf16_bwd_check(torch, counts_bf16, name, mod, args, what):
    """The bf16 instance of backward kernel `name` (in `mod`) against its
    plain version on the same inputs: its bf16 outputs within one bf16
    ulp, under 0.1% of them not bit-equal, its fp32 outputs (the
    parameter gradients) within 1e-4 + 1e-4 * max|plain|; two calls
    bit-identical. Returns (share not bit-equal, max abs gap)."""
    kern, plain = getattr(mod, name), getattr(mod, name + "_plain")
    before = counts_bf16()[name]
    got = flat_outputs(kern(*args))
    again = flat_outputs(kern(*args))
    want = flat_outputs(plain(*args))
    torch.cuda.synchronize()
    if counts_bf16()[name] != before + 2:
        fail(f"{name} [bf16] at {what}: its bf16 instance did not run")
    if not all(a is None and b is None or torch.equal(a, b)
               for a, b in zip(got, again)):
        fail(f"{name} [bf16] at {what}: two calls differ")
    share, err = 0.0, 0.0
    for a, b in zip(got, want):
        if a is None and b is None:
            continue
        if (a.shape != b.shape or a.dtype != b.dtype
                or not torch.isfinite(a.float()).all()):
            fail(f"{name} [bf16] at {what}: bad output {tuple(a.shape)} "
                 f"{a.dtype} (plain {b.dtype})")
        if a.dtype == torch.bfloat16:
            s, worst, gap = bf16_gap(torch, a, b)
            if worst > 1.0 or s >= 1e-3:
                fail(f"{name} [bf16] at {what}: kernel and plain differ by "
                     f"{worst:.2f} x one bf16 ulp, {s:.5f} not bit-equal")
            share = max(share, s)
        else:
            gap = float((a - b).abs().max())
            if gap > 1e-4 + 1e-4 * float(b.abs().max()):
                fail(f"{name} [bf16] at {what}: fp32 gradient gap {gap:.3e}")
        err = max(err, gap)
    return share, err


def bf16_bwd_cases(torch, gm, rand):
    """Phase 12's main-path cases of the bf16 backward instances, on the
    bf16 bench GraphLAM `gm` at batch 4 with bf16 activations and
    cotangents from `rand`: B1 at the training step's call (no dx) and
    with dx, B2 at g2m, B3/B4 at m2m[0], B5/B6 at m2g, and `xtd_sum` at
    B3/B4's and the decoder's pairs (from the bf16 chains). Each is
    (kernel, module, args, replaces, source, bytes, FLOP, TF32 FLOP on
    tensor cores (None: fp32 CUDA cores), library call or None). Bytes:
    each input read and each output written once, in its dtype (B2's
    fp32 X1 and DY scratch written once, as in phase 4); a 3xTF32 product
    takes three TF32 products a term, two where its A operand is a staged
    bf16 value (B1's t0 = x W0 and dW0 = x^T dt0, xtd_sum's bf16-X
    pairs)."""
    from neural_lam_tpu_torch.ops import (
        edge_flat,
        embed,
        grid_update,
        weight_grad,
    )

    bf = torch.bfloat16
    W = BATCH * H
    g = gm.graph
    pef = "neural_lam_tpu/ops/pallas_edge_flat.py"
    pgu = "neural_lam_tpu/ops/pallas_grid_update.py"
    csrc = "neural_lam_tpu_torch/csrc/"
    emb = gm.grid_embedder
    d_in = emb.layers[0].w.shape[0]
    n_grid = g.num_grid_nodes
    rows = n_grid * BATCH
    cases = []
    par1 = tuple(t.detach() for t in (emb.layers[0].w, emb.layers[0].b,
                                      emb.layers[1].w, emb.layers[1].b,
                                      emb.ln.scale, emb.ln.bias))
    x1, d1 = rand(n_grid, BATCH * d_in), rand(n_grid, W)
    for need_dx in (False, True):
        args = (x1,) + par1 + (BATCH, d1, need_dx)
        xw, dw = x1.view(-1, d_in), d1.view(-1, H)
        w0b, w1b = par1[0].to(bf), par1[2].to(bf)

        def lib(xw=xw, dw=dw, w0b=w0b, w1b=w1b, need_dx=need_dx):
            out = [torch.mm(xw, w0b), torch.mm(dw, w1b),
                   torch.mm(dw, w1b.t()), torch.mm(dw.t(), dw),
                   torch.mm(xw.t(), dw)]
            return out + [torch.mm(dw, w0b.t())] if need_dx else out

        cases.append((
            "embed_grid_flat_bwd", embed, args,
            "neural_lam_tpu/ops/pallas_embed.py:111"
            + (" (with dx)" if need_dx else ""), csrc + "embed_bwd.cu",
            nbytes(x1, d1, *par1) + nbytes(*par1)
            + (nbytes(x1) if need_dx else 0),
            2.0 * rows * ((3 if need_dx else 2) * d_in * H + 3 * H * H),
            2.0 * rows * (2 * 2 * d_in * H + 3 * 3 * H * H
                          + (3 * d_in * H if need_dx else 0)), lib))
    # B2 at g2m
    es = g.g2m
    nv, K = es.num_virt, es.dense_k
    M = nv * K
    mask_p = es.mask.view(nv, K)
    tail = mlp_tail(gm.g2m_gnn.edge_mlp)
    a2 = (rand(es.num_send, W), es.senders, rand(M, H), rand(nv, W),
          mask_p) + tail + (rand(nv, W),)
    cases.append((
        "edge_tail_sum_flat_bwd", edge_flat, a2, f"{pef}:526",
        csrc + "edge_flat_bwd.cu",
        nbytes(*a2) + M * (W + H) * 2 + nv * W * 2 + nbytes(*tail)
        + 2 * M * W * 4,
        3 * 2.0 * float(mask_p.sum()) * BATCH * H * H, None, None))
    # B3/B4 at m2m[0]
    es = g.m2m[0]
    nv, K = es.num_virt, es.dense_k
    M = nv * K
    mask_p = es.mask.view(nv, K)
    lay = gm.processor[0].edge_mlp
    par3 = mlp_first(lay) + mlp_tail(lay)
    a3 = (rand(M, W), rand(es.num_send, W), es.senders, rand(nv, W),
          mask_p) + par3 + (rand(M, W), rand(nv, W))
    cases.append((
        "edge_layer_flat_bwd", edge_flat, a3, f"{pef}:846",
        csrc + "edge_flat_bwd.cu",
        nbytes(*a3) + 2 * M * W * 2 + nv * W * 2 + nbytes(*par3),
        3 * 2.0 * M * BATCH * 2 * H * H, None, None))
    b3_pairs = edge_flat.edge_layer_bwd_chain(*a3)[4]
    # B5/B6 at m2g
    es = g.m2g
    nv, K = es.num_virt, es.dense_k
    mask_p = es.mask.view(nv, K)
    pp = {k: v.detach() for k, v in
          grid_update.pack_grid_update_params(gm).items()}
    d_out = pp["o_w1"].shape[1]
    a5 = (rand(es.num_send, W), es.senders, rand(nv * K, H),
          rand(n_grid, W), mask_p, pp, rand(nv, BATCH * d_out))
    cases.append((
        "grid_update_flat_bwd", grid_update, a5, f"{pgu}:752",
        csrc + "grid_update_bwd.cu",
        nbytes(*a5[:5], a5[6], *pp.values()) + nv * K * (W + H) * 2
        + n_grid * W * 2 + nbytes(*pp.values()),
        3 * (2.0 * nv * BATCH * (7 * H * H + H * d_out)
             + 2.0 * float(mask_p.sum()) * BATCH * H * H), None, None))
    dec_pairs = grid_update.grid_update_bwd_chain(*a5)[4]
    for pairs, label in ((b3_pairs, f"{pef}:846 (B3/B4's two pairs at "
                          "m2m[0], dW_e's X bf16)"),
                         (dec_pairs, f"{pgu}:752 (the decoder's nine "
                          "pairs, enc_w0's X bf16)")):
        if not any(x.dtype == bf for x, _ in pairs):
            fail(f"xtd_sum at {label}: no bf16 X")
        cases.append((
            "xtd_sum", weight_grad, (pairs,), label,
            csrc + "weight_grad.cu",
            unique_nbytes([t for p in pairs for t in p])
            + sum(H * d.shape[1] * 4 for _, d in pairs),
            sum(2.0 * x.shape[0] * H * d.shape[1] for x, d in pairs),
            sum((2 if x.dtype == bf else 3) * 2.0 * x.shape[0] * H
                * d.shape[1] for x, d in pairs),
            lambda pairs=pairs: [torch.mm(x.float().t(), d)
                                 for x, d in pairs]))
    return cases


def bf16_bwd_phase(torch, np, gm, counts_bf16, records, peak_flops,
                   peak_tf32, peak_bw):
    """Phase 12a: the bf16 backward instances against their plain versions
    at the main-path shapes (timed) and at K = 1..8, on the bf16 bench
    GraphLAM `gm` (module doc). Appends their records."""
    from neural_lam_tpu_torch.ops import edge_flat, grid_update, weight_grad
    from neural_lam_tpu_torch.ops.message_passing import EdgeSet

    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(12)
    W = BATCH * H

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(bf)

    def widened(args):
        return tuple(
            a.float() if torch.is_tensor(a) and a.dtype == bf
            else [(x.float(), d) for x, d in a] if isinstance(a, list)
            else a for a in args)

    # a. the bf16 backward instances at the main-path shapes ...
    with torch.no_grad():
        for (name, mod, args, replaces, source, bytes_, flops, tf32,
             lib) in bf16_bwd_cases(torch, gm, rand):
            share, err = bf16_bwd_check(torch, counts_bf16, name, mod, args,
                                        "its main-path shape")
            kern, plain = getattr(mod, name), getattr(mod, name + "_plain")
            a32 = widened(args)
            ms16 = cuda_ms(torch, lambda: kern(*args), 10)
            ms32 = cuda_ms(torch, lambda: kern(*a32), 10)
            plain_ms = cuda_ms(torch, lambda: plain(*args), 3)
            lib_ms = None if lib is None else cuda_ms(torch, lib, 10)
            t_bytes = bytes_ / peak_bw * 1e3
            t_ops = 1e3 * (tf32 / peak_tf32 if tf32 is not None
                           else flops / peak_flops)
            bound = max(t_bytes, t_ops)
            print(f"{name} [bf16] at {replaces}: bf16 outputs within one "
                  f"bf16 ulp of its plain version ({share:.5f} not "
                  f"bit-equal), fp32 gradients within 1e-4 + 1e-4*max, max "
                  f"abs {err:.3e}; two calls bit-identical; kernel "
                  f"{ms16:.4f} ms (fp32 instance on the same values "
                  f"{ms32:.4f} ms, {ms16 / ms32:.3f}x), plain "
                  f"{plain_ms:.4f} ms, library "
                  + ("none" if lib_ms is None else f"{lib_ms:.4f} ms")
                  + f", bound {bound:.4f} ms (bytes {bytes_ / 1e6:.1f} MB: "
                  f"{t_bytes:.4f} ms; {flops / 1e9:.2f} GFLOP"
                  + (f" as {tf32 / flops:.2f} TF32 products a term on "
                     "tensor cores" if tf32 is not None else " fp32")
                  + f": {t_ops:.4f} ms)")
            if "(with dx)" in replaces or (
                    name == "xtd_sum" and "decoder" not in replaces):
                continue  # printed, not recorded
            records.append({
                "name": name + "[bf16]", "route": "cuda", "source": source,
                "replaces": replaces.split(" (")[0], "launches": None,
                "max_abs_err": err, "ms": ms16, "plain_ms": plain_ms,
                "bound_ms": bound,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": lib_ms})

        # ... and at K = 1..8 on phase 3's seeded local graphs, batch 4
        rng = np.random.default_rng(0)
        n_rec, n_send = 20000, 6561
        centre = (np.arange(n_rec) * n_send // n_rec)[:, None]
        pp = {k: v.detach() for k, v in
              grid_update.pack_grid_update_params(gm).items()}
        d_out = pp["o_w1"].shape[1]
        lay = gm.processor[0].edge_mlp
        for K in range(1, 9):
            send = np.clip(centre + rng.integers(-4, 5, (n_rec, K)), 0,
                           n_send - 1).reshape(-1)
            es = EdgeSet.from_local(
                send, np.repeat(np.arange(n_rec), K),
                rng.standard_normal((K * n_rec, 3)).astype(np.float32),
                n_send, n_rec, device="cuda", build_transpose=False)
            nv, M = es.num_virt, es.num_virt * K
            mask_p = es.mask.view(nv, K)
            shares = []
            a3 = (rand(M, W), rand(n_send, W), es.senders, rand(nv, W),
                  mask_p) + mlp_first(lay) + mlp_tail(lay) + (
                      rand(M, W), rand(nv, W))
            a5 = (rand(n_send, W), es.senders, rand(M, H), rand(n_rec, W),
                  mask_p, pp, rand(nv, BATCH * d_out))
            for name, mod, args in (
                    ("edge_tail_sum_flat_bwd", edge_flat,
                     (rand(n_send, W), es.senders, rand(M, H), rand(nv, W),
                      mask_p) + mlp_tail(gm.g2m_gnn.edge_mlp)
                     + (rand(nv, W),)),
                    ("edge_layer_flat_bwd", edge_flat, a3),
                    ("grid_update_flat_bwd", grid_update, a5),
                    ("xtd_sum", weight_grad,
                     (edge_flat.edge_layer_bwd_chain(*a3)[4]
                      + grid_update.grid_update_bwd_chain(*a5)[4][:1],))):
                shares.append(bf16_bwd_check(torch, counts_bf16, name, mod,
                                             args, f"local graph K={K}")[0])
            print(f"bf16 backward instances at K={K} ({nv} rows, batch 4; "
                  f"B2, B3/B4, B5/B6, xtd_sum at B3/B4's pairs and the "
                  f"decoder's enc_w0 pair): each within its limits of its "
                  f"plain version, two calls bit-identical; shares not "
                  f"bit-equal {', '.join(f'{s:.5f}' for s in shares)}")


def bf16_train_phase(torch, np, counts, counts_bf16, reset_counts,
                     plain_kernels, records, zero_all, peak_flops,
                     peak_tf32, peak_bw):
    """Phase 12: bf16 training on the card (module doc)."""
    import copy
    import tempfile
    from pathlib import Path

    from neural_lam_tpu_torch import entry, train

    t0 = time.time()
    gm, gds = entry.build_model(**BENCH, device="cuda",
                                compute_dtype="bfloat16")
    print(f"bf16 bench GraphLAM built in {time.time() - t0:.1f} s")
    bf16_bwd_phase(torch, np, gm, counts_bf16, records, peak_flops,
                   peak_tf32, peak_bw)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 12a: {time.time() - t0:.1f} s")
    phase_t = time.time()

    # b. one AdamW step of the bf16 bench GraphLAM and HiLAM at batch 4
    L = BENCH["processor_layers"]

    def train_check(net, ds, want16, want32, what):
        """One bf16 AdamW step through entry.train_steps with the counters
        at 0 just before it (launches `want16` bf16, `want32` fp32, every
        other 0); the gradients' error size, kernel path against plain
        path; step ms, peak memory and a profile beside the fp32 twin on
        the same weights. Returns the bf16 counts."""
        entry.train_steps(net, ds, BATCH, 1, steps=1, seed=0,
                          device="cuda")  # warm-up
        reset_counts()
        losses = entry.train_steps(net, ds, BATCH, 1, steps=1, seed=1,
                                   device="cuda")
        torch.cuda.synchronize()
        c16, c32 = counts_bf16(), counts()
        print(f"{what} bf16 training step ({time.time() - phase_t:.1f} s "
              f"into phase 12b): loss {losses[0]:.6f}; launches "
              f"bf16 {({k: n for k, n in c16.items() if n})}, fp32 "
              f"{({k: n for k, n in c32.items() if n})}")
        if not all(map(math.isfinite, losses)):
            fail(f"{what} bf16 training loss is not finite: {losses}")
        if c16 != {k: want16.get(k, 0) for k in c16} or c32 != dict(
                {k: 0 for k in zero_all}, **want32):
            fail(f"{what} bf16 training launches {c16} (bf16), {c32} "
                 f"(fp32); want {want16}, {want32}")
        trainer, dm = entry.make_trainer(net, ds, BATCH, 1, seed=2)
        batch = next(trainer.train_batches(dm, 0))
        net32 = copy.copy(net)  # the same weights, fp32 path
        net32.compute_dtype = None

        def grads(m):
            m.zero_grad(set_to_none=True)
            m.training_loss(batch).backward()
            return {k: p.grad.detach().clone()
                    for k, p in m.named_parameters()}

        k16, k32 = grads(net), grads(net32)
        with plain_kernels():
            p16 = grads(net)
        scale = {k: float(v.abs().max()) or 1.0 for k, v in k32.items()}

        def vec(gr):
            return torch.cat([(gr[k] / scale[k]).flatten() for k in k32])

        error_size(torch, f"{what} bf16 training gradients (each parameter's "
                   f"over its fp32 max abs, {len(k32)} parameters)",
                   vec(k16), vec(p16), vec(k32))
        del k16, k32, p16
        net.zero_grad(set_to_none=True)
        print(f"{what}: gradients compared {time.time() - phase_t:.1f} s "
              "into phase 12b")
        line = []
        trainer32, _ = entry.make_trainer(net32, ds, BATCH, 1, seed=2)
        for tr, m, tag in ((trainer, net, "bf16"), (trainer32, net32,
                                                    "fp32")):
            times = []
            for i in range(9):
                torch.cuda.synchronize()
                if i == 2:
                    torch.cuda.reset_peak_memory_stats()
                    live = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                tr.train_step(batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                if i == 2:
                    peak = torch.cuda.max_memory_allocated()
            ms = sorted(times[2:])[3] * 1e3
            line.append(f"{tag} {ms:.3f} ms (median of 7 after 2 warm-up "
                        f"steps), peak {peak / 2**30:.3f} GiB "
                        f"({(peak - live) / 2**30:.3f} GiB above the "
                        f"{live / 2**30:.3f} live)")
            profile(torch, lambda: tr.train_step(batch),
                    f"{what} {tag} train step", top=10, cpu=False)
            m.zero_grad(set_to_none=True)
        print(f"{what} train step (fwd+bwd+AdamW, ar_steps 1, batch "
              f"{BATCH}): {'; '.join(line)}")
        return c16

    fwd = {"embed_grid_flat": 1, "edge_tail_sum_flat": 1,
           "edge_layer_flat": L, "grid_update_flat": 1}
    # phase 7's counts on the bf16 counters: the forward's, a backward
    # kernel for each, xtd_sum with its reduce kernel for the decoder and
    # each B3/B4 call (their pairs hold a bf16 X); B2's xtd_sum launch is
    # fp32 (its pair is the chain's fp32 X1, DY)
    xtd = {"xtd_sum": 1, "xtd_reduce": 1}
    c16 = train_check(gm, gds, dict(
        fwd, **{k + "_bwd": n for k, n in fwd.items()},
        xtd_sum=1 + L, xtd_reduce=1 + L), xtd, "GraphLAM")
    for rec in records:
        n = rec["name"][:-len("[bf16]")]
        if rec["name"].endswith("[bf16]") and (n.endswith("_bwd")
                                               or n in TRAIN_ONLY):
            rec["launches"] = c16[n]
    del gm, gds
    torch.cuda.empty_cache()
    hm, hds = entry.build_model(**BENCH, device="cuda",
                                compute_dtype="bfloat16", model="hi_lam")
    hfwd = dict(fwd, edge_layer_flat=3 + 7 * L, edge_layer=2 + 7 * L)
    train_check(hm, hds, dict(
        hfwd, **{k + "_bwd": n for k, n in hfwd.items() if k in FWD},
        xtd_sum=1 + hfwd["edge_layer_flat"],
        xtd_reduce=1 + hfwd["edge_layer_flat"]),
        dict(xtd, edge_tail=1), "HiLAM")
    del hm, hds
    torch.cuda.empty_cache()
    print(f"phase 12b: {time.time() - phase_t:.1f} s")
    phase_t = time.time()

    # c. train.main --precision bf16, then --eval test on its checkpoint
    with tempfile.TemporaryDirectory(prefix="nlt_bf16_train_") as tmp:
        t0 = time.time()
        root = Path(tmp)
        cfg = write_mdp_datastore(root, np)
        print(f"MDP datastore written in {time.time() - t0:.1f} s")
        argv = ["--config_path", str(cfg), "--model", "graph_lam", "--graph",
                "multiscale", *WIDTH, "--batch_size", "4", "--ar_steps_eval",
                "2", "--val_steps_to_log", "1", "2", "--precision", "bf16",
                "--save_dir", str(root / "models")]
        t0 = time.time()
        reset_counts()
        quiet(train.main, argv + ["--ar_steps_train", "1", "--max_steps",
                                  "2", "--seed", "0", "--run_name",
                                  "bf16_train"])
        torch.cuda.synchronize()
        c16 = {k: n for k, n in counts_bf16().items() if n}
        c32 = {k: n for k, n in counts().items() if n}
        print(f"train.main --precision bf16: 2 steps and validation in "
              f"{time.time() - t0:.1f} s; launches bf16 {c16}, fp32 {c32}")
        want_bwd = dict({k + "_bwd": 2 * n for k, n in fwd.items()},
                        xtd_sum=2 * (1 + L), xtd_reduce=2 * (1 + L))
        if any(c16.get(k) != n for k, n in want_bwd.items()) or c32 != {
                "xtd_sum": 2, "xtd_reduce": 2}:
            fail(f"train.main --precision bf16: launches {c16} (bf16), "
                 f"{c32} (fp32); want {want_bwd} among the bf16 ones, and "
                 "of the fp32 ones B2's xtd_sum alone")
        run = root / "models" / "bf16_train"
        log = [json.loads(line) for line in
               (run / "metrics.jsonl").read_text().splitlines()]
        loss = [r["train_loss"] for r in log if "train_loss" in r]
        if not (run / "last").exists() or not loss or not all(
                map(math.isfinite, loss)):
            fail(f"train.main --precision bf16: no checkpoint or loss "
                 f"{loss}")
        t0 = time.time()
        reset_counts()
        res = quiet(train.main, argv + ["--eval", "test", "--load",
                                        str(run / "last"), "--run_name",
                                        "bf16_train_test",
                                        "--n_example_pred", "0"])
        torch.cuda.synchronize()
        c16 = {k: n for k, n in counts_bf16().items() if n}
        rmse = np.loadtxt(root / "models" / "bf16_train_test"
                          / "test_rmse.csv", delimiter=",", ndmin=2)
        losses = [float(v) for k, v in res.items() if "loss" in k]
        print(f"train.main --eval test --precision bf16 on the bf16-trained "
              f"checkpoint: {time.time() - t0:.1f} s; launches bf16 {c16}; "
              f"test_rmse.csv {rmse.shape}, losses {losses}")
        if (not np.isfinite(rmse).all() or not losses
                or not all(map(math.isfinite, losses))
                or not all(c16.get(k) for k in FWD)):
            fail("train.main --eval test --precision bf16 on the bf16-"
                 "trained checkpoint: not finite, or the bf16 kernels did "
                 "not run")


# the port's CUDA kernels by name, as the profiler shows them
PORT_KERNELS = ("embed_kernel", "embed_bwd_kernel", "edge_tc_kernel",
                "edge_tail_bwd_kernel", "edge_layer_bwd_kernel",
                "grid_update_kernel", "grid_update_bwd_kernel",
                "xtd_sum_kernel", "xtd_reduce_kernel")


def step_stats(torch, trainer, batch, what, n=5, prof_steps=2):
    """(host ms, the median of n synchronised training steps after one,
    peak memory above the live set in bytes, device busy ms a step from a
    profile of prof_steps steps, or None) of `trainer` on `batch`."""
    trainer.train_step(batch)
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    above = torch.cuda.max_memory_allocated() - live
    prof = profile(torch, lambda: trainer.train_step(batch), what,
                   steps=prof_steps, top=6, cpu=False)
    return sorted(times)[n // 2] * 1e3, above, prof[0] if prof else None


def remat_phase(torch, counts, counts_bf16, reset_counts):
    """Phase 13a: one AdamW step with and without `remat` on the same
    weights and batch (module doc)."""
    import copy
    import dataclasses

    from neural_lam_tpu_torch import entry

    fwd_names = set(FWD + BATCHED) | {k + "[bf16]" for k in FWD + BATCHED}

    def launches():
        return dict(counts(), **{k + "[bf16]": n
                                 for k, n in counts_bf16().items()})

    def case(net, ds, ar, what, n, prof_steps):
        """Both ways on the same weights and batch: (loss, launches,
        gradients) each, with their step stats printed."""
        trainer, dm = entry.make_trainer(net, ds, BATCH, ar, seed=0)
        batch = next(trainer.train_batches(dm, 0))
        state0 = {k: v.clone() for k, v in net.state_dict().items()}
        out, stats = {}, []
        for remat in (False, True):
            net.load_state_dict(state0)
            reset_counts()
            # the first batch of epoch 0 shuffled from seed 0: `batch`
            (loss,) = entry.train_steps(net, ds, BATCH, ar, steps=1, seed=0,
                                        device="cuda", remat=remat)
            torch.cuda.synchronize()
            got = launches()
            grads = {k: p.grad.detach().clone()
                     for k, p in net.named_parameters()}
            tag = "remat" if remat else "no remat"
            net.args = dataclasses.replace(net.args, remat=remat)
            host, above, busy = step_stats(
                torch, trainer, batch, f"{what} {tag} train step", n,
                prof_steps)
            stats.append(f"{tag}: busy "
                         f"{'not measured' if busy is None else f'{busy:.3f}'}"
                         f" ms, host {host:.3f} ms (median of {n}), peak "
                         f"{above / 2**30:.3f} GiB above the live set")
            out[remat] = (loss, got, grads)
            net.zero_grad(set_to_none=True)
        net.load_state_dict(state0)
        net.args = dataclasses.replace(net.args, remat=False)
        print(f"{what} train step (ar_steps {ar}, batch {BATCH}): "
              f"{'; '.join(stats)}")
        (l0, c0, g0), (l1, c1, g1) = out[False], out[True]
        rel = abs(l1 - l0) / abs(l0)
        print(f"{what}: loss {l0:.7f} / {l1:.7f} without / with remat "
              f"(rel gap {rel:.2e}, limit 1e-6); launches without "
              f"{({k: v for k, v in c0.items() if v})}, with "
              f"{({k: v for k, v in c1.items() if v})}")
        if not (math.isfinite(l0) and rel <= 1e-6):
            fail(f"{what}: the losses with and without remat differ")
        want = {k: 2 * v if k in fwd_names else v for k, v in c0.items()}
        if c1 != want or not any(c0.get(k) for k in fwd_names) or not any(
                v for k, v in c0.items() if k not in fwd_names):
            fail(f"{what}: launches with remat {c1}, want each forward "
                 f"kernel twice and each backward kernel once: {want}")
        return g0, g1

    def fp32_check(g0, g1, what):
        worst = max((float((g1[k] - g0[k]).abs().max())
                     / (1e-4 + 1e-4 * float(g0[k].abs().max())), k)
                    for k in g0)
        print(f"{what}: gradients with remat against without, worst max "
              f"abs gap / (1e-4 + 1e-4 * max abs) {worst[0]:.3e} "
              f"({worst[1]}; limit 1), {len(g0)} parameters")
        if not worst[0] <= 1.0:
            fail(f"{what}: the gradients with and without remat disagree")

    t0 = time.time()
    gm, gds = entry.build_model(**BENCH, device="cuda")
    g0, g1 = case(gm, gds, 4, "GraphLAM fp32", 3, 2)
    fp32_check(g0, g1, "GraphLAM fp32")
    del g1
    print(f"phase 13a, GraphLAM fp32: {time.time() - t0:.1f} s")
    gm16 = copy.copy(gm)  # the same weights on the bf16 path
    gm16.compute_dtype = torch.bfloat16
    k0, k1 = case(gm16, gds, 4, "GraphLAM bf16", 3, 2)
    scale = {k: float(v.abs().max()) or 1.0 for k, v in g0.items()}

    def vec(gr):
        return torch.cat([(gr[k] / scale[k]).flatten() for k in g0])

    # phase 12's limits: the remat step's bf16 error against the fp32
    # gradients the size of the step's without remat
    error_size(torch, "GraphLAM bf16 gradients with remat (each "
               "parameter's over its fp32 max abs) against without",
               vec(k1), vec(k0), vec(g0))
    del gm, gm16, gds, g0, k0, k1
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 13a, GraphLAM bf16: {time.time() - t0:.1f} s")
    hm, hds = entry.build_model(**BENCH, device="cuda", model="hi_lam")
    h0, h1 = case(hm, hds, 2, "HiLAM fp32", 3, 1)
    fp32_check(h0, h1, "HiLAM fp32")
    del hm, hds, h0, h1
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 13a: {time.time() - t0:.1f} s")


def cli_training_phase(torch, np, counts, reset_counts, root):
    """Phase 13b: train.main on a 268x238 MDP datastore, serially and with
    the pooled loader, the prefetcher, remat and a trace (module doc)."""
    from neural_lam_tpu_torch import native, train
    from neural_lam_tpu_torch.datastore import zarr_reader

    t0 = time.time()
    cfg = write_mdp_datastore(root, np, n_t=40, n_train=32)
    print(f"MDP datastore (32 train steps: 27 samples, 6 batches of 4) "
          f"written in {time.time() - t0:.1f} s")
    argv = ["--config_path", str(cfg), "--model", "graph_lam", "--graph",
            "multiscale", *WIDTH, "--batch_size", str(BATCH),
            "--ar_steps_train", "2", "--ar_steps_eval", "2",
            "--val_interval", "1000", "--seed", "0",
            "--save_dir", str(root / "models")]
    runs = {"serial": ["--num_workers", "0", "--prefetch_batches", "0"],
            "pooled": ["--num_workers", "4", "--prefetch_batches", "2"],
            "pooled_remat_traced": ["--num_workers", "4",
                                    "--prefetch_batches", "2", "--remat",
                                    "--profile_steps", "2"]}
    steps = {}  # run -> [(batch checksums, loss, t_in, t_out)] in order
    real_step = train.Trainer.train_step

    def recording_step(self, batch):
        t_in = time.perf_counter()
        loss = real_step(self, batch)
        sums = torch.stack([b.double().sum() for b in batch]).tolist()
        steps[run].append((sums, float(loss), t_in, time.perf_counter()))
        return loss

    train.Trainer.train_step = recording_step
    got, outs, decoded, logs = {}, {}, {}, {}
    try:
        for run, extra in runs.items():
            zarr_reader._chunk_cache.clear()
            before = native.decoded_chunks
            steps[run] = []
            reset_counts()
            t0 = time.time()
            _, outs[run] = captured(train.main, argv + extra + [
                "--max_steps", "6", "--run_name", run])
            torch.cuda.synchronize()
            decoded[run] = native.decoded_chunks - before
            got[run] = counts()
            logs[run] = [json.loads(line) for line in
                         (root / "models" / run / "metrics.jsonl")
                         .read_text().splitlines()]
            print(f"train.main {' '.join(extra)}: {time.time() - t0:.1f} s")
    finally:
        train.Trainer.train_step = real_step
    for run in runs:
        ep = [r for r in logs[run] if "train_loss" in r]
        n = len(steps[run])
        wait = sum(r["input_wait_s"] for r in ep)
        # from the end of one step to the start of the next: the wait for
        # the next batch (and the loop's own host work)
        gaps = [b[2] - a[3] for a, b in zip(steps[run], steps[run][1:])]
        print(f"{run} ({' '.join(runs[run])}): {n} steps; epoch "
              f"{sum(r['epoch_s'] for r in ep):.3f} s, "
              f"{n / sum(r['epoch_s'] for r in ep):.3f} batches/s, input "
              f"wait {wait / n * 1e3:.3f} ms a step ({wait:.3f} s in all; "
              f"steps 2-{n}: {', '.join(f'{g * 1e3:.1f}' for g in gaps)} ms "
              f"from one step's end to the next's start); {decoded[run]} "
              f"chunks decoded (cache emptied before the run); launches "
              f"{({k: v for k, v in got[run].items() if v})}")
    a = steps["serial"]
    for run in list(runs)[1:]:
        b = steps[run]
        if len(a) != 6 or len(b) != 6:
            fail(f"train.main ran {len(a)} and {len(b)} steps, want 6 each")
        if [s[0] for s in a] != [s[0] for s in b]:
            fail(f"the serial and the {run} runs saw different batches")
        rel = [abs(sb[1] - sa[1]) / abs(sa[1]) for sa, sb in zip(a, b)]
        print(f"losses serial {[s[1] for s in a]}, {run} "
              f"{[s[1] for s in b]}; the same 6 batches in the same order "
              f"(checksums equal); relative gaps "
              f"{', '.join(f'{r:.2e}' for r in rel)} (first 0, the others "
              "within 1e-4)")
        if rel[0] != 0 or max(rel) > 1e-4:
            fail(f"the serial and {run} runs' losses differ beyond their "
                 "limits")
        if decoded[run] != decoded["serial"] or not decoded["serial"]:
            fail(f"chunks decoded: {decoded}; every run must decode each "
                 "chunk once, as the serial run does")
    if got["pooled"] != got["serial"]:
        fail(f"launches: serial {got['serial']}, pooled {got['pooled']}")
    want = {k: 2 * v if k in FWD + BATCHED else v
            for k, v in got["serial"].items()}
    if got["pooled_remat_traced"] != want or not all(
            got["serial"][k] for k in FWD) or not all(
            got["serial"][k + "_bwd"] for k in FWD):
        fail(f"launches: serial {got['serial']}, with remat "
             f"{got['pooled_remat_traced']}; want every forward kernel of "
             f"the serial run twice, every backward kernel once: {want}")
    traces = list((root / "models" / "pooled_remat_traced" / "profile")
                  .glob("*.json"))
    top = outs["pooled_remat_traced"].split("top device ops:", 1)
    named = [k for k in PORT_KERNELS if len(top) == 2 and k in top[1]]
    print(f"profile: {[p.name for p in traces]} "
          f"({sum(p.stat().st_size for p in traces) / 1e6:.1f} MB); port "
          f"kernels among the top device ops: {named}")
    if not traces or not named:
        fail("--profile_steps 2: no trace, or no port kernel among its top "
             "device ops")
    return cfg, argv


def preemption_phase(torch, counts, reset_counts, root, argv):
    """Phase 13c: SIGTERM to train.main in a subprocess on the card, then
    `--load auto --restore_opt` (module doc)."""
    import signal

    from neural_lam_tpu_torch import train

    t0 = time.time()
    repo = os.path.dirname(os.path.abspath(__file__))
    run = root / "models" / "pre"
    proc = subprocess.Popen(
        [sys.executable, "-m", "neural_lam_tpu_torch.train", *argv,
         "--epochs", "10000", "--val_interval", "1000000", "--run_name",
         "pre"], cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        deadline = time.time() + 300
        while not ((run / "metrics.jsonl").exists()
                   and "train_loss" in (run / "metrics.jsonl").read_text()):
            if proc.poll() is not None or time.time() > deadline:
                fail("train.main exited or logged no epoch in 300 s")
            time.sleep(0.2)
        t_sig = time.time()
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    for line in out.splitlines():
        print(f"  | {line}")
    meta_path = run / "last.meta.json"
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    print(f"train.main in a subprocess: SIGTERM {t_sig - t0:.1f} s after "
          f"its start, exit code {proc.returncode} "
          f"{time.time() - t_sig:.1f} s later; last.meta.json {meta}")
    if (proc.returncode != 0 or "Preemption signal received" not in out
            or meta.get("preempted") is not True or not meta.get("step")):
        fail("SIGTERM did not save a preempted `last` checkpoint")
    reset_counts()
    t0 = time.time()
    _, out = captured(train.main, argv + ["--epochs", "1", "--val_interval",
                                          "1", "--load", "auto",
                                          "--restore_opt", "--run_name",
                                          "pre"])
    torch.cuda.synchronize()
    meta2 = json.loads(meta_path.read_text())
    print(f"train.main --load auto --restore_opt: {time.time() - t0:.1f} s; "
          f"resumed from step {meta['step']}, now at {meta2['step']}; "
          f"launches {({k: v for k, v in counts().items() if v})}")
    if (f"(step {meta['step']})" not in out or "preempted" in meta2
            or meta2["step"] != meta["step"] + 6
            or not all(counts()[k] for k in FWD)):
        fail("--load auto did not resume the preempted run from its step")


def rest_of_training_phase(torch, np, counts, counts_bf16, reset_counts):
    """Phase 13: the rest of training (module doc)."""
    import tempfile
    from pathlib import Path

    remat_phase(torch, counts, counts_bf16, reset_counts)
    t0 = time.time()
    with tempfile.TemporaryDirectory(prefix="nlt_train_rt_") as tmp:
        root = Path(tmp)
        _, argv = cli_training_phase(torch, np, counts, reset_counts, root)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"phase 13b: {time.time() - t0:.1f} s")
        t0 = time.time()
        preemption_phase(torch, counts, reset_counts, root, argv)
    print(f"phase 13c: {time.time() - t0:.1f} s")


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
    # where wandb is installed, the trainer's W&B calls run in its disabled
    # mode: no login, no network (the subprocess of phase 13c inherits it)
    os.environ["WANDB_MODE"] = "disabled"
    smi = smi_line()
    print(smi)
    name = torch.cuda.get_device_name(0)
    peak_flops, peak_tf32, peak_bw, peak_label = peaks(name)
    print(f"device: {name}; peaks used for bounds: {peak_label}")
    reset_counts, counts, counts_bf16, plain_kernels = kernel_registry()

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
                    tag = kn[:2] + (" [bf16]" if kn.endswith("]") else "")
                    tc_usage.setdefault(tag, []).append((
                        int(re.search(r"Used (\d+)", used).group(1)),
                        sum(int(b) for b in re.findall(r"(\d+) bytes spill",
                                                       info))))
    for tag, use in sorted(tc_usage.items()):
        print(f"  edge_tc_kernel {tag} ({len(use)} instances): "
              f"{min(r for r, _ in use)}-{max(r for r, _ in use)} registers, "
              f"{sum(s for _, s in use)} bytes of spill")
    sass_counts(_build, libs["edge_flat_bwd"], "edge_layer_bwd_kernelILi8EfE")
    # edge_tc_kernel<K, kMode, kBatched>: K3, K2 (flat), P3, P2, P1 at K=8
    # and P1 at K=1 (batched)
    # (the float instances: "fE" ends their template arguments)
    sass_counts(_build, libs["edge_flat"], "edge_tc_kernelILi8ELi1ELb0EfE")
    sass_counts(_build, libs["edge_flat"], "edge_tc_kernelILi8ELi0ELb0EfE")
    for fn in ("ILi8ELi1ELb1EfE", "ILi8ELi0ELb1EfE", "ILi8ELi2ELb1EfE",
               "ILi1ELi2ELb1EfE"):
        sass_counts(_build, libs["edge"], "edge_tc_kernel" + fn)
    sass_counts(_build, libs["embed"], "embed_kernelILi0EfE")  # K1, d_in <= 64
    sass_counts(_build, libs["grid_update"], "grid_update_kernelILi4EfE")
    sass_counts(_build, libs["weight_grad"], "xtd_sum_kernel")
    sass_counts(_build, libs["embed_bwd"], "embed_bwd_kernelILb0EfE")  # B1
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
    # K4's products as three torch.mm calls, as phase 11 times its bf16
    # instance: the six 64x64 node products (encoder 2, w_i, aggregation 3
    # with its 128 inputs as two) in one, the edge product on the gathered
    # sender rows, the output map; operands built once per case
    k4_operands = {}

    def k4_products(table, senders, ew, node, mask, pp):
        key = (table.data_ptr(), node.data_ptr())
        if key not in k4_operands:
            k4_operands.clear()
            wn = torch.cat([pp[k] for k in ("enc_w0", "enc_w1", "w_i",
                                            "a_w1", "o_w0")]
                           + [pp["a_w0"][:H], pp["a_w0"][H:]], 1)
            k4_operands[key] = (node.view(-1, H), wn,
                                table.index_select(0, senders).view(-1, H),
                                pp["w2"], pp["o_w1"])
        n4, wn4, g4, w24, wo4 = k4_operands[key]
        return torch.mm(n4, wn4), torch.mm(g4, w24), torch.mm(n4, wo4)

    library["grid_update_flat"] = k4_products
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
    del k4_operands, k4_products
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
                f"{what} train step", cpu=False)
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

    # 11. the bf16 forecast path
    bf16_phase(torch, np, counts, counts_bf16, reset_counts, plain_kernels,
               records, peak_flops, peak_tf32, peak_bw)
    gc.collect()
    torch.cuda.empty_cache()
    phase_end("11 (the bf16 forecast path)")

    # 12. bf16 training
    bf16_train_phase(torch, np, counts, counts_bf16, reset_counts,
                     plain_kernels, records, zero_all, peak_flops, peak_tf32,
                     peak_bw)
    gc.collect()
    torch.cuda.empty_cache()
    phase_end("12 (bf16 training)")

    # 13. the rest of training: remat, the input pipeline, preemption
    rest_of_training_phase(torch, np, counts, counts_bf16, reset_counts)
    gc.collect()
    torch.cuda.empty_cache()
    phase_end("13 (the rest of training)")

    print(json.dumps({"kernels": records}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
