#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero, and no
result line is printed), each printing its seconds (every torch.profiler
breakdown below traces one call after a warm-up call):

1. Build every CUDA kernel of the forecast and training paths from `csrc/`
   with nvcc (one process per source and hidden width, all started
   together: every source at widths 32, 64 and 128); print the build time
   and each library's ptxas
   registers and spills (and, at width 64, per kernel
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
   (`grid_update_kernel<4, float, true>`), of `xtd_sum`'s main kernel and of B1's
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
   seeded local graphs (K = 3, 5, 6, 7 do not divide their 16-row tiles;
   each K held, not timed);
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
   (batch 4; held, not timed). B2, B3/B4 and B5/B6 run in two passes, a chain kernel and `xtd_sum` (the weight
   gradients): both passes' device times are printed apart, with their
   sum, and their bound is max(the bytes of their inputs and outputs,
   no scratch; the chain's two thirds of the FLOP on fp32 CUDA cores
   plus the weight gradients' third as 3xTF32 on tensor cores, `ops_ms`).
   `xtd_sum` is also held against
   `xtd_sum_plain` at the decoder's nine pairs, at B3/B4's two and at
   B2's one (same limit; two calls must give bit-identical outputs), with
   `torch.mm(X.t(), D)` over the same pairs timed as its library call,
   and swept over its blocks per SM at all three (1 up to what is resident,
   each value checked against `xtd_sum_plain`, then timed once); its
   reduce kernel (`xtd_reduce`) is held against
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
   as torch calls, beside its bound (bf16 bytes, no scratch, or
   operations: a chain's two thirds fp32 and its weight gradients' third
   TF32, TF32 products on tensor cores for B1 and xtd_sum, two a term
   where the A operand is a staged bf16 value). b. One AdamW step of
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

14. HiLAMParallel at `benchmarks.py`'s hi_lam_parallel_meps_ar19
   configuration (268x238, `n_max_levels=3`: 6,561 / 729 / 81 mesh
   nodes, 7 chunks a layer, hidden 64, 4 layers, seeded weights), its
   levels, chunks and each chunk's route printed first. a. A 19-step
   rollout at batch 4 and a predict step at batch 1, the counters at 0
   just before each: the launches a step equal to the table
   `step_table` computes from `flat_eligible` per edge set (K3 on every
   flat chunk, P1 with its messages, counted apart, on every batched
   one); kernel path against plain path, one step within 1e-3 and the
   rollout within `HLP_ROLLOUT_LIMIT` (gaps at steps 1, 4 and 19); host
   ms a step (19-step minus 1-step, median of 3), mesh-node updates/s
   (all levels), busy ms and idle share (a profile), peak memory above
   the live set, beside a 3-level HiLAM on the same graph (its launches
   held to its own table too). b. P1 with messages at each batched
   chunk's shape (batch 4 and 1) against its plain version (1e-4 +
   1e-4 * |plain|), two calls bit-identical, timed beside its plain
   version, its W2 product as `torch.mm` (TF32 off) and its bound. c.
   One AdamW step at batch 4 (ar_steps 1) with the counters at 0: the
   forward's launches and a backward kernel for each flat one, xtd_sum
   for the decoder, B2 and each B3/B4; gradients kernel vs plain within
   1e-3 * max abs per parameter; the fp32 and bf16 steps' host ms, busy
   ms and peak memory; the bf16 step's and the bf16 predict step's
   launches (P1 and B2's xtd_sum fp32, the rest bf16); their bf16 error
   the plain path's size (`error_size`); the bf16 instances at this
   model's shapes (K3, B3/B4 and xtd_sum on each flat chunk, P3 on the
   batched mesh-init set, K2 and B2 at g2m, K4 and B5/B6 at m2g) within
   one bf16 ulp of their plain versions. d. `train.main --model
   hi_lam_parallel` 2 steps at ar_steps 2 on a 268x238 MDP datastore,
   a finite loss and a saved `last`; `predict.main` forecasts 4 steps
   from it (`forecast_check`: launches, plain path within 1e-3).

15. GraphEFM and HiEFM at `benchmarks.py`'s graph_efm_meps_ar4 (268x238,
   multiscale) and prob_model_global_0p7deg (a 512x256 global grid,
   icosahedral mesh at 5 refinements, 3 levels of 10,242 / 2,562 / 642
   nodes), hidden 64, 4 layers, latent_dim 32, seeded weights. a. A
   4-step prior-mean rollout at batch 4, the counters at 0 just before
   it: the launches a step, and the virtual-row fold's row gathers a step
   (the global g2m's polar receivers own 128 virtual rows), equal to the
   table `step_table` computes from `flat_eligible` per round; one step
   (1e-3) and the rollout (`EFM_ROLLOUT_LIMIT`) against the plain path;
   host ms a step (4-step minus 1-step), mesh-node updates/s, busy ms and
   idle share, peak memory above the live set (`hlp_step_stats`). b.
   `entry.sample_ensemble`, 5 members over 2 steps at batch 1 (the
   batched route) and 4 (the flat route), the same draws on both paths:
   members within `EFM_ROLLOUT_LIMIT`, CRPS, spread, ensemble-mean RMSE and
   SSR within `EFM_SCORE_LIMIT` of their largest magnitude, the rank
   histogram within `EFM_RANK_LIMIT` of its counts. c. An ELBO AdamW step
   at batch 4 (ar_steps 1) with the counters at 0: the forward's launches
   with the posterior's rounds, a backward kernel for each flat one and
   xtd_sum for the decoder, each B2 and each B3/B4; fp32 gradients kernels
   vs plain within 1e-3 x max abs, the bf16 gradients' error the plain
   path's size; fp32 and bf16 step host ms, busy ms and peak memory; one
   `--loss crps_ens` AdamW step with 4 members, its launches equal to the
   prior's table at batch 4 x 4 members (the backward kernels at 16 batch
   columns, W = 1024), and its gradients kernels vs plain within 1e-3 x
   max abs per parameter, from the loss and from the plain path's
   cotangent on the members through both paths (the kernels alone:
   the loss's sort turns where members nearly tie). d. On a 64x32
   dummydata_global datastore whose graph the train CLI builds:
   `train.main --model hi_efm` 2 steps, `--eval test --ensemble_members
   3` and `predict.main --ensemble_members 3` (a `member` dim), each
   against the plain path with the same seed (losses within 1e-3
   relative, the scores and the members within the limits above); the
   launches printed.

16. Data parallelism and the grid scheme (`parallel/`) on two rank
   processes of the one card, which share it through the gloo backend
   (NCCL refuses two ranks on one card; gloo stages each collective
   through host memory, so no time here is an NCCL or multi-GPU figure).
   A dummydata datastore at the bench grid and features (30 time steps).
   a. `train.main` with phase 7's GraphLAM (hidden 64, 4 layers, the
   multiscale graph, fp32): 3 AdamW steps at batch 4 in this process,
   then the same on `--num_nodes 2` ranks x batch 2 (rows 0-1 and 2-3 of
   each global batch): the losses (mean over the ranks) within 1e-5
   relative, the gradients of the first step (reduced over the ranks)
   within 1e-4 x max abs + 1e-6 of the single process's per parameter
   (AdamW's update would hide a gradient scaled by a constant), the
   parameters after the steps within 2e-3 relative, each
   rank's launches of its second step phase 7's table (no count depends
   on the batch); one step as a one-rank world (`--num_nodes 1
   --coordinator_address`), which runs nccl, its loss the single
   process's. b. GraphLAM at full depth grid-sharded over the 2 ranks
   (`spatialize`) against the unsharded model on the same rank: a
   predict step and a 2-step rollout within 1e-5 x state_std, a training
   step's gradients within 1e-4 + 1e-4 x max abs per parameter. c. HiLAM,
   HiLAMParallel (3 levels), GraphEFM and HiEFM at
   prob_model_global_0p7deg (phase 15's global configuration, whose polar
   g2m receivers take edges from both grid blocks) at one processor
   layer, held the same way, and a bf16 GraphLAM (one layer) whose bf16 error
   against the fp32 model is the unsharded bf16 model's size (phase 11's
   limits, outputs and gradients). In b and c each rank's launches of a
   predict and a training step equal the per-rank table `step_table`
   gives for its twin (its part of the graph), and each rank prints the
   routes of its sets, the collectives of a step and their bytes, host ms
   (median of 3) beside the unsharded step's, and device busy ms (a
   profile of 2). Each rank process has its own 300 s limit; any failure
   fails the run.

17. The mesh-node-sharded schemes `mesh_rs` and `mesh_halo`
   (`parallel/grid_sharded.py`'s `spatialize_rs`) on two rank processes of
   the one card (gloo; its point-to-point calls staged through host
   memory, `collectives.HOST_STAGED`), on phase 16's datastore, each
   model against its unsharded run on the same rank. a. GraphLAM at full
   depth under each scheme: a predict step and a 2-step rollout within
   1e-5 x state_std, a training step's gradients within 1e-4 + 1e-4 x
   max abs per parameter, host ms (median of 3) beside the unsharded
   step's and device busy ms (a profile of 2). b. The other models of
   16c (HiLAM, HiLAMParallel, GraphEFM, HiEFM at
   prob_model_global_0p7deg, one processor layer; a bf16 GraphLAM by its
   error's size) under each scheme, held the same way. In a and b each
   rank's launches of a predict and a training step equal the table
   `step_table` gives for its twin (a split set's interior and frontier
   rounds), and its collectives by kind those `collective_table` derives
   from its sets and halo plans; each rank prints its routes and its
   collectives by kind and bytes, beside the grid scheme's of 16b. c.
   `train.main --spatial_shards 2 --spatial_scheme mesh_halo` on the two
   ranks, 2 AdamW steps at batch 4: each rank's losses within 1e-5
   relative of 16a's single process's. Each rank process has its own
   300 s limit.

18. The serving export and the kernels' operators (`ops/library.py`:
   K1-K4 and P1-P3 are `nlt::` operators of PyTorch's dispatcher). a.
   Each operator's host us a call through the dispatcher against its
   CUDA implementation called directly (at its first call's arguments in
   a GraphLAM batch-4 or HiLAM batch-1 predict step; enqueue time behind
   a sleep kernel, median of 3 rounds of 100), and the bench GraphLAM's
   and HiLAM's batch-4 predict steps' host and busy ms
   (`hlp_step_stats`, 4-step minus 1-step rollouts). b. `export.
   export_predict_step` of the bench GraphLAM at batch 4 in fp32 and
   bf16 and of the 4-level HiLAM at batch 1, each saved with
   `torch.export.save`; a fresh process (`chip_smoke.py --export-load`)
   that imports `neural_lam_tpu_torch.export` and nothing of the models
   loads each (`load_exported`) and runs it on the eager step's inputs:
   its output must equal the eager step's bit for bit, its launches a
   step (the bf16 instances' for bf16) equal `step_table`, as the eager
   step's must; printed: export, save and load s, the artifact's MB, and
   host and busy ms a step of the loaded program beside the eager
   step's. c. A `--hidden_layers 2` GraphLAM at bench width: a 2-step
   rollout at batch 1 launches no kernel (the JAX package's gates send
   3-layer MLPs to the plain route) and is within 1e-5 x max abs of the
   same weights' rollout on the CPU (TF32 off); 3 AdamW steps at batch 4
   launch no kernel and give finite losses. d. The bench GraphLAM's and
   HiLAM's graph scene (`plot_graph.graph_scene`, numpy only, from the
   graph on the card) and interactive page (`graph/html_viz.py`): every
   point and edge set embedded whole.

19. The forward kernels at hidden widths 32 and 128 (each forward source
   built once per width). a. Each width-32 and width-128 instance's
   ptxas registers and spill. b. At each width, the bench GraphLAM
   (batch 4) and 4-level HiLAM (batch 1) built at that width: every
   forward kernel's fp32 and bf16 instances (P1 fp32) at their shapes
   (`main_path_cases`) against the plain versions (fp32 1e-4 + 1e-4 *
   |plain|, bf16 one ulp), two calls bit-identical, timed beside the
   plain version, the products as `torch.mm` and the bound; K4 with
   output maps wider than its width (d_out 80 and 200 at 64, 34 at 32,
   160 at 128). c. 4-step rollouts through `entry.forecast`, the
   counters at 0 just before each, launches a step equal to
   `step_table`'s: at 32 GraphLAM batch 4 (the flat route) and batch 1
   (every set batched: P2/P3) in fp32 and bf16, HiLAM batch 1; at 128
   GraphLAM batch 4 and HiLAM batch 1 (mixed) in fp32 and bf16; fp32
   predict steps within 1e-3 of the plain path, bf16 ones by phase 11's
   error size. At 128 on a 268x238 MDP datastore, from checkpoints the
   port writes at --hidden_dim 128: `predict.main` for GraphLAM and
   HiLAM (`forecast_check`) and GraphLAM `--precision bf16`, and
   `train.main --eval val` against the plain path (1e-4 relative). d.
   Width 48 raises in K1, K2, K4 and P2, in every backward wrapper (B1,
   B2, B3/B4, B5/B6, xtd_sum) and in training (`train.main`, before its
   first step), naming the built widths, with no launch. Its records are
   named `<kernel>[bf16]@h<width>`, their launches those of 19c's runs
   (P2 at 128 runs on no bench path: every static set is flat there).

20. The backward kernels at hidden widths 32 and 128 (each backward
   source built once per width in phase 1). a. Each width-32 and
   width-128 backward instance's ptxas registers and spill. b. At each
   width, the bench GraphLAM and 4-level HiLAM built at that width: B1
   (the training step's call), B2 (g2m), B3/B4 (m2m[0]), B5/B6 (m2g),
   xtd_sum (the decoder's nine pairs) and xtd_reduce (their partials) at
   GraphLAM's batch-4 training-step shapes, fp32 and bf16, against their
   plain versions (fp32 every tensor within 1e-4 + 1e-4 * max|plain|,
   bf16 outputs one bf16 ulp), two calls bit-identical, each timed beside
   its plain version, its weight-gradient products as `torch.mm` (TF32
   off) and its bound (as phase 12's); B3/B4 at HiLAM's m2m[0] and B5/B6 at its m2g held
   too. B1 at d_in 160 (x in column chunks) at 32, 64 and 128, with and
   without dx, and B5/B6 at output maps wider than the width (d_out 80
   and 200 at 64, 34 at 32, 160 at 128), fp32 and bf16. c. `train.main`
   for GraphLAM and HiLAM at batch 4, fp32 and `--precision bf16`, 4
   AdamW steps each at 32 and 128 on a 268x238 MDP datastore, every
   counter at 0 just before each step: launches a step equal to
   `train_tables`'s (from `step_table`'s routes); the first step's
   gradients on the same weights and batch, fp32 kernels vs plain within
   1e-3 of each parameter's max abs, bf16 by phase 12's error size; per
   step host ms and peak device memory, the last step's device busy ms (a
   device-only profile). Its records are named `<kernel>[bf16]@h<width>`,
   their launches those of 20c's steps.

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
            for extra in ("launches_bf16", "launches_with_messages"):
                if hasattr(w, extra):
                    setattr(w, extra, 0)

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
    long enough for the host to enqueue all of them (4x the warm-up call's
    host time for each call, 25-100 ms), so the events time the device
    work alone; fails if the host did not finish in time. Without it, a
    call whose host side (argument checks, ctypes, allocation) takes longer
    than its kernel is timed at its host cost."""
    t0 = time.perf_counter()
    fn()
    warm_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    t0 = time.perf_counter()
    if queued:
        events[0].record()
        sleep_s = min(max(4 * reps * warm_s, 0.025), 0.1)
        torch.cuda._sleep(int(SLEEP_CYCLES * sleep_s / 0.1))
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


def wgrad_tf32(pairs, slot_rows=0, real_share=1.0):
    """TF32 FLOP of xtd_sum's 3xTF32 products over `pairs`: three TF32
    products a term, two where X is bf16; a pair whose X has `slot_rows`
    rows (an edge set's slots, masked ones among them) at `real_share` of
    its rows, the edges this run's mask holds. X is fp32 or bf16."""
    return sum((2 if x.element_size() == 2 else 3) * 2.0 * x.shape[0]
               * x.shape[1] * d.shape[1]
               * (real_share if x.shape[0] == slot_rows else 1.0)
               for x, d in pairs)


def ops_ms(ops, peak_flops, peak_tf32):
    """The operations bound in ms of ops = (fp32 FLOP on CUDA cores, TF32
    FLOP on tensor cores), run one after the other: a backward kernel's
    chain pass (two products a forward product, fp32) and its xtd_sum pass
    (the third, `wgrad_tf32`)."""
    return 1e3 * (ops[0] / peak_flops + ops[1] / peak_tf32)


def xtd_sweep(torch, weight_grad, pairs, what):
    """xtd_sum's two kernels at each count of blocks per SM from 1 up to
    what is resident, on `pairs` (`what` names them): each held against
    xtd_sum_plain (1e-4 + 1e-4 * max|plain|), then timed once (queued, 10
    calls); prints each value's grid, segments and time."""
    dev = pairs[0][0].device
    ns = [x.shape[0] for x, _ in pairs]
    widths = [d.shape[1] for _, d in pairs]
    h = pairs[0][0].shape[1]
    resident = weight_grad._occupancy(dev, h)[1]
    values = range(1, resident + 1)

    def run(v):
        return weight_grad.xtd_reduce(*weight_grad.xtd_partials(
            pairs, weight_grad.n_blocks(ns, dev, h, v)), widths, h)

    want = weight_grad.xtd_sum_plain(pairs)
    for v in values:
        for a, b in zip(run(v), want):
            if not bool(((a - b).abs() <= 1e-4 + 1e-4 * b.abs().max()).all()):
                fail(f"xtd_sum at {v} blocks per SM disagrees with plain")
    print(f"xtd_sum blocks per SM at {what} (shipped: "
          f"{weight_grad.BLOCKS_PER_SM}; {resident} resident; ms):")
    for v in values:
        ms = cuda_ms(torch, lambda: run(v), 10)
        blocks = weight_grad.n_blocks(ns, dev, h, v)
        n_seg = len(weight_grad.segments(ns, blocks))
        print(f"  {v}: {blocks} blocks, {n_seg} segments; {ms:.4f}")


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


def kernel_rows(torch, prof):
    """(device us, calls, name) of each kernel in a torch.profiler trace,
    largest first: device-side kernel events only (a host op's row, and a
    user annotation's device range, e.g. "Optimizer.step#AdamW.step",
    repeat the time of the kernels inside them; kernel names may hold "#"
    too, as in "{lambda(float)#1}")."""
    def dev_us(e):
        v = getattr(e, "self_device_time_total", None)
        return v if v is not None else getattr(e, "self_cuda_time_total", 0)

    def annotation(e):
        return (getattr(e, "is_user_annotation", False)
                or re.fullmatch(r"[\w.]+#[\w.]+", e.key) is not None)

    return sorted(((dev_us(e), e.count, e.key) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not annotation(e) and dev_us(e) > 0), reverse=True)


def profile(torch, step, what, steps=1, top=12, cpu=True):
    """Device time by kernel over `steps` calls of `step` (torch.profiler;
    one call after a warm-up by default, which keeps the script inside
    its time limit),
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

    rows = kernel_rows(torch, prof)
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
    return w0[:w0.shape[1]], mlp.layers[0].b.detach()


def main_path_cases(torch, gm, hm, rand, dt):
    """The main-path cases of the forward kernels' instances of dtype
    `dt` at the hidden width h of the bench GraphLAM `gm` and HiLAM `hm`
    (phase 11's bf16 cases at 64; phase 19's at 32 and 128), inputs of
    `dt` from `rand`: K1-K4 at GraphLAM's batch 4, P2 at HiLAM's m2g and
    P3 at its m2m[0], batch 1, and, for fp32 (P1 has no bf16 instance), P1
    at HiLAM's down[0], batch 1. Each is (kernel, module, args, replaces,
    source, bytes, FLOP, TF32 FLOP on tensor cores (None: fp32 CUDA
    cores), the library call for its products on operands of `dt`); a
    3xTF32 product takes three TF32 products a term, two where its A
    operand is a bf16 value (its small half is zero: the first products
    of K1, K3 and P3)."""
    from neural_lam_tpu_torch.ops import edge, edge_flat, embed, grid_update

    h = gm.args.hidden_dim
    isz = torch.finfo(dt).bits // 8  # bytes a stored value
    a = 2 if dt == torch.bfloat16 else 3  # TF32 products of a staged A
    W = BATCH * h
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
    w0b, w1b = k1[1].to(dt), k1[3].to(dt)
    cases.append((
        "embed_grid_flat", embed, k1, "neural_lam_tpu/ops/pallas_embed.py:99",
        csrc + "embed.cu", nbytes(*k1[:7]) + rows * h * isz,
        2.0 * rows * (d_in * h + h * h),
        2.0 * rows * (a * d_in + 3 * h) * h,
        lambda: torch.mm(torch.mm(k1[0].view(-1, d_in), w0b), w1b)))
    es = g.g2m
    nv, K = es.num_virt, es.dense_k
    mask_p = es.mask.view(nv, K)
    a2 = (rand(es.num_send, W), es.senders, rand(nv * K, h), rand(nv, W),
          mask_p) + tail(gm.g2m_gnn.edge_mlp)
    g2 = a2[0].index_select(0, es.senders).view(-1, h)
    w2b = a2[5].to(dt)
    cases.append((
        "edge_tail_sum_flat", edge_flat, a2, f"{pef}:373",
        csrc + "edge_tc.cuh", nbytes(*a2) + nv * W * isz,
        2.0 * float(mask_p.sum()) * BATCH * h * h,
        3 * 2.0 * float(mask_p.sum()) * BATCH * h * h,
        lambda: torch.mm(g2, w2b)))
    es = g.m2m[0]
    nv, K = es.num_virt, es.dense_k
    mask_p = es.mask.view(nv, K)
    lay = gm.processor[0].edge_mlp
    a3 = (rand(nv * K, W), rand(es.num_send, W), es.senders, rand(nv, W),
          mask_p) + first(lay) + tail(lay)
    e3, web3, w2b3 = a3[0].view(-1, h), a3[5].to(dt), a3[7].to(dt)
    cases.append((
        "edge_layer_flat", edge_flat, a3, f"{pef}:727", csrc + "edge_tc.cuh",
        nbytes(*a3) + nv * K * W * isz + nv * W * isz,
        2.0 * nv * K * BATCH * 2 * h * h,
        (a + 3) * 2.0 * nv * K * BATCH * h * h,
        lambda: (torch.mm(e3, web3), torch.mm(e3, w2b3))))
    es = g.m2g
    nv, K = es.num_virt, es.dense_k
    mask_p = es.mask.view(nv, K)
    a4 = (rand(es.num_send, W), es.senders, rand(nv * K, h), rand(n_grid, W),
          mask_p, pp)
    # K4's products as three torch.mm calls: the six hxh node products
    # (encoder 2, w_i, aggregation 3 with its 2h inputs as two) in one,
    # the edge product, the output map
    node4 = a4[3].view(-1, h)
    wn4 = torch.cat([pp[k] for k in ("enc_w0", "enc_w1", "w_i", "a_w1",
                                     "o_w0")] + [pp["a_w0"][:h],
                                                 pp["a_w0"][h:]], 1).to(dt)
    g4 = a4[0].index_select(0, es.senders).view(-1, h)
    w24, wo4 = pp["w2"].to(dt), pp["o_w1"].to(dt)
    cases.append((
        "grid_update_flat", grid_update, a4,
        "neural_lam_tpu/ops/pallas_grid_update.py:174",
        csrc + "grid_update.cu",
        nbytes(*a4[:5], *pp.values()) + nv * BATCH * d_out * isz,
        2.0 * nv * BATCH * (7 * h * h + h * d_out)
        + 2.0 * float(mask_p.sum()) * BATCH * h * h, None,
        lambda: (torch.mm(node4, wn4), torch.mm(g4, w24),
                 torch.mm(node4, wo4))))
    es = hg.m2g
    nv, K = es.num_virt, es.dense_k
    mlp = hm.m2g_gnn.edge_mlp
    a5 = (rand(1, es.num_send, h), es.senders, rand(nv * K, h),
          rand(1, nv, h)) + tail(mlp) + (es.mask, K, False)
    g5 = a5[0].index_select(1, es.senders).view(-1, h)
    w2b5 = a5[4].to(dt)
    cases.append((
        "edge_tail_sum", edge, a5, f"{PALLAS_EDGE}:182",
        csrc + "edge_tc.cuh",
        nbytes(*(t for t in a5 if torch.is_tensor(t))) + nv * h * isz,
        2.0 * float(es.mask.sum()) * h * h,
        3 * 2.0 * float(es.mask.sum()) * h * h,
        lambda: torch.mm(g5, w2b5)))
    es = hg.m2m[0]
    nv, K = es.num_virt, es.dense_k
    lay = hm.mesh_up_same_gnns[0][0].edge_mlp
    a6 = (rand(1, nv * K, h), rand(1, es.num_send, h), es.senders,
          rand(1, nv, h), es.mask) + first(lay) + tail(lay) + (K,)
    e6, web6, w2b6 = a6[0].view(-1, h), a6[5].to(dt), a6[7].to(dt)
    cases.append((
        "edge_layer", edge, a6, f"{PALLAS_EDGE}:304", csrc + "edge_tc.cuh",
        nbytes(*(t for t in a6 if torch.is_tensor(t))) + nv * K * h * isz
        + nv * h * isz, 2.0 * nv * K * 2 * h * h,
        (a + 3) * 2.0 * nv * K * h * h,
        lambda: (torch.mm(e6, web6), torch.mm(e6, w2b6))))
    if dt == torch.float32:
        es = hg.down[0]
        nv, K = es.num_virt, es.dense_k
        a7 = (rand(1, nv * K, h),) + tail(hm.mesh_read_gnns[0].edge_mlp) + (
            es.mask, K, False)
        cases.append((
            "edge_tail", edge, a7, f"{PALLAS_EDGE}:54", csrc + "edge_tc.cuh",
            nbytes(*(t for t in a7 if torch.is_tensor(t))) + nv * h * isz,
            2.0 * float(es.mask.sum()) * h * h,
            3 * 2.0 * float(es.mask.sum()) * h * h,
            lambda: torch.mm(a7[0].view(-1, h), a7[1])))
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
    cases = main_path_cases(torch, gm, hm, rand, bf)

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
    (kernel, module, args, replaces, source, bytes, FLOP, ops (fp32 FLOP
    on CUDA cores, TF32 FLOP on tensor cores; `ops_ms`), library call or
    None). Bytes: each input read and each output written once, in its
    dtype (no scratch). Ops: B1's and xtd_sum's products on tensor cores;
    a chain pass's two products a forward product on CUDA cores, its
    weight gradients as its xtd_sum pass runs them (`wgrad_tf32`); a
    3xTF32 product takes three TF32 products a term, two where its A
    operand is a staged bf16 value (B1's t0 = x W0 and dW0 = x^T dt0,
    xtd_sum's bf16-X pairs)."""
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
            (0.0, 2.0 * rows * (2 * 2 * d_in * H + 3 * 3 * H * H
                                + (3 * d_in * H if need_dx else 0))), lib))
    # B2 at g2m
    es = g.g2m
    nv, K = es.num_virt, es.dense_k
    M = nv * K
    mask_p = es.mask.view(nv, K)
    tail = mlp_tail(gm.g2m_gnn.edge_mlp)
    a2 = (rand(es.num_send, W), es.senders, rand(M, H), rand(nv, W),
          mask_p) + tail + (rand(nv, W),)
    # B2's, B3/B4's and B5/B6's library call: their weight-gradient
    # products, one torch.mm(X.float().t(), D) a pair of their bf16 chain
    # pass, as the fp32 column's (phase 4's xtd_sum cases)
    b2_pairs = edge_flat.edge_tail_bwd_chain(*a2)[4]
    real = float(mask_p.sum())
    fwd = 2.0 * real * BATCH * H * H
    cases.append((
        "edge_tail_sum_flat_bwd", edge_flat, a2, f"{pef}:526",
        csrc + "edge_flat_bwd.cu",
        nbytes(*a2) + M * (W + H) * 2 + nv * W * 2 + nbytes(*tail),
        3 * fwd, (2 * fwd, wgrad_tf32(b2_pairs, M * BATCH, real / M)),
        lambda: [torch.mm(x.float().t(), d) for x, d in b2_pairs]))
    # B3/B4 at m2m[0]
    es = g.m2m[0]
    nv, K = es.num_virt, es.dense_k
    M = nv * K
    mask_p = es.mask.view(nv, K)
    lay = gm.processor[0].edge_mlp
    par3 = mlp_first(lay) + mlp_tail(lay)
    a3 = (rand(M, W), rand(es.num_send, W), es.senders, rand(nv, W),
          mask_p) + par3 + (rand(M, W), rand(nv, W))
    b3_pairs = edge_flat.edge_layer_bwd_chain(*a3)[4]
    fwd = 2.0 * M * BATCH * 2 * H * H
    cases.append((
        "edge_layer_flat_bwd", edge_flat, a3, f"{pef}:846",
        csrc + "edge_flat_bwd.cu",
        nbytes(*a3) + 2 * M * W * 2 + nv * W * 2 + nbytes(*par3),
        3 * fwd, (2 * fwd, wgrad_tf32(b3_pairs)),
        lambda: [torch.mm(x.float().t(), d) for x, d in b3_pairs]))
    # B5/B6 at m2g
    es = g.m2g
    nv, K = es.num_virt, es.dense_k
    mask_p = es.mask.view(nv, K)
    pp = {k: v.detach() for k, v in
          grid_update.pack_grid_update_params(gm).items()}
    d_out = pp["o_w1"].shape[1]
    a5 = (rand(es.num_send, W), es.senders, rand(nv * K, H),
          rand(n_grid, W), mask_p, pp, rand(nv, BATCH * d_out))
    dec_pairs = grid_update.grid_update_bwd_chain(*a5)[4]
    real = float(mask_p.sum())
    fwd = (2.0 * nv * BATCH * (7 * H * H + H * d_out)
           + 2.0 * real * BATCH * H * H)
    cases.append((
        "grid_update_flat_bwd", grid_update, a5, f"{pgu}:752",
        csrc + "grid_update_bwd.cu",
        nbytes(*a5[:5], a5[6], *pp.values()) + nv * K * (W + H) * 2
        + n_grid * W * 2 + nbytes(*pp.values()), 3 * fwd,
        (2 * fwd, wgrad_tf32(dec_pairs, nv * K * BATCH, real / (nv * K))),
        lambda: [torch.mm(x.float().t(), d) for x, d in dec_pairs]))
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
            (0.0, wgrad_tf32(pairs)),
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
        for (name, mod, args, replaces, source, bytes_, flops, ops,
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
            t_ops = ops_ms(ops, peak_flops, peak_tf32)
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
                  f"{t_bytes:.4f} ms; {flops / 1e9:.2f} GFLOP as "
                  f"{ops[0] / 1e9:.2f} fp32 and {ops[1] / 1e9:.2f} TF32: "
                  f"{t_ops:.4f} ms)")
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


def step_stats(torch, trainer, batch, what, n=5):
    """(host ms, the median of n synchronised training steps after one,
    peak memory above the live set in bytes, device busy ms a step from a
    profile of one step, or None) of `trainer` on `batch`."""
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
    prof = profile(torch, lambda: trainer.train_step(batch), what, top=6,
                   cpu=False)
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

    def case(net, ds, ar, what):
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
                torch, trainer, batch, f"{what} {tag} train step", 3)
            stats.append(f"{tag}: busy "
                         f"{'not measured' if busy is None else f'{busy:.3f}'}"
                         f" ms, host {host:.3f} ms (median of 3), peak "
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
    g0, g1 = case(gm, gds, 4, "GraphLAM fp32")
    fp32_check(g0, g1, "GraphLAM fp32")
    del g1
    print(f"phase 13a, GraphLAM fp32: {time.time() - t0:.1f} s")
    gm16 = copy.copy(gm)  # the same weights on the bf16 path
    gm16.compute_dtype = torch.bfloat16
    k0, k1 = case(gm16, gds, 4, "GraphLAM bf16")
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
    h0, h1 = case(hm, hds, 2, "HiLAM fp32")
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


# phase 14: HiLAMParallel at benchmarks.py's hi_lam_parallel_meps_ar19
HLP_STEPS = 19  # the configuration's rollout length
HLP_LEVELS = 3  # its n_max_levels
# the 19-step rollout's kernel-vs-plain limit (PERF.md, set before the
# first run on the card)
HLP_ROLLOUT_LIMIT = 1e-3


def chunk_names(net):
    """HiLAMParallel's chunk names in chunk order: m2m levels, up, down."""
    g = net.graph
    return ([f"m2m[{i}]" for i in range(len(g.m2m))]
            + [f"up[{i}]" for i in range(len(g.up))]
            + [f"down[{i}]" for i in range(len(g.down))])


def step_rounds(net, B, posterior=False):
    """The rounds of a predict step of `net` (a hierarchical or a latent
    model) at batch B, as (edge set, kind, name): kind "static"
    (update_edges=False on a static edge term: K2 flat, P2 batched),
    "layer" (the edge state updated: K3 or P3), "tail" (an edge state
    read, not updated: K3 or P1), "chunk" (a HiLAMParallel chunk: K3 or
    P1 with messages), and on the flat-grid route "embed" (K1) and
    "decoder" (K4). The grid side, a latent model's prior on m2m[0] (with
    `posterior`, the posterior's g2m and m2m[0] rounds of a training step
    too), then a hierarchical model's mesh init over the up sets, its
    processor (HiLAM: the sweeps; HiLAMParallel: each chunk) and its
    read-out over the down sets, or GraphEFM's m2m[0] layers; m2g last."""
    from neural_lam_tpu_torch.models.base_hi_graph_model import (
        BaseHiGraphModel,
    )
    from neural_lam_tpu_torch.models.hi_lam_parallel import HiLAMParallel

    g = net.graph
    L = net.args.processor_layers
    if net._flat_grid_eligible(B):
        head = [(None, "embed", "grid"), (g.g2m, "static", "g2m")]
        tail = [(g.m2g, "decoder", "m2g")]
    else:
        head, tail = [(g.g2m, "static", "g2m")], [(g.m2g, "static", "m2g")]
    rounds = head
    if getattr(net, "is_latent", False):
        rounds += [(g.m2m[0], "static", "prior m2m[0]")]
        if posterior:
            rounds += [(g.g2m, "static", "posterior g2m"),
                       (g.m2m[0], "static", "posterior m2m[0]")]
    if not isinstance(net, BaseHiGraphModel):
        return rounds + [(g.m2m[0], "layer", "m2m[0]")] * L + tail
    n = len(g.m2m)
    rounds += [(es, "layer", f"up[{i}]") for i, es in enumerate(g.up)]
    if isinstance(net, HiLAMParallel):
        rounds += [(es, "chunk", nm) for es, nm in zip(
            net._chunk_edge_sets(), chunk_names(net))] * L
    else:
        down = [(g.m2m[-1], f"m2m[{n - 1}]")] + [
            s for lv in range(n - 2, -1, -1)
            for s in ((g.down[lv], f"down[{lv}]"), (g.m2m[lv], f"m2m[{lv}]"))]
        up = [(g.m2m[0], "m2m[0]")] + [
            s for lv in range(1, n)
            for s in ((g.up[lv - 1], f"up[{lv - 1}]"),
                      (g.m2m[lv], f"m2m[{lv}]"))]
        rounds += [(es, "layer", nm) for es, nm in (down + up) * L]
    rounds += [(g.down[lv], "tail", f"read-out down[{lv}]")
               for lv in range(n - 2, -1, -1)]
    return rounds + tail


def step_table(net, B, posterior=False):
    """(launches a predict step by kernel, P1's launches with messages,
    the virtual-row fold's row gathers) of `step_rounds`, each round's
    route from `flat_eligible`: each round on a set that is not
    virt_identity folds its receivers' R virtual rows by R gathers (the
    global g2m's polar receivers: R = 128). A round on a split set of the
    mesh-node schemes (`es.frontier`) runs twice, the frontier on the
    interior's route, and an edge-state update there on the batched route
    is P1 with its messages (the JAX package's `_apply_inet_split`), not
    P3."""
    from neural_lam_tpu_torch.ops.message_passing import flat_eligible

    names = {"static": ("edge_tail_sum_flat", "edge_tail_sum"),
             "layer": ("edge_layer_flat", "edge_layer"),
             "tail": ("edge_layer_flat", "edge_tail"),
             "chunk": ("edge_layer_flat", "edge_tail")}
    t = dict.fromkeys(FWD + BATCHED, 0)
    msg = gathers = 0
    for es, kind, _ in step_rounds(net, B, posterior):
        if kind in ("embed", "decoder"):
            t["embed_grid_flat" if kind == "embed"
              else "grid_update_flat"] += 1
            continue
        flat = flat_eligible(es, B, net.args.hidden_dim)
        split = es.frontier is not None
        if split and kind == "layer" and not flat:
            kind = "chunk"  # P1 with its messages
        for part in (es, es.frontier) if split else (es,):
            t[names[kind][0 if flat else 1]] += 1
            msg += kind == "chunk" and not flat
            if part.rec_slots is not None:
                gathers += part.rec_slots.shape[1]
    return t, msg, gathers


def hlp_step_stats(torch, entry, net, B, what, steps=HLP_STEPS):
    """Host ms a predict step (`steps`-step minus 1-step rollout, median
    of 3), mesh-node updates/s, peak memory above the live set over one
    step, and the device's busy ms and idle share (a profile of 3
    steps)."""
    init, forcing, true = entry.make_inputs(net, B, steps, seed=0)

    def rollout_s(steps):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            entry.forecast(net, init, forcing[:, :steps], true[:, :steps])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return sorted(times)[1]

    entry.forecast(net, init, forcing[:, :2], true[:, :2])  # warm-up
    ms = (rollout_s(steps) - rollout_s(1)) / (steps - 1) * 1e3
    updates = (net.num_mesh_nodes * BENCH["processor_layers"] * B * 1e3
               / ms)
    with torch.no_grad():
        ctx = net.precompute_rollout_ctx()
        torch.cuda.synchronize()
        live = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        net.predict_step(init[:, 1], init[:, 0], forcing[:, 0], ctx)
        torch.cuda.synchronize()
        above = torch.cuda.max_memory_allocated() - live
        prof = profile(torch, lambda: net.predict_step(
            init[:, 1], init[:, 0], forcing[:, 0], ctx),
            f"{what} predict step", top=8)
    busy = prof[0] if prof else None
    print(f"{what}: predict step {ms:.3f} ms (host clock, {steps}-step "
          f"minus 1-step rollout, median of 3); {updates:.4e} mesh-node "
          f"updates/s ({net.num_mesh_nodes} mesh nodes, all levels, x "
          f"{BENCH['processor_layers']} layers x batch {B}); device busy "
          + (f"{busy:.3f} ms a step (idle share {1 - busy / ms:.3f} of the "
             "host-clock step)" if busy else "not measured")
          + f"; peak memory {above / 2**30:.3f} GiB above the "
          f"{live / 2**30:.3f} GiB live")
    return {"ms": ms, "updates": updates, "busy": busy, "above": above}


def hilam_parallel_phase(torch, np, counts, counts_bf16, reset_counts,
                         plain_kernels, zero_all, peak_tf32, peak_bw):
    """Phase 14: HiLAMParallel at benchmarks.py's hi_lam_parallel_meps_ar19
    configuration (module doc)."""
    import copy
    import tempfile
    from pathlib import Path

    from neural_lam_tpu_torch import entry, predict, train
    from neural_lam_tpu_torch.config import (
        DatastoreSelection,
        NeuralLAMConfig,
        TrainingConfig,
    )
    from neural_lam_tpu_torch.models import MODELS
    from neural_lam_tpu_torch.ops import (
        edge,
        edge_flat,
        grid_update,
        weight_grad,
    )
    from neural_lam_tpu_torch.ops.message_passing import flat_eligible

    t_phase = time.time()
    net, ds = entry.build_model(**BENCH, device="cuda",
                                model="hi_lam_parallel",
                                n_max_levels=HLP_LEVELS)
    config = NeuralLAMConfig(
        datastore=DatastoreSelection(kind="dummydata", config_path=""),
        training=TrainingConfig())
    # the 3-level HiLAM on the same graph and weights' seed
    hilam = MODELS["hi_lam"](net.args, config, ds, net.graph, device="cuda",
                             generator=torch.Generator().manual_seed(0))
    g = net.graph
    L = BENCH["processor_layers"]
    names, chunks = chunk_names(net), net._chunk_edge_sets()
    print(f"HiLAMParallel (hi_lam_parallel_meps_ar19: 268x238 grid, "
          f"n_max_levels={HLP_LEVELS}, hidden 64, {L} processor layers) and "
          f"a 3-level HiLAM on its graph built in "
          f"{time.time() - t_phase:.1f} s: levels {g.level_sizes} (N_mesh="
          f"{net.num_mesh_nodes}), {len(chunks)} chunks a layer")
    for B in (BATCH, 1):
        print(f"  routes at batch {B}: " + ", ".join(
            f"{n} (K={es.dense_k}, {es.num_virt} rows) "
            f"{'K3' if flat_eligible(es, B, H) else 'P1 with messages'}"
            for n, es in zip(names, chunks)))

    # a. the forecast: launches, kernel path against plain path, step time
    def forecast_counted(m, B, steps, what):
        """A `steps`-step rollout through entry.forecast with every
        counter at 0 just before it: the launches must be `step_table`'s
        a step, P1's with-messages launches among them; returns (the
        inputs, the rollout)."""
        init, forcing, true = entry.make_inputs(m, B, steps, seed=0)
        entry.forecast(m, init, forcing[:, :1], true[:, :1])  # warm-up
        reset_counts()
        pred = entry.forecast(m, init, forcing, true)
        torch.cuda.synchronize()
        got, msg = counts(), edge.edge_tail.launches_with_messages
        table, want_msg, _ = step_table(m, B)
        want = dict(zero_all, **{k: n * steps for k, n in table.items()})
        per_step = {k: n / steps for k, n in got.items() if n}
        print(f"{what}: {steps}-step rollout, output {tuple(pred.shape)}; "
              f"launches a step {per_step}"
              f", P1 with messages {msg / steps:g} (table "
              f"{({k: n for k, n in table.items() if n})}, {want_msg})")
        if got != want or msg != want_msg * steps:
            fail(f"{what}: launches {got} ({msg} P1 with messages), want "
                 f"{want} ({want_msg * steps})")
        if tuple(pred.shape) != (B, steps, g.num_grid_nodes, 17) or not bool(
                torch.isfinite(pred).all()):
            fail(f"{what}: rollout {tuple(pred.shape)}, not finite")
        return (init, forcing, true), pred

    def step_gap(m, inputs, what):
        init, forcing, _ = inputs
        with torch.no_grad():
            k = m.predict_step(init[:, 1], init[:, 0], forcing[:, 0])[0]
            with plain_kernels():
                p = m.predict_step(init[:, 1], init[:, 0], forcing[:, 0])[0]
        gap = float((k - p).abs().max())
        print(f"{what}: predict step, kernels vs plain versions on the card: "
              f"max abs gap {gap:.3e} (limit 1e-3)")
        if not gap <= 1e-3:
            fail(f"{what}: kernel path and plain path disagree")

    inputs, pred = forecast_counted(net, BATCH, HLP_STEPS,
                                    "HiLAMParallel batch 4")
    step_gap(net, inputs, "HiLAMParallel batch 4")
    with plain_kernels():
        pred_p = entry.forecast(net, *inputs)
    gaps = [float((pred[:, s - 1] - pred_p[:, s - 1]).abs().max())
            for s in (1, 4, HLP_STEPS)]
    print(f"HiLAMParallel batch 4 {HLP_STEPS}-step rollout, kernels vs plain "
          f"versions: max abs gap at steps 1, 4, {HLP_STEPS}: "
          f"{', '.join(f'{x:.3e}' for x in gaps)} (limit "
          f"{HLP_ROLLOUT_LIMIT:g}); largest |output| "
          f"{float(pred.abs().max()):.3f}")
    if not max(gaps) <= HLP_ROLLOUT_LIMIT:
        fail("HiLAMParallel: the kernel path's rollout left the plain "
             "path's")
    del pred, pred_p
    inputs1, _ = forecast_counted(net, 1, 1, "HiLAMParallel batch 1")
    step_gap(net, inputs1, "HiLAMParallel batch 1")
    forecast_counted(hilam, BATCH, 1, "HiLAM (3 levels) batch 4")
    stats = {}
    for m, B, what in ((net, BATCH, "HiLAMParallel batch 4"),
                       (hilam, BATCH, "HiLAM (3 levels) batch 4"),
                       (net, 1, "HiLAMParallel batch 1")):
        stats[what] = hlp_step_stats(torch, entry, m, B, what)
    a, b = stats["HiLAMParallel batch 4"], stats["HiLAM (3 levels) batch 4"]
    print(f"HiLAMParallel against HiLAM, 3 levels, batch 4: host ms a step "
          f"{a['ms'] / b['ms']:.3f}x, updates/s "
          f"{a['updates'] / b['updates']:.3f}x"
          + (f", busy {a['busy'] / b['busy']:.3f}x" if a["busy"] and b["busy"]
             else ""))
    print(f"phase 14a: {time.time() - t_phase:.1f} s")

    # b. P1 with messages at each batched chunk's shape
    gen = torch.Generator(device="cuda").manual_seed(14)

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    with torch.no_grad():
        for B in (BATCH, 1):
            for c, (n, es) in enumerate(zip(names, chunks)):
                if flat_eligible(es, B, H):
                    continue
                K, nv = es.dense_k, es.num_virt
                M = nv * K
                args = ((rand(B, M, H),) + mlp_tail(net.processor[0]
                                                    .edge_mlps[c])
                        + (es.mask, K, True))
                before = edge.edge_tail.launches_with_messages
                got = edge.edge_tail(*args)
                again = edge.edge_tail(*args)
                want = edge.edge_tail_plain(*args)
                torch.cuda.synchronize()
                if edge.edge_tail.launches_with_messages != before + 2:
                    fail(f"P1 with messages at {n}: no launch with messages")
                if not all(torch.equal(x, y) for x, y in zip(got, again)):
                    fail(f"P1 with messages at {n}: two calls differ")
                err = 0.0
                for x, y in zip(got, want):
                    gap = (x - y).abs()
                    if x.shape != y.shape or not bool(
                            (gap <= 1e-4 + 1e-4 * y.abs()).all()):
                        fail(f"P1 with messages at {n}, B={B}: kernel and "
                             f"plain disagree, {float(gap.max()):.3e}")
                    err = max(err, float(gap.max()))
                ms = cuda_ms(torch, lambda: edge.edge_tail(*args), 20)
                plain_ms = cuda_ms(torch, lambda: edge.edge_tail_plain(*args),
                                   5)
                x0, w2 = args[0], args[1]
                lib_ms = cuda_ms(torch, lambda: torch.mm(x0.view(-1, H), w2),
                                 10)
                bytes_ = (nbytes(*(t for t in args if torch.is_tensor(t)))
                          + B * M * H * 4 + B * nv * H * 4)
                flops = 2.0 * B * M * H * H
                t_bytes = bytes_ / peak_bw * 1e3
                t_ops = 3 * flops / peak_tf32 * 1e3
                print(f"edge_tail (P1) with messages at HiLAMParallel {n} "
                      f"(K={K}, {nv} rows, B={B}): max_abs_err {err:.3e} "
                      f"(tol 1e-4 + 1e-4*|plain|), two calls bit-identical; "
                      f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                      f"{lib_ms:.4f} ms (torch.mm for its W2 product, TF32 "
                      f"off), bound {max(t_bytes, t_ops):.4f} ms ("
                      f"{'bytes' if t_bytes >= t_ops else 'operations'}; "
                      f"{bytes_ / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP as "
                      "3xTF32)")
    print(f"phase 14b: {time.time() - t_phase:.1f} s")

    # c. training, fp32 and bf16; the bf16 forecast
    table = step_table(net, BATCH)[0]
    k3 = table["edge_layer_flat"]
    train_want = dict(table, **{k + "_bwd": table[k] for k in FWD},
                      xtd_sum=2 + k3, xtd_reduce=2 + k3)
    entry.train_steps(net, ds, BATCH, 1, steps=1, seed=0,
                      device="cuda")  # warm-up
    reset_counts()
    losses = entry.train_steps(net, ds, BATCH, 1, steps=1, seed=1,
                               device="cuda")
    torch.cuda.synchronize()
    got = counts()
    print(f"HiLAMParallel training step: loss {losses[0]:.6f}; launches "
          f"{({k: n for k, n in got.items() if n})}")
    if not all(map(math.isfinite, losses)) or got != dict(zero_all,
                                                           **train_want):
        fail(f"HiLAMParallel training: loss {losses}, launches {got}, want "
             f"{train_want}")
    trainer, dm = entry.make_trainer(net, ds, BATCH, 1, seed=2)
    batch = next(trainer.train_batches(dm, 0))

    def grads(m):
        m.zero_grad(set_to_none=True)
        m.training_loss(batch).backward()
        return {k: p.grad.detach().clone() for k, p in m.named_parameters()}

    g_k = grads(net)
    with plain_kernels():
        g_p = grads(net)
    worst = max((float((g_k[k] - g_p[k]).abs().max())
                 / max(float(g_p[k].abs().max()), 1e-30), k) for k in g_p)
    print(f"HiLAMParallel training gradients, kernels vs plain versions on "
          f"the card: worst max abs gap / max abs {worst[0]:.3e} "
          f"({worst[1]}; limit 1e-3), {len(g_p)} parameters")
    if not worst[0] <= 1e-3:
        fail("HiLAMParallel: kernel-path and plain-path gradients disagree")
    net16 = copy.copy(net)  # the same weights, the bf16 path
    net16.compute_dtype = torch.bfloat16
    g16 = grads(net16)
    with plain_kernels():
        p16 = grads(net16)
    scale = {k: float(v.abs().max()) or 1.0 for k, v in g_k.items()}

    def vec(gr):
        return torch.cat([(gr[k] / scale[k]).flatten() for k in g_k])

    error_size(torch, "HiLAMParallel bf16 training gradients (each "
               f"parameter's over its fp32 max abs, {len(g_k)} parameters)",
               vec(g16), vec(p16), vec(g_k))
    del g_k, g_p, g16, p16
    net.zero_grad(set_to_none=True)
    trainer16, _ = entry.make_trainer(net16, ds, BATCH, 1, seed=2)
    for tr, tag in ((trainer, "fp32"), (trainer16, "bf16")):
        ms, above, busy = step_stats(torch, tr, batch,
                                     f"HiLAMParallel {tag} train step")
        busy = "not measured" if busy is None else f"{busy:.3f} ms"
        print(f"HiLAMParallel {tag} train step (fwd+bwd+AdamW, ar_steps 1, "
              f"batch {BATCH}): {ms:.3f} ms (host clock, median of 5), "
              f"device busy {busy}"
              f", peak {above / 2**30:.3f} GiB above the live set")
        net.zero_grad(set_to_none=True)
    # the bf16 training step's launches: the bf16 instances, P1 and B2's
    # xtd_sum in fp32
    reset_counts()
    trainer16.train_step(batch)
    torch.cuda.synchronize()
    c16, c32 = counts_bf16(), counts()
    want16 = {k: n for k, n in train_want.items() if k != "edge_tail"}
    want16.update(xtd_sum=1 + k3, xtd_reduce=1 + k3)
    want32 = {"edge_tail": table["edge_tail"], "xtd_sum": 1,
              "xtd_reduce": 1}
    print(f"HiLAMParallel bf16 training step: launches bf16 "
          f"{({k: n for k, n in c16.items() if n})}, fp32 "
          f"{({k: n for k, n in c32.items() if n})}")
    if c16 != {k: want16.get(k, 0) for k in c16} or c32 != dict(
            zero_all, **want32):
        fail(f"HiLAMParallel bf16 training: launches {c16} (bf16), {c32} "
             f"(fp32); want {want16}, {want32}")
    # the bf16 predict step beside its fp32 twin
    init, forcing, true = inputs
    reset_counts()
    with torch.no_grad():
        k16 = net16.predict_step(init[:, 1], init[:, 0], forcing[:, 0])[0]
        torch.cuda.synchronize()
        c16, c32 = counts_bf16(), counts()
        k32 = net.predict_step(init[:, 1], init[:, 0], forcing[:, 0])[0]
        with plain_kernels():
            pp16 = net16.predict_step(init[:, 1], init[:, 0],
                                      forcing[:, 0])[0]
    want16 = {k: n for k, n in table.items() if k != "edge_tail" and n}
    print(f"HiLAMParallel bf16 predict step, batch 4: launches bf16 "
          f"{({k: n for k, n in c16.items() if n})}, fp32 "
          f"{({k: n for k, n in c32.items() if n})}")
    if c16 != {k: want16.get(k, 0) for k in c16} or c32 != dict(
            zero_all, edge_tail=table["edge_tail"]):
        fail(f"HiLAMParallel bf16 predict step: launches {c16} (bf16), {c32}"
             f" (fp32); want {want16}, P1 {table['edge_tail']} fp32")
    error_size(torch, "HiLAMParallel bf16 predict step", k16, pp16, k32)
    hlp_step_stats(torch, entry, net16, BATCH, "HiLAMParallel bf16 batch 4")
    # each bf16 instance at this model's shapes: K3 and B3/B4 (with its
    # xtd_sum) on every flat chunk, P3 on the batched mesh-init set, K2
    # and B2 at g2m, K4 and B5/B6 at m2g (K1's and B1's shapes are
    # GraphLAM's, held in phases 11-12)
    bf = torch.bfloat16
    W = BATCH * H

    def rand16(*shape):
        return rand(*shape).to(bf)

    checked = []
    with torch.no_grad():
        for c, (n, es) in enumerate(zip(names, chunks)):
            if not flat_eligible(es, BATCH, H):
                continue
            nv, K = es.num_virt, es.dense_k
            M, mask_p = nv * K, es.mask.view(nv, K)
            lay = net.processor[0].edge_mlps[c]
            a3 = (rand16(M, W), rand16(es.num_send, W), es.senders,
                  rand16(nv, W), mask_p) + mlp_first(lay) + mlp_tail(lay)
            checked.append(("edge_layer_flat", n, bf16_check(
                torch, counts_bf16, "edge_layer_flat", edge_flat, a3, n)))
            b3 = a3 + (rand16(M, W), rand16(nv, W))
            checked.append(("edge_layer_flat_bwd", n, bf16_bwd_check(
                torch, counts_bf16, "edge_layer_flat_bwd", edge_flat, b3,
                n)))
            pairs = edge_flat.edge_layer_bwd_chain(*b3)[4]
            checked.append(("xtd_sum", n, bf16_bwd_check(
                torch, counts_bf16, "xtd_sum", weight_grad, (pairs,), n)))
        for lv, es in enumerate(g.up):
            if flat_eligible(es, BATCH, H):
                continue
            nv, K = es.num_virt, es.dense_k
            lay = net.mesh_init_gnns[lv].edge_mlp
            a6 = (rand16(BATCH, nv * K, H), rand16(BATCH, es.num_send, H),
                  es.senders, rand16(BATCH, nv, H), es.mask) + mlp_first(
                      lay) + mlp_tail(lay) + (K,)
            checked.append(("edge_layer", f"up[{lv}]", bf16_check(
                torch, counts_bf16, "edge_layer", edge, a6, f"up[{lv}]")))
        es = g.g2m
        nv, K = es.num_virt, es.dense_k
        a2 = (rand16(es.num_send, W), es.senders, rand16(nv * K, H),
              rand16(nv, W), es.mask.view(nv, K)) + mlp_tail(
                  net.g2m_gnn.edge_mlp)
        checked.append(("edge_tail_sum_flat", "g2m", bf16_check(
            torch, counts_bf16, "edge_tail_sum_flat", edge_flat, a2, "g2m")))
        checked.append(("edge_tail_sum_flat_bwd", "g2m", bf16_bwd_check(
            torch, counts_bf16, "edge_tail_sum_flat_bwd", edge_flat,
            a2 + (rand16(nv, W),), "g2m")))
        es = g.m2g
        nv, K = es.num_virt, es.dense_k
        pp = {k: v.detach() for k, v in
              grid_update.pack_grid_update_params(net).items()}
        a4 = (rand16(es.num_send, W), es.senders, rand16(nv * K, H),
              rand16(g.num_grid_nodes, W), es.mask.view(nv, K), pp)
        checked.append(("grid_update_flat", "m2g", bf16_check(
            torch, counts_bf16, "grid_update_flat", grid_update, a4, "m2g")))
        checked.append(("grid_update_flat_bwd", "m2g", bf16_bwd_check(
            torch, counts_bf16, "grid_update_flat_bwd", grid_update,
            a4 + (rand16(nv, BATCH * pp["o_w1"].shape[1]),), "m2g")))
    print("bf16 instances at HiLAMParallel's batch-4 shapes, each within one "
          "bf16 ulp of its plain version, two calls bit-identical (share not "
          "bit-equal, max abs): " + "; ".join(
              f"{k} {n} {s:.5f} {e:.2e}" for k, n, (s, e) in checked))
    del trainer, trainer16, net16, batch, dm
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 14c: {time.time() - t_phase:.1f} s")

    # d. the CLIs on a 268x238 MDP datastore: train 2 steps, then forecast
    with tempfile.TemporaryDirectory(prefix="nlt_hlp_") as tmp:
        root = Path(tmp)
        t0 = time.time()
        cfg = write_mdp_datastore(root, np, n_t=32, n_train=16)
        argv = ["--config_path", str(cfg), "--model", "hi_lam_parallel",
                "--graph", "hierarchical", *WIDTH, "--batch_size",
                str(BATCH), "--ar_steps_train", "2", "--ar_steps_eval", "2",
                "--val_steps_to_log", "1", "2", "--max_steps", "2",
                "--seed", "0", "--save_dir", str(root / "models"),
                "--run_name", "hlp"]
        reset_counts()
        quiet(train.main, argv)
        torch.cuda.synchronize()
        got = {k: n for k, n in counts().items() if n}
        run = root / "models" / "hlp"
        log = [json.loads(line) for line in
               (run / "metrics.jsonl").read_text().splitlines()]
        loss = [r["train_loss"] for r in log if "train_loss" in r]
        print(f"train.main --model hi_lam_parallel: 2 steps at ar_steps 2 "
              f"and validation on the MDP datastore in {time.time() - t0:.1f}"
              f" s (datastore written included); losses {loss}; launches "
              f"{got}")
        if not (run / "last").exists() or not loss or not all(
                map(math.isfinite, loss)) or not all(
                    got.get(k) for k in FWD + ("edge_layer_flat_bwd",
                                               "edge_tail")):
            fail("train.main --model hi_lam_parallel: no checkpoint, a loss "
                 "that is not finite, or a kernel of the path not launched")
        out = root / "hlp.zarr"
        pargv = ["--config_path", str(cfg), "--model", "hi_lam_parallel",
                 "--graph", "hierarchical", *WIDTH, "--load",
                 str(run / "last"), "--split", "test", "--sample_idx", "-1",
                 "--ar_steps", str(STEPS), "--out", str(out)]
        # the launch table of the CLI's model (its graph is the CLI's own)
        cli_net = predict.prepare(predict.parse_args(pargv))[0]
        want, msg, _ = step_table(cli_net, 1)
        print(f"the predict CLI's HiLAMParallel: levels "
              f"{cli_net.graph.level_sizes}, {len(cli_net._chunk_edge_sets())}"
              f" chunks; at batch 1 {msg} P1 launches with messages a step")
        del cli_net
        forecast_check(torch, np, pargv, {k: n for k, n in want.items() if n},
                       counts, reset_counts, plain_kernels, zero_all,
                       "hi_lam_parallel")
    print(f"phase 14d: {time.time() - t_phase:.1f} s")


# phase 15: the latent models GraphEFM and HiEFM at benchmarks.py's
# graph_efm_meps_ar4 and prob_model_global_0p7deg, their ensembles, their
# training and the CLIs on a global datastore
EFM_STEPS = 4  # both configurations' rollout length (benchmarks.py)
EFM_MEMBERS = 5  # 15b's members: B x 5 rows picks the routes
EFM_CRPS_MEMBERS = 4  # 15c's --loss crps_ens step
EFM_CLI_MEMBERS = 3  # 15d
# entry.build_model keywords of each configuration (benchmarks.py's
# run_config and run_global_config: 268x238 MEPS-shaped grid, multiscale;
# 512x256 global grid, icosahedral mesh at 5 refinements, 3 levels)
EFM_CONFIGS = {
    "graph_efm_meps_ar4": dict(BENCH, model="graph_efm"),
    "prob_model_global_0p7deg": dict(BENCH, nx=512, ny=256, model="hi_efm",
                                     global_grid=True, refinements=5,
                                     n_max_levels=3),
}
EFM_CLI_GRID = (64, 32)  # 15d's global datastore, lon x lat
# kernel path against plain path (PERF.md, set before the first run on
# the card): the 4-step rollouts and the members; the scores (relative to
# their largest magnitude); the share of rank-histogram counts that move
EFM_ROLLOUT_LIMIT = 1e-3
EFM_SCORE_LIMIT = 1e-3
EFM_RANK_LIMIT = 1e-3


@contextlib.contextmanager
def counted_folds():
    """Counts the virtual-row fold's row gathers (`_rec_fold`'s
    index_selects) while it is open, into the yielded one-item list."""
    from neural_lam_tpu_torch.ops import message_passing

    orig, n = message_passing._rec_fold, [0]

    def counted(virt, rec_slots, rec_mask):
        n[0] += rec_slots.shape[1]
        return orig(virt, rec_slots, rec_mask)

    message_passing._rec_fold = counted
    try:
        yield n
    finally:
        message_passing._rec_fold = orig


def efm_scores(torch, net, ens, batch):
    """ensemble.score_ensemble's averaged scores of the members `ens`."""
    from neural_lam_tpu_torch import ensemble

    with torch.no_grad():
        return ensemble.score_ensemble(ens, batch[1], net.interior_mask_bool())


def score_gaps(torch, np, k, p, what):
    """Kernel-path scores `k` against plain-path scores `p`: each score's
    max abs gap over its largest magnitude (limit EFM_SCORE_LIMIT), and
    the share of rank-histogram counts that moved (EFM_RANK_LIMIT)."""
    rel = {}
    for name in ("crps", "spread", "ens_rmse", "ssr"):
        a, b = (np.asarray(x.cpu() if torch.is_tensor(x) else x, np.float64)
                for x in (k[name], p[name]))
        rel[name] = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
    rk, rp = k["rank_hist"].double(), p["rank_hist"].double()
    moved = float((rk - rp).abs().sum() / (2 * rp.sum()))
    print(f"{what}: kernels vs plain, scores' max gap / max "
          + ", ".join(f"{n} {v:.2e}" for n, v in rel.items())
          + f" (limit {EFM_SCORE_LIMIT:g}); rank histogram {moved:.2e} of "
          f"the counts moved (limit {EFM_RANK_LIMIT:g}); crps "
          f"{np.round(np.asarray(p['crps'].cpu()), 5).tolist()}, ssr "
          f"{np.round(np.asarray(p['ssr']), 5).tolist()}")
    if max(rel.values()) > EFM_SCORE_LIMIT or moved > EFM_RANK_LIMIT:
        fail(f"{what}: the kernel path's ensemble scores left the plain "
             "path's")


def efm_forecast(torch, entry, net, B, what, counts, reset_counts,
                 plain_kernels, zero_all):
    """15a for one model at batch B: a counted EFM_STEPS-step prior-mean
    rollout (launches and fold gathers against `step_table`), one step
    and the rollout against the plain path, then `hlp_step_stats`."""
    init, forcing, true = entry.make_inputs(net, B, EFM_STEPS, seed=0)
    entry.forecast(net, init, forcing[:, :1], true[:, :1])  # warm-up
    with counted_folds() as gathers:
        reset_counts()
        pred = entry.forecast(net, init, forcing, true)
        torch.cuda.synchronize()
    got = counts()
    table, _, want_g = step_table(net, B)
    want = dict(zero_all, **{k: n * EFM_STEPS for k, n in table.items()})
    print(f"{what}: {EFM_STEPS}-step prior-mean rollout, output "
          f"{tuple(pred.shape)}; launches a step "
          f"{ {k: n / EFM_STEPS for k, n in got.items() if n} }, fold "
          f"gathers a step {gathers[0] / EFM_STEPS:g} (table "
          f"{ {k: n for k, n in table.items() if n} }, {want_g})")
    if got != want or gathers[0] != want_g * EFM_STEPS:
        fail(f"{what}: launches {got}, fold gathers {gathers[0]}; want "
             f"{want}, {want_g * EFM_STEPS}")
    if tuple(pred.shape) != (B, EFM_STEPS, net.num_grid_nodes, 17) or not \
            bool(torch.isfinite(pred).all()):
        fail(f"{what}: rollout {tuple(pred.shape)}, not finite")
    with torch.no_grad():
        k = net.predict_step(init[:, 1], init[:, 0], forcing[:, 0])[0]
        with plain_kernels():
            p = net.predict_step(init[:, 1], init[:, 0], forcing[:, 0])[0]
            pred_p = entry.forecast(net, init, forcing, true)
    gaps = [float((pred[:, s] - pred_p[:, s]).abs().max())
            for s in range(EFM_STEPS)]
    print(f"{what}: kernels vs plain versions on the card: predict step "
          f"{float((k - p).abs().max()):.3e} (limit 1e-3), rollout steps "
          f"1-{EFM_STEPS} {', '.join(f'{x:.3e}' for x in gaps)} (limit "
          f"{EFM_ROLLOUT_LIMIT:g}); largest |output| "
          f"{float(pred.abs().max()):.3f}")
    if not (float((k - p).abs().max()) <= 1e-3
            and max(gaps) <= EFM_ROLLOUT_LIMIT):
        fail(f"{what}: kernel path and plain path disagree")
    del pred, pred_p, k, p
    return hlp_step_stats(torch, entry, net, B, what, steps=EFM_STEPS)


def efm_members(torch, np, entry, net, what, counts, reset_counts,
                plain_kernels):
    """15b for one model: `entry.sample_ensemble`, EFM_MEMBERS members
    over 2 steps, at batch 1 (B x h = 320: the batched route) and batch
    4 (the flat route), the same draws on the kernel and the plain path
    (generators of one seed); members and scores against the plain
    path's."""
    from neural_lam_tpu_torch.ops.message_passing import flat_eligible

    m = EFM_MEMBERS
    for B in (1, BATCH):
        init, forcing, true = entry.make_inputs(net, B, 2, seed=1)

        def members():
            return entry.sample_ensemble(net, init, forcing, true, m,
                                         seed=15)

        flat = flat_eligible(net.graph.m2m[0], B * m, H)
        if flat != (B == BATCH):
            fail(f"{what}: m2m[0] at {B} x {m} rows: flat {flat}")
        t0 = time.perf_counter()
        reset_counts()
        ens = members()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        got = {k: n for k, n in counts().items() if n}
        with plain_kernels():
            ens_p = members()
        gap = float((ens - ens_p).abs().max())
        spread = float(ens.std(dim=1).mean())
        print(f"{what}: sample_rollout, batch {B} x {m} members ("
              f"{'flat' if flat else 'batched'} route), 2 steps in "
              f"{sec:.2f} s, launches {got}; members kernels vs plain "
              f"{gap:.3e} (limit {EFM_ROLLOUT_LIMIT:g}); mean member "
              f"spread {spread:.4f}")
        if tuple(ens.shape) != (B, m, 2, net.num_grid_nodes, 17) or not (
                gap <= EFM_ROLLOUT_LIMIT and spread > 0):
            fail(f"{what}: members {tuple(ens.shape)} disagree with the "
                 "plain path's, or do not spread")
        batch = (init, true, forcing, None)
        score_gaps(torch, np, efm_scores(torch, net, ens, batch),
                   efm_scores(torch, net, ens_p, batch),
                   f"{what} batch {B}")
        del ens, ens_p


def efm_training(torch, entry, net, ds, what, counts, counts_bf16,
                 reset_counts, plain_kernels, zero_all):
    """15c for one model: an ELBO AdamW step at batch 4 (ar_steps 1) with
    the counters at 0 (the forward's launches with the posterior's rounds,
    a backward kernel for each flat one, xtd_sum for the decoder, each B2
    and each B3/B4); fp32 gradients kernels vs plain (the same draws,
    1e-3 x max abs per parameter), the bf16 gradients' error by size
    (`error_size`); fp32 and bf16 step host ms, busy ms and peak memory;
    then one --loss crps_ens AdamW step with EFM_CRPS_MEMBERS members
    (its launches against the prior's table at B x m rows) and its
    gradients kernels vs plain (the same draws, 1e-3 x max abs), also
    under one cotangent on the members."""
    import copy

    from neural_lam_tpu_torch import ensemble

    table = step_table(net, BATCH, posterior=True)[0]
    n23 = table["edge_tail_sum_flat"] + table["edge_layer_flat"]
    want = dict(zero_all, **table,
                **{k + "_bwd": table[k] for k in FWD},
                xtd_sum=table["grid_update_flat"] + n23,
                xtd_reduce=table["grid_update_flat"] + n23)
    trainer, dm = entry.make_trainer(net, ds, BATCH, 1, seed=2)
    batch = next(trainer.train_batches(dm, 0))
    trainer.train_step(batch)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    loss = float(trainer.train_step(batch))
    torch.cuda.synchronize()
    got = counts()
    print(f"{what} ELBO training step: loss {loss:.6f}; launches "
          f"{ {k: n for k, n in got.items() if n} }")
    if not math.isfinite(loss) or got != want:
        fail(f"{what} ELBO training: loss {loss}, launches {got}, want "
             f"{want}")

    def grads(m):
        m.zero_grad(set_to_none=True)
        m.training_loss(batch, generator=ensemble.step_generator(
            0, 0, "cuda")).backward()
        return {k: (p.grad.detach().clone() if p.grad is not None
                    else torch.zeros_like(p))
                for k, p in m.named_parameters()}

    g_k = grads(net)
    with plain_kernels():
        g_p = grads(net)
    worst = max((float((g_k[k] - g_p[k]).abs().max())
                 / max(float(g_p[k].abs().max()), 1e-30), k) for k in g_p)
    print(f"{what} ELBO gradients, kernels vs plain versions on the card: "
          f"worst max abs gap / max abs {worst[0]:.3e} ({worst[1]}; limit "
          f"1e-3), {len(g_p)} parameters")
    if not worst[0] <= 1e-3:
        fail(f"{what}: kernel-path and plain-path gradients disagree")
    net16 = copy.copy(net)  # the same weights, the bf16 path
    net16.compute_dtype = torch.bfloat16
    g16 = grads(net16)
    with plain_kernels():
        p16 = grads(net16)
    scale = {k: float(v.abs().max()) or 1.0 for k, v in g_k.items()}

    def vec(gr):
        return torch.cat([(gr[k] / scale[k]).flatten() for k in g_k])

    error_size(torch, f"{what} bf16 ELBO gradients (each parameter's over "
               f"its fp32 max abs, {len(g_k)} parameters)", vec(g16),
               vec(p16), vec(g_k))
    del g_k, g_p, g16, p16
    net.zero_grad(set_to_none=True)
    trainer16, _ = entry.make_trainer(net16, ds, BATCH, 1, seed=2)
    for tr, tag in ((trainer, "fp32"), (trainer16, "bf16")):
        ms, above, busy = step_stats(torch, tr, batch,
                                     f"{what} {tag} ELBO train step")
        busy = "not measured" if busy is None else f"{busy:.3f} ms"
        print(f"{what} {tag} ELBO train step (fwd+bwd+AdamW, ar_steps 1, "
              f"batch {BATCH}): {ms:.3f} ms (host clock, median of 5), "
              f"device busy {busy}, peak {above / 2**30:.3f} GiB above the "
              "live set")
        net.zero_grad(set_to_none=True)
    del trainer16, net16
    net.crps_train, net.crps_members = True, EFM_CRPS_MEMBERS
    # the members fold into the batch: the prior's rounds at B x m rows
    table = step_table(net, BATCH * EFM_CRPS_MEMBERS)[0]
    n23 = table["edge_tail_sum_flat"] + table["edge_layer_flat"]
    want = dict(zero_all, **table,
                **{k + "_bwd": table[k] for k in FWD},
                xtd_sum=table["grid_update_flat"] + n23,
                xtd_reduce=table["grid_update_flat"] + n23)
    try:
        reset_counts()
        t0 = time.perf_counter()
        loss = float(trainer.train_step(batch))
        torch.cuda.synchronize()
        got = counts()
        print(f"{what} --loss crps_ens AdamW step ({EFM_CRPS_MEMBERS} "
              f"members, batch {BATCH}): loss {loss:.6f} in "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms; launches "
              f"{ {k: n for k, n in got.items() if n} }")
        if not math.isfinite(loss) or got != want:
            fail(f"{what} crps_ens step: loss {loss}, launches {got}, want "
                 f"{want}")
        # the backward kernels at B x m = 16 batch columns (W = 1024)
        g_k = grads(net)
        with plain_kernels():
            g_p = grads(net)
        worst = max((float((g_k[k] - g_p[k]).abs().max())
                     / max(float(g_p[k].abs().max()), 1e-30), k)
                    for k in g_p)
        print(f"{what} --loss crps_ens gradients ({EFM_CRPS_MEMBERS} "
              f"members, batch {BATCH}), kernels vs plain versions on the "
              f"card: worst max abs gap / max abs {worst[0]:.3e} "
              f"({worst[1]}; limit 1e-3), {len(g_p)} parameters")
        if not worst[0] <= 1e-3:
            fail(f"{what}: kernel-path and plain-path crps_ens gradients "
                 "disagree")
        del g_k, g_p

        # the loss's sort and |.| turn where two members (or a member and
        # the target) are nearly equal: its cotangent on the members may
        # differ between the paths at such points. The same cotangent
        # through both paths holds the kernels alone at W = 1024.
        def member_grads(m, cot=None):
            m.zero_grad(set_to_none=True)
            ens = ensemble.sample_rollout(
                m, batch[0], batch[2], batch[1],
                ensemble.step_generator(0, 0, "cuda"), EFM_CRPS_MEMBERS)
            own = torch.autograd.grad(
                torch.mean(ensemble.crps_ensemble(
                    ens, batch[1], mask=m.interior_mask_bool())),
                ens, retain_graph=True)[0]
            ens.backward(own if cot is None else cot)
            return own, {k: (p.grad.detach().clone() if p.grad is not None
                             else torch.zeros_like(p))
                         for k, p in m.named_parameters()}

        with plain_kernels():
            cot_p, g_p = member_grads(net)
        cot_k, g_k = member_grads(net, cot_p)
        turned = float((cot_k != cot_p).float().mean())
        worst = max((float((g_k[k] - g_p[k]).abs().max())
                     / max(float(g_p[k].abs().max()), 1e-30), k)
                    for k in g_p)
        print(f"{what} --loss crps_ens, the plain path's cotangent on the "
              f"members through both paths: worst max abs gap / max abs "
              f"{worst[0]:.3e} ({worst[1]}; limit 1e-3); the two paths' own "
              f"cotangents differ at {turned:.3e} of the "
              f"{cot_p.numel()} member entries")
        if not worst[0] <= 1e-3:
            fail(f"{what}: kernel-path and plain-path crps_ens gradients "
                 "disagree under the same cotangent")
        del g_k, g_p, cot_k, cot_p
    finally:
        net.crps_train, net.crps_members = False, 4
    net.zero_grad(set_to_none=True)
    del trainer, batch, dm
    gc.collect()
    torch.cuda.empty_cache()


def efm_cli_phase(torch, np, root, counts, reset_counts, plain_kernels):
    """15d: the CLIs on a small global datastore whose graph the train CLI
    builds (hierarchical: 2 icosahedral levels), each run again on the
    plain path with the same seed: `train.main --model hi_efm` 2 steps,
    `--eval test --ensemble_members` and `predict.main
    --ensemble_members` (a `member` dim in the output)."""
    from neural_lam_tpu_torch import predict, train
    from neural_lam_tpu_torch.config import load_config_and_datastore
    from neural_lam_tpu_torch.datastore.zarr_reader import ZarrGroup

    n_lon, n_lat = EFM_CLI_GRID
    (root / "g.yaml").write_text(json.dumps(dict(
        n_lon=n_lon, n_lat=n_lat, n_timesteps=40, root="dsroot")))
    cfg = root / "config.yaml"
    cfg.write_text(json.dumps({"datastore": {
        "kind": "dummydata_global", "config_path": "g.yaml"}}))
    common = ["--config_path", str(cfg), "--model", "hi_efm", "--graph",
              "hierarchical", *WIDTH]
    runs = root / "models"

    def run(fn, argv, plain):
        reset_counts()
        if plain:
            with plain_kernels():
                out = quiet(fn, argv)
        else:
            out = quiet(fn, argv)
        torch.cuda.synchronize()
        return out, {k: n for k, n in counts().items() if n}

    t0 = time.time()
    losses = {}
    for plain in (False, True):
        name = "efm_plain" if plain else "efm"
        _, got = run(train.main, common + [
            "--batch_size", str(BATCH), "--ar_steps_train", "1",
            "--ar_steps_eval", "2", "--val_steps_to_log", "1", "2",
            "--max_steps", "2", "--seed", "0", "--save_dir", str(runs),
            "--run_name", name], plain)
        log = [json.loads(line) for line in
               (runs / name / "metrics.jsonl").read_text().splitlines()]
        losses[plain] = [r[k] for r in log for k in ("train_loss",
                                                     "val_mean_loss")
                         if k in r]
        if not plain:
            print(f"train.main --model hi_efm ({n_lon}x{n_lat} global, graph"
                  f" built by the CLI): 2 ELBO steps and validation in "
                  f"{time.time() - t0:.1f} s; launches {got}")
            if not (runs / name / "last").exists() or not all(
                    got.get(k) for k in FWD + ("edge_tail_sum_flat_bwd",)):
                fail("train.main --model hi_efm: no checkpoint, or a kernel "
                     "of the path not launched")
    a, b = np.asarray(losses[False]), np.asarray(losses[True])
    rel = float(np.abs(a - b).max() / np.abs(b).max())
    print(f"train.main --model hi_efm: losses {a.tolist()}, plain path "
          f"{b.tolist()}: max gap {rel:.2e} relative (limit 1e-3)")
    if a.shape != b.shape or not np.isfinite(a).all() or rel > 1e-3:
        fail("train.main --model hi_efm: the kernel path's losses left the "
             "plain path's")
    last = str(runs / "efm" / "last")
    res = {}
    for plain in (False, True):
        out, got = run(train.main, common + [
            "--batch_size", str(BATCH), "--ar_steps_eval", "2",
            "--val_steps_to_log", "1", "2", "--eval", "test",
            "--ensemble_members", str(EFM_CLI_MEMBERS), "--n_example_pred",
            "0", "--load", last, "--save_dir", str(runs), "--run_name",
            "eval_plain" if plain else "eval"], plain)
        res[plain] = out["ensemble"]
        if not plain:
            print(f"train.main --eval test --ensemble_members "
                  f"{EFM_CLI_MEMBERS}: launches {got}; scores {out['ensemble']}")
    rank = {p: np.load(runs / ("eval_plain" if p else "eval")
                       / "ens_rank_hist.npy") for p in (False, True)}
    rel = {k: float(np.abs(np.asarray(res[False][k]) - res[True][k]).max()
                    / max(np.abs(np.asarray(res[True][k])).max(), 1e-30))
           for k in ("crps", "spread", "ens_rmse", "ssr")}
    moved = float(np.abs(rank[False] - rank[True]).sum() / 2
                  / rank[True].sum())
    print(f"--eval test --ensemble_members {EFM_CLI_MEMBERS}, kernels vs "
          f"plain: {rel} (limit {EFM_SCORE_LIMIT:g}); ens_rank_hist.npy "
          f"{rank[False].shape}, {moved:.2e} of the frequency moved (limit "
          f"{EFM_RANK_LIMIT:g})")
    if max(rel.values()) > EFM_SCORE_LIMIT or moved > EFM_RANK_LIMIT:
        fail("--eval test --ensemble_members: the kernel path's scores left "
             "the plain path's")
    outs = {}
    for plain in (False, True):
        out = root / ("efm_plain.zarr" if plain else "efm.zarr")
        summary, got = run(predict.main, common + [
            "--load", last, "--ar_steps", "2", "--ensemble_members",
            str(EFM_CLI_MEMBERS), "--seed", "0", "--out", str(out)], plain)
        outs[plain] = ZarrGroup(out)["state"]
        if not plain:
            print(f"predict.main --ensemble_members {EFM_CLI_MEMBERS}: "
                  f"dims {summary['dims']}, shape {summary['shape']}, "
                  f"launches a step {({k: n / 2 for k, n in got.items()})}")
    std = np.asarray(load_config_and_datastore(cfg)[1]
                     .get_standardization_dataarray("state")["state_std"])
    a, b = outs[False].read_full(), outs[True].read_full()
    gap = float(np.abs((a - b) / std).max())
    print(f"predict.main --ensemble_members: members {a.shape}, dims "
          f"{outs[False].dims}, standardized within {gap:.3e} of the plain "
          "path (limit 1e-3)")
    if outs[False].dims[0] != "member" or a.shape[0] != EFM_CLI_MEMBERS \
            or not np.isfinite(a).all() or gap > 1e-3:
        fail("predict.main --ensemble_members: no member dim, or the "
             "members left the plain path's")


def latent_phase(torch, np, counts, counts_bf16, reset_counts,
                 plain_kernels, zero_all):
    """Phase 15: GraphEFM and HiEFM (module doc)."""
    import tempfile
    from pathlib import Path

    from neural_lam_tpu_torch import entry

    t_phase = time.time()
    for name, kw in EFM_CONFIGS.items():
        t0 = time.time()
        net, ds = entry.build_model(**kw, device="cuda")
        g = net.graph
        print(f"{name}: {kw['model']} built in {time.time() - t0:.1f} s: "
              f"{g.num_grid_nodes} grid points, levels {g.level_sizes} "
              f"(N_mesh={net.num_mesh_nodes}), latent {net.latent_dim} on "
              f"{net.latent_num_nodes} nodes; g2m K={g.g2m.dense_k}, "
              f"{g.g2m.num_virt} rows, fold R="
              f"{0 if g.g2m.rec_slots is None else g.g2m.rec_slots.shape[1]};"
              f" m2g K={g.m2g.dense_k}, identity {g.m2g.virt_identity}")
        efm_forecast(torch, entry, net, BATCH, f"{name} batch 4", counts,
                     reset_counts, plain_kernels, zero_all)
        print(f"phase 15a ({name}): {time.time() - t_phase:.1f} s")
        efm_members(torch, np, entry, net, name, counts, reset_counts,
                    plain_kernels)
        print(f"phase 15b ({name}): {time.time() - t_phase:.1f} s")
        efm_training(torch, entry, net, ds, name, counts, counts_bf16,
                     reset_counts, plain_kernels, zero_all)
        print(f"phase 15c ({name}): {time.time() - t_phase:.1f} s")
        del net, ds, g
        gc.collect()
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="nlt_efm_") as tmp:
        efm_cli_phase(torch, np, Path(tmp), counts, reset_counts,
                      plain_kernels)
    print(f"phase 15d: {time.time() - t_phase:.1f} s")


def disk_mb(path):
    """MB of the files under path."""
    return sum(f.stat().st_size for f in path.rglob("*")
               if f.is_file()) / 1e6


# phase 16: data parallelism and the grid scheme, 2 ranks on the one card
PAR_RANKS = 2
PAR_TIMEOUT_S = 300  # each rank process's own limit
PAR_STEPS = 3  # 16a's AdamW steps
PAR_PARAM_LIMIT = 2e-3  # 16a: parameters after PAR_STEPS steps, relative
PAR_LOSS_LIMIT = 1e-5  # 16a: losses, relative
# 16a: the first step's gradients, reduced over the ranks, against the
# single process's: max abs gap <= this x max abs + 1e-6, per parameter
# (AdamW's update hides a gradient scaled by a constant)
PAR_GRAD_LIMIT = 1e-4
PAR_STEP_LIMIT = 1e-5  # 16b-c: predict step and rollout, x state_std
# 16b (full depth) and 16c (processor layers cut to 1); HiLAMParallel at
# phase 14's levels, HiEFM at phase 15's global configuration
PAR_CASES = {
    "GraphLAM": dict(model="graph_lam"),
    "HiLAM": dict(model="hi_lam", processor_layers=1),
    "HiLAMParallel": dict(model="hi_lam_parallel", processor_layers=1,
                          n_max_levels=HLP_LEVELS),
    "GraphEFM": dict(model="graph_efm", processor_layers=1),
    "HiEFM global": dict(EFM_CONFIGS["prob_model_global_0p7deg"],
                         processor_layers=1),
    "GraphLAM bf16": dict(model="graph_lam", processor_layers=1,
                          compute_dtype="bfloat16"),
}


# phase 17: the mesh-node-sharded schemes, 2 ranks on the one card, on
# PAR_CASES' models and limits
RS_SCHEMES = ("mesh_rs", "mesh_halo")
RS_CLI_STEPS = 2  # 17c's AdamW steps through train.main


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def write_dummy_config(root):
    """A dummydata datastore at the bench grid and feature counts, 30 time
    steps (a train split of 16: 14 samples), under <root>/dsroot; returns
    the config's path."""
    root.mkdir(parents=True, exist_ok=True)
    (root / "dummy.yaml").write_text(json.dumps({
        "grid_shape": [BENCH["nx"], BENCH["ny"]],
        "n_features": BENCH["n_features"], "n_timesteps": 30,
        "root": "dsroot"}))
    cfg = root / "config.yaml"
    cfg.write_text(json.dumps({"datastore": {
        "kind": "dummydata", "config_path": "dummy.yaml"}}))
    return cfg


def par_argv(cfg, root):
    """16a's train.main arguments, without the batch size and the run."""
    return ["--config_path", str(cfg), "--model", "graph_lam", "--graph",
            "multiscale", *WIDTH, "--ar_steps_train", "1",
            "--ar_steps_eval", "1", "--epochs", "1",
            "--max_steps", str(PAR_STEPS), "--val_interval", "0", "--seed",
            "0", "--num_workers", "0", "--prefetch_batches", "0",
            "--save_dir", str(root / "models")]


@contextlib.contextmanager
def training_recorder(torch, counts, reset_counts, params_out,
                      grads_out=None):
    """Within it, each `Trainer.train_step` records its loss and host ms,
    the first one its gradients (after their reduction over the ranks) to
    `grads_out` (.npz) when given, the second one its launches (every
    counter at 0 just before it), and `Trainer.fit` writes the parameters
    it ends with to `params_out` (.npz) on rank 0. Yields the record."""
    import numpy as np

    from neural_lam_tpu_torch import train

    rec = {"losses": [], "ms": [], "launches": None}
    real_step, real_fit = train.Trainer.train_step, train.Trainer.fit

    def step(self, batch):
        if len(rec["losses"]) == 1:
            reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = real_step(self, batch)
        rec["losses"].append(float(loss))
        rec["ms"].append((time.perf_counter() - t0) * 1e3)
        if len(rec["losses"]) == 1 and grads_out is not None:
            np.savez(grads_out, **{
                k: p.grad.detach().cpu().numpy()
                for k, p in self.model.named_parameters()
                if p.grad is not None})
        if len(rec["losses"]) == 2:
            rec["launches"] = counts()
        return loss

    def fit(self, datamodule):
        out = real_fit(self, datamodule)
        if self.rank == 0:
            np.savez(params_out, **{k: v.detach().cpu().numpy() for k, v in
                                    self.model.state_dict().items()})
        return out

    train.Trainer.train_step, train.Trainer.fit = step, fit
    try:
        yield rec
    finally:
        train.Trainer.train_step, train.Trainer.fit = real_step, real_fit


def train_table(fwd):
    """The launches of a training step (ar_steps 1) from its forward's:
    a backward kernel for each flat forward launch (B1-B6; P1-P3's
    backward recomputes through the plain versions), and xtd_sum with its
    reduce kernel for the decoder, each B2 and each B3/B4."""
    want = dict(fwd, **{k + "_bwd": fwd[k] for k in FWD})
    n = fwd["grid_update_flat"] + fwd["edge_tail_sum_flat"] \
        + fwd["edge_layer_flat"]
    return dict(want, xtd_sum=n, xtd_reduce=n)


def grid_case(torch, entry, mesh, what, case, counts, counts_bf16,
              reset_counts, schemes=("grid",), timed=True):
    """16b/16c (and, with `schemes`, 17a/17b) on this rank: the model of
    `case` unsharded, then sharded over `mesh`'s space group under each of
    `schemes` (`spatialize_scheme`), on the same inputs and weights.
    Returns {scheme: a JSON-able record of the gaps, the launches against
    the per-rank tables, the collectives (against their table, for the
    mesh-node schemes) and, when `timed`, the timings}."""
    from neural_lam_tpu_torch.ensemble import step_generator
    from neural_lam_tpu_torch.parallel import collectives
    from neural_lam_tpu_torch.parallel.grid_sharded import spatialize_scheme

    t0 = time.time()
    cfg = dict(BENCH, **case)
    net, _ = entry.build_model(**cfg, device="cuda")
    init, forcing, true = entry.make_inputs(net, BATCH, 2, seed=0)
    batch = (init, true[:, :1], forcing[:, :1],
             torch.zeros((BATCH, 1), dtype=torch.long, device="cuda"))
    latent = bool(getattr(net, "is_latent", False))
    bf16 = case.get("compute_dtype") == "bfloat16"

    def step(m):
        with torch.no_grad():
            return m.predict_step(init[:, 1], init[:, 0],
                                  forcing[:, 0])[0].float()

    def rollout(m):
        with torch.no_grad():
            return entry.forecast(m, init, forcing, true).float()

    def grads(m, sharded):
        owner = net if sharded else m  # the sharded copy shares net's
        owner.zero_grad(set_to_none=True)
        gen = step_generator(0, 0, "cuda") if latent else None
        loss = m.training_loss(batch, generator=gen)
        loss.backward()
        if sharded:
            collectives.reduce_gradients(net.parameters(), mesh.world_group,
                                         mesh.n_data)
        return float(loss), {k: p.grad.detach().clone()
                             for k, p in owner.named_parameters()
                             if p.grad is not None}

    def total():
        c = counts()
        for k, v in counts_bf16().items():
            c[k] += v
        return c

    ref_step, ref_roll = step(net), rollout(net)
    ref_loss, ref_grads = grads(net, False)
    if bf16:
        fp32, _ = entry.build_model(**dict(cfg, compute_dtype=None),
                                    device="cuda")
        step32 = step(fp32)
        _, g32 = grads(fp32, False)
        del fp32
    build_s = time.time() - t0
    recs = {}
    for scheme in schemes:
        t_scheme = time.time()
        sp = spatialize_scheme(net, mesh, scheme)
        rec = {"build_s": build_s, "shard_s": time.time() - t_scheme}
        step(sp)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        collectives.reset_counts()
        got_step = step(sp)
        torch.cuda.synchronize()
        rec["step_launches"] = total()
        rec["step_collectives"] = dict(collectives.counts)
        got_roll = rollout(sp)
        reset_counts()
        collectives.reset_counts()
        got_loss, got_grads = grads(sp, True)
        torch.cuda.synchronize()
        rec["train_launches"] = total()
        rec["train_collectives"] = dict(collectives.counts)
        twin = sp._twin
        fwd, _, _ = step_table(twin, BATCH)
        fwd_post, _, _ = step_table(twin, BATCH, posterior=latent)
        zero_all = {k: 0 for k in rec["train_launches"]}
        rec["step_want"] = dict(zero_all, **fwd)
        rec["train_want"] = dict(zero_all, **train_table(fwd_post))
        if scheme != "grid":
            rec["step_coll_want"] = collective_table(twin, sp.spatial,
                                                     BATCH, train=False)
            rec["train_coll_want"] = collective_table(twin, sp.spatial,
                                                      BATCH, train=True)
        rec["routes"] = {
            nm: ("flat" if flat_eligible_of(es) else "batched")
            + (" split" if es.frontier is not None else "")
            for nm, es in (("g2m", twin.graph.g2m), ("m2g", twin.graph.m2g),
                           *[(f"m2m[{i}]", es) for i, es in
                             enumerate(twin.graph.m2m)],
                           *[(f"up[{i}]", es) for i, es in
                             enumerate(twin.graph.up)],
                           *[(f"down[{i}]", es) for i, es in
                             enumerate(twin.graph.down)])}
        rec["loss"], rec["ref_loss"] = got_loss, ref_loss
        if bf16:
            e_k, e_r = (got_step - step32).abs(), (ref_step - step32).abs()
            rec["bf16_mean_ratio"] = float(e_k.mean() / e_r.mean())
            rec["bf16_max_ratio"] = float(e_k.max() / e_r.max())
            keys = sorted(g32)
            v32 = torch.cat([g32[k].flatten() for k in keys])
            vk = torch.cat([got_grads[k].flatten() for k in keys])
            vr = torch.cat([ref_grads[k].flatten() for k in keys])
            rec["bf16_grad_mean_ratio"] = float((vk - v32).abs().mean()
                                                / (vr - v32).abs().mean())
            rec["bf16_grad_max_ratio"] = float((vk - v32).abs().max()
                                               / (vr - v32).abs().max())
        else:
            rec["step_gap"] = float((got_step - ref_step).abs().max())
            rec["rollout_gap"] = float((got_roll - ref_roll).abs().max())
            rec["grad_excess"] = max(
                (float((got_grads[k] - g).abs().max()
                       - (1e-4 + 1e-4 * g.abs().max())), k)
                for k, g in ref_grads.items())
            rec["grad_rel"] = max(
                (float((got_grads[k] - g).abs().max()
                       / g.abs().max().clamp_min(1e-30)), k)
                for k, g in ref_grads.items())
            rec["grad_keys"] = [len(got_grads), len(ref_grads)]
        del got_grads
        if timed:
            # timings on this rank: host ms (median of 3) and device busy
            # ms (a profile of 2) of the sharded predict and training
            # steps, and the unsharded steps' host ms beside them
            for name, fn in (("step", lambda: step(sp)),
                             ("train", lambda: grads(sp, True)),
                             ("step_unsharded", lambda: step(net)),
                             ("train_unsharded", lambda: grads(net, False))):
                times = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t1) * 1e3)
                rec[f"{name}_ms"] = sorted(times)[1]
            for name, fn in (("step", lambda: step(sp)),
                             ("train", lambda: grads(sp, True))):
                prof = profile(torch, fn, f"{what} {scheme} {name} (rank "
                               f"{mesh.space_index})", steps=2, top=0,
                               cpu=False)
                rec[f"{name}_busy_ms"] = prof[0] if prof else None
        rec["seconds"] = time.time() - t_scheme + build_s
        recs[scheme] = rec
        del sp, twin
    del net
    torch.cuda.empty_cache()
    return recs


def collective_table(twin, part, B, train):
    """The collectives by kind of one predict step of a rank's twin under
    a mesh-node-sharded scheme (`part`: its RSShard), from its sets; with
    `train`, of a training step at ar_steps 1 (the posterior's rounds of a
    latent model and its KL's gather, each body collective's backward,
    and the gradients' all-reduce). mesh_rs: the g2m sums'
    reduce-scatter; an all-gather for each round on a split set (its
    frontier's table) and for the decoder's table; an all-reduce for each
    round into an upper level (HiLAMParallel: one a level a layer).
    mesh_halo: a ppermute for each round of the plan of g2m, of m2g and of
    each split set. Both: the prediction's gather by blocks, whose
    backward moves nothing."""
    from neural_lam_tpu_torch.models.base_hi_graph_model import (
        BaseHiGraphModel,
    )
    from neural_lam_tpu_torch.models.hi_lam_parallel import HiLAMParallel
    from neural_lam_tpu_torch.parallel.collectives import KINDS

    halo = part.halo
    latent = bool(getattr(twin, "is_latent", False))
    hier = isinstance(twin, BaseHiGraphModel)
    plans = {"m2m": part.mm_plans, "up": part.up_plans,
             "down": part.down_plans}
    c = dict.fromkeys(KINDS, 0)
    for es, kind, name in step_rounds(twin, B, posterior=train and latent):
        if kind == "embed":
            continue
        if kind == "decoder" or name == "m2g":
            c["ppermute" if halo else "all_gather"] += (
                len(part.mg_plan) if halo else 1)
            continue
        if name.endswith("g2m"):
            c["ppermute" if halo else "reduce_scatter"] += (
                len(part.g2m_plan) if halo else 1)
            continue
        sets, idx = re.search(r"(m2m|up|down)\[(\d+)\]", name).groups()
        idx = int(idx)
        if es.frontier is not None:
            c["ppermute" if halo else "all_gather"] += (
                len(plans[sets][idx]) if halo else 1)
        rec_level = idx + 1 if sets == "up" else idx
        if hier and not halo and kind != "chunk" and rec_level > 0:
            c["all_reduce"] += 1
    if isinstance(twin, HiLAMParallel) and not halo:
        c["all_reduce"] += (twin.num_levels - 1) * len(twin.processor)
    blocks = 1 + (train and latent)  # the prediction's and the KL's
    c["all_gather"] += blocks
    if not train:
        return c
    return {"all_reduce": 2 * c["all_reduce"] + 1,
            "all_gather": c["all_gather"] + c["reduce_scatter"],
            "reduce_scatter": c["reduce_scatter"] + c["all_gather"]
            - blocks,
            "ppermute": 2 * c["ppermute"]}


def flat_eligible_of(es):
    from neural_lam_tpu_torch.ops.message_passing import flat_eligible

    return flat_eligible(es, BATCH, H)


def parallel_rank_main(argv):
    """A rank process of phase 16: `chip_smoke.py --parallel-rank RANK
    PORT_A PORT_B OUT CONFIG`. 16a through train.main on a 2-rank gloo
    world at PORT_A, then 16b-c on a 2-rank gloo world at PORT_B; writes
    OUT/rank{RANK}.json (and rank 0 OUT/dp_params.npz)."""
    from pathlib import Path

    import torch

    rank, port_a, port_b = (int(a) for a in argv[:3])
    out, cfg = Path(argv[3]), Path(argv[4])
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from neural_lam_tpu_torch import entry, train
    from neural_lam_tpu_torch.parallel import collectives, distributed
    from neural_lam_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reset_counts, counts, counts_bf16, _ = kernel_registry()
    res = {"rank": rank}
    t0 = time.time()
    collectives.reset_counts()
    with training_recorder(torch, counts, reset_counts,
                           out / "dp_params.npz",
                           out / f"dp_grads{rank}.npz") as rec:
        train.main(par_argv(cfg, out) + [
            "--batch_size", str(BATCH // PAR_RANKS), "--run_name", "dp",
            "--num_nodes", str(PAR_RANKS), "--node_rank", str(rank),
            "--coordinator_address", f"127.0.0.1:{port_a}",
            "--dist_backend", "gloo"])
    res["16a"] = dict(rec, collectives=dict(collectives.counts),
                      seconds=time.time() - t0)
    distributed.init_multihost(f"127.0.0.1:{port_b}", PAR_RANKS, rank,
                               backend="gloo", device="cuda",
                               timeout_s=PAR_TIMEOUT_S)
    mesh = make_mesh(n_space=PAR_RANKS)
    for what, case in PAR_CASES.items():
        res[what] = grid_case(torch, entry, mesh, what, case, counts,
                              counts_bf16, reset_counts)["grid"]
    distributed.barrier()
    distributed.shutdown()
    (out / f"rank{rank}.json").write_text(json.dumps(res))
    return 0


def rs_rank_main(argv):
    """A rank process of phase 17: `chip_smoke.py --rs-rank RANK PORT_A
    PORT_B OUT CONFIG`. 17a-b on a 2-rank gloo world at PORT_A (every
    PAR_CASES model under both mesh-node schemes), then 17c through
    train.main on a 2-rank world at PORT_B; writes OUT/rs{RANK}.json."""
    from pathlib import Path

    import torch

    rank, port_a, port_b = (int(a) for a in argv[:3])
    out, cfg = Path(argv[3]), Path(argv[4])
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from neural_lam_tpu_torch import entry, train
    from neural_lam_tpu_torch.parallel import collectives, distributed
    from neural_lam_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reset_counts, counts, counts_bf16, _ = kernel_registry()
    res = {"rank": rank}
    distributed.init_multihost(f"127.0.0.1:{port_a}", PAR_RANKS, rank,
                               backend="gloo", device="cuda",
                               timeout_s=PAR_TIMEOUT_S)
    mesh = make_mesh(n_space=PAR_RANKS)
    for what, case in PAR_CASES.items():
        res[what] = grid_case(torch, entry, mesh, what, case, counts,
                              counts_bf16, reset_counts, schemes=RS_SCHEMES,
                              timed=what == "GraphLAM")
    distributed.barrier()
    distributed.shutdown()
    t0 = time.time()
    collectives.reset_counts()
    with training_recorder(torch, counts, reset_counts,
                           out / "halo_params.npz") as rec:
        train.main(par_argv(cfg, out) + [
            "--batch_size", str(BATCH), "--run_name", "halo",
            "--max_steps", str(RS_CLI_STEPS), "--num_nodes", str(PAR_RANKS),
            "--node_rank", str(rank), "--coordinator_address",
            f"127.0.0.1:{port_b}", "--dist_backend", "gloo",
            "--spatial_shards", str(PAR_RANKS), "--spatial_scheme",
            "mesh_halo"])
    res["17c"] = dict(rec, collectives=dict(collectives.counts),
                      seconds=time.time() - t0)
    (out / f"rs{rank}.json").write_text(json.dumps(res))
    return 0


def mesh_node_phase(np, root, cfg, single_losses, grid_collectives):
    """Phase 17 (module doc): 17a-c on 2 rank processes of the one card,
    against the single process on the card (17c: phase 16a's losses);
    `grid_collectives`, 16b's rank 0 collectives a GraphLAM predict step
    under the grid scheme, printed beside."""
    t_phase = time.time()
    run_rank_processes("--rs-rank", (free_port(), free_port(), root, cfg),
                       "phase 17")
    ranks = [json.loads((root / f"rs{r}.json").read_text())
             for r in range(PAR_RANKS)]

    def coll(c):
        return ", ".join(f"{k} {c[k]} ({c[k + '_bytes'] / 1e6:.3f} MB)"
                         for k in ("all_reduce", "all_gather",
                                   "reduce_scatter", "ppermute") if c[k]) \
            + f"; {c['bytes'] / 1e6:.3f} MB in all, {c['host_staged']} " \
            "staged through host memory"

    print(f"17 grid scheme (16b, rank 0), GraphLAM predict step: "
          f"{coll(grid_collectives)}")
    for what, case in PAR_CASES.items():
        for scheme in RS_SCHEMES:
            sub = "a" if what == "GraphLAM" else "b"
            for r, rank in enumerate(ranks):
                c = rank[what][scheme]
                nz = {k: v for k, v in c["train_launches"].items() if v}
                timing = (
                    f"; host ms: predict step {c['step_ms']:.3f} "
                    f"(unsharded {c['step_unsharded_ms']:.3f}), training "
                    f"step {c['train_ms']:.3f} (unsharded "
                    f"{c['train_unsharded_ms']:.3f}); device busy ms: "
                    f"predict step {c['step_busy_ms']}, training step "
                    f"{c['train_busy_ms']}" if "step_ms" in c else "")
                print(f"17{sub} {what} {scheme} ({case}) rank {r}: routes "
                      f"{c['routes']}; predict step launches "
                      f"{({k: v for k, v in c['step_launches'].items() if v})}"
                      f", training step {nz}; collectives a predict step "
                      f"{coll(c['step_collectives'])}; a training step "
                      f"{coll(c['train_collectives'])}{timing}; sharded in "
                      f"{c['shard_s']:.2f} s, {c['seconds']:.1f} s")
                if c["step_launches"] != c["step_want"] or \
                        c["train_launches"] != c["train_want"]:
                    fail(f"17 {what} {scheme} rank {r}: launches, want "
                         f"predict {c['step_want']} and training "
                         f"{c['train_want']}")
                for step in ("step", "train"):
                    got = {k: c[f"{step}_collectives"][k]
                           for k in c[f"{step}_coll_want"]}
                    if got != c[f"{step}_coll_want"]:
                        fail(f"17 {what} {scheme} rank {r}: {step} "
                             f"collectives {got}, want "
                             f"{c[f'{step}_coll_want']}")
                if not math.isfinite(c["loss"]):
                    fail(f"17 {what} {scheme} rank {r}: the loss is not "
                         "finite")
            c = ranks[0][what][scheme]
            if "step_gap" in c:
                print(f"  {what} {scheme}: sharded vs unsharded on the card:"
                      f" predict step max abs gap {c['step_gap']:.3e}, "
                      f"2-step rollout {c['rollout_gap']:.3e} (limit "
                      f"{PAR_STEP_LIMIT} x state_std); loss "
                      f"{c['loss']:.7f} vs {c['ref_loss']:.7f}; gradients: "
                      f"worst max abs gap over 1e-4 + 1e-4 x max abs "
                      f"{c['grad_excess'][0]:.3e} ({c['grad_excess'][1]}; "
                      f"must be <= 0), worst max abs gap / max abs "
                      f"{c['grad_rel'][0]:.3e} ({c['grad_rel'][1]}), "
                      f"{c['grad_keys']} parameters")
                if not (c["step_gap"] <= PAR_STEP_LIMIT
                        and c["rollout_gap"] <= PAR_STEP_LIMIT
                        and c["grad_excess"][0] <= 0
                        and c["grad_keys"][0] == c["grad_keys"][1]):
                    fail(f"17 {what} {scheme}: the sharded model and the "
                         "unsharded one disagree")
            else:
                print(f"  {what} {scheme}: bf16 error against fp32, sharded"
                      f" / unsharded: predict step mean "
                      f"{c['bf16_mean_ratio']:.4f} (limit 0.9-1.1), max "
                      f"{c['bf16_max_ratio']:.4f} (limit 0.5-1.5); "
                      f"gradients mean {c['bf16_grad_mean_ratio']:.4f}, "
                      f"max {c['bf16_grad_max_ratio']:.4f} (the same "
                      "limits)")
                if not (0.9 <= c["bf16_mean_ratio"] <= 1.1
                        and 0.5 <= c["bf16_max_ratio"] <= 1.5
                        and 0.9 <= c["bf16_grad_mean_ratio"] <= 1.1
                        and 0.5 <= c["bf16_grad_max_ratio"] <= 1.5):
                    fail(f"17 {what} {scheme}: the sharded bf16 error is "
                         "not the unsharded one's size")
    # 17c: train.main under mesh_halo against 16a's single process
    for r, rank in enumerate(ranks):
        d = rank["17c"]
        got, want = d["losses"], single_losses[:RS_CLI_STEPS]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        print(f"17c train.main --spatial_shards {PAR_RANKS} "
              f"--spatial_scheme mesh_halo rank {r}: losses {got} vs the "
              f"single process's {want}, worst relative gap {rel:.2e} "
              f"(limit {PAR_LOSS_LIMIT}); host ms a step "
              f"{[round(t, 3) for t in d['ms']]}; collectives in "
              f"train.main {d['collectives']}; {d['seconds']:.1f} s")
        if len(got) != RS_CLI_STEPS or not rel <= PAR_LOSS_LIMIT:
            fail("17c: the mesh_halo CLI run and the single process "
                 "disagree")
    print(f"phase 17 took {time.time() - t_phase:.1f} s")


def run_rank_processes(flag, args, what):
    """Start PAR_RANKS processes `chip_smoke.py FLAG RANK *args`, each
    with its own PAR_TIMEOUT_S limit, print each one's last lines, and
    fail unless each exits with 0."""
    t_ranks = time.time()
    env = dict(os.environ, OMP_NUM_THREADS="4")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag, str(r),
         *map(str, args)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(PAR_RANKS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=PAR_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, o) in enumerate(zip(procs, outs)):
        tail = "\n".join(o.splitlines()[-12:])
        print(f"rank {r}: exit code {p.returncode}, "
              f"{time.time() - t_ranks:.1f} s; its last lines:\n  | "
              + tail.replace("\n", "\n  | "))
    if any(p.returncode != 0 for p in procs):
        fail(f"a rank process of {what} failed")


def parallel_phase(torch, np, counts, reset_counts):
    """Phase 16 (module doc): 16a-c on 2 rank processes of the one card,
    against the single process on the card; then phase 17 in the same
    datastore (its 17c against 16a's single process)."""
    import tempfile
    from pathlib import Path

    from neural_lam_tpu_torch import train
    from neural_lam_tpu_torch.parallel import distributed

    t_phase = time.time()
    with tempfile.TemporaryDirectory(prefix="nlt_par_") as tmp:
        root = Path(tmp)
        cfg = write_dummy_config(root)
        argv = par_argv(cfg, root)
        # the single process at batch 4 (it builds the graph the ranks read)
        with training_recorder(torch, counts, reset_counts,
                               root / "single_params.npz",
                               root / "single_grads.npz") as single:
            train.main(argv + ["--batch_size", str(BATCH), "--run_name",
                               "single"])
        print(f"16a single process, batch {BATCH}: losses "
              f"{single['losses']}, host ms a step "
              f"{[round(t, 3) for t in single['ms']]} "
              f"({time.time() - t_phase:.1f} s into phase 16)")
        # a one-rank world: the nccl backend
        port = free_port()
        with training_recorder(torch, counts, reset_counts,
                               root / "nccl_params.npz") as one:
            _, out = captured(train.main, argv + [
                "--batch_size", str(BATCH), "--run_name", "nccl",
                "--max_steps", "1", "--num_nodes", "1",
                "--coordinator_address", f"127.0.0.1:{port}"])
        if distributed.world() is not None or "backend nccl" not in out:
            fail("the one-rank world did not run on nccl, or stayed open")
        rel = abs(one["losses"][0] - single["losses"][0]) / abs(
            single["losses"][0])
        print(f"16a one-rank world (nccl): loss {one['losses'][0]:.7f}, "
              f"{rel:.2e} relative to the single process's first "
              f"(limit {PAR_LOSS_LIMIT}); {time.time() - t_phase:.1f} s "
              "into phase 16")
        if not rel <= PAR_LOSS_LIMIT:
            fail("the one-rank nccl world's loss differs")
        gc.collect()
        torch.cuda.empty_cache()

        run_rank_processes("--parallel-rank", (free_port(), free_port(),
                                                root, cfg), "phase 16")
        ranks = [json.loads((root / f"rank{r}.json").read_text())
                 for r in range(PAR_RANKS)]

        # 16a: the data-parallel trajectory against the single process's
        dp = [r["16a"] for r in ranks]
        losses = [float(np.mean([d["losses"][i] for d in dp]))
                  for i in range(PAR_STEPS)]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                      single["losses"]))
        pa = np.load(root / "dp_params.npz")
        pb = np.load(root / "single_params.npz")
        worst = max((float(np.abs(pa[k] - pb[k]).max())
                     / max(float(np.abs(pb[k]).max()), 1e-30), k)
                    for k in pb.files)
        print(f"16a data parallelism, {PAR_RANKS} ranks x batch "
              f"{BATCH // PAR_RANKS} (gloo on one card) against 1 x batch "
              f"{BATCH}, {PAR_STEPS} AdamW steps: losses (mean over the "
              f"ranks) {losses} vs {single['losses']}, worst relative gap "
              f"{rel:.2e} (limit {PAR_LOSS_LIMIT}); parameters after the "
              f"steps: worst max abs gap / max abs {worst[0]:.2e} "
              f"({worst[1]}; limit {PAR_PARAM_LIMIT})")
        gs = np.load(root / "single_grads.npz")
        excess = -math.inf
        for r in range(PAR_RANKS):
            gr = np.load(root / f"dp_grads{r}.npz")
            if set(gr.files) != set(gs.files):
                fail(f"16a rank {r}: gradients of other parameters than "
                     "the single process's")
            gaps = {k: (float(np.abs(gr[k] - gs[k]).max()),
                        float(np.abs(gs[k]).max())) for k in gs.files}
            g_rel = max((g / max(m, 1e-30), k) for k, (g, m) in gaps.items())
            g_exc = max((g - (PAR_GRAD_LIMIT * m + 1e-6), k)
                        for k, (g, m) in gaps.items())
            excess = max(excess, g_exc[0])
            print(f"16a rank {r}: the first step's gradients (summed over "
                  f"the ranks, averaged over the data groups) against the "
                  f"single process's at batch {BATCH}: worst max abs gap / "
                  f"max abs {g_rel[0]:.3e} ({g_rel[1]}); worst excess over "
                  f"{PAR_GRAD_LIMIT} x max abs + 1e-6 {g_exc[0]:.3e} "
                  f"({g_exc[1]}; must be <= 0); {len(gaps)} parameters, "
                  f"the smallest max abs gradient "
                  f"{min(m for _, m in gaps.values()):.3e}")
        if not (rel <= PAR_LOSS_LIMIT and worst[0] <= PAR_PARAM_LIMIT
                and excess <= 0):
            fail("16a: the data-parallel run and the single process "
                 "disagree")
        L = BENCH["processor_layers"]
        want = dict({k: 0 for k in single["launches"]}, **train_table({
            "embed_grid_flat": 1, "edge_tail_sum_flat": 1,
            "edge_layer_flat": L, "grid_update_flat": 1}))
        for r, d in enumerate(dp):
            nz = {k: v for k, v in d["launches"].items() if v}
            print(f"16a rank {r}: launches of its second step {nz}; host ms "
                  f"a step {[round(t, 3) for t in d['ms']]}; collectives in "
                  f"train.main {d['collectives']}; {d['seconds']:.1f} s")
            if d["launches"] != want:
                fail(f"16a rank {r}: launches {d['launches']}, want {want} "
                     "(phase 7's table: no count depends on the batch)")
        if single["launches"] != want:
            fail(f"16a single process: launches {single['launches']}, "
                 f"want {want}")

        # 16b-c: the grid scheme against the unsharded model
        for what, case in PAR_CASES.items():
            for r, rank in enumerate(ranks):
                c = rank[what]
                nz = {k: v for k, v in c["train_launches"].items() if v}
                print(f"16{'b' if what == 'GraphLAM' else 'c'} {what} "
                      f"({case}) rank {r}: routes {c['routes']}; predict "
                      f"step launches "
                      f"{({k: v for k, v in c['step_launches'].items() if v})}"
                      f", training step {nz}; collectives a predict step "
                      f"{c['step_collectives']}, a training step "
                      f"{c['train_collectives']} (gloo, staged through "
                      f"host memory); host ms: predict step "
                      f"{c['step_ms']:.3f} (unsharded "
                      f"{c['step_unsharded_ms']:.3f}), training step "
                      f"{c['train_ms']:.3f} (unsharded "
                      f"{c['train_unsharded_ms']:.3f}); device busy ms: "
                      f"predict step {c['step_busy_ms']}, training step "
                      f"{c['train_busy_ms']}; built and sharded in "
                      f"{c['build_s']:.1f} s, {c['seconds']:.1f} s in all")
                if c["step_launches"] != c["step_want"] or \
                        c["train_launches"] != c["train_want"]:
                    fail(f"{what} rank {r}: launches, want predict "
                         f"{c['step_want']} and training "
                         f"{c['train_want']}")
                if not math.isfinite(c["loss"]):
                    fail(f"{what} rank {r}: the sharded loss is not finite")
            c = ranks[0][what]
            if "step_gap" in c:
                print(f"  {what}: sharded vs unsharded on the card: predict "
                      f"step max abs gap {c['step_gap']:.3e}, 2-step "
                      f"rollout {c['rollout_gap']:.3e} (limit "
                      f"{PAR_STEP_LIMIT} x state_std, the states being "
                      f"standardized); loss {c['loss']:.7f} vs "
                      f"{c['ref_loss']:.7f}; gradients: worst max abs gap "
                      f"over 1e-4 + 1e-4 x max abs {c['grad_excess'][0]:.3e}"
                      f" ({c['grad_excess'][1]}; must be <= 0), worst max "
                      f"abs gap / max abs {c['grad_rel'][0]:.3e} "
                      f"({c['grad_rel'][1]}), {c['grad_keys']} parameters")
                if not (c["step_gap"] <= PAR_STEP_LIMIT
                        and c["rollout_gap"] <= PAR_STEP_LIMIT
                        and c["grad_excess"][0] <= 0
                        and c["grad_keys"][0] == c["grad_keys"][1]):
                    fail(f"{what}: the sharded model and the unsharded one "
                         "disagree")
            else:
                print(f"  {what}: bf16 error against fp32, sharded / "
                      f"unsharded: predict step mean "
                      f"{c['bf16_mean_ratio']:.4f} (limit 0.9-1.1), max "
                      f"{c['bf16_max_ratio']:.4f} (limit 0.5-1.5); "
                      f"gradients mean {c['bf16_grad_mean_ratio']:.4f}, "
                      f"max {c['bf16_grad_max_ratio']:.4f} (the same "
                      "limits)")
                if not (0.9 <= c["bf16_mean_ratio"] <= 1.1
                        and 0.5 <= c["bf16_max_ratio"] <= 1.5
                        and 0.9 <= c["bf16_grad_mean_ratio"] <= 1.1
                        and 0.5 <= c["bf16_grad_max_ratio"] <= 1.5):
                    fail(f"{what}: the sharded bf16 error is not the "
                         "unsharded one's size")
        print(f"phase 16 took {time.time() - t_phase:.1f} s")
        mesh_node_phase(np, root, cfg, single["losses"],
                        ranks[0]["GraphLAM"]["step_collectives"])


# phase 18: the export path, the dispatcher's operators, deeper MLPs
EXPORT_CASES = (  # (what, model, batch, compute dtype)
    ("GraphLAM batch 4", "graph_lam", 4, None),
    ("GraphLAM batch 4 bf16", "graph_lam", 4, "bfloat16"),
    ("HiLAM batch 1", "hi_lam", 1, None),
)
# each forward operator's CUDA implementation, by operator name
OP_IMPLS = {"embed_grid_flat": ("embed", "_embed_cuda"),
            "edge_tail_sum_flat": ("edge_flat", "_tail_cuda"),
            "edge_layer_flat": ("edge_flat", "_layer_cuda"),
            "grid_update_flat": ("grid_update", "_grid_cuda"),
            "edge_tail": ("edge", "_tail_cuda"),
            "edge_tail_sum": ("edge", "_tail_sum_cuda"),
            "edge_layer": ("edge", "_layer_cuda")}
HIDDEN_LAYERS_LIMIT = 1e-5  # 18c: card vs CPU, x the CPU output's max abs


def op_calls(torch, step):
    """{operator name: (operator, args)} of the first call of each `nlt::`
    operator in `step()`."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = {}

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace == "nlt":
                seen.setdefault(func._schema.name.split("::")[1],
                                (func, args))
            return func(*args, **(kwargs or {}))

    with torch.no_grad(), Record():
        step()
    return seen


def host_us(torch, fn, args, n=50):
    """Host microseconds a call of fn(*args), its `n` calls queued behind
    a ~25 ms sleep kernel (the host's enqueue time, not the device's);
    fails if the host did not finish first."""
    fn(*args)
    torch.cuda.synchronize()
    done = torch.cuda.Event()
    torch.cuda._sleep(SLEEP_CYCLES // 4)
    done.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn(*args)
    us = (time.perf_counter() - t0) / n * 1e6
    if done.query():
        fail(f"host_us: {n} calls took longer to queue than the sleep")
    torch.cuda.synchronize()
    return us


def step_ms(torch, step, what):
    """(host ms a call of `step`, median of 5 synchronised calls; device
    busy ms a call, from a device-only profile of 3, or None)."""
    times = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    prof = profile(torch, step, what, top=4, cpu=False)
    return sorted(times[1:])[2], (prof[0] if prof else None)


def export_load_main(argv):
    """`chip_smoke.py --export-load MANIFEST`: in a fresh process that
    imports `neural_lam_tpu_torch.export` (and, through it, the kernels'
    operators) and nothing of the models, load each exported artifact of
    the manifest, run it on its saved inputs, and print one JSON line a
    case: load s, the launches of one step by kernel, host and busy ms a
    step, whether the model code was imported."""
    import torch

    from neural_lam_tpu_torch.export import load_exported

    with open(argv[0]) as f:
        manifest = json.load(f)
    for case in manifest:
        t0 = time.perf_counter()
        step = load_exported(case["path"])
        load_s = time.perf_counter() - t0
        inputs = torch.load(case["inputs"])
        step(*inputs)  # the first call loads the kernels' libraries
        torch.cuda.synchronize()
        reset_counts, counts, counts_bf16, _ = kernel_registry()
        reset_counts()
        pred, _ = step(*inputs)
        torch.cuda.synchronize()
        launches, launches_bf16 = counts(), counts_bf16()
        torch.save(pred, case["out"])
        host, busy = step_ms(torch, lambda: step(*inputs),
                             f"loaded {case['what']} step")
        print(json.dumps({
            "what": case["what"], "load_s": load_s,
            "launches": {k: v for k, v in launches.items() if v},
            "launches_bf16": {k: v for k, v in launches_bf16.items() if v},
            "host_ms": host, "busy_ms": busy,
            "models_imported": any(m.startswith("neural_lam_tpu_torch.models")
                                   for m in sys.modules)}), flush=True)
    return 0


def op_overhead(torch, nets):
    """18a: host us a call of each operator through the dispatcher
    against its CUDA implementation called directly, at the shapes of the
    first call in a predict step of each (what, net, batch)."""
    import importlib

    from neural_lam_tpu_torch import entry

    calls = {}
    for what, net, B in nets:
        init, forcing, _ = entry.make_inputs(net, B, 1, seed=0)
        with torch.no_grad():
            ctx = net.precompute_rollout_ctx()
        for name, call in op_calls(torch, lambda: net.predict_step(
                init[:, 1], init[:, 0], forcing[:, 0], ctx)).items():
            calls.setdefault(name, (what, call))
    if sorted(calls) != sorted(OP_IMPLS):
        fail(f"18a: the steps called the operators {sorted(calls)}, want "
             f"{sorted(OP_IMPLS)}")
    for name in sorted(OP_IMPLS):
        what, (op, args) = calls[name]
        mod, fn = OP_IMPLS[name]
        impl = getattr(importlib.import_module(
            f"neural_lam_tpu_torch.ops.{mod}"), fn)
        rounds = [(host_us(torch, op, args), host_us(torch, impl, args))
                  for _ in range(3)]
        via, direct = (sorted(r[i] for r in rounds)[1] for i in (0, 1))
        print(f"18a: nlt::{name} ({what}'s first call): {via:.1f} us a call "
              f"through the dispatcher, {direct:.1f} us its CUDA "
              f"implementation called directly (+{via - direct:.1f} us; host "
              "enqueue time behind a sleep kernel, median of 3 rounds of "
              "50)")


def export_cases(torch, np, tmp, counts, counts_bf16, reset_counts, nets):
    """18b: export, save and reload each of `EXPORT_CASES` at full width
    (the fp32 models from `nets`, {kind: model}, which it empties); the
    fresh process's output against the eager step's, its launches
    against `step_table`, and the export, load and step times."""
    from neural_lam_tpu_torch import entry, export

    manifest, eager = [], {}
    for what, kind, B, cd in EXPORT_CASES:
        net = nets.pop(kind) if cd is None else entry.build_model(
            **BENCH, model=kind, compute_dtype=cd, device="cuda")[0]
        init, forcing, _ = entry.make_inputs(net, B, 1, seed=0)
        inputs = (init[:, 1], init[:, 0], forcing[:, 0])
        t0 = time.perf_counter()
        program, meta = export.export_predict_step(net, B)
        export_s = time.perf_counter() - t0
        stem = tmp / f"{kind}_{B}_{cd or 'fp32'}"
        path = stem.with_suffix(".pt2")
        t0 = time.perf_counter()
        torch.export.save(program, str(path))
        save_s = time.perf_counter() - t0
        del program
        with torch.no_grad():
            ctx = net.precompute_rollout_ctx()
            net.predict_step(*inputs, ctx)
            reset_counts()
            pred, _ = net.predict_step(*inputs, ctx)
            torch.cuda.synchronize()
            got = {k: v for k, v in counts().items() if v}
            got16 = {k: v for k, v in counts_bf16().items() if v}
            host, busy = step_ms(torch, lambda: net.predict_step(
                *inputs, ctx), f"eager {what} step")
        table = {k: v for k, v in step_table(net, B)[0].items() if v}
        both = {k: got.get(k, 0) + got16.get(k, 0) for k in set(got) | set(
            got16)}
        if both != table:
            fail(f"18b {what}: the eager step launched {both}, the table "
                 f"says {table}")
        torch.save(inputs, stem.with_suffix(".in.pt"))
        manifest.append({"what": what, "path": str(path),
                         "inputs": str(stem.with_suffix(".in.pt")),
                         "out": str(stem.with_suffix(".out.pt"))})
        eager[what] = (pred, table, bool(got16), host, busy, export_s,
                       save_s, path.stat().st_size / 1e6, meta)
        print(f"18b {what}: exported in {export_s:.2f} s, saved in "
              f"{save_s:.2f} s ({path.stat().st_size / 1e6:.1f} MB); eager "
              f"step launches {table}")
        del net, ctx
        gc.collect()
        torch.cuda.empty_cache()
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    res = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--export-load",
         str(tmp / "manifest.json")], capture_output=True, text=True,
        timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
    for line in res.stdout.splitlines():
        if not line.startswith("{"):
            print(f"  | {line}")
    if res.returncode != 0:
        fail(f"18b: the loading process failed:\n{res.stderr[-4000:]}")
    loaded = [json.loads(x) for x in res.stdout.splitlines()
              if x.startswith("{")]
    if len(loaded) != len(EXPORT_CASES):
        fail(f"18b: the loading process reported {len(loaded)} cases")
    for rec in loaded:
        what = rec["what"]
        pred, table, bf16, host, busy, export_s, save_s, mb, meta = \
            eager[what]
        got = torch.load(next(c["out"] for c in manifest
                              if c["what"] == what))
        gap = float((got.float() - pred.float()).abs().max())
        launched = (rec["launches_bf16"] if bf16 else rec["launches"])
        if rec["models_imported"]:
            fail(f"18b {what}: loading the program imported the model code")
        if not torch.equal(got, pred):
            fail(f"18b {what}: the loaded program's output is not the eager "
                 f"step's bit for bit (max abs gap {gap:.3e})")
        if launched != table or (bf16 and rec["launches"]):
            fail(f"18b {what}: the loaded program launched "
                 f"{rec['launches']} (bf16 {rec['launches_bf16']}), the "
                 f"table says {table}")
        print(f"18b {what}: export {export_s:.2f} s, save {save_s:.2f} s, "
              f"load {rec['load_s']:.2f} s in a fresh process (no model "
              f"code imported), artifact {mb:.1f} MB; output bit-equal to "
              f"the eager step's, {meta['n_grid']} x {meta['n_state_vars']}"
              f" x batch {meta['batch_size']}; launches "
              f"{'(bf16) ' if bf16 else ''}{launched} = step_table; host ms "
              f"a step {rec['host_ms']:.3f} loaded vs {host:.3f} eager, "
              f"busy ms {rec['busy_ms'] or float('nan'):.3f} vs "
              f"{busy or float('nan'):.3f}")


def hidden_layers_case(torch, np, counts, reset_counts):
    """18c: a --hidden_layers 2 GraphLAM at bench width: no kernel
    launches (the JAX package's gates take none), its forecast against
    the same weights on the CPU (TF32 off), and a few training steps."""
    from neural_lam_tpu_torch import entry

    kw = dict(BENCH, hidden_layers=2)
    net, ds = entry.build_model(**kw, device="cuda")
    cpu, _ = entry.build_model(**kw, device="cpu")
    init, forcing, true = entry.make_inputs(net, 1, 2, seed=0)
    reset_counts()
    pred = entry.forecast(net, init, forcing, true)
    torch.cuda.synchronize()
    launched = {k: v for k, v in counts().items() if v}
    t0 = time.perf_counter()
    want = entry.forecast(cpu, init.cpu(), forcing.cpu(), true.cpu())
    cpu_s = time.perf_counter() - t0
    gap = float((pred.cpu() - want).abs().max())
    scale = float(want.abs().max())
    print(f"18c: GraphLAM hidden_layers 2 (268x238, hidden 64, 4 layers), "
          f"2-step rollout at batch 1: launches {launched or 'none'}; card "
          f"vs CPU max abs gap {gap:.3e} = {gap / scale:.3e} x max "
          f"{scale:.3f} (limit {HIDDEN_LAYERS_LIMIT:g}; CPU rollout "
          f"{cpu_s:.1f} s)")
    if launched:
        fail(f"18c: a hidden_layers 2 model launched {launched}")
    if not gap <= HIDDEN_LAYERS_LIMIT * scale:
        fail("18c: the card's hidden_layers 2 forecast is off the CPU's")
    del cpu, want
    reset_counts()
    losses = entry.train_steps(net, ds, batch_size=4, steps=3,
                               device=net.device)
    launched = {k: v for k, v in counts().items() if v}
    print(f"18c: 3 AdamW steps at batch 4: losses {losses}, launches "
          f"{launched or 'none'}")
    if launched or not all(math.isfinite(x) for x in losses):
        fail("18c: hidden_layers 2 training launched kernels or lost "
             "finiteness")


def graph_page_case(tmp):
    """18d: the bench graph's scene (numpy only) and its interactive page
    from the graph on the card, every set embedded."""
    import base64

    import numpy as np

    from neural_lam_tpu_torch import entry
    from neural_lam_tpu_torch.graph.html_viz import save_interactive_html
    from neural_lam_tpu_torch.plot_graph import graph_scene

    for kind in ("graph_lam", "hi_lam"):
        net, ds = entry.build_model(**BENCH, model=kind, device="cuda")
        t0 = time.perf_counter()
        points, edges = graph_scene(net.graph, ds.get_xy("state"))
        page = save_interactive_html(points, edges, tmp / f"{kind}.html",
                                     title=kind)
        html = page.read_text()
        s = time.perf_counter() - t0
        sets = json.loads(re.search(r"const SETS = (\[.*?\]);\n", html,
                                    re.S).group(1))
        arrays = [e["segs"] for e in edges] + [p["pos"] for p in points]
        if len(sets) != len(arrays) or any(
                np.frombuffer(base64.b64decode(e["data"]), np.float32).size
                != a.size for e, a in zip(sets, arrays)):
            fail(f"18d: the {kind} page does not embed every set whole")
        print(f"18d: {kind} graph page in {s:.2f} s: {len(edges)} edge sets "
              f"({sum(len(e['segs']) for e in edges)} segments), "
              f"{len(points)} point sets, {page.stat().st_size / 1e6:.1f} "
              "MB, every set embedded")


def export_phase(torch, np, counts, counts_bf16, reset_counts):
    """Phase 18 (see the module doc)."""
    import tempfile
    from pathlib import Path

    from neural_lam_tpu_torch import entry

    t0 = time.time()
    gl, _ = entry.build_model(**BENCH, device="cuda")
    hl, _ = entry.build_model(**BENCH, model="hi_lam", device="cuda")
    op_overhead(torch, [("GraphLAM batch 4", gl, 4),
                        ("HiLAM batch 1", hl, 1)])
    for what, net in (("GraphLAM", gl), ("HiLAM", hl)):
        hlp_step_stats(torch, entry, net, 4, f"18a {what} batch 4", steps=4)
    nets = {"graph_lam": gl, "hi_lam": hl}
    del gl, hl
    print(f"phase 18a: {time.time() - t0:.1f} s")
    with tempfile.TemporaryDirectory(prefix="nlt_export_") as tmp:
        t0 = time.time()
        export_cases(torch, np, Path(tmp), counts, counts_bf16, reset_counts,
                     nets)
        print(f"phase 18b: {time.time() - t0:.1f} s")
        t0 = time.time()
        graph_page_case(Path(tmp))
        print(f"phase 18d: {time.time() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    hidden_layers_case(torch, np, counts, reset_counts)
    print(f"phase 18c: {time.time() - t0:.1f} s")


NEW_WIDTHS = (32, 128)  # phase 19's hidden widths beside 64


def usage_lines(_build, libs):
    """Each kernel instance's ptxas registers and spill in the build logs
    of `libs` (build_all's keys)."""
    for key in libs:
        log = _build.build_log(key)
        found = re.findall(r"Compiling entry function '(\w+)'.*?\n(.*?Used "
                           r"\d+ registers[^\n]*)", log, re.S)
        if not found:
            fail(f"no ptxas lines in the build log of {key}")
        for fn, info in sorted(found):
            regs = int(re.search(r"Used (\d+) registers", info).group(1))
            spill = sum(int(b) for b in re.findall(r"(\d+) bytes spill",
                                                   info))
            print(f"  {key} {kernel_name(fn)}: {regs} registers, {spill} "
                  "bytes of spill")


def width_build(_build):
    """19a: the forward libraries at widths 32 and 128 (one nvcc per
    source and width, all started together; from `main` phase 1 has built
    them already), their seconds, and each kernel instance's ptxas
    registers and spill."""
    t0 = time.time()
    libs = _build.build_all(_build.FORWARD, widths=NEW_WIDTHS)
    print(f"phase 19a: {len(libs)} forward libraries at widths "
          f"{NEW_WIDTHS} ready in {time.time() - t0:.1f} s")
    usage_lines(_build, libs)


def fp32_check(torch, counts, name, mod, args, what, per_tensor=False):
    """The fp32 instance of kernel `name` (in `mod`) against its plain
    version within 1e-4 + 1e-4 * |plain| (phase 3's limit; `per_tensor`:
    within 1e-4 + 1e-4 * each output tensor's max |plain|, phase 4's),
    two calls bit-identical; returns the max abs error."""
    kern, plain = getattr(mod, name), getattr(mod, name + "_plain")
    before = counts()[name]
    got, again = flat_outputs(kern(*args)), flat_outputs(kern(*args))
    want = flat_outputs(plain(*args))
    torch.cuda.synchronize()
    if counts()[name] != before + 2:
        fail(f"{name} at {what}: its kernel did not run")
    if not all(a is None and b is None or torch.equal(a, b)
               for a, b in zip(got, again)):
        fail(f"{name} at {what}: two calls differ")
    err = 0.0
    for a, b in zip(got, want):
        if a is None and b is None:
            continue
        if a.shape != b.shape or not torch.isfinite(a).all():
            fail(f"{name} at {what}: bad output {tuple(a.shape)}")
        gap = (a - b).abs()
        scale = b.abs().max() if per_tensor else b.abs()
        if not bool((gap <= 1e-4 + 1e-4 * scale).all()):
            fail(f"{name} at {what}: kernel and plain disagree, max abs err "
                 f"{float(gap.max()):.3e}")
        err = max(err, float(gap.max()))
    return err


def width_kernel_cases(torch, h, counts, counts_bf16, records, peaks):
    """19b: each forward kernel's fp32 and bf16 instances (P1: fp32) at
    hidden width h, at the shapes of the bench GraphLAM (batch 4) and
    4-level HiLAM (batch 1) of that width (`main_path_cases`), against its
    plain version (fp32: phase 3's limit; bf16: one bf16 ulp, phase 11's),
    two calls bit-identical; each timed beside its plain version, its
    products as torch.mm calls and its bound; a record a kernel instance,
    named `<kernel>[bf16]@h<h>`. Returns the two models."""
    from neural_lam_tpu_torch import entry

    peak_flops, peak_tf32, peak_bw = peaks
    t0 = time.time()
    cfg = dict(BENCH, hidden_dim=h)
    gm, _ = entry.build_model(**cfg, device="cuda")
    hm, _ = entry.build_model(**cfg, device="cuda", model="hi_lam")
    print(f"hidden {h}: bench GraphLAM and 4-level HiLAM built in "
          f"{time.time() - t0:.1f} s")
    with torch.no_grad():
        for dt in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device="cuda").manual_seed(19)

            def rand(*shape):
                return torch.randn(*shape, device="cuda",
                                   generator=gen).to(dt)

            bf = dt == torch.bfloat16
            for (name, mod, args, replaces, source, bytes_, flops, tf32,
                 lib) in main_path_cases(torch, gm, hm, rand, dt):
                what = f"hidden {h}"
                if bf:
                    share, err = bf16_check(torch, counts_bf16, name, mod,
                                            args, what)
                    rule = (f"within one bf16 ulp ({share:.5f} of the "
                            "outputs not bit-equal)")
                else:
                    err = fp32_check(torch, counts, name, mod, args, what)
                    rule = "within 1e-4 + 1e-4*|plain|"
                kern, plain = getattr(mod, name), getattr(mod, name + "_plain")
                ms = cuda_ms(torch, lambda: kern(*args), 20)
                plain_ms = cuda_ms(torch, lambda: plain(*args), 5)
                lib_ms = cuda_ms(torch, lib, 10)
                t_bytes = bytes_ / peak_bw * 1e3
                t_ops = 1e3 * (tf32 / peak_tf32 if tf32 is not None
                               else flops / peak_flops)
                bound = max(t_bytes, t_ops)
                tag = f"{name}{'[bf16]' if bf else ''}@h{h}"
                print(f"{tag}: {rule}, max abs err {err:.3e}, two calls "
                      f"bit-identical; kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms (torch.mm "
                      f"on {'bf16' if bf else 'fp32'} operands), bound "
                      f"{bound:.4f} ms ({bytes_ / 1e6:.1f} MB: "
                      f"{t_bytes:.4f} ms; {flops / 1e9:.2f} GFLOP"
                      + (f" as {tf32 / flops:.2f} TF32 products a term"
                         if tf32 is not None else " fp32")
                      + f": {t_ops:.4f} ms)")
                records.append({
                    "name": tag, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": None,
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound,
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "library_ms": lib_ms})
    return gm, hm


def k4_d_out_cases(torch, np, counts, counts_bf16):
    """19b: K4 with output maps wider than its hidden width, on a seeded
    local graph (20,000 receivers, K = 4 senders each among 6,561) at batch
    4 with seeded weights: d_out 80 (two 64-column chunks, o_w1 in shared
    memory) and 200 (o_w1 read from device memory) at width 64, 34 at 32,
    160 at 128 (streamed per chunk); each against its plain version
    (fp32: 1e-4 + 1e-4 * |plain|; bf16: one bf16 ulp), two calls
    bit-identical, timed beside it."""
    from neural_lam_tpu_torch.ops import grid_update
    from neural_lam_tpu_torch.ops.message_passing import EdgeSet

    rng = np.random.default_rng(3)
    n_rec, n_send, K = 20000, 6561, 4
    centre = (np.arange(n_rec) * n_send // n_rec)[:, None]
    send = np.clip(centre + rng.integers(-4, 5, (n_rec, K)), 0,
                   n_send - 1).reshape(-1)
    es = EdgeSet.from_local(
        send, np.repeat(np.arange(n_rec), K),
        rng.standard_normal((K * n_rec, 3)).astype(np.float32), n_send,
        n_rec, device="cuda", build_transpose=False)
    mask_p = es.mask.view(es.num_virt, K)
    gen = torch.Generator(device="cuda").manual_seed(23)

    def rand(*shape, scale=1.0):
        return scale * torch.randn(*shape, device="cuda", generator=gen)

    with torch.no_grad():
        for h, d_out in ((64, 80), (64, 200), (32, 34), (128, 160)):
            pp = {k: rand(2 * h if k == "a_w0" else h, h, scale=0.1)
                  for k in ("enc_w0", "enc_w1", "w_i", "w2", "a_w0", "a_w1",
                            "o_w0")}
            pp.update({k: rand(h, scale=0.1) for k in (
                "enc_b0", "enc_b1", "enc_lb", "b2", "e_lb", "a_b0", "a_b1",
                "a_lb", "o_b0")})
            pp.update({k: 1 + rand(h, scale=0.1)
                       for k in ("enc_ls", "e_ls", "a_ls")})
            pp.update(o_w1=rand(h, d_out, scale=0.1),
                      o_b1=rand(d_out, scale=0.1))
            base = (rand(n_send, BATCH * h), es.senders,
                    rand(es.num_virt * K, h), rand(n_rec, BATCH * h), mask_p,
                    pp)
            for dt in (torch.float32, torch.bfloat16):
                args = tuple(t.to(dt) if i in (0, 2, 3) else t
                             for i, t in enumerate(base))
                what = f"hidden {h}, d_out {d_out}"
                if dt == torch.bfloat16:
                    share, err = bf16_check(torch, counts_bf16,
                                            "grid_update_flat", grid_update,
                                            args, what)
                    rule = (f"within one bf16 ulp ({share:.5f} not "
                            "bit-equal)")
                else:
                    err = fp32_check(torch, counts, "grid_update_flat",
                                     grid_update, args, what)
                    rule = "within 1e-4 + 1e-4*|plain|"
                ms = cuda_ms(torch, lambda: grid_update.grid_update_flat(
                    *args), 10)
                plain_ms = cuda_ms(
                    torch, lambda: grid_update.grid_update_flat_plain(*args),
                    3)
                print(f"grid_update_flat{'[bf16]' if dt != torch.float32 else ''}"
                      f" at {what} (local graph K={K}, {es.num_virt} rows, "
                      f"B=4): {rule}, max abs err {err:.3e}, two calls "
                      f"bit-identical; kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms")


def width_rollout(torch, entry, net, B, what, counts, counts_bf16,
                  reset_counts, plain_kernels, launched, net32=None):
    """A 4-step rollout through `entry.forecast` with every counter at 0
    just before it: the launches a step equal `step_table`'s (a bf16
    model's on the bf16 counters, P1's on the fp32 ones), a finite output
    of the bench's shape; fp32: one predict step through the kernels
    within 1e-3 of the plain path's; bf16 (`net32` its fp32 twin): the
    kernel path's bf16 error against the fp32 step the plain path's size
    (`error_size`). The launches are added to `launched` ({record name:
    count})."""
    h = net.args.hidden_dim
    bf = net.compute_dtype is not None
    init, forcing, true = entry.make_inputs(net, B, STEPS, seed=0)
    entry.forecast(net, init, forcing[:, :1], true[:, :1])  # warm-up
    reset_counts()
    pred = entry.forecast(net, init, forcing, true)
    torch.cuda.synchronize()
    c32, c16 = counts(), counts_bf16()
    table = step_table(net, B)[0]
    if bf:
        want16 = {k: n for k, n in table.items() if k != "edge_tail"}
        want32 = {"edge_tail": table["edge_tail"]}
    else:
        want16, want32 = {}, table
    ok = (all(c32[k] == want32.get(k, 0) * STEPS for k in c32)
          and all(c16[k] == want16.get(k, 0) * STEPS for k in c16))
    shape = (B, STEPS, net.graph.num_grid_nodes, 17)
    print(f"{what}: {STEPS}-step rollout {tuple(pred.shape)}, finite "
          f"{bool(torch.isfinite(pred.float()).all())}; launches a step "
          f"{ {k: n / STEPS for k, n in c32.items() if n} } (fp32)"
          + (f", { {k: n / STEPS for k, n in c16.items() if n} } (bf16)"
             if bf else "") + f"; step_table {table}")
    if not ok:
        fail(f"{what}: launches differ from the step table")
    if tuple(pred.shape) != shape or not bool(
            torch.isfinite(pred.float()).all()):
        fail(f"{what}: rollout {tuple(pred.shape)} not finite")
    for k, n in c32.items():
        if k in FWD + BATCHED and n:
            launched[f"{k}@h{h}"] = launched.get(f"{k}@h{h}", 0) + n
    for k, n in c16.items():
        if k in FWD + BATCHED and n:
            launched[f"{k}[bf16]@h{h}"] = (
                launched.get(f"{k}[bf16]@h{h}", 0) + n)
    with torch.no_grad():
        step_k = net.predict_step(init[:, 1], init[:, 0], forcing[:, 0])[0]
        with plain_kernels():
            step_p = net.predict_step(init[:, 1], init[:, 0],
                                      forcing[:, 0])[0]
        if not bf:
            gap = float((step_k - step_p).abs().max())
            print(f"{what}: predict step, kernels vs plain on the card: max "
                  f"abs gap {gap:.3e} (limit 1e-3)")
            if not gap <= 1e-3:
                fail(f"{what}: kernel path and plain path disagree")
        else:
            step32 = net32.predict_step(init[:, 1], init[:, 0],
                                        forcing[:, 0])[0]
            error_size(torch, f"{what} predict step", step_k, step_p, step32)
    step_ms = median_ms(torch, lambda: entry.forecast(
        net, init, forcing, true)) / STEPS
    print(f"{what}: {step_ms:.3f} ms a step (host clock, a 4-step rollout, "
          "median of 3)")


def width_cli_phase(torch, np, counts, counts_bf16, reset_counts,
                    plain_kernels, zero, launched):
    """19c's CLIs at width 128 on a 268x238 MDP datastore: seeded GraphLAM
    and HiLAM checkpoints written by the port at --hidden_dim 128;
    `predict.main` forecasts 4 steps from each (batch 1, where B*h = 128
    takes the flat-grid route: `forecast_check`, launches from
    `step_table`) and from the GraphLAM's with `--precision bf16` (the bf16
    counters, its error against the fp32 forecast the plain bf16 path's
    size); `train.main --eval val` scores the GraphLAM through the kernels
    and the plain versions (within 1e-4 relative)."""
    import copy
    import tempfile
    from pathlib import Path

    from neural_lam_tpu_torch import predict, train
    from neural_lam_tpu_torch.checkpoint import save_checkpoint
    from neural_lam_tpu_torch.config import load_config_and_datastore
    from neural_lam_tpu_torch.datastore.zarr_reader import ZarrGroup
    from neural_lam_tpu_torch.graph.storage import load_or_build_graph
    from neural_lam_tpu_torch.models import MODELS
    from neural_lam_tpu_torch.models.ar_model import ModelArgs

    L = BENCH["processor_layers"]
    width = ("--hidden_dim", "128", "--processor_layers", str(L))
    with tempfile.TemporaryDirectory(prefix="nlt_widths_") as tmp:
        root = Path(tmp)
        t0 = time.time()
        cfg = write_mdp_datastore(root, np)
        config, ds = load_config_and_datastore(cfg)
        tables = {}
        for kind, graph in (("graph_lam", "multiscale"),
                            ("hi_lam", "hierarchical")):
            net = MODELS[kind](
                ModelArgs(hidden_dim=128, processor_layers=L), config, ds,
                load_or_build_graph(ds, graph, "cuda"), device="cuda",
                generator=torch.Generator().manual_seed(0))
            save_checkpoint(root / "models", kind, net.state_dict(),
                            meta={"step": 0})
            tables[kind] = {k: n for k, n in step_table(net, 1)[0].items()
                            if n}
        del net
        print(f"MDP datastore and seeded GraphLAM and HiLAM checkpoints at "
              f"hidden 128 written in {time.time() - t0:.1f} s; launches a "
              f"step at batch 1: {tables}")

        def argv(kind, graph, out, *extra):
            return ["--config_path", str(cfg), "--model", kind, "--graph",
                    graph, *width, "--load", str(root / "models" / kind),
                    "--split", "test", "--sample_idx", "-1", "--ar_steps",
                    str(STEPS), "--out", str(out), *extra]

        for kind, graph in (("graph_lam", "multiscale"),
                            ("hi_lam", "hierarchical")):
            reset_counts()
            forecast_check(torch, np, argv(kind, graph,
                                           root / f"{kind}.zarr"),
                           tables[kind], counts, reset_counts,
                           plain_kernels, zero, f"{kind} --hidden_dim 128")
            for k, n in tables[kind].items():
                launched[f"{k}@h128"] = launched.get(f"{k}@h128", 0) + (
                    n * STEPS)
        # --precision bf16
        out = root / "graph_lam16.zarr"
        a16 = argv("graph_lam", "multiscale", out, "--precision", "bf16")
        reset_counts()
        summary = quiet(predict.main, a16)
        torch.cuda.synchronize()
        c16, c32 = counts_bf16(), counts()
        want = tables["graph_lam"]
        if c16 != {k: want.get(k, 0) * STEPS for k in c16} or any(
                c32.values()):
            fail(f"predict.main graph_lam --hidden_dim 128 --precision bf16: "
                 f"launches {c16} (bf16), {c32} (fp32); want {want} a step "
                 "in bf16")
        for k, n in c16.items():
            if n:
                launched[f"{k}[bf16]@h128"] = (
                    launched.get(f"{k}[bf16]@h128", 0) + n)
        pred = ZarrGroup(out)["state"].read_full()
        if pred.shape != (STEPS, 268 * 238, 17) or not np.isfinite(
                pred).all():
            fail(f"predict.main --hidden_dim 128 --precision bf16: forecast "
                 f"{pred.shape}, finite {np.isfinite(pred).all()}")
        args = predict.parse_args(a16)
        net, nds, _ = predict.prepare(args)
        net32 = copy.copy(net)
        net32.compute_dtype = None
        stats = nds.get_standardization_dataarray("state")
        k16 = (pred - stats["state_mean"]) / stats["state_std"]
        p32, _ = predict.rollout(net32, nds, args)
        with plain_kernels():
            pp16, _ = predict.rollout(net, nds, args)
        print(f"predict.main graph_lam --hidden_dim 128 --precision bf16: "
              f"init {summary['init_s']:.2f} s, rollout "
              f"{summary['rollout_s'] * 1e3 / STEPS:.1f} ms a step; "
              f"launches a step { {k: n / STEPS for k, n in c16.items() if n} }"
              " in bf16")
        error_size(torch, "predict.main --hidden_dim 128 --precision bf16 "
                   "forecast", k16, pp16, p32)
        del net, net32, nds, pp16, p32
        torch.cuda.empty_cache()
        # train.main --eval val: the val split's one sample, batch 1 (the
        # flat-grid route at B*h = 128), 2 steps
        val_argv = ["--config_path", str(cfg), *width, "--batch_size", "4",
                    "--ar_steps_eval", "2", "--val_steps_to_log", "1", "2",
                    "--save_dir", str(root / "models"), "--model",
                    "graph_lam", "--graph", "multiscale", "--load",
                    str(root / "models" / "graph_lam"), "--eval", "val"]
        val = {}
        for path, ctx in (("kernels", contextlib.nullcontext),
                          ("plain", plain_kernels)):
            reset_counts()
            with ctx():
                val[path] = quiet(train.main,
                                  val_argv + ["--run_name", f"val_{path}"])
            torch.cuda.synchronize()
            if path == "kernels":
                got = {k: n for k, n in counts().items() if n}
                w2 = {k: 2 * n for k, n in want.items()}
                print(f"train.main --eval val --hidden_dim 128: launches "
                      f"{got}")
                if got != w2:
                    fail(f"train.main --eval val --hidden_dim 128: launches "
                         f"{got}, want {w2}")
        v, w = val["kernels"]["val_mean_loss"], val["plain"]["val_mean_loss"]
        print(f"train.main --eval val --hidden_dim 128: val_mean_loss {v!r}, "
              f"within {abs(v - w) / abs(w):.3e} relative of the plain path "
              "(limit 1e-4)")
        if not (math.isfinite(v) and abs(v - w) <= 1e-4 * abs(w)):
            fail("train.main --eval val --hidden_dim 128: kernels and plain "
                 "path disagree")
        # training at 48 (no library) on the card raises before its first
        # step, naming the built widths
        reset_counts()
        argv48 = [a if a != "128" else "48" for a in val_argv[:-2]]
        try:
            quiet(train.main, argv48 + ["--epochs", "1", "--run_name",
                                        "train48"])
        except ValueError as e:
            if "32, 64, 128" not in str(e):
                fail(f"train.main --hidden_dim 48: raised {e!r}, which does "
                     "not name the built widths")
            print(f"train.main --hidden_dim 48 (training) raises: {e}")
        else:
            fail("train.main --hidden_dim 48 trained on the card")
        if any(counts().values()):
            fail(f"train.main --hidden_dim 48: launches {counts()} before "
                 "it raised")


def width_raises(torch, np, counts, reset_counts):
    """19d: hidden width 48 (no library) raises ValueError on the card,
    naming the built widths, in K1, K2, K4 and P2 (each module's check)
    and in every backward wrapper (B1, B2, B3/B4, B5/B6, xtd_sum), with no
    launch."""
    from neural_lam_tpu_torch.ops import (
        edge,
        edge_flat,
        embed,
        grid_update,
        weight_grad,
    )
    from neural_lam_tpu_torch.ops.message_passing import EdgeSet

    h, B, K = 48, 4, 2
    es = EdgeSet.from_local(np.repeat(np.arange(20), K),
                            np.repeat(np.arange(20), K),
                            np.zeros((20 * K, 3), np.float32), 20, 20,
                            device="cuda", build_transpose=False)
    M, nv = es.num_virt * K, es.num_virt
    mask_p = es.mask.view(nv, K)

    def r(*shape):
        return torch.randn(*shape, device="cuda")

    def dec(hh):
        pp = {k: r(2 * hh if k == "a_w0" else hh, hh)
              for k in grid_update._MATS}
        pp.update({k: r(hh) for k in grid_update._VECS})
        return dict(pp, o_w1=r(hh, 17), o_b1=r(17))

    tail = (r(h, h), r(h), r(h), r(h))
    calls = {
        "embed_grid_flat": lambda: embed.embed_grid_flat(
            r(20, B * 5), r(5, h), r(h), r(h, h), r(h), r(h), r(h), B),
        "edge_tail_sum_flat": lambda: edge_flat.edge_tail_sum_flat(
            r(20, B * h), es.senders, r(M, h), r(nv, B * h), mask_p, *tail),
        "grid_update_flat": lambda: grid_update.grid_update_flat(
            r(20, B * h), es.senders, r(M, h), r(20, B * h), mask_p, dec(h)),
        "edge_tail_sum": lambda: edge.edge_tail_sum(
            r(1, 20, h), es.senders, r(M, h), r(1, nv, h), *tail, es.mask,
            K),
    }
    for name, call in calls.items():
        reset_counts()
        try:
            call()
        except ValueError as e:
            if "32, 64, 128" not in str(e):
                fail(f"{name} at hidden 48 raised {e!r}, which does not "
                     "name the built widths")
            print(f"{name} at hidden 48 raises: {e}")
        else:
            fail(f"{name} ran at hidden 48")
        if any(counts().values()):
            fail(f"{name} at hidden 48 counted launches {counts()}")
    # the backward kernels at hidden 48: each wrapper raises naming the
    # built widths, with no launch
    dec48 = dec(h)
    bwd_calls = {
        "embed_grid_flat_bwd": lambda: embed.embed_grid_flat_bwd(
            r(20, B * 5), r(5, h), r(h), r(h, h), r(h), r(h), r(h), B,
            r(20, B * h), False),
        "edge_tail_sum_flat_bwd": lambda: edge_flat.edge_tail_sum_flat_bwd(
            r(20, B * h), es.senders, r(M, h), r(nv, B * h), mask_p, *tail,
            r(nv, B * h)),
        "edge_layer_flat_bwd": lambda: edge_flat.edge_layer_flat_bwd(
            r(M, B * h), r(20, B * h), es.senders, r(nv, B * h), mask_p,
            r(h, h), r(h), *tail, None, r(nv, B * h)),
        "grid_update_flat_bwd": lambda: grid_update.grid_update_flat_bwd(
            r(20, B * h), es.senders, r(M, h), r(20, B * h), mask_p, dec48,
            r(nv, B * 17)),
        "xtd_sum": lambda: weight_grad.xtd_sum([(r(64, h), r(64, 17))]),
    }
    for name, call in bwd_calls.items():
        reset_counts()
        try:
            call()
        except ValueError as e:
            if "32, 64, 128" not in str(e):
                fail(f"{name} at hidden 48 raised {e!r}, which does not "
                     "name the built widths")
            print(f"{name} at hidden 48 raises: {e}")
        else:
            fail(f"{name} ran at hidden 48")
        if any(counts().values()):
            fail(f"{name} at hidden 48 counted launches {counts()}")


def widths_phase(torch, np, counts, counts_bf16, reset_counts,
                 plain_kernels, zero, records, peaks):
    """Phase 19 (see the module doc)."""
    from neural_lam_tpu_torch import entry
    from neural_lam_tpu_torch.ops import _build

    t0 = time.time()
    width_build(_build)
    launched = {}
    first = len(records)
    for h in NEW_WIDTHS:
        t1 = time.time()
        gm, hm = width_kernel_cases(torch, h, counts, counts_bf16, records,
                                    peaks)
        print(f"phase 19b (hidden {h}): {time.time() - t1:.1f} s")
        t1 = time.time()
        gm16 = copy_with_dtype(gm, torch.bfloat16)
        runs = [(gm, BATCH, "GraphLAM batch 4", None),
                (gm16, BATCH, "bf16 GraphLAM batch 4", gm)]
        if h == 32:  # B*h = 32: every set batched (P2, P3; HiLAM's P1)
            runs += [(gm, 1, "GraphLAM batch 1", None),
                     (gm16, 1, "bf16 GraphLAM batch 1", gm),
                     (hm, 1, "HiLAM batch 1", None)]
        else:  # B*h = 128: HiLAM's mixed route (P1, P3 on its small sets)
            runs += [(hm, 1, "HiLAM batch 1", None),
                     (copy_with_dtype(hm, torch.bfloat16), 1,
                      "bf16 HiLAM batch 1", hm)]
        for net, B, what, net32 in runs:
            width_rollout(torch, entry, net, B, f"hidden {h} {what}", counts,
                          counts_bf16, reset_counts, plain_kernels, launched,
                          net32)
        del gm, hm, gm16, runs, net, net32
        gc.collect()
        torch.cuda.empty_cache()
        print(f"phase 19c (hidden {h}, entry.forecast): "
              f"{time.time() - t1:.1f} s")
    t1 = time.time()
    k4_d_out_cases(torch, np, counts, counts_bf16)
    print(f"phase 19b (K4's output widths): {time.time() - t1:.1f} s")
    t1 = time.time()
    width_cli_phase(torch, np, counts, counts_bf16, reset_counts,
                    plain_kernels, zero, launched)
    print(f"phase 19c (the CLIs at hidden 128): {time.time() - t1:.1f} s")
    t1 = time.time()
    width_raises(torch, np, counts, reset_counts)
    print(f"phase 19d: {time.time() - t1:.1f} s")
    # the main-path launches of each instance; P2's at 128 are 0: at B*h
    # >= 128 every static round of the bench graphs is flat (K2)
    for rec in records[first:]:
        rec["launches"] = launched.get(rec["name"], 0)
        if not rec["launches"] and rec["name"] not in (
                "edge_tail_sum@h128", "edge_tail_sum[bf16]@h128"):
            fail(f"{rec['name']}: no launch on phase 19's main paths")
    print(f"phase 19: {time.time() - t0:.1f} s")


# phase 20: the backward kernels at hidden widths 32 and 128


def bwd_width_build(_build):
    """20a: registers and spill of each backward library at widths 32 and
    128 (built with every other library in phase 1)."""
    usage_lines(_build, _build.build_all(_build.BACKWARD, widths=NEW_WIDTHS))


def bwd_main_path_cases(torch, gm, hm, rand, dt):
    """The backward kernels' cases at the training-step shapes of the
    bench GraphLAM `gm` and 4-level HiLAM `hm` at batch 4 (hidden width h
    of both; inputs of `dt` from `rand`): B1 at the step's call (no dx),
    B2 at g2m, B3/B4 at m2m[0], B5/B6 at m2g, xtd_sum at the decoder's
    pairs and xtd_reduce at their partials (GraphLAM's, timed), and B3/B4
    at HiLAM's m2m[0] and B5/B6 at its m2g (checked). Each is (kernel,
    module, args, replaces, source, bytes, FLOP, ops (fp32 FLOP on CUDA
    cores, TF32 FLOP on tensor cores; `ops_ms`), library call or None,
    timed). Bytes: each input read and each output written once in its
    dtype (no scratch). Ops: B1's and xtd_sum's products on tensor cores;
    a chain pass's two products a forward product on CUDA cores, its
    weight gradients (the third) as its xtd_sum pass runs them
    (`wgrad_tf32`); a 3xTF32 product takes three TF32 products a term,
    two where its A operand is a staged bf16 value."""
    from neural_lam_tpu_torch.ops import (
        edge_flat,
        embed,
        grid_update,
        weight_grad,
    )

    h = gm.args.hidden_dim
    bf = dt == torch.bfloat16
    isz = 2 if bf else 4
    a = 2 if bf else 3
    W = BATCH * h
    pef = "neural_lam_tpu/ops/pallas_edge_flat.py"
    pgu = "neural_lam_tpu/ops/pallas_grid_update.py"
    csrc = "neural_lam_tpu_torch/csrc/"
    cases = []
    g = gm.graph
    emb = gm.grid_embedder
    d_in = emb.layers[0].w.shape[0]
    n_grid = g.num_grid_nodes
    rows = n_grid * BATCH
    par1 = tuple(t.detach() for t in (emb.layers[0].w, emb.layers[0].b,
                                      emb.layers[1].w, emb.layers[1].b,
                                      emb.ln.scale, emb.ln.bias))
    x1, d1 = rand(n_grid, BATCH * d_in), rand(n_grid, W)
    xw, dw = x1.view(-1, d_in), d1.view(-1, h)
    w0b, w1b = par1[0].to(dt), par1[2].to(dt)
    cases.append((
        "embed_grid_flat_bwd", embed, (x1,) + par1 + (BATCH, d1, False),
        "neural_lam_tpu/ops/pallas_embed.py:111", csrc + "embed_bwd.cu",
        nbytes(x1, d1, *par1) + nbytes(*par1),
        2.0 * rows * (2 * d_in * h + 3 * h * h),
        (0.0, 2.0 * rows * (2 * a * d_in * h + 3 * 3 * h * h)),
        lambda: [torch.mm(xw, w0b), torch.mm(dw, w1b), torch.mm(dw, w1b.t()),
                 torch.mm(dw.t(), dw), torch.mm(xw.t(), dw)], True))

    def pair_mms(pairs):
        return lambda: [torch.mm(x.float().t(), d) for x, d in pairs]

    def b3_case(net, es, lay, what, timed):
        nv, K = es.num_virt, es.dense_k
        M = nv * K
        par3 = mlp_first(lay) + mlp_tail(lay)
        a3 = (rand(M, W), rand(es.num_send, W), es.senders, rand(nv, W),
              es.mask.view(nv, K)) + par3 + (rand(M, W), rand(nv, W))
        pairs = edge_flat.edge_layer_bwd_chain(*a3)[4]
        fwd = 2.0 * M * BATCH * 2 * h * h  # at every slot, as K3
        return ("edge_layer_flat_bwd", edge_flat, a3, f"{pef}:846{what}",
                csrc + "edge_flat_bwd.cu",
                nbytes(*a3) + 2 * M * W * isz + nv * W * isz
                + nbytes(*par3), 3 * fwd, (2 * fwd, wgrad_tf32(pairs)),
                pair_mms(pairs), timed)

    def b5_case(net, what, timed):
        es = net.graph.m2g
        nv, K = es.num_virt, es.dense_k
        pp = {k: v.detach() for k, v in
              grid_update.pack_grid_update_params(net).items()}
        d_out = pp["o_w1"].shape[1]
        n_g = net.graph.num_grid_nodes
        a5 = (rand(es.num_send, W), es.senders, rand(nv * K, h),
              rand(n_g, W), es.mask.view(nv, K), pp, rand(nv, BATCH * d_out))
        pairs = grid_update.grid_update_bwd_chain(*a5)[4]
        real = float(es.mask.sum())
        fwd = (2.0 * nv * BATCH * (7 * h * h + h * d_out)
               + 2.0 * real * BATCH * h * h)
        return ("grid_update_flat_bwd", grid_update, a5, f"{pgu}:752{what}",
                csrc + "grid_update_bwd.cu",
                nbytes(*a5[:5], a5[6], *pp.values()) + nv * K * (W + h) * isz
                + n_g * W * isz + nbytes(*pp.values()), 3 * fwd,
                (2 * fwd, wgrad_tf32(pairs, nv * K * BATCH, real / (nv * K))),
                pair_mms(pairs), timed), pairs

    es = g.g2m
    nv, K = es.num_virt, es.dense_k
    M = nv * K
    mask_p = es.mask.view(nv, K)
    tail = mlp_tail(gm.g2m_gnn.edge_mlp)
    a2 = (rand(es.num_send, W), es.senders, rand(M, h), rand(nv, W),
          mask_p) + tail + (rand(nv, W),)
    b2_pairs = edge_flat.edge_tail_bwd_chain(*a2)[4]
    real = float(mask_p.sum())
    fwd = 2.0 * real * BATCH * h * h
    cases.append((
        "edge_tail_sum_flat_bwd", edge_flat, a2, f"{pef}:526",
        csrc + "edge_flat_bwd.cu",
        nbytes(*a2) + M * (W + h) * isz + nv * W * isz + nbytes(*tail),
        3 * fwd, (2 * fwd, wgrad_tf32(b2_pairs, M * BATCH, real / M)),
        pair_mms(b2_pairs), True))
    cases.append(b3_case(gm, g.m2m[0], gm.processor[0].edge_mlp, "", True))
    b5, dec_pairs = b5_case(gm, "", True)
    cases.append(b5)
    cases.append((
        "xtd_sum", weight_grad, (dec_pairs,),
        f"{pgu}:752 (the decoder's nine pairs)", csrc + "weight_grad.cu",
        unique_nbytes([t for p in dec_pairs for t in p])
        + sum(h * d.shape[1] * 4 for _, d in dec_pairs),
        sum(2.0 * x.shape[0] * h * d.shape[1] for x, d in dec_pairs),
        (0.0, wgrad_tf32(dec_pairs)), pair_mms(dec_pairs), True))
    partial, pair_first = weight_grad.xtd_partials(
        dec_pairs, weight_grad.n_blocks(
            [x.shape[0] for x, _ in dec_pairs], dec_pairs[0][0].device, h))
    widths = [d.shape[1] for _, d in dec_pairs]
    red_elems = sum((b - a_) * h * w for a_, b, w
                    in zip(pair_first, pair_first[1:], widths))
    seg_pair = torch.repeat_interleave(
        torch.arange(len(widths), device="cuda"),
        torch.tensor([b - a_ for a_, b in zip(pair_first, pair_first[1:])],
                     device="cuda"))
    red_zeros = torch.zeros(len(widths), h * h, device="cuda")
    if not bf:  # one instance: its partials are fp32 in either path
        cases.append((
            "xtd_reduce", weight_grad, (partial, pair_first, widths, h),
            f"{pgu}:752 (the decoder's {pair_first[-1]} partials)",
            csrc + "weight_grad.cu", 4 * (red_elems + h * sum(widths)),
            float(red_elems), (float(red_elems), 0.0),
            lambda: red_zeros.index_add(0, seg_pair,
                                        partial[:pair_first[-1]]), True))
    hg = hm.graph
    cases.append(b3_case(hm, hg.m2m[0],
                         hm.mesh_up_same_gnns[0][0].edge_mlp,
                         " (HiLAM m2m[0])", False))
    cases.append(b5_case(hm, " (HiLAM m2g)", False)[0])
    return cases



def bwd_check(torch, counts, counts_bf16, name, mod, args, dt, what):
    """`fp32_check` (per tensor) or `bf16_bwd_check` by dtype: (rule, max
    abs)."""
    if dt == torch.bfloat16:
        share, err = bf16_bwd_check(torch, counts_bf16, name, mod, args,
                                    what)
        return (f"bf16 outputs within one bf16 ulp ({share:.5f} not "
                "bit-equal), fp32 gradients within 1e-4 + 1e-4*max"), err
    err = fp32_check(torch, counts, name, mod, args, what, per_tensor=True)
    return "within 1e-4 + 1e-4*max|plain| per tensor", err


def bwd_width_kernel_cases(torch, h, counts, counts_bf16, records, peaks):
    """20b at hidden width h: each backward kernel's fp32 and bf16
    instances at the training-step shapes of the bench GraphLAM and
    4-level HiLAM built at that width (`bwd_main_path_cases`), against
    their plain versions, two calls bit-identical; GraphLAM's timed beside
    the plain version, the products as torch.mm (TF32 off) and the bound,
    one record a kernel instance, named `<kernel>[bf16]@h<h>`."""
    from neural_lam_tpu_torch import entry

    peak_flops, peak_tf32, peak_bw = peaks
    t0 = time.time()
    cfg = dict(BENCH, hidden_dim=h)
    gm, _ = entry.build_model(**cfg, device="cuda")
    hm, _ = entry.build_model(**cfg, device="cuda", model="hi_lam")
    print(f"hidden {h}: bench GraphLAM and 4-level HiLAM built in "
          f"{time.time() - t0:.1f} s")
    with torch.no_grad():
        for dt in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device="cuda").manual_seed(20)

            def rand(*shape):
                return torch.randn(*shape, device="cuda",
                                   generator=gen).to(dt)

            bf = dt == torch.bfloat16
            for (name, mod, args, replaces, source, bytes_, flops, ops,
                 lib, timed) in bwd_main_path_cases(torch, gm, hm, rand, dt):
                at = f"hidden {h}, {replaces}"
                rule, err = bwd_check(torch, counts, counts_bf16, name, mod,
                                      args, dt, at)
                tag = f"{name}{'[bf16]' if bf else ''}@h{h}"
                if not timed:
                    print(f"{tag} at {replaces}: {rule}, max abs err "
                          f"{err:.3e}, two calls bit-identical")
                    continue
                kern, plain = getattr(mod, name), getattr(mod, name + "_plain")
                ms = cuda_ms(torch, lambda: kern(*args), 10)
                plain_ms = cuda_ms(torch, lambda: plain(*args), 2)
                lib_ms = cuda_ms(torch, lib, 10)
                t_bytes = bytes_ / peak_bw * 1e3
                t_ops = ops_ms(ops, peak_flops, peak_tf32)
                bound = max(t_bytes, t_ops)
                print(f"{tag}: {rule}, max abs err {err:.3e}, two calls "
                      f"bit-identical; kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
                      f"{bound:.4f} ms ({bytes_ / 1e6:.1f} MB: "
                      f"{t_bytes:.4f} ms; {flops / 1e9:.2f} GFLOP as "
                      f"{ops[0] / 1e9:.2f} fp32 and {ops[1] / 1e9:.2f} TF32: "
                      f"{t_ops:.4f} ms)")
                records.append({
                    "name": tag, "route": "cuda", "source": source,
                    "replaces": replaces.split(" (")[0], "launches": None,
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound,
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "library_ms": lib_ms})
    del gm, hm
    gc.collect()
    torch.cuda.empty_cache()


def bwd_wide_cases(torch, np, counts, counts_bf16):
    """20b: B1 at d_in 160 (x staged in column chunks) and B5/B6 at output
    maps wider than the width, fp32 and bf16, on seeded inputs: d_in 160
    at h 32, 64 and 128 (20,000 node rows, batch 4); B5/B6 on a seeded
    local graph (20,000 receivers, K = 4 among 6,561 senders, batch 4) at
    d_out 80 and 200 (h 64), 34 (h 32) and 160 (h 128); against their
    plain versions, two calls bit-identical."""
    from neural_lam_tpu_torch.ops import embed, grid_update
    from neural_lam_tpu_torch.ops.message_passing import EdgeSet

    rng = np.random.default_rng(20)
    n_rec, n_send, K = 20000, 6561, 4
    centre = (np.arange(n_rec) * n_send // n_rec)[:, None]
    send = np.clip(centre + rng.integers(-4, 5, (n_rec, K)), 0,
                   n_send - 1).reshape(-1)
    es = EdgeSet.from_local(
        send, np.repeat(np.arange(n_rec), K),
        rng.standard_normal((K * n_rec, 3)).astype(np.float32), n_send,
        n_rec, device="cuda", build_transpose=False)
    nv = es.num_virt
    gen = torch.Generator(device="cuda").manual_seed(21)
    for dt in (torch.float32, torch.bfloat16):
        def rand(*shape, scale=1.0):
            return (scale * torch.randn(*shape, device="cuda",
                                        generator=gen)).to(dt)

        def w(*shape):
            return torch.randn(*shape, device="cuda",
                               generator=gen) / shape[0] ** 0.5

        tag = "[bf16]" if dt == torch.bfloat16 else ""
        for h in (32, 64, 128):
            d_in = 160
            par = (w(d_in, h), 0.1 * w(h, 1)[:, 0], w(h, h), 0.1 * w(h, 1)[:, 0],
                   1 + 0.1 * w(h, 1)[:, 0], 0.1 * w(h, 1)[:, 0])
            for need_dx in (False, True):
                args = (rand(n_rec, BATCH * d_in),) + par + (
                    BATCH, rand(n_rec, BATCH * h), need_dx)
                rule, err = bwd_check(torch, counts, counts_bf16,
                                      "embed_grid_flat_bwd", embed, args, dt,
                                      f"d_in {d_in}, hidden {h}")
                print(f"embed_grid_flat_bwd{tag}@h{h} at d_in {d_in} "
                      f"({'with' if need_dx else 'no'} dx): {rule}, max abs "
                      f"err {err:.3e}, two calls bit-identical")
        for h, d_out in ((64, 80), (64, 200), (32, 34), (128, 160)):
            pp = {k: w(2 * h if k == "a_w0" else h, h)
                  for k in grid_update._MATS}
            pp.update({k: 0.1 * w(h, 1)[:, 0] for k in grid_update._VECS})
            for k in ("enc_ls", "e_ls", "a_ls"):
                pp[k] = 1 + pp[k]
            pp.update(o_w1=w(h, d_out), o_b1=0.1 * w(d_out, 1)[:, 0])
            a5 = (rand(n_send, BATCH * h), es.senders, rand(nv * K, h),
                  rand(n_rec, BATCH * h), es.mask.view(nv, K), pp,
                  rand(nv, BATCH * d_out))
            rule, err = bwd_check(torch, counts, counts_bf16,
                                  "grid_update_flat_bwd", grid_update, a5,
                                  dt, f"d_out {d_out}, hidden {h}")
            print(f"grid_update_flat_bwd{tag}@h{h} at d_out {d_out} (local "
                  f"graph K={K}, {nv} rows, batch 4): {rule}, max abs err "
                  f"{err:.3e}, two calls bit-identical")


def busy_ms_of(torch, fn):
    """(fn(), device busy ms of the call): the device time of its kernels
    in a device-only torch.profiler trace, or None when the profiler saw
    none."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    us = sum(r[0] for r in kernel_rows(torch, prof))
    return out, (us / 1e3 if us else None)


def train_tables(net, B, bf):
    """(fp32 counts, bf16 counts) of a training step (ar_steps 1) of `net`
    at batch B, from `step_table`'s forward launches (`train_table`): in
    bf16, every kernel on the bf16 counters but P1 and B2's xtd_sum and
    reduce launches (its pair is the chain's fp32 X1, DY)."""
    fwd = step_table(net, B)[0]
    t = train_table(fwd)
    if not bf:
        return t, {}
    n_b2 = fwd["edge_tail_sum_flat"]
    want16 = {k: n for k, n in t.items() if k != "edge_tail"}
    want16["xtd_sum"] = want16["xtd_reduce"] = t["xtd_sum"] - n_b2
    return {"edge_tail": fwd["edge_tail"], "xtd_sum": n_b2,
            "xtd_reduce": n_b2}, want16


def bwd_width_training(torch, np, counts, counts_bf16, reset_counts,
                       plain_kernels, launched):
    """20c: `train.main` at hidden 32 and 128 for GraphLAM and HiLAM at
    batch 4, fp32 and `--precision bf16`, 4 AdamW steps each on a
    268x238 MDP datastore. Every counter at 0 just before each step: its
    launches equal `train_tables`'s. Before the first step, its gradients
    on the same weights and batch: fp32, kernel path against plain path
    within 1e-3 of each parameter's max abs (phase 7's limit); bf16, the
    kernel path's error against the fp32 gradients the plain bf16 path's
    size (phase 12's `error_size`). Per step: host ms (synchronised) and
    peak device memory; the last step's device busy ms from a device-only
    profile."""
    import tempfile
    from pathlib import Path

    from neural_lam_tpu_torch import train

    L = BENCH["processor_layers"]
    real_step = train.Trainer.train_step
    with tempfile.TemporaryDirectory(prefix="nlt_bwd_widths_") as tmp:
        root = Path(tmp)
        t0 = time.time()
        cfg = write_mdp_datastore(root, np)
        print(f"MDP datastore written in {time.time() - t0:.1f} s")
        for h in NEW_WIDTHS:
            for kind, graph in (("graph_lam", "multiscale"),
                                ("hi_lam", "hierarchical")):
                for bf in (False, True):
                    what = (f"train.main {kind} --hidden_dim {h}"
                            + (" --precision bf16" if bf else ""))
                    rec = {"n": 0, "lines": []}

                    def step(self, batch, rec=rec, what=what, bf=bf, h=h):
                        net = self.model
                        rec["want"] = train_tables(net, batch[0].shape[0],
                                                   bf)
                        if rec["n"] == 0:
                            grads_check(torch, net, batch, bf,
                                        plain_kernels, what)
                        reset_counts()
                        torch.cuda.reset_peak_memory_stats()
                        live = torch.cuda.memory_allocated()
                        torch.cuda.synchronize()
                        t_in = time.perf_counter()
                        if rec["n"] < 3:
                            loss, busy = real_step(self, batch), None
                            torch.cuda.synchronize()
                        else:  # the last step under a device-only profile
                            loss, busy = busy_ms_of(
                                torch, lambda: real_step(self, batch))
                        host = (time.perf_counter() - t_in) * 1e3
                        c32, c16 = counts(), counts_bf16()
                        peak = torch.cuda.max_memory_allocated()
                        want32, want16 = rec["want"]
                        if (any(c32[k] != want32.get(k, 0) for k in c32)
                                or any(c16[k] != want16.get(k, 0)
                                       for k in c16)):
                            fail(f"{what} step {rec['n'] + 1}: launches "
                                 f"{c32} (fp32), {c16} (bf16); want "
                                 f"{want32}, {want16}")
                        for k, n in c32.items():
                            if n and k not in FWD + BATCHED:
                                key = f"{k}@h{h}"
                                launched[key] = launched.get(key, 0) + n
                        for k, n in c16.items():
                            if n and k not in FWD + BATCHED:
                                key = f"{k}[bf16]@h{h}"
                                launched[key] = launched.get(key, 0) + n
                        rec["n"] += 1
                        rec["lines"].append(
                            f"step {rec['n']}: loss {float(loss):.6f}, host "
                            f"{host:.1f} ms"
                            + ("" if busy is None else
                               f" (under the profiler), device busy "
                               f"{busy:.1f} ms")
                            + f", peak {peak / 2**30:.3f} GiB "
                            f"({(peak - live) / 2**30:.3f} above the live "
                            f"{live / 2**30:.3f})")
                        if not math.isfinite(float(loss)):
                            fail(f"{what}: loss {float(loss)}")
                        return loss

                    argv = ["--config_path", str(cfg), "--model", kind,
                            "--graph", graph, "--hidden_dim", str(h),
                            "--processor_layers", str(L), "--batch_size",
                            str(BATCH), "--ar_steps_train", "1",
                            "--ar_steps_eval", "1", "--val_interval", "1000",
                            "--max_steps", "4", "--seed", "0",
                            "--num_workers", "0", "--save_dir",
                            str(root / "models"), "--run_name",
                            f"{kind}_{h}_{int(bf)}"]
                    if bf:
                        argv += ["--precision", "bf16"]
                    t1 = time.time()
                    train.Trainer.train_step = step
                    try:
                        quiet(train.main, argv)
                    finally:
                        train.Trainer.train_step = real_step
                    torch.cuda.synchronize()
                    if rec["n"] != 4:
                        fail(f"{what}: {rec['n']} steps, want 4")
                    want32, want16 = rec["want"]
                    print(f"{what} ({time.time() - t1:.1f} s): launches a "
                          f"step { {k: n for k, n in want32.items() if n} }"
                          + (f" fp32, {want16} bf16" if bf else "")
                          + "; " + "; ".join(rec["lines"]))
                    gc.collect()
                    torch.cuda.empty_cache()


def grads_check(torch, net, batch, bf, plain_kernels, what):
    """One training step's gradients of `net` on `batch`: fp32, kernel
    path against plain path within 1e-3 of each parameter's max abs; bf16,
    the kernel path's error against the fp32 gradients (`copy_with_dtype`
    on the same weights) the plain bf16 path's size."""

    def grads(m):
        m.zero_grad(set_to_none=True)
        m.training_loss(batch).backward()
        out = {k: p.grad.detach().clone() for k, p in m.named_parameters()}
        m.zero_grad(set_to_none=True)
        return out

    g_k = grads(net)
    with plain_kernels():
        g_p = grads(net)
    if not bf:
        worst = max((float((g_k[k] - g_p[k]).abs().max())
                     / max(float(g_p[k].abs().max()), 1e-30), k)
                    for k in g_p)
        print(f"{what}: first-step gradients, kernels vs plain on the card: "
              f"worst max abs gap / max abs {worst[0]:.3e} ({worst[1]}; "
              f"limit 1e-3), {len(g_p)} parameters")
        if not worst[0] <= 1e-3:
            fail(f"{what}: kernel-path and plain-path gradients disagree")
        return
    g_32 = grads(copy_with_dtype(net, None))
    scale = {k: float(v.abs().max()) or 1.0 for k, v in g_32.items()}

    def vec(gr):
        return torch.cat([(gr[k] / scale[k]).flatten() for k in g_32])

    error_size(torch, f"{what} first-step gradients (each parameter's over "
               f"its fp32 max abs, {len(g_32)} parameters)", vec(g_k),
               vec(g_p), vec(g_32))


def bwd_widths_phase(torch, np, counts, counts_bf16, reset_counts,
                     plain_kernels, records, peaks):
    """Phase 20 (see the module doc)."""
    from neural_lam_tpu_torch.ops import _build

    t0 = time.time()
    bwd_width_build(_build)
    print(f"phase 20a: {time.time() - t0:.1f} s")
    first = len(records)
    for h in NEW_WIDTHS:
        t1 = time.time()
        bwd_width_kernel_cases(torch, h, counts, counts_bf16, records, peaks)
        print(f"phase 20b (hidden {h}): {time.time() - t1:.1f} s")
    t1 = time.time()
    bwd_wide_cases(torch, np, counts, counts_bf16)
    print(f"phase 20b (B1 at d_in 160, B5/B6's output widths): "
          f"{time.time() - t1:.1f} s")
    t1 = time.time()
    launched = {}
    bwd_width_training(torch, np, counts, counts_bf16, reset_counts,
                       plain_kernels, launched)
    print(f"phase 20c: {time.time() - t1:.1f} s; launches on the training "
          f"paths {launched}")
    for rec in records[first:]:
        rec["launches"] = launched.get(rec["name"], 0)
        if not rec["launches"]:
            fail(f"{rec['name']}: no launch on phase 20's training paths")
    print(f"phase 20: {time.time() - t0:.1f} s")


def copy_with_dtype(net, dtype):
    """A shallow copy of `net` that computes in `dtype` (None: fp32) on the
    same weights and graph."""
    import copy

    twin = copy.copy(net)
    twin.compute_dtype = dtype
    return twin


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

    # 1. build (every source at every width: phases 19 and 20 too)
    t0 = time.time()
    libs = _build.build_all(widths=_build.WIDTHS)
    print(f"kernel build: {time.time() - t0:.1f} s for {len(libs)} libraries "
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
    # every listing below at once (cuobjdump, one thread a library)
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if os.path.exists(tool):
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(8) as pool:
            list(pool.map(lambda k: sass_of(tool, libs[k]), (
                "edge_flat_bwd", "edge_flat", "edge", "embed", "grid_update",
                "weight_grad", "embed_bwd")))
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
    sass_counts(_build, libs["grid_update"], "grid_update_kernelILi4EfLb1EE")
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
        bwd_bytes = (nbytes(*bwd_args) + M * (W + H) * 4 + n_virt * W * 4
                     + nbytes(*tail))
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
                                        xtd_pairs[0][0].device, H))
    widths = [d.shape[1] for _, d in xtd_pairs]
    red_elems = sum((b - a) * H * w for a, b, w
                    in zip(pair_first, pair_first[1:], widths))
    cases.append(("xtd_reduce", weight_grad,
                  (partial, pair_first, widths, H),
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
    library["xtd_reduce"] = lambda partial, pair_first, widths, h: (
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
            if "(local graph K=" in replaces:
                # the K sweep: each K held, not timed (the main-path
                # shapes are)
                print(f"{kname} at {replaces[replaces.index('(') + 1:-1]}: "
                      f"max_abs_err {err:.3e} (not timed)")
                continue
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
            elif kname in ("edge_tail_sum_flat_bwd", "edge_layer_flat_bwd",
                           "grid_update_flat_bwd"):
                # a chain pass (two thirds, fp32 CUDA cores), then its
                # xtd_sum pass (the weight gradients' third, 3xTF32 on
                # fp32 pairs)
                fp32_note = (f"; fp32 CUDA-core bound "
                             f"{max(t_bytes, t_ops):.4f} ms")
                t_ops = ops_ms((2 * flops / 3, flops), peak_flops, peak_tf32)
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

    # 14. HiLAMParallel
    hilam_parallel_phase(torch, np, counts, counts_bf16, reset_counts,
                         plain_kernels, zero_all, peak_tf32, peak_bw)
    gc.collect()
    torch.cuda.empty_cache()
    phase_end("14 (HiLAMParallel)")

    # 15. GraphEFM and HiEFM, ensembles, the global configuration
    latent_phase(torch, np, counts, counts_bf16, reset_counts, plain_kernels,
                 zero_all)
    gc.collect()
    torch.cuda.empty_cache()
    phase_end("15 (GraphEFM, HiEFM and ensembles)")

    # 16. data parallelism and the grid scheme on 2 ranks of the one card;
    # 17. the mesh-node-sharded schemes on 2 ranks
    parallel_phase(torch, np, counts, reset_counts)
    gc.collect()
    torch.cuda.empty_cache()
    phase_end("16-17 (data parallelism and the spatial schemes, 2 ranks)")

    # 18. the export path, the kernels' operators, hidden_layers 2, the
    # graph page
    export_phase(torch, np, counts, counts_bf16, reset_counts)
    gc.collect()
    torch.cuda.empty_cache()
    phase_end("18 (export, operators, hidden_layers 2, graph page)")

    # 19. the forward kernels at hidden widths 32 and 128
    widths_phase(torch, np, counts, counts_bf16, reset_counts, plain_kernels,
                 zero_all, records, (peak_flops, peak_tf32, peak_bw))
    gc.collect()
    torch.cuda.empty_cache()
    phase_end("19 (the forward kernels at hidden widths 32 and 128)")

    # 20. the backward kernels at hidden widths 32 and 128
    bwd_widths_phase(torch, np, counts, counts_bf16, reset_counts,
                     plain_kernels, records,
                     (peak_flops, peak_tf32, peak_bw))
    gc.collect()
    torch.cuda.empty_cache()
    phase_end("20 (the backward kernels at hidden widths 32 and 128)")

    print(json.dumps({"kernels": records}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        sys.exit(parallel_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--rs-rank"]:
        sys.exit(rs_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--export-load"]:
        sys.exit(export_load_main(sys.argv[2:]))
    sys.exit(main())
