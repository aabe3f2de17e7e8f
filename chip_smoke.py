#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero, and no
result line is printed):

1. Build every CUDA kernel of the forecast and training paths from `csrc/`
   with nvcc (one process per source, all started together); print the
   build time and each source's ptxas registers and spills.
2. Build the bench-width GraphLAM through `neural_lam_tpu_torch.entry`
   (268x238 grid, 17 state / 6x3 forcing / 4 static features, hidden 64,
   4 processor layers, batch 4, fp32, weights from a seeded generator).
3. For each forward kernel (K1-K4), at the shapes that model gives it:
   hold the kernel against its plain PyTorch version on the card (TF32
   off), and time both with CUDA events beside the least time the card
   could take.
4. The same for each backward kernel (B1, B2, B3/B4, B5/B6) against its
   `*_bwd_plain` version: every output tensor within 1e-4 + 1e-4 * its
   plain version's max abs.
5. The forecast path: a 4-step rollout with every launch counter set to 0
   just before it, asserting 1/1/4/1 launches of K1/K2/K3/K4 per predict
   step and finite output; then the time per predict step, the mesh-node
   updates/s (bench.py's metric), a torch.profiler breakdown of device
   time by kernel with the device's idle share, and the gap between one
   kernel-path and one plain-path predict step on the card.
6. A small model (16x16 grid) built on the CPU and on the card from one
   seed: the card's rollout (kernels) agrees with the CPU's (plain versions).
7. The training path at bench width: one AdamW step through
   `entry.train_steps` with every counter set to 0 just before it,
   asserting 1/1/4/1 launches of K1-K4 and of B1/B2/B3/B5 and a finite
   loss; one step's parameter gradients on the kernel path against the
   plain path within 1e-3 * max abs; the training-step time (host clock
   around a synchronised step, median of 7 after warm-up), samples/s,
   peak device memory and a profiler breakdown of a step.
8. The 16x16 model trained 3 AdamW steps on the card and on the CPU:
   the loss trajectories agree within rtol 1e-4.

The last three lines are the `kernels` JSON, the card's name and power
limit as nvidia-smi reports them, and {"ok": true, "device": {...}}.
Imports nothing of JAX or of the JAX package.
"""

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time

BENCH = dict(nx=268, ny=238, hidden_dim=64, processor_layers=4,
             n_features={"state": 17, "forcing": 6, "static": 4},
             n_timesteps=20)
BATCH = 4
STEPS = 4
H = 64
FWD = ("embed_grid_flat", "edge_tail_sum_flat", "edge_layer_flat",
       "grid_update_flat")


def fail(msg):
    raise RuntimeError(msg)


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def peaks(device_name):
    """(fp32 FLOP/s without tensor cores, memory bytes/s, label) from the
    data sheet of the named card."""
    if "H100" in device_name and "PCIe" in device_name:
        return 51.2e12, 2.0e12, "H100 PCIe: 51.2 TFLOP/s fp32, 2.0 TB/s"
    if "H100" in device_name and "NVL" in device_name:
        return 60e12, 3.9e12, "H100 NVL: 60 TFLOP/s fp32, 3.9 TB/s"
    return 67e12, 3.35e12, "H100 SXM: 67 TFLOP/s fp32, 3.35 TB/s"


def cuda_ms(torch, fn, reps):
    """Mean ms per call over `reps` calls, from CUDA events, after a
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from neural_lam_tpu_torch import entry
    from neural_lam_tpu_torch.ops import _build, edge_flat, embed, grid_update

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    print(smi)
    name = torch.cuda.get_device_name(0)
    peak_flops, peak_bw, peak_label = peaks(name)
    print(f"device: {name}; peaks used for bounds: {peak_label}")
    mods = {"embed_grid_flat": embed, "edge_tail_sum_flat": edge_flat,
            "edge_layer_flat": edge_flat, "grid_update_flat": grid_update}
    wrappers = {}
    for k, m in mods.items():
        wrappers[k] = getattr(m, k)
        wrappers[k + "_bwd"] = getattr(m, k + "_bwd")

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
            setattr(m, k, lambda *a, fold=None, _p=plain: _p(*a))
        try:
            yield
        finally:
            for k, m in mods.items():
                setattr(m, k, wrappers[k])

    # 1. build
    t0 = time.time()
    libs = _build.build_all()
    print(f"kernel build: {time.time() - t0:.1f} s for {len(libs)} sources "
          f"({', '.join(p.name for p in libs.values())})")
    for src in libs:
        log = _build.build_log(src)
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill", log)]
        print(f"  ptxas[{src}]: {len(regs)} kernels, {min(regs)}-{max(regs)} "
              f"registers, {sum(spills)} bytes of spill stores and loads")

    # 2. the bench-width model
    t0 = time.time()
    model, datastore = entry.build_model(**BENCH, device="cuda")
    g = model.graph
    print(f"model built in {time.time() - t0:.1f} s: N_grid="
          f"{g.num_grid_nodes}, N_mesh={model.num_mesh_nodes}, "
          f"g2m K={g.g2m.dense_k} rows={g.g2m.num_virt}, m2m "
          f"K={g.m2m[0].dense_k} rows={g.m2m[0].num_virt}, m2g "
          f"K={g.m2g.dense_k} rows={g.m2g.num_virt}")

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
    cases.append(("embed_grid_flat", embed, k1 + (BATCH,),
                  "neural_lam_tpu/ops/pallas_embed.py:99",
                  nbytes(*k1) + rows1 * H * 4,
                  2.0 * rows1 * (d_in * H + H * H)))
    cases.append(("embed_grid_flat_bwd", embed,
                  k1 + (BATCH, rand(n_grid, W)),
                  "neural_lam_tpu/ops/pallas_embed.py:111",
                  nbytes(*k1) + rows1 * (H + d_in) * 4 + nbytes(*k1[1:]),
                  2.0 * rows1 * 3 * (d_in * H + H * H)))

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
    a5 = a4 + (rand(n_virt, BATCH * d_out),)
    cases.append(("grid_update_flat_bwd", grid_update, a5, f"{pgu}:752",
                  in4 + nbytes(a5[-1]) + n_virt * K * (W + H) * 4
                  + n_grid * W * 4 + nbytes(*pp.values()),
                  3 * (node_flops + edge_flops4)))

    records = []
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
            bwd = kname.endswith("_bwd")
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
            plain_ms = cuda_ms(torch, lambda: plain(*args), 3 if bwd else 5)
            t_bytes = bytes_ / peak_bw * 1e3
            t_ops = flops / peak_flops * 1e3
            bound_ms = max(t_bytes, t_ops)
            rule = ("1e-4 + 1e-4*max|plain| per tensor" if bwd
                    else "1e-4 + 1e-4*|plain|")
            print(f"{kname}: max_abs_err {err:.3e} (tol {rule}); kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({bytes_ / 1e6:.1f} MB, "
                  f"{flops / 1e9:.2f} GFLOP)")
            base = os.path.basename(mod.__file__)[:-3]
            records.append({
                "name": kname, "route": "cuda",
                "source": f"neural_lam_tpu_torch/csrc/{base}"
                          f"{'_bwd' if bwd else ''}.cu",
                "replaces": replaces, "launches": None,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None,
            })
    del cases, args, a4, a5, k1
    torch.cuda.empty_cache()

    # 5. the forecast path
    init, forcing, true = entry.make_inputs(model, BATCH, STEPS, seed=0)
    entry.forecast(model, init, forcing[:, :1], true[:, :1])  # warm-up
    reset_counts()
    pred = entry.forecast(model, init, forcing, true)
    torch.cuda.synchronize()
    fwd_counts = counts()
    if tuple(pred.shape) != (BATCH, STEPS, g.num_grid_nodes, 17):
        fail(f"rollout shape {tuple(pred.shape)}")
    if not bool(torch.isfinite(pred).all()):
        fail("rollout output is not finite")
    want = {"embed_grid_flat": 1, "edge_tail_sum_flat": 1,
            "edge_layer_flat": BENCH["processor_layers"],
            "grid_update_flat": 1}
    print(f"rollout: {STEPS} steps, output {tuple(pred.shape)} finite; "
          f"launches per step "
          f"{ {k: fwd_counts[k] / STEPS for k in FWD} }")
    if any(fwd_counts[k] != want[k] * STEPS for k in want) or any(
            fwd_counts[k + "_bwd"] for k in FWD):
        fail(f"launch counts {fwd_counts}, want {want} per step and no "
             "backward launch")

    def rollout_s(steps):
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            entry.forecast(model, init, forcing[:, :steps], true[:, :steps])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return sorted(times)[2]

    t1, tn = rollout_s(1), rollout_s(STEPS)
    ms_step = (tn - t1) / (STEPS - 1) * 1e3
    updates = model.num_mesh_nodes * BENCH["processor_layers"] * BATCH \
        * 1e3 / ms_step
    print(f"predict step: {ms_step:.3f} ms (batch {BATCH}; median of 5, "
          f"{STEPS}-step minus 1-step rollout); {updates:.4e} mesh-node "
          f"updates/s")

    with torch.no_grad():
        ctx = model.precompute_rollout_ctx()
        profile(torch, lambda: model.predict_step(
            init[:, 1], init[:, 0], forcing[:, 0], ctx), "predict step")
        step_k, _ = model.predict_step(init[:, 1], init[:, 0], forcing[:, 0])
        with plain_kernels():
            step_p, _ = model.predict_step(init[:, 1], init[:, 0],
                                           forcing[:, 0])
    gap = float((step_k - step_p).abs().max())
    print(f"predict step, kernels vs plain versions on the card: max abs "
          f"gap {gap:.3e} (limit 1e-3)")
    if not gap <= 1e-3:
        fail("kernel path and plain path disagree")
    del init, forcing, true, pred, step_k, step_p, ctx

    # 6. small model: card (kernels) against CPU (plain versions)
    small = dict(nx=16, ny=16, hidden_dim=64, processor_layers=2,
                 n_timesteps=20)
    preds = []
    for dev in ("cpu", "cuda"):
        m, _ = entry.build_model(**small, device=dev, seed=1)
        inputs = entry.make_inputs(m, 2, 3, seed=1)
        preds.append(entry.forecast(m, *inputs).cpu())
    small_gap = float((preds[0] - preds[1]).abs().max())
    print(f"16x16 rollout, card vs CPU: max abs gap {small_gap:.3e} "
          f"(limit 5e-4)")
    if not small_gap <= 5e-4:
        fail("card and CPU rollouts disagree")

    # 7. the training path at bench width
    entry.train_steps(model, datastore, BATCH, 1, steps=1, seed=0,
                      device="cuda")  # warm-up
    reset_counts()
    losses = entry.train_steps(model, datastore, BATCH, 1, steps=1, seed=1,
                               device="cuda")
    torch.cuda.synchronize()
    train_counts = counts()
    want_train = dict(want, **{k + "_bwd": n for k, n in want.items()})
    print(f"training step: loss {losses[0]:.6f}; launches {train_counts}")
    if not all(map(math.isfinite, losses)):
        fail(f"training loss is not finite: {losses}")
    if train_counts != want_train:
        fail(f"training launch counts {train_counts}, want {want_train}")
    for rec in records:
        n = rec["name"]
        rec["launches"] = (train_counts[n] if n.endswith("_bwd")
                           else fwd_counts[n])

    trainer, dm = entry.make_trainer(model, datastore, BATCH, 1, seed=2)
    batch = next(trainer.train_batches(dm, 0))

    def grads():
        model.zero_grad(set_to_none=True)
        model.training_loss(batch).backward()
        return {k: p.grad.detach().clone()
                for k, p in model.named_parameters()}

    g_k = grads()
    with plain_kernels():
        g_p = grads()
    worst = max((float((g_k[k] - g_p[k]).abs().max())
                 / max(float(g_p[k].abs().max()), 1e-30), k) for k in g_p)
    print(f"training gradients, kernels vs plain versions on the card: "
          f"worst max abs gap / max abs {worst[0]:.3e} ({worst[1]}; limit "
          f"1e-3), {len(g_p)} parameters")
    if not worst[0] <= 1e-3:
        fail("kernel-path and plain-path gradients disagree")
    del g_k, g_p
    model.zero_grad(set_to_none=True)

    times = []
    for i in range(9):
        torch.cuda.synchronize()
        if i == 2:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if i == 2:
            peak = torch.cuda.max_memory_allocated()
    ms_train = sorted(times[2:])[3] * 1e3
    print(f"train step (fwd+bwd+AdamW, ar_steps 1, batch {BATCH}): "
          f"{ms_train:.3f} ms (median of 7 after 2 warm-up steps); "
          f"{4000 / ms_train:.2f} samples/s; peak device memory "
          f"{peak / 2**30:.3f} GiB (max_memory_allocated over one step)")
    profile(torch, lambda: trainer.train_step(batch), "train step")
    del trainer, dm, batch, model
    torch.cuda.empty_cache()

    # 8. small model trained on the card and on the CPU
    trajectories = []
    for dev in ("cpu", "cuda"):
        m, ds = entry.build_model(**small, device=dev, seed=1)
        trajectories.append(entry.train_steps(m, ds, 2, 1, steps=3, seed=1,
                                              device=dev))
    rel = max(abs(a - b) / abs(a) for a, b in zip(*trajectories))
    print(f"16x16 training, 3 AdamW steps: CPU losses {trajectories[0]}, "
          f"card losses {trajectories[1]}; max rel gap {rel:.3e} "
          f"(limit 1e-4)")
    if not rel <= 1e-4:
        fail("card and CPU training trajectories disagree")

    print(json.dumps({"kernels": records}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
