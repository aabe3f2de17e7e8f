#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero, and no
result line is printed):

1. Build every CUDA kernel of the forecast path from `csrc/` with nvcc
   (one process per source, all started together) and print the build time.
2. Build the bench-width GraphLAM through `neural_lam_tpu_torch.entry`
   (268x238 grid, 17 state / 6x3 forcing / 4 static features, hidden 64,
   4 processor layers, batch 4, fp32, weights from a seeded generator).
3. For each kernel, at the shapes that model gives it: hold the kernel
   against its plain PyTorch version on the card (TF32 off), and time both
   with CUDA events beside the least time the card could take.
4. The main path: a 4-step forecast rollout with every launch counter set
   to 0 just before it, asserting 1/1/4/1 launches of K1/K2/K3/K4 per
   predict step and finite output; then the time per predict step, the
   mesh-node updates/s (bench.py's metric), a torch.profiler breakdown of
   device time by kernel with the device's idle share, and the gap between
   one kernel-path and one plain-path predict step on the card.
5. A small model (16x16 grid) built on the CPU and on the card from one
   seed: the card's rollout (kernels) agrees with the CPU's (plain versions).

The last three lines are the `kernels` JSON, the card's name and power
limit as nvidia-smi reports them, and {"ok": true, "device": {...}}.
Imports nothing of JAX or of the JAX package.
"""

import contextlib
import json
import os
import re
import subprocess
import sys
import time

BENCH = dict(nx=268, ny=238, hidden_dim=64, processor_layers=4,
             n_features={"state": 17, "forcing": 6, "static": 4},
             n_timesteps=8)
BATCH = 4
STEPS = 4
H = 64


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


def profile_steps(torch, model, init, forcing, steps=3, top=12):
    """Device time by kernel over `steps` predict steps (torch.profiler),
    and the device's busy share of the profiled window's wall time (the
    profiler's own host overhead lengthens that window)."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        ctx = model.precompute_rollout_ctx()

        def step():
            model.predict_step(init[:, 1], init[:, 0], forcing[:, 0], ctx)

        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps

    def dev_us(e):
        v = getattr(e, "self_device_time_total", None)
        return v if v is not None else getattr(e, "self_cuda_time_total", 0)

    # device-side events only: a host op's row repeats its kernels' time
    rows = sorted(((dev_us(e), e.count, e.key) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and dev_us(e) > 0), reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3 / steps
    if not rows:
        print("profile: the profiler recorded no device time "
              "(device busy share not measured)")
        return
    print(f"profile of {steps} predict steps: device busy {busy_ms:.3f} "
          f"ms/step of {wall_ms:.3f} ms wall/step under the profiler "
          f"(idle share {1 - busy_ms / wall_ms:.3f})")
    for us, count, key in rows[:top]:
        print(f"  {us / 1e3 / steps:.4f} ms/step  {count / steps:g} "
              f"calls/step  {key[:90]}")


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
    model, _ = entry.build_model(**BENCH, device="cuda")
    g = model.graph
    print(f"model built in {time.time() - t0:.1f} s: N_grid="
          f"{g.num_grid_nodes}, N_mesh={model.num_mesh_nodes}, "
          f"g2m K={g.g2m.dense_k} rows={g.g2m.num_virt}, m2m "
          f"K={g.m2m[0].dense_k} rows={g.m2m[0].num_virt}, m2g "
          f"K={g.m2g.dense_k} rows={g.m2g.num_virt}")

    # 3. every kernel against its plain version at the main path's shapes
    gen = torch.Generator(device="cuda").manual_seed(0)
    W = BATCH * H

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    records = []
    with torch.no_grad():
        emb = model.grid_embedder
        d_in = emb.layers[0].w.shape[0]
        n_grid = g.num_grid_nodes
        x_f = rand(n_grid, BATCH * d_in)
        k1 = (x_f, emb.layers[0].w, emb.layers[0].b, emb.layers[1].w,
              emb.layers[1].b, emb.ln.scale, emb.ln.bias, BATCH)
        rows1 = n_grid * BATCH
        cases = [(
            "embed_grid_flat", embed, k1,
            "neural_lam_tpu/ops/pallas_embed.py:99",
            nbytes(*k1[:7]) + rows1 * H * 4,
            2.0 * rows1 * (d_in * H + H * H),
        )]

        def edge_case(edges, inet, layer):
            n_virt, K = edges.num_virt, edges.dense_k
            mask_p = edges.mask.view(n_virt, K)
            mlp = inet.edge_mlp
            tail = (mlp.layers[1].w, mlp.layers[1].b, mlp.ln.scale,
                    mlp.ln.bias)
            table = rand(edges.num_send, W)
            rec_rows = rand(n_virt, W)
            if layer:
                w0 = mlp.layers[0].w
                args = (rand(n_virt * K, W), table, edges.senders, rec_rows,
                        mask_p, w0[:H], mlp.layers[0].b) + tail
                out_bytes = n_virt * K * W * 4 + n_virt * W * 4
                slots = n_virt * K  # edge_out is written at every slot
                flops = 2.0 * slots * BATCH * 2 * H * H
                return args, nbytes(*args[:7], *tail) + out_bytes, flops
            args = (table, edges.senders, rand(n_virt * K, H), rec_rows,
                    mask_p) + tail
            real = float(mask_p.sum())
            return (args, nbytes(*args[:5], *tail) + n_virt * W * 4,
                    2.0 * real * BATCH * H * H)

        a2, b2, f2 = edge_case(g.g2m, model.g2m_gnn, False)
        cases.append(("edge_tail_sum_flat", edge_flat, a2,
                      "neural_lam_tpu/ops/pallas_edge_flat.py:373", b2, f2))
        a3, b3, f3 = edge_case(g.m2m[0], model.processor[0], True)
        cases.append(("edge_layer_flat", edge_flat, a3,
                      "neural_lam_tpu/ops/pallas_edge_flat.py:727", b3, f3))

        m2g = g.m2g
        n_virt, K = m2g.num_virt, m2g.dense_k
        pp = grid_update.pack_grid_update_params(model)
        d_out = pp["o_w1"].shape[1]
        mask_p = m2g.mask.view(n_virt, K)
        a4 = (rand(m2g.num_send, W), m2g.senders, rand(n_virt * K, H),
              rand(n_grid, W), mask_p, pp)
        real4 = float(mask_p.sum())
        node_flops = 2.0 * n_virt * BATCH * (7 * H * H + H * d_out)
        cases.append((
            "grid_update_flat", grid_update, a4,
            "neural_lam_tpu/ops/pallas_grid_update.py:174",
            nbytes(*a4[:5], *pp.values()) + n_virt * BATCH * d_out * 4,
            node_flops + 2.0 * real4 * BATCH * H * H,
        ))

        for kname, mod, args, replaces, bytes_, flops in cases:
            kern = getattr(mod, kname)
            plain = getattr(mod, kname + "_plain")
            got = kern(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = 0.0
            for a, b in zip(got, want):
                if a.shape != b.shape or not torch.isfinite(a).all():
                    fail(f"{kname}: bad output {tuple(a.shape)}")
                tol = 1e-4 + 1e-4 * b.abs()
                if not bool(((a - b).abs() <= tol).all()):
                    fail(f"{kname}: kernel and plain disagree, max abs "
                         f"err {float((a - b).abs().max()):.3e}")
                err = max(err, float((a - b).abs().max()))
            ms = cuda_ms(torch, lambda: kern(*args), 20)
            plain_ms = cuda_ms(torch, lambda: plain(*args), 5)
            t_bytes = bytes_ / peak_bw * 1e3
            t_ops = flops / peak_flops * 1e3
            bound_ms = max(t_bytes, t_ops)
            print(f"{kname}: max_abs_err {err:.3e} (tol 1e-4 + 1e-4*|plain|)"
                  f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({bytes_ / 1e6:.1f} MB, "
                  f"{flops / 1e9:.2f} GFLOP)")
            records.append({
                "name": kname, "route": "cuda",
                "source": f"neural_lam_tpu_torch/csrc/"
                          f"{os.path.basename(mod.__file__)[:-3]}.cu",
                "replaces": replaces, "launches": None,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None,
            })
        del cases, a2, a3, a4, args

    # 4. the main path
    init, forcing, true = entry.make_inputs(model, BATCH, STEPS, seed=0)
    entry.forecast(model, init, forcing[:, :1], true[:, :1])  # warm-up
    wrappers = {"embed_grid_flat": embed.embed_grid_flat,
                "edge_tail_sum_flat": edge_flat.edge_tail_sum_flat,
                "edge_layer_flat": edge_flat.edge_layer_flat,
                "grid_update_flat": grid_update.grid_update_flat}
    for w in wrappers.values():
        w.launches = 0
    pred = entry.forecast(model, init, forcing, true)
    torch.cuda.synchronize()
    counts = {k: w.launches for k, w in wrappers.items()}
    if tuple(pred.shape) != (BATCH, STEPS, g.num_grid_nodes, 17):
        fail(f"rollout shape {tuple(pred.shape)}")
    if not bool(torch.isfinite(pred).all()):
        fail("rollout output is not finite")
    want = {"embed_grid_flat": 1, "edge_tail_sum_flat": 1,
            "edge_layer_flat": BENCH["processor_layers"],
            "grid_update_flat": 1}
    per_step = {k: counts[k] / STEPS for k in counts}
    print(f"rollout: {STEPS} steps, output {tuple(pred.shape)} finite; "
          f"launches per step {per_step}")
    if any(counts[k] != want[k] * STEPS for k in want):
        fail(f"launch counts {counts}, want {want} per step")
    for rec in records:
        rec["launches"] = counts[rec["name"]]

    def rollout_s(steps):
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            entry.forecast(model, init, forcing[:, :steps],
                           true[:, :steps])
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

    profile_steps(torch, model, init, forcing)

    @contextlib.contextmanager
    def plain_kernels():
        mods = {"embed_grid_flat": embed, "edge_tail_sum_flat": edge_flat,
                "edge_layer_flat": edge_flat, "grid_update_flat": grid_update}
        for k, m in mods.items():
            setattr(m, k, getattr(m, k + "_plain"))
        try:
            yield
        finally:
            for k, m in mods.items():
                setattr(m, k, wrappers[k])

    with torch.no_grad():
        step_k, _ = model.predict_step(init[:, 1], init[:, 0], forcing[:, 0])
        with plain_kernels():
            step_p, _ = model.predict_step(init[:, 1], init[:, 0],
                                           forcing[:, 0])
    gap = float((step_k - step_p).abs().max())
    print(f"predict step, kernels vs plain versions on the card: max abs "
          f"gap {gap:.3e} (limit 1e-3)")
    if not gap <= 1e-3:
        fail("kernel path and plain path disagree")
    del model, init, forcing, true, pred, step_k, step_p

    # 5. small model: card (kernels) against CPU (plain versions)
    small = dict(nx=16, ny=16, hidden_dim=64, processor_layers=2)
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

    print(json.dumps({"kernels": records}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
