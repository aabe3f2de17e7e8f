"""P1 (the batched edge tail on a materialised x0, `edge.edge_tail`), P2
(the batched edge tail, `edge.edge_tail_sum`) and P3 (the batched edge
layer, `edge.edge_layer`) of two or more checkouts of the repo, on one
CUDA card, in alternating processes, at every edge set that runs them in
a batch-1 forecast; K2 and K3, whose kernel P1-P3 share, timed beside
them at their bench shapes.

    python3 probes/torch_p23_probe.py ROOT_A ROOT_B ... [--rounds 2]
        [--variants NAME,...]

`--variants` adds, for each NAME of VARIANTS below, a copy of the last
root's `neural_lam_tpu_torch/` under build/p23_probe/NAME/ with one
textual change to `csrc/edge_tc.cuh` (the warps of P1's block), as one
more root. Every root's `edge` and `edge_flat` kernels are built first,
all at once.
Each round runs one worker process per root in the order A B ... B A. A
worker imports `neural_lam_tpu_torch` from its root, builds the
bench-width HiLAM (268x238 grid, hidden 64, 4 processor layers, the
4-level hierarchical graph) and GraphLAM (the multiscale graph), and, on
inputs from a seeded generator with each set's own interaction-net
weights:

- holds P3 at HiLAM's m2m[0..3], up[0..2] (with their virtual-row fold)
  and down[0..2] (K = 1) and GraphLAM's m2m, P2 at HiLAM's and
  GraphLAM's g2m and m2g, and P1 at HiLAM's read-out sets down[0..2],
  all at batch 1, and P2 with messages at HiLAM's m2g, P1 with messages
  at down[0..2] and P1 at the top down set at batch 4 (the one P1 launch
  of a batch-4 step), against their plain versions: every output within
  1e-4 +
  1e-4 * |plain|, two calls bit-identical; K2 at GraphLAM's g2m and K3
  at its m2m[0], batch 4, the same way;
- times each, and the one other kernel of a wrapper call (its
  parameter blob, `torch.cat`), with CUDA events around 20 calls queued
  behind a sleep kernel, in three interleaved rounds, and prints one
  JSON line
  (`ms`: set -> the rounds' times; `err`: the largest error; `ptxas`:
  each kernel's register and spill line of the edge and edge_flat
  builds).

The orchestrator prints every worker's line, then, per set, its launches
per batch-1 predict step, each root's median time, the bound max(bytes /
3.35 TB/s, 3 x FLOP / 495 TFLOP/s) (each input read once, each output
written once; 3xTF32 products, real slots only for a virt-only tail) and
launches x (ms - bound) per root, summed per kernel and model; then the
card's name and power limit. Needs one card.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

BENCH = dict(nx=268, ny=238, hidden_dim=64, processor_layers=4,
             n_features={"state": 17, "forcing": 6, "static": 4},
             n_timesteps=20)
H = 64
SLEEP_CYCLES = 400_000_000  # ~0.2 s at the H100's 1.98 GHz boost clock
PEAK_BW, PEAK_TF32 = 3.35e12, 495e12  # H100 SXM data sheet
OUT = os.path.join("build", "p23_probe")
# name -> (old text, new text) in csrc/edge_tc.cuh
VARIANTS = {f"x0w{n}": ("constexpr int kX0Warps = 16;",
                        f"constexpr int kX0Warps = {n};")
            for n in (12, 14, 20)}


def queued_ms(torch, fn, reps=20):
    """Device ms per call of `fn`: CUDA events around `reps` calls queued
    behind a sleep kernel."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(SLEEP_CYCLES)
    ev[1].record()
    for _ in range(reps):
        fn()
    ev[2].record()
    torch.cuda.synchronize()
    if ev[0].elapsed_time(ev[1]) < 1.0:
        raise RuntimeError("sleep kernel too short")
    return ev[1].elapsed_time(ev[2]) / reps


def check(torch, what, kern, plain, args):
    """Kernel against plain (1e-4 + 1e-4*|plain|), two calls
    bit-identical; returns the max abs error."""
    got, again, want = kern(*args), kern(*args), plain(*args)
    torch.cuda.synchronize()
    err = 0.0
    for i, (a, b, c) in enumerate(zip(got, again, want)):
        if a is None and c is None:
            continue
        if not torch.equal(a, b):
            raise RuntimeError(f"{what}: two calls differ on output {i}")
        if a.shape != c.shape or not bool(torch.isfinite(a).all()):
            raise RuntimeError(f"{what}: bad output {i}")
        gap = (a - c).abs()
        if not bool((gap <= 1e-4 + 1e-4 * c.abs()).all()):
            raise RuntimeError(f"{what}: output {i} off by "
                               f"{float(gap.max()):.3e}")
        err = max(err, float(gap.max()))
    return err


def cases(torch, entry, rand):
    """{set: (kernel, plain, args, bound ms, launches per batch-1 predict
    step, tag)} for every P1/P2/P3 set of a batch-1 forecast, and K2/K3
    at their bench shapes (launches None)."""
    from neural_lam_tpu_torch.ops import edge, edge_flat

    def nbytes(args):
        return sum(t.numel() * t.element_size() for t in args
                   if torch.is_tensor(t))

    def bound(bytes_, flops):
        return max(bytes_ / PEAK_BW, 3 * flops / PEAK_TF32) * 1e3

    def tail(inet):
        mlp = inet.edge_mlp
        return tuple(t.detach() for t in (mlp.layers[1].w, mlp.layers[1].b,
                                          mlp.ln.scale, mlp.ln.bias))

    def p3(es, inet, B=1):
        n_virt, K, M = es.num_virt, es.dense_k, es.num_virt * es.dense_k
        w0 = inet.edge_mlp.layers[0].w.detach()
        args = (rand(B, M, H), rand(B, es.num_send, H), es.senders,
                rand(B, n_virt, H), es.mask, w0[:H],
                inet.edge_mlp.layers[0].b.detach()) + tail(inet) + (K,)
        out = B * (M + n_virt) * H * 4
        return (edge.edge_layer, edge.edge_layer_plain, args,
                bound(nbytes(args) + out, 2.0 * B * M * 2 * H * H))

    def p1(es, inet, B=1, wm=False):
        n_virt, K, M = es.num_virt, es.dense_k, es.num_virt * es.dense_k
        args = (rand(B, M, H),) + tail(inet) + (es.mask, K, wm)
        out = B * (n_virt + (M if wm else 0)) * H * 4
        slots = M if wm else float(es.mask.sum())
        return (edge.edge_tail, edge.edge_tail_plain, args,
                bound(nbytes(args) + out, 2.0 * B * slots * H * H))

    def p2(es, inet, B=1, wm=False):
        n_virt, K, M = es.num_virt, es.dense_k, es.num_virt * es.dense_k
        args = (rand(B, es.num_send, H), es.senders, rand(M, H),
                rand(B, n_virt, H)) + tail(inet) + (es.mask, K, wm)
        out = B * (n_virt + (M if wm else 0)) * H * 4
        slots = M if wm else float(es.mask.sum())
        return (edge.edge_tail_sum, edge.edge_tail_sum_plain, args,
                bound(nbytes(args) + out, 2.0 * B * slots * H * H))

    def flat(es, inet, layer, B=4):
        n_virt, K, M = es.num_virt, es.dense_k, es.num_virt * es.dense_k
        W = B * H
        mask_p = es.mask.view(n_virt, K)
        if layer:
            w0 = inet.edge_mlp.layers[0].w.detach()
            args = (rand(M, W), rand(es.num_send, W), es.senders,
                    rand(n_virt, W), mask_p, w0[:H],
                    inet.edge_mlp.layers[0].b.detach()) + tail(inet)
            return (edge_flat.edge_layer_flat, edge_flat.edge_layer_flat_plain,
                    args, bound(nbytes(args) + (M + n_virt) * W * 4,
                                2.0 * M * B * 2 * H * H))
        args = (rand(es.num_send, W), es.senders, rand(M, H),
                rand(n_virt, W), mask_p) + tail(inet)
        return (edge_flat.edge_tail_sum_flat,
                edge_flat.edge_tail_sum_flat_plain, args,
                bound(nbytes(args) + n_virt * W * 4,
                      2.0 * float(es.mask.sum()) * B * H * H))

    hilam, _ = entry.build_model(**BENCH, device="cuda", model="hi_lam")
    hg, L = hilam.graph, BENCH["processor_layers"]
    out = {}
    # HiLAM batch 1: m2m[l] twice a processor layer; up[l] once a layer
    # and once in the initial sweep; down[l] once a layer
    for lv, es in enumerate(hg.m2m):
        out[f"HiLAM m2m[{lv}]"] = p3(es, hilam.mesh_up_same_gnns[0][lv]) \
            + (2 * L, "P3")
    for lv, es in enumerate(hg.up):
        out[f"HiLAM up[{lv}]"] = p3(es, hilam.mesh_up_gnns[0][lv]) \
            + (L + 1, "P3")
    for lv, es in enumerate(hg.down):
        out[f"HiLAM down[{lv}]"] = p3(es, hilam.mesh_down_gnns[0][lv]) \
            + (L, "P3")
    # the read-out: P1 once on each down set
    for lv, es in enumerate(hg.down):
        out[f"HiLAM read-out down[{lv}]"] = p1(
            es, hilam.mesh_read_gnns[lv]) + (1, "P1")
        out[f"HiLAM read-out down[{lv}], with messages"] = p1(
            es, hilam.mesh_read_gnns[lv], wm=True) + (None, "P1")
    out["HiLAM read-out top down set, B=4"] = p1(
        hg.down[-1], hilam.mesh_read_gnns[-1], B=4) + (None, "P1")
    out["HiLAM g2m"] = p2(hg.g2m, hilam.g2m_gnn) + (1, "P2")
    out["HiLAM m2g"] = p2(hg.m2g, hilam.m2g_gnn) + (1, "P2")
    out["HiLAM m2g, with messages"] = p2(hg.m2g, hilam.m2g_gnn,
                                         wm=True) + (None, "P2")
    del hilam
    model, _ = entry.build_model(**BENCH, device="cuda")
    g = model.graph
    out["GraphLAM m2m"] = p3(g.m2m[0], model.processor[0]) + (L, "P3")
    out["GraphLAM g2m"] = p2(g.g2m, model.g2m_gnn) + (1, "P2")
    out["GraphLAM m2g"] = p2(g.m2g, model.m2g_gnn) + (1, "P2")
    out["K2 at GraphLAM g2m, B=4"] = flat(g.g2m, model.g2m_gnn, False) \
        + (None, "K2")
    out["K3 at GraphLAM m2m[0], B=4"] = flat(g.m2m[0], model.processor[0],
                                             True) + (None, "K3")
    # the one other kernel of each wrapper call: its parameter blob
    out["P3's parameter blob (torch.cat)"] = (
        lambda *a: (edge._tail_params(*a[7:11], a[5], a[6]),), None,
        out["HiLAM m2m[0]"][2], 0.0, None, "cat")
    return out


def worker(root):
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from neural_lam_tpu_torch import entry
    from neural_lam_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    with torch.no_grad():
        sets = cases(torch, entry, rand)
        err = {k: check(torch, k, kern, plain, args)
               for k, (kern, plain, args, *_) in sets.items()
               if plain is not None}
        ms = {k: [] for k in sets}
        for _ in range(3):
            for k, (kern, _, args, *_) in sets.items():
                ms[k].append(queued_ms(torch, lambda: kern(*args)))
    ptxas = {}
    for src in ("edge", "edge_flat"):
        log = _build.build_log(src)
        ptxas[src] = sorted(
            fn + ": " + "; ".join(re.findall(
                r"Used \d+ registers|\d+ bytes spill \w+", info))
            for fn, info in re.findall(
                r"Compiling entry function '(\w+)'.*?\n(.*?Used \d+ "
                r"registers[^\n]*)", log, re.S))
    meta = {k: {"bound_ms": c[3], "launches": c[4], "kernel": c[5]}
            for k, c in sets.items()}
    print(json.dumps(dict(root=root, err=err, ms=ms, meta=meta,
                          ptxas=ptxas)), flush=True)


def build_roots(roots):
    """Build every root's edge kernels, one process per root, all at
    once."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from neural_lam_tpu_torch.ops import _build; "
            "_build.build_all(('edge', 'edge_flat'))")
    procs = {r: subprocess.Popen([sys.executable, "-c", code, r],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for r in roots}
    ok = []
    for r, p in procs.items():
        out, _ = p.communicate(timeout=900)
        if p.returncode == 0:
            ok.append(r)
        else:
            print(f"build of {r} failed:\n{out[-6000:]}", flush=True)
    return ok


def make_variant(base, name):
    """A copy of `base`'s package under OUT/name with VARIANTS[name]'s
    change to csrc/edge_tc.cuh; returns its root."""
    old, new = VARIANTS[name]
    root = os.path.join(OUT, name)
    pkg = os.path.join(root, "neural_lam_tpu_torch")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(base, "neural_lam_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("__pycache__", "_kernels"))
    path = os.path.join(pkg, "csrc", "edge_tc.cuh")
    text = open(path).read()
    if text.count(old) != 1:
        raise RuntimeError(f"{name}: no single match for {old!r}")
    with open(path, "w") as f:
        f.write(text.replace(old, new))
    return root


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def main(argv):
    if argv[:1] == ["--worker"]:
        worker(argv[1])
        return 0
    rounds, variants = 2, []
    for flag in ("--rounds", "--variants"):
        if flag in argv:
            i = argv.index(flag)
            if flag == "--rounds":
                rounds = int(argv[i + 1])
            else:
                variants = argv[i + 1].split(",")
            argv = argv[:i] + argv[i + 2:]
    roots = argv or ["."]
    roots = build_roots(roots + [make_variant(roots[-1], v)
                                 for v in variants])
    order = []
    for r in range(rounds):
        order += roots if r % 2 == 0 else roots[::-1]
    results = {root: [] for root in roots}
    failed = False
    for root in order:
        proc = subprocess.run([sys.executable, __file__, "--worker", root],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(f"worker for {root} failed:\n{proc.stderr[-6000:]}",
                  flush=True)
            failed = True
            continue
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        results[root].append(json.loads(line))
    done = [r for r in roots if results[r]]
    if done:
        meta = results[done[0]][0]["meta"]
        med = {r: {k: median([t for w in results[r] for t in w["ms"][k]])
                   for k in meta} for r in done}
        print("set | launches/step | " + " | ".join(
            f"{r} ms" for r in done) + " | bound ms | " + " | ".join(
            f"{r} launches x gap" for r in done))
        totals = {}
        for k, m in meta.items():
            n, b = m["launches"], m["bound_ms"]
            gaps = [n * (med[r][k] - b) if n else None for r in done]
            print(f"{k} | {n} | " + " | ".join(
                f"{med[r][k]:.4f}" for r in done) + f" | {b:.4f} | "
                + " | ".join("-" if x is None else f"{x:.4f}"
                             for x in gaps))
            if n:
                key = (k.split()[0], m["kernel"])
                totals[key] = [t + x for t, x in zip(
                    totals.get(key, [0.0] * len(done)), gaps)]
        for (model, kern), ts in sorted(totals.items()):
            print(f"{model} batch 1, {kern}: launches x gap summed over "
                  "its sets " + ", ".join(f"{r} {t:.4f} ms"
                                          for r, t in zip(done, ts)))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 1 if failed or not done else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
