"""K1 (the grid embedder, `embed.embed_grid_flat`) and K2 (the g2m edge
tail, `edge_flat.edge_tail_sum_flat`) of two or more checkouts of the
repo, on one CUDA card, in alternating processes; B1 and K3, whose
sources share code with them, timed beside them.

    python3 probes/torch_k1k2_probe.py ROOT_A ROOT_B [--rounds 2]
        [--variants NAME,...]

`--variants` adds, for each NAME of VARIANTS below, a copy of the last
root's `neural_lam_tpu_torch/` under build/k1k2_probe/NAME/ with one
textual change to a kernel source (the warps of K1's or K2's block), as
one more root. Every root's kernels are built first, all at once.

Each round runs one worker process per root in the order A B ... B A. A
worker imports `neural_lam_tpu_torch` from its root and, on the
bench-width GraphLAM (268x238 grid, batch 4, hidden 64; inputs and
weights from a seeded generator):

- holds K1 against `embed_grid_flat_plain` at d_in 56 (63,784 nodes) and
  at d_in 23, 100 and 160 (63,783 nodes: rows not a multiple of 16), K2
  against `edge_tail_sum_flat_plain` at g2m and at K = 1..8 on seeded
  local graphs (20,000 receivers of K senders each among 6,561), and K3
  at m2m[0]: every output within 1e-4 + 1e-4 * |plain|, two calls
  bit-identical; B1 at the training call (no dx) within 1e-4 + 1e-4 *
  max|plain| per tensor;
- times K1 at the bench, K2 at g2m, K3 at m2m[0] and B1 (no dx) with
  CUDA events around 20 calls queued behind a sleep kernel, in three
  interleaved rounds, and prints one JSON line (`<kernel>_ms`: the
  rounds' times; `err`: the largest error of each kernel; `ptxas`: the
  register and spill lines of the embed and edge_flat builds).

The orchestrator prints every worker's line, then the median time of each
kernel per root, and the card's name and power limit. Needs one card.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "k1k2_probe")
BENCH = dict(nx=268, ny=238, hidden_dim=64, processor_layers=4,
             n_features={"state": 17, "forcing": 6, "static": 4},
             n_timesteps=20)
BATCH, H = 4, 64
SLEEP_CYCLES = 400_000_000  # ~0.2 s at the H100's 1.98 GHz boost clock
SOURCES = ("embed", "edge_flat", "embed_bwd")
KERNELS = ("k1", "k2", "k3", "b1")
# name -> (file under csrc/, old text, new text)
VARIANTS = {
    "k1w12": ("embed.cu", "return kKind == kWide ? 8 : 16;",
              "return kKind == kWide ? 8 : 12;"),
    "k1w20": ("embed.cu", "return kKind == kWide ? 8 : 16;",
              "return kKind == kWide ? 8 : 20;"),
    "k2w12": ("edge_tc.cuh", "constexpr int kTailWarps = 14;",
              "constexpr int kTailWarps = 12;"),
}


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


def check(torch, what, kern, plain, args, per_tensor=False):
    """Kernel against plain (1e-4 + 1e-4*|plain|, or * max|plain| per
    tensor), two calls bit-identical; returns the max abs error."""
    got = kern(*args)
    again = kern(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    got, again, want = ([t] if torch.is_tensor(t) else list(t)
                        for t in (got, again, want))
    err = 0.0
    for i, (a, b, c) in enumerate(zip(got, again, want)):
        if a is None and c is None:
            continue
        if not torch.equal(a, b):
            raise RuntimeError(f"{what}: two calls differ on output {i}")
        if a.shape != c.shape or not bool(torch.isfinite(a).all()):
            raise RuntimeError(f"{what}: bad output {i}")
        gap = (a - c).abs()
        tol = 1e-4 + 1e-4 * (c.abs().max() if per_tensor else c.abs())
        if not bool((gap <= tol).all()):
            raise RuntimeError(f"{what}: output {i} off by "
                               f"{float(gap.max()):.3e}")
        err = max(err, float(gap.max()))
    return err


def worker(root):
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from neural_lam_tpu_torch import entry
    from neural_lam_tpu_torch.ops import _build, edge_flat, embed
    from neural_lam_tpu_torch.ops.message_passing import EdgeSet

    torch.backends.cuda.matmul.allow_tf32 = False
    model, _ = entry.build_model(**BENCH, device="cuda")
    g = model.graph
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    def det(*ts):
        return tuple(t.detach() for t in ts)

    emb = model.grid_embedder
    d_in, n_grid = emb.layers[0].w.shape[0], g.num_grid_nodes
    k1 = (rand(n_grid, BATCH * d_in),) + det(
        emb.layers[0].w, emb.layers[0].b, emb.layers[1].w, emb.layers[1].b,
        emb.ln.scale, emb.ln.bias) + (BATCH,)
    err = dict.fromkeys(KERNELS, 0.0)
    fwd1 = (embed.embed_grid_flat, embed.embed_grid_flat_plain)
    with torch.no_grad():
        err["k1"] = check(torch, "K1", *fwd1, k1)
        for din in (23, 100, 160):
            args = (rand(n_grid - 1, BATCH * din), rand(din, H, scale=0.2),
                    rand(H, scale=0.1), rand(H, H, scale=0.2),
                    rand(H, scale=0.1), 1 + rand(H, scale=0.1),
                    rand(H, scale=0.1), BATCH)
            err["k1"] = max(err["k1"], check(torch, f"K1 d_in {din}", *fwd1,
                                             args))

        def edge_args(edges, inet, layer):
            n_virt, K = edges.num_virt, edges.dense_k
            mlp = inet.edge_mlp
            tail = det(mlp.layers[1].w, mlp.layers[1].b, mlp.ln.scale,
                       mlp.ln.bias)
            mask_p = edges.mask.view(n_virt, K)
            table, rec = rand(edges.num_send, BATCH * H), rand(
                n_virt, BATCH * H)
            if layer:
                w0 = mlp.layers[0].w.detach()
                return (rand(n_virt * K, BATCH * H), table, edges.senders,
                        rec, mask_p, w0[:H], mlp.layers[0].b.detach()) + tail
            return (table, edges.senders, rand(n_virt * K, H), rec,
                    mask_p) + tail

        fwd2 = (edge_flat.edge_tail_sum_flat,
                edge_flat.edge_tail_sum_flat_plain)
        fwd3 = (edge_flat.edge_layer_flat, edge_flat.edge_layer_flat_plain)
        k2 = edge_args(g.g2m, model.g2m_gnn, False)
        k3 = edge_args(g.m2m[0], model.processor[0], True)
        err["k2"] = check(torch, "K2 at g2m", *fwd2, k2)
        err["k3"] = check(torch, "K3 at m2m[0]", *fwd3, k3)
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
            assert es.dense_k == K, (K, es.dense_k)
            err["k2"] = max(err["k2"], check(
                torch, f"K2 at K={K}", *fwd2,
                edge_args(es, model.g2m_gnn, False)))
            err["k3"] = max(err["k3"], check(
                torch, f"K3 at K={K}", *fwd3,
                edge_args(es, model.processor[0], True)))
        b1 = k1 + (rand(n_grid, BATCH * H), False)
        err["b1"] = check(torch, "B1", embed.embed_grid_flat_bwd,
                          embed.embed_grid_flat_bwd_plain, b1,
                          per_tensor=True)
        calls = {"k1": (fwd1[0], k1), "k2": (fwd2[0], k2),
                 "k3": (fwd3[0], k3), "b1": (embed.embed_grid_flat_bwd, b1)}
        times = {k + "_ms": [] for k in KERNELS}
        for _ in range(3):
            for k, (fn, args) in calls.items():
                times[k + "_ms"].append(queued_ms(torch, lambda: fn(*args)))
    ptxas = {}
    for src in ("embed", "edge_flat"):
        log = _build.build_log(src)
        ptxas[src] = sorted(set(re.findall(
            r"Used \d+ registers[^\n]*|\d+ bytes spill[^\n]*", log)))
    print(json.dumps(dict(root=root, err=err, ptxas=ptxas, **times)),
          flush=True)


def build_roots(roots):
    """Build every root's kernels, one process per root, all at once."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from neural_lam_tpu_torch.ops import _build; "
            f"_build.build_all({SOURCES!r})")
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
    src, old, new = VARIANTS[name]
    root = os.path.join(OUT, name)
    pkg = os.path.join(root, "neural_lam_tpu_torch")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(base, "neural_lam_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(pkg, "csrc", src)
    text = open(path).read()
    if text.count(old) != 1:
        raise RuntimeError(f"{name}: no single match for {old!r}")
    with open(path, "w") as f:
        f.write(text.replace(old, new))
    return root


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
    roots = build_roots(roots)
    if variants and roots:
        extra = [make_variant(roots[-1], v) for v in variants]
        roots += build_roots(extra)
    order = []
    for r in range(rounds):
        order += roots if r % 2 == 0 else roots[::-1]
    results = {root: [] for root in roots}
    for root in order:
        proc = subprocess.run([sys.executable, __file__, "--worker", root],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(f"worker for {root} failed:\n{proc.stderr[-6000:]}",
                  flush=True)
            continue
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        results[root].append(json.loads(line))
    for root, rs in results.items():
        for k in KERNELS if rs else ():
            ts = sorted(t for r in rs for t in r[k + "_ms"])
            print(f"{root}: {k.upper()} median {ts[len(ts) // 2]:.4f} ms "
                  f"over {len(ts)} timings ({ts[0]:.4f}-{ts[-1]:.4f})")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
