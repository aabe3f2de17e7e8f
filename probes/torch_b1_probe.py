"""B1 (the grid embedder's backward, `embed.embed_grid_flat_bwd`) of two
or more checkouts of the repo, on one CUDA card, in alternating processes.

    python3 probes/torch_b1_probe.py ROOT_A ROOT_B [--rounds 2]

Each round runs one worker process per root in the order A B ... B A. A
worker imports `neural_lam_tpu_torch` from its root (kernels built into
that root's build directory) and, at the bench shapes (268x238 = 63,784
grid nodes, batch 4, d_in = 17 + 17 + 18 + 4 = 56, hidden 64; inputs and
weights from a seeded generator):

- holds the kernel against `embed_grid_flat_bwd_plain` at d_in 56, 23
  and 100, with and without dx: every output within 1e-4 + 1e-4 *
  max|plain|, and two calls bit-identical;
- times B1 at the training step's call (`need_dx=False`) and with dx,
  with CUDA events around 20 calls queued behind a sleep kernel, in
  three interleaved rounds, and prints one JSON line (`nodx_ms`,
  `dx_ms`: the rounds' times; `err`: the largest error over every case
  and tensor; `ptxas`: the register and spill lines of B1's build).

The orchestrator prints every worker's line, then the median time of each
call per root and the card's name and power limit. Needs one card.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

N_GRID, BATCH, D_IN, H = 63784, 4, 56, 64
SLEEP_CYCLES = 400_000_000  # ~0.2 s at the H100's 1.98 GHz boost clock


def queued_ms(torch, fn, reps=20):
    """Device ms per call of `fn`: CUDA events around `reps` calls queued
    behind a sleep kernel (raises if the host did not queue them in
    time)."""
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


def case(torch, gen, d_in):
    def rand(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    return (rand(N_GRID, BATCH * d_in), rand(d_in, H, scale=0.2),
            rand(H, scale=0.1), rand(H, H, scale=0.2), rand(H, scale=0.1),
            1 + rand(H, scale=0.1), rand(H, scale=0.1), BATCH,
            rand(N_GRID, BATCH * H))


def worker(root):
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from neural_lam_tpu_torch.ops import _build, embed

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    err = 0.0
    with torch.no_grad():
        for d_in in (D_IN, 23, 100):
            args = case(torch, gen, d_in)
            for need_dx in (False, True):
                got = embed.embed_grid_flat_bwd(*args, need_dx)
                again = embed.embed_grid_flat_bwd(*args, need_dx)
                want = embed.embed_grid_flat_bwd_plain(*args, need_dx)
                for i, (a, b, c) in enumerate(zip(got, again, want)):
                    if b is None and c is None and a is None:
                        continue
                    if not torch.equal(a, b):
                        raise RuntimeError(f"d_in {d_in} dx {need_dx}: two "
                                           f"calls differ on output {i}")
                    gap = float((a - c).abs().max())
                    tol = 1e-4 + 1e-4 * float(c.abs().max())
                    if not gap <= tol:
                        raise RuntimeError(
                            f"d_in {d_in} dx {need_dx}: output {i} off by "
                            f"{gap:.3e} (tol {tol:.3e})")
                    err = max(err, gap)
        args = case(torch, gen, D_IN)
        times = {"nodx_ms": [], "dx_ms": []}
        for _ in range(3):
            for key, need_dx in (("nodx_ms", False), ("dx_ms", True)):
                times[key].append(queued_ms(
                    torch, lambda: embed.embed_grid_flat_bwd(*args, need_dx)))
    log = _build.build_log("embed_bwd")
    ptxas = re.findall(r"Used \d+ registers[^\n]*|\d+ bytes spill[^\n]*", log)
    print(json.dumps(dict(root=root, err=err, ptxas=ptxas, **times)),
          flush=True)


def main(argv):
    if argv[:1] == ["--worker"]:
        worker(argv[1])
        return 0
    rounds = 2
    if "--rounds" in argv:
        i = argv.index("--rounds")
        rounds = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    roots = argv or ["."]
    order = []
    for r in range(rounds):
        order += roots if r % 2 == 0 else roots[::-1]
    results = {root: [] for root in roots}
    for root in order:
        proc = subprocess.run([sys.executable, __file__, "--worker", root],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(f"worker for {root} failed:\n{proc.stderr[-6000:]}")
            continue
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        results[root].append(json.loads(line))
    for root, rs in results.items():
        if not rs:
            continue
        for key in ("nodx_ms", "dx_ms"):
            ts = sorted(t for r in rs for t in r[key])
            print(f"{root}: B1 {key[:-3]} median {ts[len(ts) // 2]:.4f} ms "
                  f"over {len(ts)} timings ({ts[0]:.4f}-{ts[-1]:.4f})")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
