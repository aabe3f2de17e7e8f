"""Host clocks of the PyTorch port on one CUDA card, for two or more
checkouts of the repo, each measured in fresh processes that alternate.

    python3 probes/torch_host_clock.py ROOT_A ROOT_B [--rounds 3]

Each round runs one worker process per root in the order A B ... B A, so
each root goes first and last equally often. A worker imports
`neural_lam_tpu_torch` from its root (kernels built into that root's
build directory), builds the bench GraphLAM (268x238 grid, hidden 64, 4
processor layers, fp32, seeded weights) and prints one JSON line:

- `train_ms`: one AdamW step at batch 4, `ar_steps` 1, host clock around
  a synchronised step, median of 15 after 3 warm-up steps (as
  chip_smoke.py phase 7, which takes the median of 7);
- `predict_ms`: one GraphLAM batch-4 predict step, host clock over 20
  steps and one synchronisation, median of 5;
- `xtd_sum_us` / `xtd_sum2_us`: host time of one `weight_grad.xtd_sum`
  call at the decoder backward's nine pairs / at the first two of them,
  and `k4_us`: of one `grid_update.grid_update_flat` call (K4) at the
  m2g shape, each the mean over 50 calls queued behind a sleep kernel so
  that the host never waits for the card;
- `add_us`: host time of one `torch.add` on a small tensor, the same way:
  the yardstick of the host's speed in that process.

The orchestrator prints every worker's line, then the median of each
number per root (the upper of the two middle values for an even count).
Needs one card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

BENCH = dict(nx=268, ny=238, hidden_dim=64, processor_layers=4,
             n_features={"state": 17, "forcing": 6, "static": 4},
             n_timesteps=20)
BATCH = 4
SLEEP_CYCLES = 1_000_000_000  # ~0.5 s at the H100's 1.98 GHz boost clock


def host_us(torch, fn, calls=50):
    """Mean host microseconds per call of `fn`, queued behind a sleep
    kernel; raises if the host caught up with the card."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    end.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    if host * 1e3 >= start.elapsed_time(end):
        raise RuntimeError("the host outran the sleep kernel")
    return host / calls * 1e6


def median(xs):
    return sorted(xs)[len(xs) // 2]


def worker(root):
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from neural_lam_tpu_torch import entry
    from neural_lam_tpu_torch.ops import _build, grid_update, weight_grad

    _build.build_all()  # one nvcc per stale source, all at once
    model, datastore = entry.build_model(**BENCH, device="cuda")
    g = model.graph
    H, W = BENCH["hidden_dim"], BATCH * BENCH["hidden_dim"]
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    out = {"root": root}
    with torch.no_grad():
        pp = {k: v.detach() for k, v in
              grid_update.pack_grid_update_params(model).items()}
        m2g = g.m2g
        n_virt, K = m2g.num_virt, m2g.dense_k
        a4 = (rand(m2g.num_send, W), m2g.senders, rand(n_virt * K, H),
              rand(g.num_grid_nodes, W), m2g.mask.view(n_virt, K), pp)
        a5 = a4 + (rand(n_virt, BATCH * pp["o_w1"].shape[1]),)
        pairs = grid_update.grid_update_bwd_chain(*a5)[4]
        out["add_us"] = host_us(torch, lambda: torch.add(a4[0][:4], 1.0))
        out["xtd_sum_us"] = host_us(torch, lambda: weight_grad.xtd_sum(pairs))
        out["xtd_sum2_us"] = host_us(
            torch, lambda: weight_grad.xtd_sum(pairs[:2]))
        out["k4_us"] = host_us(torch,
                               lambda: grid_update.grid_update_flat(*a4))
        del a4, a5, pairs

        init, forcing, _ = entry.make_inputs(model, BATCH, 1, seed=0)
        init = torch.as_tensor(init, device="cuda")
        forcing = torch.as_tensor(forcing, device="cuda")
        ctx = model.precompute_rollout_ctx()
        times = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                model.predict_step(init[:, 1], init[:, 0], forcing[:, 0], ctx)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) / 20 * 1e3)
        out["predict_ms"] = median(times[1:])
        del ctx
    torch.cuda.empty_cache()

    trainer, dm = entry.make_trainer(model, datastore, BATCH, 1, seed=2)
    batch = next(trainer.train_batches(dm, 0))
    times = []
    for _ in range(18):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["train_ms"] = median(times[3:])
    print(json.dumps(out), flush=True)


def main(argv):
    if argv[:1] == ["--worker"]:
        worker(argv[1])
        return 0
    rounds = 3
    if "--rounds" in argv:
        i = argv.index("--rounds")
        rounds = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    roots = argv
    if not roots:
        print(__doc__)
        return 2
    results = {r: [] for r in roots}
    for k in range(rounds):
        order = roots if k % 2 == 0 else roots[::-1]
        for root in order:
            run = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker", root],
                capture_output=True, text=True, timeout=600)
            if run.returncode != 0:
                sys.stderr.write(run.stderr[-4000:])
                print(f"worker for {root} failed: rc {run.returncode}")
                return 1
            line = run.stdout.strip().splitlines()[-1]
            print(f"round {k} {line}", flush=True)
            results[root].append(json.loads(line))
    keys = [k for k in results[roots[0]][0] if k != "root"]
    for root in roots:
        print(f"median over {rounds} workers, {root}: " + ", ".join(
            f"{k} {median([r[k] for r in results[root]]):.3f}"
            for k in keys))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
