"""Do gloo's collectives take CUDA tensors on this card and torch, and
does the nccl backend refuse two ranks on one card?

    python3 probes/torch_gloo_cuda_probe.py

Two rank processes on cuda:0 with the gloo backend run all_reduce,
broadcast and all_gather on fp32 and bf16 CUDA tensors and check the
results; then two ranks run reduce_scatter_tensor and one
batch_isend_irecv round (each rank sending to the other) on CUDA
tensors and report, each, whether it returned the right values or what
it raised (the mesh-node-sharded schemes stage through host memory what
gloo does not take: `parallel/collectives.py`'s HOST_STAGED); then two
ranks ask for nccl on the one card and must fail with the port's error
(`parallel.distributed`), and one rank alone must run an nccl
all_reduce. Prints one line per check and the seconds each took.
"""

import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker(mode, rank, world, port):
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from neural_lam_tpu_torch.parallel import distributed as D

    D.init_multihost(f"127.0.0.1:{port}", world, rank,
                     backend="gloo" if mode == "gloo" else "nccl",
                     device="cuda", timeout_s=60)
    dev = D.world().device
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.full((1000,), float(rank + 1), device=dev, dtype=dtype)
        dist.all_reduce(x)
        assert x.device == dev and float(x[0]) == world * (world + 1) / 2
        y = torch.full((7,), float(rank), device=dev, dtype=dtype)
        dist.broadcast(y, src=world - 1)
        assert float(y[0]) == world - 1
        parts = [torch.empty(5, device=dev, dtype=dtype)
                 for _ in range(world)]
        dist.all_gather(parts, torch.full((5,), float(rank), device=dev,
                                          dtype=dtype))
        assert [float(p[0]) for p in parts] == list(range(world))
    torch.cuda.synchronize()
    print(f"rank {rank}: {mode} all_reduce, broadcast and all_gather on "
          f"CUDA fp32 and bf16 tensors: right", flush=True)
    D.shutdown()


def worker_rs_p2p(rank, world, port):
    """reduce_scatter_tensor and a point-to-point round on CUDA tensors:
    a line each, "takes CUDA tensors" or what the call raised."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from neural_lam_tpu_torch.parallel import distributed as D

    D.init_multihost(f"127.0.0.1:{port}", world, rank, backend="gloo",
                     device="cuda", timeout_s=30)
    dev = D.world().device
    for what in ("reduce_scatter_tensor", "batch_isend_irecv"):
        try:
            if what == "reduce_scatter_tensor":
                x = torch.arange(2 * world, dtype=torch.float32,
                                 device=dev) + 10 * rank
                out = torch.empty(2, device=dev)
                dist.reduce_scatter_tensor(out, x)
                want = [float(world * v + 10 * sum(range(world)))
                        for v in range(2 * rank, 2 * rank + 2)]
            else:
                out = torch.zeros(3, device=dev)
                peer = (rank + 1) % world
                ops = [dist.P2POp(dist.isend, torch.full((3,), 7.0 + rank,
                                                         device=dev), peer),
                       dist.P2POp(dist.irecv, out, (rank - 1) % world)]
                for w in dist.batch_isend_irecv(ops):
                    w.wait()
                want = [7.0 + (rank - 1) % world] * 3
            got = out.cpu().tolist()
            print(f"rank {rank}: gloo {what} on CUDA tensors: "
                  + ("takes them, values right" if got == want
                     else f"wrong values {got}, want {want}"), flush=True)
        except RuntimeError as e:  # what the probe reports
            print(f"rank {rank}: gloo {what} on CUDA tensors raises: "
                  f"{str(e).splitlines()[0][:200]}", flush=True)
            break
    D.shutdown()


def run(mode, world):
    port = free_port()
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--worker", mode, str(r), str(world),
         str(port)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    rcs = [p.returncode for p in procs]
    return rcs, outs, time.time() - t0


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        if sys.argv[2] == "gloo_rs_p2p":
            worker_rs_p2p(int(sys.argv[3]), int(sys.argv[4]),
                          int(sys.argv[5]))
        else:
            worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
                   int(sys.argv[5]))
        return 0
    ok = True
    rcs, outs, dt = run("gloo", 2)
    print(f"gloo, 2 ranks on one card: exit codes {rcs} ({dt:.1f} s)")
    for o in outs:
        print("  | " + o.strip().replace("\n", "\n  | ")[-1500:])
    ok &= rcs == [0, 0]
    rcs, outs, dt = run("gloo_rs_p2p", 2)
    print(f"gloo reduce-scatter and point-to-point, 2 ranks on one card: "
          f"exit codes {rcs} ({dt:.1f} s)")
    for o in outs:
        print("  | " + "\n  | ".join(
            ln for ln in o.strip().splitlines() if ln.startswith("rank")))
    rcs, outs, dt = run("nccl", 2)
    refused = all(rc != 0 for rc in rcs) and any(
        "take one rank a card" in o or "takes one rank a card" in o
        for o in outs)
    print(f"nccl, 2 ranks on one card: exit codes {rcs}, refused with the "
          f"port's error: {refused} ({dt:.1f} s)")
    for o in outs:
        print("  | " + o.strip().splitlines()[-1][-300:] if o.strip()
              else "  | (no output)")
    ok &= refused
    rcs, outs, dt = run("nccl", 1)
    print(f"nccl, 1 rank: exit codes {rcs} ({dt:.1f} s)")
    for o in outs:
        print("  | " + o.strip().replace("\n", "\n  | ")[-800:])
    ok &= rcs == [0]
    print("probe:", "all checks passed" if ok else "a check FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
