"""The serving input of two or more checkouts of the repo, cold and warm,
on one CUDA card, in alternating processes: chip_smoke.py phase 9's
4-step test sample, read from a 268x238 MDP zarr (zlib chunks),
standardized and copied to the card.

    python3 probes/torch_read_probe.py ROOT_A ROOT_B ... [--rounds 2]

Writes one datastore into build/read_probe/ with chip_smoke.py's
`write_mdp_datastore`, then runs a fresh worker process per root and
round (A B B A for two roots and 2 rounds). A worker imports
`neural_lam_tpu_torch` from its root, reads the sample once (imports,
page cache), then 3 times cold (a new, empty chunk cache) and 3 times
warm, each synchronised on the host clock, and prints one JSON line with
the chunks its native decoder decoded (null for a tree without one).
The orchestrator prints every worker's line and the medians per root.
Needs one card.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.append(REPO)

from chip_smoke import STEPS, fail, smi_line, write_mdp_datastore  # noqa: E402


def worker(root, ds_dir):
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from neural_lam_tpu_torch.config import load_config_and_datastore
    from neural_lam_tpu_torch.dataset import WeatherDataset
    from neural_lam_tpu_torch.datastore import zarr_reader

    try:
        from neural_lam_tpu_torch import native
    except ImportError:  # a tree from before the native decoder
        native = None
    _, ds = load_config_and_datastore(os.path.join(ds_dir, "config.yaml"))

    def read():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        item = WeatherDataset(ds, split="test", ar_steps=STEPS)[-1]
        [torch.as_tensor(b, device="cuda")[None] for b in item[:3]]
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    read()
    cold, decoded = [], 0
    for _ in range(3):
        zarr_reader._chunk_cache = zarr_reader._ChunkCache(
            zarr_reader.CHUNK_CACHE_BYTES)
        before = native.decoded_chunks if native else 0
        cold.append(read())
        decoded += native.decoded_chunks - before if native else 0
    warm = [read() for _ in range(3)]
    print(json.dumps({"root": root, "cold_ms": cold, "warm_ms": warm,
                      "decoded_chunks": decoded if native else None,
                      "card": smi_line()}), flush=True)
    return 0


def main(args):
    import numpy as np

    rounds = 2
    if "--rounds" in args:
        i = args.index("--rounds")
        rounds = int(args[i + 1])
        del args[i:i + 2]
    ds_dir = os.path.join(REPO, "build", "read_probe")
    os.makedirs(ds_dir, exist_ok=True)
    t0 = time.time()
    write_mdp_datastore(pathlib.Path(ds_dir), np)
    print(f"datastore written in {time.time() - t0:.1f} s", flush=True)
    results = {root: [] for root in args}
    for r in range(rounds):
        for root in args if r % 2 == 0 else args[::-1]:
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 root, ds_dir], capture_output=True, text=True, timeout=600)
            if out.returncode != 0:
                fail(f"read worker for {root} failed:\n{out.stderr}")
            line = out.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            results[root].append(json.loads(line))
    for root, recs in results.items():
        cold = sorted(t for r in recs for t in r["cold_ms"])
        warm = sorted(t for r in recs for t in r["warm_ms"])
        print(f"{root}: cold median {cold[len(cold) // 2]:.2f} ms "
              f"({cold[0]:.2f}-{cold[-1]:.2f}), warm median "
              f"{warm[len(warm) // 2]:.2f} ms ({warm[0]:.2f}-{warm[-1]:.2f})"
              f", {len(recs)} workers", flush=True)
    print(smi_line())
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.exit(worker(*sys.argv[2:4]))
    sys.exit(main(sys.argv[1:]))
