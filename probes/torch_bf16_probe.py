"""The bf16 forecast path alone on one CUDA card: phase 11 of
`chip_smoke.py` without phases 2-10, or the bf16 instances of two or more
checkouts of the repo side by side.

    python3 probes/torch_bf16_probe.py
    python3 probes/torch_bf16_probe.py --roots ROOT_A ROOT_B [--rounds 2]

Without --roots: builds the forward kernels' libraries (`embed`,
`edge_flat`, `edge`, `grid_update`) from `neural_lam_tpu_torch/csrc/`,
prints their build time and ptxas's registers and spills for every bf16
instance, then runs `chip_smoke.bf16_phase`: the bf16 instances of K1-K4,
P2 and P3 against their plain versions and timed beside their fp32
instances at the main-path shapes, at K = 1..8, the bf16 predict steps at
bench width, the predict CLI with `--precision bf16`, its evaluation, and
the refusal of bf16 training. Ends with the kernels' JSON records and the
card's name and power limit.

With --roots: builds every root's forward libraries at once (one process
per root), then runs one worker process per root in the order A B ... B A
for each round. A worker imports `neural_lam_tpu_torch` from its root
(and `chip_smoke` from this checkout), builds the bench GraphLAM and
HiLAM in bf16, holds each bf16 instance against its plain version at its
main-path shape (`chip_smoke.bf16_cases`, `bf16_check`: one bf16 ulp, two
calls bit-identical), times the bf16 and fp32 instances there in three
interleaved rounds (CUDA events around 20 calls queued behind a sleep
kernel), and times the bf16 predict step of GraphLAM at batch 4 and of
HiLAM at batch 1: host ms (synchronised, median of 7) and device busy ms
(torch.profiler over 3 steps); it prints one JSON line, with the ptxas
register and spill lines of its bf16 instances. The orchestrator prints
each worker's line, the medians per root, and the card's name and power
limit.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = ("embed", "edge_flat", "edge", "grid_update")


def load_chip_smoke():
    """chip_smoke.py of this checkout, whatever root comes first on
    sys.path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bf16_ptxas(chip_smoke, _build):
    """ptxas's registers and spills of every bf16 instance built."""
    lines = []
    for src in SOURCES:
        log = _build.build_log(src)
        for fn, info in sorted(re.findall(
                r"Compiling entry function '(\w+)'.*?\n(.*?Used \d+ "
                r"registers[^\n]*)", log, re.S)):
            if "__nv_bfloat16" in fn:
                used = re.search(r"Used [^\n]*", info).group(0)
                spill = ", ".join(re.findall(r"\d+ bytes spill \w+", info))
                lines.append(f"{src}: {chip_smoke.kernel_name(fn)}: {used};"
                             f" {spill or 'no spill line'}")
    return lines


def phase():
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from neural_lam_tpu_torch.ops import _build

    chip_smoke = load_chip_smoke()
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    _build.build_all(SOURCES)
    print(f"build: {time.time() - t0:.1f} s")
    for line in bf16_ptxas(chip_smoke, _build):
        print(f"  {line}")
    name = torch.cuda.get_device_name(0)
    peak_flops, peak_tf32, peak_bw, _ = chip_smoke.peaks(name)
    reset, counts, counts_bf16, plain = chip_smoke.kernel_registry()
    records = []
    t0 = time.time()
    chip_smoke.bf16_phase(torch, np, counts, counts_bf16, reset, plain,
                          records, peak_flops, peak_tf32, peak_bw)
    print(f"phase 11: {time.time() - t0:.1f} s")
    print(json.dumps({"kernels": records}))
    print(chip_smoke.smi_line())
    return 0


def worker(root):
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from neural_lam_tpu_torch import entry
    from neural_lam_tpu_torch.ops import _build

    chip_smoke = load_chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, _, counts_bf16, _ = chip_smoke.kernel_registry()
    bf = torch.bfloat16
    gm, _ = entry.build_model(**chip_smoke.BENCH, device="cuda",
                              compute_dtype="bfloat16")
    hm, _ = entry.build_model(**chip_smoke.BENCH, device="cuda",
                              compute_dtype="bfloat16", model="hi_lam")
    gen = torch.Generator(device="cuda").manual_seed(11)

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(bf)

    out = {"root": root, "share": {}, "err": {}, "ms16": {}, "ms32": {}}
    with torch.no_grad():
        cases = chip_smoke.bf16_cases(torch, gm, hm, rand)
        calls = {}
        for name, mod, args, *_ in cases:
            share, err = chip_smoke.bf16_check(torch, counts_bf16, name, mod,
                                               args, "its main-path shape")
            out["share"][name], out["err"][name] = share, err
            a32 = tuple(a.float() if torch.is_tensor(a) and a.dtype == bf
                        else a for a in args)
            calls[name] = (getattr(mod, name), args, a32)
            out["ms16"][name], out["ms32"][name] = [], []
        for _ in range(3):
            for name, (fn, a16, a32) in calls.items():
                out["ms16"][name].append(chip_smoke.cuda_ms(
                    torch, lambda: fn(*a16), 20))
                out["ms32"][name].append(chip_smoke.cuda_ms(
                    torch, lambda: fn(*a32), 20))
        del cases, calls
        for net, B, what in ((gm, 4, "graph_lam_b4"), (hm, 1, "hi_lam_b1")):
            init, forcing, _ = entry.make_inputs(net, B, 1, seed=0)
            ctx = net.precompute_rollout_ctx()

            def step():
                net.predict_step(init[:, 1], init[:, 0], forcing[:, 0], ctx)

            ts = []
            for _ in range(8):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
            busy = chip_smoke.profile(torch, step, f"{what} bf16 step", top=4)
            out[what] = {"host_ms": sorted(ts[1:])[3],
                         "busy_ms": busy[0] if busy else None}
    out["ptxas"] = bf16_ptxas(chip_smoke, _build)
    print(json.dumps(out), flush=True)


def build_roots(roots):
    """Build every root's forward kernels, one process per root, at once."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from neural_lam_tpu_torch.ops import _build; "
            f"_build.build_all({SOURCES!r})")
    t0 = time.time()
    procs = {r: subprocess.Popen([sys.executable, "-c", code, r],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for r in roots}
    failed = False
    for r, p in procs.items():
        log, _ = p.communicate(timeout=900)
        if p.returncode != 0:
            errors = sorted({line for line in log.splitlines()
                             if "error" in line})
            print(f"build of {r} failed:\n" + "\n".join(errors)[-12000:]
                  + f"\n{log[-2000:]}", flush=True)
            failed = True
    print(f"build of {len(roots)} roots: {time.time() - t0:.1f} s",
          flush=True)
    return not failed


def compare(roots, rounds):
    if not build_roots(roots):
        return 1
    order = []
    for r in range(rounds):
        order += roots if r % 2 == 0 else roots[::-1]
    results = {root: [] for root in roots}
    for root in order:
        proc = subprocess.run([sys.executable, __file__, "--worker", root],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(f"worker for {root} failed:\n{proc.stdout[-3000:]}\n"
                  f"{proc.stderr[-6000:]}", flush=True)
            return 1
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        results[root].append(json.loads(line))
    for root, rs in results.items():
        for name in rs[0]["ms16"]:
            t16 = sorted(t for r in rs for t in r["ms16"][name])
            t32 = sorted(t for r in rs for t in r["ms32"][name])
            m16, m32 = t16[len(t16) // 2], t32[len(t32) // 2]
            print(f"{root}: {name} bf16 median {m16:.4f} ms "
                  f"({t16[0]:.4f}-{t16[-1]:.4f}), fp32 instance {m32:.4f} "
                  f"({t32[0]:.4f}-{t32[-1]:.4f}), {m16 / m32:.3f}x; shares "
                  f"not bit-equal {[r['share'][name] for r in rs]}")
        for what in ("graph_lam_b4", "hi_lam_b1"):
            print(f"{root}: {what} bf16 predict step: host ms "
                  f"{[round(r[what]['host_ms'], 3) for r in rs]}, device "
                  f"busy ms {[r[what]['busy_ms'] for r in rs]}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


def main(argv):
    if argv[:1] == ["--worker"]:
        worker(argv[1])
        return 0
    if "--roots" not in argv:
        return phase()
    rounds = 2
    if "--rounds" in argv:
        i = argv.index("--rounds")
        rounds = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    roots = argv[argv.index("--roots") + 1:]
    return compare(roots, rounds)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
