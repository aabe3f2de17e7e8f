"""Build the CUDA kernels with nvcc and bind them with ctypes.

Each `csrc/<name>.cu` compiles on its own into a plain-C shared library
(`nvcc -gencode arch=compute_90a,code=sm_90a -shared`), once per hidden
width it is built for (`-DNLT_H=<h>`: every source, forward and
backward, at 32, 64 and 128, `WIDTHS`), named after the source,
the width and the hash of its sources and flags, under
`neural_lam_tpu_torch/_kernels/` (listed in .gitignore). A library is
built at first use of its width and rebuilt when a source's hash changes;
`build_all` starts one nvcc per source and width at once. Nothing is
compiled when the package is imported.

A width with no library raises (`require_width`); nothing falls back to
the plain versions.

The C entry points take device pointers, sizes and a stream as plain
values; every launch returns `cudaGetLastError()` and the Python wrapper
raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
SOURCES = ("embed", "edge_flat", "grid_update", "edge",
           "embed_bwd", "edge_flat_bwd", "grid_update_bwd", "weight_grad")
# the forward sources (K1-K4, P1-P3) and the backward ones (B1-B6, xtd_sum)
FORWARD, BACKWARD = SOURCES[:4], SOURCES[4:]
WIDTHS = (32, 64, 128)  # every source is built at each

P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong
IP = ctypes.POINTER(ctypes.c_int)

_LIBS: dict[tuple, ctypes.CDLL] = {}  # (source, width) -> library
_GRIDS: dict[tuple, int] = {}  # (library, entry, *sizes, device) -> blocks
_INCLUDE = re.compile(r'^\s*#include\s+"([\w.]+)"', re.MULTILINE)


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and PATH)")


def _headers(name: str) -> list[Path]:
    """The csrc/ headers `<name>.cu` includes, directly or through other
    headers, so that a header change rebuilds only what depends on it."""
    seen, todo = set(), [CSRC / f"{name}.cu"]
    while todo:
        for inc in _INCLUDE.findall(todo.pop().read_text()):
            path = CSRC / inc
            if path.exists() and path not in seen:
                seen.add(path)
                todo.append(path)
    return sorted(seen)


def require_width(h: int, what: str) -> int:
    """`h` if the kernels have a library at hidden width h, else
    ValueError naming the built widths (no plain fallback on the card)."""
    if h not in WIDTHS:
        raise ValueError(
            f"{what}: no kernel library at hidden width {h}; the kernels "
            f"are built for widths {', '.join(map(str, WIDTHS))} (other "
            "widths: ROADMAP.md item 8d)")
    return h


def nvcc_flags(width: int) -> list[str]:
    """nvcc's flags for a library of hidden width `width`."""
    return [*NVCC_FLAGS, f"-DNLT_H={width}"]


def _check_source(name: str, width: int) -> None:
    if name not in SOURCES:
        raise ValueError(f"no kernel source {name!r}")
    require_width(width, f"csrc/{name}.cu")


def lib_path(name: str, width: int = 64) -> Path:
    """The library of csrc/<name>.cu at hidden width `width`: its name
    holds the source, the width and the hash of the sources it includes
    and of its nvcc flags."""
    _check_source(name, width)
    h = hashlib.sha256()
    for src in _headers(name) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(nvcc_flags(width)).encode())
    return BUILD_DIR / f"libnlt_{name}_h{width}-{h.hexdigest()[:16]}.so"


def lib_key(name: str, width: int = 64) -> str:
    """The key of a library in `build_all`'s result: the source's name at
    width 64, `<name>@<width>` at another width."""
    return name if width == 64 else f"{name}@{width}"


def _split_key(key: str) -> tuple[str, int]:
    name, _, width = key.partition("@")
    return name, int(width or 64)


def _start(name: str, width: int):
    """Start nvcc for one source at one width; None when its library is up
    to date."""
    out = lib_path(name, width)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *nvcc_flags(width), "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(key: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {key}:\n{log}")
    os.replace(tmp, out)


def build_all(names=SOURCES, widths=(64,)) -> dict[str, Path]:
    """Build every stale library of `names` at each of `widths`, one nvcc
    per source and width, all started together. Returns {lib_key: library
    path}."""
    pairs = [(n, w) for w in widths for n in names]
    jobs = {lib_key(n, w): _start(n, w) for n, w in pairs}
    errors = []
    for key, job in jobs.items():
        if job is None:
            continue
        try:
            _finish(key, job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return {lib_key(n, w): lib_path(n, w) for n, w in pairs}


def build_log(key: str) -> str:
    """nvcc's output (with ptxas register/shared-memory usage) from the
    build of the current library of `key` (`lib_key`)."""
    log = lib_path(*_split_key(key)).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name: str, signatures: dict, width: int = 64) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu at hidden width `width`, built
    if stale, with argtypes/restype set from `signatures` ({function:
    [argtypes]})."""
    lib = _LIBS.get((name, width))
    if lib is None:
        path = build_all((name,), (width,))[lib_key(name, width)]
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        lib.nlt_error_string.argtypes = [ctypes.c_int]
        lib.nlt_error_string.restype = ctypes.c_char_p
        _LIBS[name, width] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc != 0:
        msg = lib.nlt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg}) at launch")


def require_cuda(t):
    """The CUDA device of `t`; raises for any device but CUDA (the
    wrappers take their plain versions only for CPU tensors)."""
    if t.device.type != "cuda":
        raise ValueError(f"expected a CPU or CUDA tensor, got {t.device}")
    return t.device


def expect(ok: bool, name: str, got) -> None:
    if not ok:
        raise ValueError(f"unexpected {name}: {got}")


def pointers(device, *specs) -> list[int]:
    """data_ptr() of each (name, tensor, dtype) after checking that it lies
    on `device`, has `dtype` and is contiguous."""
    out = []
    for name, t, dtype in specs:
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        out.append(t.data_ptr())
    return out


def io_dtype(what: str, t):
    """The storage dtype of the kernel instance that takes `t`: float32 or
    bfloat16 (the bf16 instances read and write bf16 and compute in fp32).
    Raises TypeError for any other dtype: there is no instance to run."""
    import torch

    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what} is {t.dtype}: the kernel has float32 and "
                        "bfloat16 instances only")
    return t.dtype


def suffix(dtype) -> str:
    """The suffix of the C entry of the kernel instance of `dtype`: "" for
    float32, "_bf16" for bfloat16."""
    import torch

    return "_bf16" if dtype == torch.bfloat16 else ""


def count_launch(wrapper, dtype) -> None:
    """One launch of `wrapper`'s kernel instance of `dtype`: counted on
    `wrapper.launches` (float32) or `wrapper.launches_bf16` (bfloat16)."""
    import torch

    if dtype == torch.bfloat16:
        wrapper.launches_bf16 += 1
    else:
        wrapper.launches += 1


def stream_of(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def run_bwd(lib: ctypes.CDLL, fn_name: str, ptrs: list, sizes: list,
            n_params: int, device, what: str):
    """Launch a backward kernel and return its parameter gradients.

    `<fn_name>_grid(*sizes, device, &grid)` gives the number of blocks
    the kernel uses for these sizes (asked once per sizes and device);
    `<fn_name>(*ptrs, partial, *sizes, grid, device, stream)` launches
    them, each block writing its partial sums to its row of a (grid,
    n_params) scratch, summed here over blocks in a fixed order (no float
    atomics). Returns the (n_params,) sum."""
    import torch

    key = (lib._name, fn_name, *sizes, device.index)
    grid = _GRIDS.get(key)
    if grid is None:
        out = ctypes.c_int(0)
        check(lib, getattr(lib, fn_name + "_grid")(
            *sizes, device.index, ctypes.byref(out)), what)
        grid = _GRIDS[key] = out.value
    partial = torch.empty((grid, n_params), device=device,
                          dtype=torch.float32)
    check(lib, getattr(lib, fn_name)(*ptrs, partial.data_ptr(), *sizes, grid,
                                     device.index, stream_of(device)), what)
    return partial.sum(dim=0)
