"""The native zarr-chunk decoder, built at first use with the system g++.

Counterpart of neural_lam_tpu/native. `decode_chunks_parallel` decodes a
batch of compressed zarr chunks (blosc, zlib, gzip or raw) across a C++
thread pool outside the GIL, one thread per hardware thread unless
NLT_DECODE_THREADS sets the budget of a call;
`datastore/zarr_reader.py` sends every chunk it misses of those codecs
through it.

`chunkdec.cpp` compiles into `neural_lam_tpu_torch/_kernels/` (listed in
.gitignore), into a library named after the hash of its source and flags,
built aside and renamed into place, so processes that build at once each
load a whole library. It links neither libblosc nor zlib: it opens each at
the first chunk of its codec, so it builds where neither is installed, and
a blosc chunk on such a machine raises. There is no fallback: a failed
build raises.

`decoded_chunks` counts the chunks this process decoded here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "chunkdec.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_kernels"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
LIBS = ["-ldl", "-lpthread"]

CODEC_RAW, CODEC_BLOSC, CODEC_ZLIB = 0, 1, 2
ERRORS = {
    -1: "blosc decompression failed",
    -2: "raw chunk of the wrong size",
    -3: "zlib inflateInit2 failed",
    -4: "zlib/gzip decompression failed",
    -5: "unknown codec",
    -6: "libblosc.so.1 could not be opened (is libblosc installed?)",
    -7: "libz.so.1 could not be opened",
}

_lock = threading.Lock()
_lib = None
decoded_chunks = 0


def decode_threads() -> int:
    """The thread budget of one decode call: NLT_DECODE_THREADS, or 0 (one
    thread per hardware thread) where it is unset: a manual override, so
    that the concurrent calls of a pooled loader's threads need not
    oversubscribe the cores (the chunk cache's in-flight dedup keeps them
    off each other's chunks, so their calls rarely overlap)."""
    return int(os.environ.get("NLT_DECODE_THREADS", "0") or 0)


def lib_path() -> Path:
    """The library's path for the current source and flags."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libchunkdec-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Build the library unless it is there; returns its path. Raises
    RuntimeError when g++ is missing or fails."""
    out = lib_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"building {SRC.name} failed: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SRC.name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded decoder library, built first if need be."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.decode_chunks.restype = ctypes.c_int
            lib.decode_chunks.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int64,
                ctypes.c_void_p,
                ctypes.c_int64,
                ctypes.c_int32,
            ]
            _lib = lib
    return _lib


def decode_chunks_parallel(buffers: list, codecs: list,
                           chunk_nbytes: int) -> np.ndarray:
    """Decode the compressed chunks `buffers` (bytes each) concurrently.

    codecs: a CODEC_* id per chunk. Returns a flat uint8 array of
    len(buffers) * chunk_nbytes bytes, chunk i at i * chunk_nbytes.
    Raises ValueError when a chunk does not decode to chunk_nbytes bytes."""
    global decoded_chunks
    n = len(buffers)
    if len(codecs) != n or chunk_nbytes <= 0:
        raise ValueError(f"{n} buffers with {len(codecs)} codecs, "
                         f"{chunk_nbytes} bytes a chunk")
    lib = library()
    out = np.empty(n * chunk_nbytes, dtype=np.uint8)
    if n == 0:
        return out
    srcs = (ctypes.c_char_p * n)(*buffers)
    sizes = (ctypes.c_int64 * n)(*[len(b) for b in buffers])
    ids = (ctypes.c_int32 * n)(*codecs)
    rc = lib.decode_chunks(srcs, sizes, ids, n, out.ctypes.data,
                           chunk_nbytes, decode_threads())
    if rc != 0:
        raise ValueError(f"native chunk decode failed (code {rc}: "
                         f"{ERRORS.get(rc, 'unknown error')})")
    with _lock:
        decoded_chunks += n
    return out
