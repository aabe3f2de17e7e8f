"""Minimal zarr v2 reader and writer: numpy and the standard library, no
zarr or numcodecs package.

Counterpart of neural_lam_tpu/datastore/zarr_reader.py. MDP
("training-ready" zarr) datasets are read with this self-contained
implementation:

* zarr v2 directory layout: consolidated `.zmetadata` or per-array
  `.zarray`/`.zattrs`, chunk files `i.j.k` (configurable separator).
* compressors: blosc (via the system `libblosc` through ctypes — the
  default for mllam-data-prep outputs), zlib/gzip (stdlib), zstd (system
  `libzstd`), or none.
* filters: `vlen-utf8` (string feature-name arrays).
* xarray conventions: `_ARRAY_DIMENSIONS` dim names and CF time decoding
  ("<units> since <epoch>").

The writer covers the same subset; it writes the forecasts of the predict
CLI and builds datasets for tests. Decoded chunks go through a
process-wide LRU cache; a chunk that one thread is decoding, another
waits for instead of decoding it again. The chunks a read misses of a blosc, zlib, gzip
or uncompressed array decode together in the native decoder's thread pool
(`neural_lam_tpu_torch/native`); a zstd chunk and a string array decode
here, in Python.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import json
import threading
import zlib
from collections import OrderedDict
from pathlib import Path

import numpy as np

_blosc = None


class _ChunkCache:
    """Process-wide LRU over decoded chunks, keyed by (array path, chunk
    idx). Training samples are overlapping time windows — consecutive
    samples share ~(W-1)/W of their time rows — so caching decoded chunks
    removes most decompression from the input pipeline's hot path. Cached
    arrays are marked read-only; all read paths copy slices out of them.
    Budget: CHUNK_CACHE_BYTES."""

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self._d: OrderedDict = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self._inflight: dict = {}

    def get(self, key):
        with self._lock:
            v = self._d.get(key)
            if v is not None:
                self._d.move_to_end(key)
            return v

    def begin(self, key):
        """Claim a key for decoding: ('hit', chunk) if cached, ('compute',
        event) if this thread should decode it (call finish after), or
        ('wait', event) if another thread is already decoding it: wait on
        the event, then get(). Keeps the pooled loader's threads from
        decoding again the chunks their overlapping windows share."""
        with self._lock:
            v = self._d.get(key)
            if v is not None:
                self._d.move_to_end(key)
                return "hit", v
            ev = self._inflight.get(key)
            if ev is not None:
                return "wait", ev
            ev = threading.Event()
            self._inflight[key] = ev
            return "compute", ev

    def finish(self, key, chunk, event):
        """Complete a 'compute' claim (chunk=None releases it without
        caching, as after a failed decode)."""
        if chunk is not None:
            self.put(key, chunk)
        with self._lock:
            self._inflight.pop(key, None)
        event.set()

    def clear(self):
        """Drop every cached chunk."""
        with self._lock:
            self._d.clear()
            self._bytes = 0

    def put(self, key, arr: np.ndarray):
        if arr.nbytes > self.max_bytes:
            return
        arr.flags.writeable = False
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                return
            self._d[key] = arr
            self._bytes += arr.nbytes
            while self._bytes > self.max_bytes:
                _, old = self._d.popitem(last=False)
                self._bytes -= old.nbytes


CHUNK_CACHE_BYTES = 256_000_000
_chunk_cache = _ChunkCache(CHUNK_CACHE_BYTES)


def _get_blosc():
    global _blosc
    if _blosc is None:
        libname = ctypes.util.find_library("blosc") or "libblosc.so.1"
        lib = ctypes.CDLL(libname)
        lib.blosc_decompress_ctx.restype = ctypes.c_int
        lib.blosc_compress_ctx.restype = ctypes.c_int
        _blosc = lib
    return _blosc


def _blosc_decompress(buf: bytes, nbytes_out: int) -> bytes:
    lib = _get_blosc()
    out = ctypes.create_string_buffer(nbytes_out)
    n = lib.blosc_decompress_ctx(
        ctypes.c_char_p(buf), out, ctypes.c_size_t(nbytes_out),
        ctypes.c_int(1),
    )
    if n < 0:
        raise ValueError(f"blosc decompression failed (code {n})")
    return out.raw[:n]


def _blosc_compress(data: bytes, typesize: int, cname: str = "lz4",
                    clevel: int = 5, shuffle: int = 1) -> bytes:
    lib = _get_blosc()
    out = ctypes.create_string_buffer(len(data) + 16 + 2**12)
    n = lib.blosc_compress_ctx(
        ctypes.c_int(clevel), ctypes.c_int(shuffle),
        ctypes.c_size_t(typesize), ctypes.c_size_t(len(data)),
        ctypes.c_char_p(data), out, ctypes.c_size_t(len(out)),
        ctypes.c_char_p(cname.encode()), ctypes.c_size_t(0), ctypes.c_int(1),
    )
    if n <= 0:
        raise ValueError(f"blosc compression failed (code {n})")
    return out.raw[:n]


def _decompress(buf: bytes, compressor: dict | None, nbytes_out: int) -> bytes:
    if compressor is None:
        return buf
    cid = compressor["id"]
    if cid == "blosc":
        return _blosc_decompress(buf, nbytes_out)
    if cid in ("zlib", "gzip"):
        return zlib.decompress(buf, 47)  # auto-detect zlib/gzip headers
    if cid == "zstd":
        lib = ctypes.CDLL(ctypes.util.find_library("zstd") or "libzstd.so.1")
        lib.ZSTD_decompress.restype = ctypes.c_size_t
        out = ctypes.create_string_buffer(nbytes_out)
        n = lib.ZSTD_decompress(out, ctypes.c_size_t(nbytes_out),
                                ctypes.c_char_p(buf), ctypes.c_size_t(len(buf)))
        if n > nbytes_out:
            raise ValueError("zstd decompression failed")
        return out.raw[:n]
    raise NotImplementedError(f"compressor {cid}")


def _compress(data: bytes, compressor: dict | None, typesize: int) -> bytes:
    if compressor is None:
        return data
    cid = compressor["id"]
    if cid == "blosc":
        return _blosc_compress(
            data, typesize,
            cname=compressor.get("cname", "lz4"),
            clevel=compressor.get("clevel", 5),
            shuffle=compressor.get("shuffle", 1),
        )
    if cid == "zlib":
        return zlib.compress(data, compressor.get("level", 5))
    raise NotImplementedError(f"compressor {cid}")


def _decode_vlen_utf8(buf: bytes) -> np.ndarray:
    (count,) = np.frombuffer(buf[:4], "<u4")
    items = []
    off = 4
    for _ in range(count):
        (ln,) = np.frombuffer(buf[off:off + 4], "<u4")
        off += 4
        items.append(buf[off:off + ln].decode("utf-8"))
        off += ln
    return np.array(items, dtype=object)


def _encode_vlen_utf8(arr: np.ndarray) -> bytes:
    out = [np.uint32(arr.size).tobytes()]
    for s in arr.ravel():
        b = str(s).encode("utf-8")
        out.append(np.uint32(len(b)).tobytes())
        out.append(b)
    return b"".join(out)


_CF_UNITS = {
    "nanoseconds": "ns", "microseconds": "us", "milliseconds": "ms",
    "seconds": "s", "minutes": "m", "hours": "h", "days": "D",
}


def decode_cf_time(values: np.ndarray, units: str) -> np.ndarray:
    """Decode CF "<unit> since <epoch>" integers to datetime64[ns]."""
    unit_word, _, epoch = units.partition(" since ")
    np_unit = _CF_UNITS[unit_word.strip().lower()]
    epoch = epoch.strip().replace(" ", "T").rstrip("Z")
    base = np.datetime64(epoch).astype("datetime64[ns]")
    deltas = values.astype("int64") * np.timedelta64(1, np_unit).astype(
        "timedelta64[ns]"
    )
    return base + deltas


class ZarrArray:
    """One zarr v2 array inside a directory store."""

    def __init__(self, path: Path, meta: dict, attrs: dict):
        self.path = Path(path)
        self.meta = meta
        self.attrs = attrs or {}
        self.shape = tuple(meta["shape"])
        self.chunks = tuple(meta["chunks"])
        self.compressor = meta.get("compressor")
        self.filters = meta.get("filters") or []
        self.fill_value = meta.get("fill_value", 0)
        self.order = meta.get("order", "C")
        self.sep = meta.get("dimension_separator", ".")
        self._dtype_str = meta["dtype"]
        self.is_object = any(
            f.get("id") == "vlen-utf8" for f in self.filters
        ) or self._dtype_str in ("|O", "O")
        self.dtype = np.dtype("O") if self.is_object else np.dtype(self._dtype_str)

    @property
    def dims(self):
        return tuple(self.attrs.get("_ARRAY_DIMENSIONS", ()))

    @property
    def ndim(self):
        return len(self.shape)

    def _read_chunk_nocache(self, idx: tuple) -> np.ndarray:
        key = self.sep.join(str(i) for i in idx) if idx else "0"
        fp = self.path / key
        chunk_shape = tuple(self.chunks) if self.chunks else ()
        if not fp.exists():
            if self.is_object:
                out = np.empty(chunk_shape, dtype=object)
                out[...] = self.fill_value
                return out
            return np.full(chunk_shape, self.fill_value, dtype=self.dtype)
        raw = fp.read_bytes()
        if self.is_object:
            return _decode_vlen_utf8(
                _decompress(raw, self.compressor, 1 << 31)
                if self.compressor else raw
            ).reshape(chunk_shape)
        nbytes = int(np.prod(chunk_shape)) * self.dtype.itemsize
        buf = _decompress(raw, self.compressor, nbytes)
        arr = np.frombuffer(buf, dtype=self.dtype)
        return arr.reshape(chunk_shape, order=self.order)

    def _codec_id(self):
        """The native decoder's codec id for this array, or None where
        it has none (zstd, strings)."""
        from ..native import CODEC_BLOSC, CODEC_RAW, CODEC_ZLIB

        if self.is_object:
            return None
        if self.compressor is None:
            return CODEC_RAW
        return {"blosc": CODEC_BLOSC, "zlib": CODEC_ZLIB,
                "gzip": CODEC_ZLIB}.get(self.compressor["id"])

    def _decode_list(self, idx_list) -> list:
        """Decode the chunks `idx_list`, bypassing the cache: those of a
        codec the native decoder has go through it together."""
        codec = self._codec_id()
        if codec is None or not idx_list:
            return [self._read_chunk_nocache(idx) for idx in idx_list]
        from ..native import decode_chunks_parallel

        chunk_shape = tuple(self.chunks)
        nbytes = int(np.prod(chunk_shape)) * self.dtype.itemsize
        paths = [self.path / (self.sep.join(str(i) for i in idx) or "0")
                 for idx in idx_list]
        present = [fp.exists() for fp in paths]
        buffers = [fp.read_bytes() for fp, ok in zip(paths, present) if ok]
        flat = decode_chunks_parallel(buffers, [codec] * len(buffers),
                                      nbytes)
        decoded = iter(flat.reshape(len(buffers), nbytes).view(self.dtype))
        # copy each: a cached view would pin the whole batch's buffer
        return [np.array(next(decoded).reshape(chunk_shape,
                                               order=self.order))
                if ok else np.full(chunk_shape, self.fill_value, self.dtype)
                for ok in present]

    def _read_chunks_batch(self, idx_list) -> list:
        """The chunks `idx_list` through the LRU cache, with in-flight
        dedup across threads: the misses this thread claims are decoded
        together (`_decode_list`); a chunk another thread is decoding is
        waited for, not decoded again."""
        if self.is_object:  # strings are not cached
            return self._decode_list(idx_list)
        out, mine, waits = {}, [], []
        for idx in dict.fromkeys(idx_list):
            state, val = _chunk_cache.begin((self.path, idx))
            if state == "hit":
                out[idx] = val
            elif state == "compute":
                mine.append((idx, val))
            else:
                waits.append((idx, val))
        done = 0
        try:
            decoded = self._decode_list([idx for idx, _ in mine])
            for (idx, ev), chunk in zip(mine, decoded):
                _chunk_cache.finish((self.path, idx), chunk, ev)
                out[idx] = chunk
                done += 1
        finally:
            for idx, ev in mine[done:]:  # release the claims on failure
                _chunk_cache.finish((self.path, idx), None, ev)
        for idx, ev in waits:
            ev.wait()
            hit = _chunk_cache.get((self.path, idx))
            out[idx] = hit if hit is not None else self._decode_list([idx])[0]
        return [out[idx] for idx in idx_list]

    def read_full(self) -> np.ndarray:
        """Materialize the whole array."""
        if self.ndim == 0:
            return self._read_chunks_batch([()])[0]
        n_chunks = [
            -(-s // c) for s, c in zip(self.shape, self.chunks)
        ]
        out = np.empty(self.shape, dtype=self.dtype)
        idx_list = list(np.ndindex(*n_chunks))
        for idx, chunk in zip(idx_list, self._read_chunks_batch(idx_list)):
            slices = tuple(
                slice(i * c, min((i + 1) * c, s))
                for i, c, s in zip(idx, self.chunks, self.shape)
            )
            sub = tuple(slice(0, sl.stop - sl.start) for sl in slices)
            out[slices] = chunk[sub]
        return out

    def read_slice0(self, start: int, stop: int) -> np.ndarray:
        """Read rows [start, stop) along axis 0, touching only the chunks
        that intersect (the lazy-loading hot path for time slicing)."""
        start = max(0, start)
        stop = min(self.shape[0], stop)
        if stop <= start:
            return np.empty((0,) + self.shape[1:], dtype=self.dtype)
        c0 = self.chunks[0]
        first_chunk, last_chunk = start // c0, (stop - 1) // c0
        n_chunks_rest = [
            -(-s // c) for s, c in zip(self.shape[1:], self.chunks[1:])
        ]
        idx_list = [
            (i0,) + idx_rest
            for i0 in range(first_chunk, last_chunk + 1)
            for idx_rest in np.ndindex(*n_chunks_rest)
        ]
        chunks = dict(zip(idx_list, self._read_chunks_batch(idx_list)))
        out = np.empty((stop - start,) + self.shape[1:], dtype=self.dtype)
        for idx in idx_list:
            i0, idx_rest = idx[0], idx[1:]
            row_lo = max(start, i0 * c0)
            row_hi = min(stop, (i0 + 1) * c0, self.shape[0])
            rest_slices_out = tuple(
                slice(i * c, min((i + 1) * c, s))
                for i, c, s in zip(idx_rest, self.chunks[1:], self.shape[1:])
            )
            rest_slices_in = tuple(
                slice(0, sl.stop - sl.start) for sl in rest_slices_out
            )
            out[(slice(row_lo - start, row_hi - start),) + rest_slices_out] = (
                chunks[idx][(slice(row_lo - i0 * c0, row_hi - i0 * c0),)
                            + rest_slices_in]
            )
        return out

    def __getitem__(self, key):
        if isinstance(key, (int, np.integer)):
            k = int(key) + (self.shape[0] if key < 0 else 0)
            return self.read_slice0(k, k + 1)[0]
        if isinstance(key, slice) and key.step in (None, 1):
            lo, hi, _ = key.indices(self.shape[0])
            return self.read_slice0(lo, hi)
        return self.read_full()[key]


class LazyZarrLeading:
    """FieldArray-compatible lazy view over a ZarrArray's leading axis,
    with an optional row offset window [lo, hi)."""

    def __init__(self, arr: ZarrArray, lo: int = 0, hi: int | None = None):
        self._arr = arr
        self._lo = lo
        self._hi = arr.shape[0] if hi is None else hi
        self.dtype = arr.dtype

    @property
    def shape(self):
        return (self._hi - self._lo,) + self._arr.shape[1:]

    def __getitem__(self, key):
        n = self._hi - self._lo
        if isinstance(key, (int, np.integer)):
            k = int(key) + (n if key < 0 else 0)
            return self._arr.read_slice0(self._lo + k, self._lo + k + 1)[0]
        if isinstance(key, slice) and key.step in (None, 1):
            lo, hi, _ = key.indices(n)
            return self._arr.read_slice0(self._lo + lo, self._lo + hi)
        return self._arr.read_slice0(self._lo, self._hi)[key]


class ZarrGroup:
    """A zarr v2 group directory (consolidated metadata supported)."""

    def __init__(self, path):
        self.path = Path(path)
        self.arrays: dict[str, ZarrArray] = {}
        self.attrs: dict = {}
        meta_path = self.path / ".zmetadata"
        if meta_path.exists():
            consolidated = json.loads(meta_path.read_text())["metadata"]
            self.attrs = consolidated.get(".zattrs", {})
            names = {
                k.split("/")[0]
                for k in consolidated
                if k.endswith("/.zarray")
            }
            for name in names:
                self.arrays[name] = ZarrArray(
                    self.path / name,
                    consolidated[f"{name}/.zarray"],
                    consolidated.get(f"{name}/.zattrs", {}),
                )
        else:
            zattrs = self.path / ".zattrs"
            if zattrs.exists():
                self.attrs = json.loads(zattrs.read_text())
            for sub in sorted(self.path.iterdir()):
                if (sub / ".zarray").exists():
                    meta = json.loads((sub / ".zarray").read_text())
                    attrs = {}
                    if (sub / ".zattrs").exists():
                        attrs = json.loads((sub / ".zattrs").read_text())
                    self.arrays[sub.name] = ZarrArray(sub, meta, attrs)

    def __contains__(self, name):
        return name in self.arrays

    def __getitem__(self, name) -> ZarrArray:
        return self.arrays[name]


# --- writer (forecasts, test datasets) ---

def write_zarr_array(group_path, name, arr: np.ndarray, dims=None,
                     attrs=None, chunks=None, compressor="default"):
    """Write one array in zarr v2 format under group_path/name."""
    group_path = Path(group_path)
    adir = group_path / name
    adir.mkdir(parents=True, exist_ok=True)
    arr = np.asarray(arr)
    if compressor == "default":
        compressor = {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1}

    is_str = arr.dtype.kind in ("U", "O")
    filters = None
    if is_str:
        dtype_str = "|O"
        filters = [{"id": "vlen-utf8"}]
    else:
        dtype_str = arr.dtype.str

    time_attrs = {}
    if arr.dtype.kind == "M":
        # CF-encode datetimes as int64 ns
        time_attrs = {"units": "nanoseconds since 1970-01-01",
                      "calendar": "proleptic_gregorian"}
        arr = arr.astype("datetime64[ns]").astype("int64")
        dtype_str = arr.dtype.str
    if arr.dtype.kind == "m":
        time_attrs = {"units": "nanoseconds"}
        arr = arr.astype("timedelta64[ns]").astype("int64")
        dtype_str = arr.dtype.str

    chunks = list(chunks or arr.shape or [1])
    meta = {
        "zarr_format": 2,
        "shape": list(arr.shape),
        "chunks": chunks,
        "dtype": dtype_str,
        "compressor": compressor,
        "fill_value": None if is_str else 0,
        "filters": filters,
        "order": "C",
        "dimension_separator": ".",
    }
    (adir / ".zarray").write_text(json.dumps(meta))
    all_attrs = dict(attrs or {})
    if dims is not None:
        all_attrs["_ARRAY_DIMENSIONS"] = list(dims)
    all_attrs.update(time_attrs)
    (adir / ".zattrs").write_text(json.dumps(all_attrs))

    n_chunks = [-(-s // c) for s, c in zip(arr.shape, chunks)] or []
    if not arr.shape:
        data = (_encode_vlen_utf8(arr.reshape(1)) if is_str
                else arr.tobytes())
        (adir / "0").write_bytes(
            _compress(data, compressor, arr.dtype.itemsize if not is_str else 1)
        )
        return
    for idx in np.ndindex(*n_chunks):
        slices = tuple(
            slice(i * c, min((i + 1) * c, s))
            for i, c, s in zip(idx, chunks, arr.shape)
        )
        chunk = arr[slices]
        # pad partial chunks to full chunk shape
        if tuple(chunk.shape) != tuple(chunks):
            if is_str:
                full = np.empty(chunks, dtype=object)
                full[...] = ""
            else:
                full = np.zeros(chunks, dtype=arr.dtype)
            full[tuple(slice(0, e - s.start) for s, e in
                       zip(slices, [sl.stop for sl in slices]))] = chunk
            chunk = full
        data = (_encode_vlen_utf8(chunk) if is_str
                else np.ascontiguousarray(chunk).tobytes())
        key = ".".join(str(i) for i in idx)
        (adir / key).write_bytes(
            _compress(data, compressor,
                      1 if is_str else arr.dtype.itemsize)
        )


def consolidate_metadata(group_path):
    """Write .zmetadata + .zgroup for a directory of arrays."""
    group_path = Path(group_path)
    meta = {".zgroup": {"zarr_format": 2}}
    (group_path / ".zgroup").write_text(json.dumps({"zarr_format": 2}))
    for sub in sorted(group_path.iterdir()):
        if (sub / ".zarray").exists():
            meta[f"{sub.name}/.zarray"] = json.loads(
                (sub / ".zarray").read_text()
            )
            if (sub / ".zattrs").exists():
                meta[f"{sub.name}/.zattrs"] = json.loads(
                    (sub / ".zattrs").read_text()
                )
    (group_path / ".zmetadata").write_text(
        json.dumps({"metadata": meta, "zarr_consolidated_format": 1})
    )
