"""The port's native zarr-chunk decoder (`neural_lam_tpu_torch/native`)
against the JAX package's and against the port's Python path, on the CPU.

* Raw, zlib, gzip and blosc chunks, one call over all codecs and one per
  codec: the same bytes as the JAX decoder and as `zarr_reader._decompress`.
* Multi-chunk `read_full` and `read_slice0` of arrays written with each
  codec (a missing chunk file among them) and a one-chunk array equal to
  the JAX reader's, with the misses decoded natively (its chunk count
  rises), a warm read served from the cache and a string array decoded in
  Python (it does not).
* A corrupt or truncated chunk raises, in the decoder and in the reader.
* The library links neither libblosc nor zlib (`readelf -d`).
* Two processes building into one empty directory at once each load a
  whole library, and no build file is left behind.
"""

import ctypes
import gzip
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

from neural_lam_tpu import native as j_native
from neural_lam_tpu.datastore.zarr_reader import ZarrGroup as JZarrGroup
from neural_lam_tpu_torch import native
from neural_lam_tpu_torch.datastore import zarr_reader
from neural_lam_tpu_torch.datastore.zarr_reader import (
    ZarrGroup,
    write_zarr_array,
)

ROOT = Path(__file__).resolve().parent.parent
NBYTES = 4 * 3000


def _chunks(n=6, seed=0):
    rng = np.random.default_rng(seed)
    # smooth rows compress; noise does not: both kinds of stream
    return [(np.cumsum(rng.standard_normal(NBYTES // 4)) if i % 2 else
             rng.standard_normal(NBYTES // 4)).astype(np.float32).tobytes()
            for i in range(n)]


def _encode(codec, raw):
    """(native codec id, compressor dict for the Python path, bytes)."""
    if codec == "raw":
        return native.CODEC_RAW, None, raw
    if codec == "zlib":
        return native.CODEC_ZLIB, {"id": "zlib"}, zlib.compress(raw, 5)
    if codec == "gzip":
        return native.CODEC_ZLIB, {"id": "gzip"}, gzip.compress(raw)
    return native.CODEC_BLOSC, {"id": "blosc"}, \
        zarr_reader._blosc_compress(raw, 4)


CODECS = ["raw", "zlib", "gzip", "blosc"]


@pytest.fixture(scope="module")
def j_decode(tmp_path_factory):
    """The JAX package's decoder, built by its own code into a private
    path (so that no other test process building it beside its source
    can race this one)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_native, "_SO_PATH",
                   str(tmp_path_factory.mktemp("jax_native") / "lib.so"))
        mp.setattr(j_native, "_lib", None)
        mp.setattr(j_native, "_tried", False)
        assert j_native.get_lib() is not None
        yield j_native.decode_chunks_parallel


@pytest.mark.parametrize("codec", CODECS + ["mixed"])
def test_decoder_matches_jax_and_python(codec, j_decode):
    raws = _chunks()
    names = [CODECS[i % 4] for i in range(len(raws))] if codec == "mixed" \
        else [codec] * len(raws)
    enc = [_encode(c, r) for c, r in zip(names, raws)]
    ids, bufs = [e[0] for e in enc], [e[2] for e in enc]
    before = native.decoded_chunks
    got = native.decode_chunks_parallel(bufs, ids, NBYTES)
    assert native.decoded_chunks == before + len(bufs)
    assert got.tobytes() == b"".join(raws)
    want = j_decode(bufs, ids, NBYTES)
    assert want is not None and got.tobytes() == want.tobytes()
    python = b"".join(zarr_reader._decompress(b, c, NBYTES)
                      for _, c, b in enc)
    assert got.tobytes() == python
    # one thread and more threads than chunks give the same bytes
    for threads in (1, 64):
        assert _decode_with_threads(bufs, ids, threads) == got.tobytes()


def _decode_with_threads(bufs, ids, n_threads):
    """The library's C entry at a thread count of its own."""
    n = len(bufs)
    out = np.empty(n * NBYTES, dtype=np.uint8)
    rc = native.library().decode_chunks(
        (ctypes.c_char_p * n)(*bufs), (ctypes.c_int64 * n)(*map(len, bufs)),
        (ctypes.c_int32 * n)(*ids), n, out.ctypes.data, NBYTES, n_threads)
    assert rc == 0
    return out.tobytes()


@pytest.mark.parametrize("codec", ["zlib", "gzip", "blosc", "raw"])
def test_corrupt_chunk_raises(codec):
    raws = _chunks(3)
    enc = [_encode(codec, r) for r in raws]
    ids = [e[0] for e in enc]
    bad = [e[2] for e in enc]
    bad[1] = bad[1][:len(bad[1]) // 2]  # truncated
    with pytest.raises(ValueError, match="native chunk decode failed"):
        native.decode_chunks_parallel(bad, ids, NBYTES)
    if codec != "raw":
        garbage = [e[2] for e in enc]
        garbage[2] = bytes(len(garbage[2]))
        with pytest.raises(ValueError, match="native chunk decode failed"):
            native.decode_chunks_parallel(garbage, ids, NBYTES)
    with pytest.raises(ValueError, match="unknown codec"):
        native.decode_chunks_parallel([enc[0][2]] * 2, [7, 7], NBYTES)
    with pytest.raises(ValueError, match="3 buffers with 2 codecs"):
        native.decode_chunks_parallel(bad, ids[:2], NBYTES)


@pytest.mark.parametrize("compressor", [
    {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1},
    {"id": "zlib", "level": 1}, None])
def test_reader_batches_match_jax(tmp_path, compressor):
    rng = np.random.default_rng(1)
    arr = rng.standard_normal((11, 37, 5)).astype(np.float32)
    write_zarr_array(tmp_path / "g", "a", arr, dims=["t", "n", "f"],
                     chunks=[3, 20, 5], compressor=compressor)
    write_zarr_array(tmp_path / "g", "s", arr[0, :, 0], dims=["n"],
                     chunks=[37], compressor=compressor)
    (tmp_path / "g" / "a" / "1.1.0").unlink()  # a chunk of fill values
    want = JZarrGroup(tmp_path / "g")["a"]
    expect = want.read_full()
    assert (expect[3:6, 20:] == 0).all()

    zarr_reader._chunk_cache.clear()
    a = ZarrGroup(tmp_path / "g")["a"]
    before = native.decoded_chunks
    np.testing.assert_array_equal(a.read_slice0(2, 7), want.read_slice0(2, 7))
    # rows 2..6 span chunks 0-2 of axis 0, two chunks each on axis 1; the
    # missing file is filled, not decoded
    assert native.decoded_chunks == before + 5
    np.testing.assert_array_equal(a.read_full(), expect)
    assert native.decoded_chunks == before + 7  # the last row of chunks
    np.testing.assert_array_equal(a.read_full(), expect)
    np.testing.assert_array_equal(a[4], want[4])
    np.testing.assert_array_equal(a[-2:], want[-2:])
    assert native.decoded_chunks == before + 7  # warm: served by the cache
    # a one-chunk array decodes natively too
    np.testing.assert_array_equal(ZarrGroup(tmp_path / "g")["s"].read_full(),
                                  JZarrGroup(tmp_path / "g")["s"].read_full())
    assert native.decoded_chunks == before + 8
    # a string array decodes in Python
    names = ["u10", "v10", "t2m"]
    write_zarr_array(tmp_path / "g", "names", np.array(names, dtype=object),
                     dims=["f"], chunks=[3], compressor=None)
    assert list(ZarrGroup(tmp_path / "g")["names"].read_full()) == names
    assert list(JZarrGroup(tmp_path / "g")["names"].read_full()) == names
    assert native.decoded_chunks == before + 8


def test_reader_corrupt_chunk_raises(tmp_path):
    arr = np.arange(40, dtype=np.float32).reshape(8, 5)
    write_zarr_array(tmp_path / "g", "a", arr, dims=["t", "f"], chunks=[2, 5],
                     compressor={"id": "zlib", "level": 1})
    fp = tmp_path / "g" / "a" / "2.0"
    fp.write_bytes(fp.read_bytes()[:-4])
    zarr_reader._chunk_cache.clear()
    with pytest.raises(ValueError, match="native chunk decode failed"):
        ZarrGroup(tmp_path / "g")["a"].read_full()


def test_library_links_no_codec_library():
    path = native.build()
    assert path.parent == native.BUILD_DIR
    needed = [line for line in subprocess.run(
        ["readelf", "-d", str(path)], check=True, capture_output=True,
        text=True).stdout.splitlines() if "(NEEDED)" in line]
    assert needed
    assert not [n for n in needed if "blosc" in n or "libz" in n], needed


def test_concurrent_builds_load_whole_libraries(tmp_path):
    code = f"""
import sys, zlib
from pathlib import Path
from neural_lam_tpu_torch import native
native.BUILD_DIR = Path({str(tmp_path)!r})
raw = bytes(range(256)) * 64
out = native.decode_chunks_parallel(
    [zlib.compress(raw), raw], [native.CODEC_ZLIB, native.CODEC_RAW],
    len(raw))
assert out.tobytes() == raw * 2
print(native.lib_path().name)
"""
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    names = {out.split()[-1] for out, _ in outs}
    assert len(names) == 1
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(names)


def test_failed_build_raises(tmp_path, monkeypatch):
    """No fallback: a source g++ cannot compile raises, and nothing is
    left in the build directory."""
    src = tmp_path / "chunkdec.cpp"
    src.write_text(native.SRC.read_text().replace("namespace {", "namespace"))
    monkeypatch.setattr(native, "SRC", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.decode_chunks_parallel([b"x" * 8] * 2, [native.CODEC_RAW] * 2,
                                      8)
    assert list((tmp_path / "build").iterdir()) == []
