// Parallel zarr-chunk decoder: blosc/zlib/gzip decompression across a
// thread pool, outside the GIL.
//
// A sample's time window spans several compressed zarr chunks; this decodes
// a whole set of them concurrently into one preallocated buffer. Bound from
// Python with ctypes (neural_lam_tpu_torch/native/__init__.py builds it at
// first use).
//
// Neither libblosc nor zlib is linked: each is opened with dlopen at the
// first chunk of its codec, so the library builds and loads on a machine
// that has neither the libraries nor their headers. A chunk whose codec
// library is missing fails with its own error code.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libchunkdec.so chunkdec.cpp
//        -ldl -lpthread

#include <dlfcn.h>

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

enum Codec : int32_t {
  CODEC_RAW = 0,
  CODEC_BLOSC = 1,
  CODEC_ZLIB = 2,
};

// Error codes (the Python binding names them).
enum Error : int {
  OK = 0,
  ERR_BLOSC = -1,      // blosc_decompress_ctx failed or wrote too little
  ERR_RAW_SIZE = -2,   // raw chunk of the wrong size
  ERR_ZLIB_INIT = -3,  // inflateInit2_ failed
  ERR_ZLIB = -4,       // inflate did not reach the stream's end
  ERR_CODEC = -5,      // unknown codec id
  ERR_NO_BLOSC = -6,   // libblosc.so.1 could not be opened
  ERR_NO_ZLIB = -7,    // libz.so.1 could not be opened
};

// zlib's z_stream, as its public ABI lays it out (zlib.h, unchanged since
// 1.2.0); inflateInit2_ checks sizeof(ZStream) against its own.
struct ZStream {
  const unsigned char* next_in;
  unsigned int avail_in;
  unsigned long total_in;
  unsigned char* next_out;
  unsigned int avail_out;
  unsigned long total_out;
  const char* msg;
  void* state;
  void* zalloc;
  void* zfree;
  void* opaque;
  int data_type;
  unsigned long adler;
  unsigned long reserved;
};
constexpr int Z_OK = 0, Z_STREAM_END = 1, Z_FINISH = 4;

struct Blosc {
  int (*decompress_ctx)(const void*, void*, size_t, int) = nullptr;
};

struct Zlib {
  const char* (*version)() = nullptr;
  int (*inflate_init2)(ZStream*, int, const char*, int) = nullptr;
  int (*inflate)(ZStream*, int) = nullptr;
  int (*inflate_end)(ZStream*) = nullptr;
};

// Opened once, at the first chunk that needs it (thread-safe statics).
const Blosc& blosc() {
  static const Blosc lib = [] {
    Blosc b;
    if (void* h = dlopen("libblosc.so.1", RTLD_NOW | RTLD_LOCAL)) {
      b.decompress_ctx = reinterpret_cast<decltype(b.decompress_ctx)>(
          dlsym(h, "blosc_decompress_ctx"));
    }
    return b;
  }();
  return lib;
}

const Zlib& zlib() {
  static const Zlib lib = [] {
    Zlib z;
    if (void* h = dlopen("libz.so.1", RTLD_NOW | RTLD_LOCAL)) {
      z.version = reinterpret_cast<decltype(z.version)>(
          dlsym(h, "zlibVersion"));
      z.inflate_init2 = reinterpret_cast<decltype(z.inflate_init2)>(
          dlsym(h, "inflateInit2_"));
      z.inflate = reinterpret_cast<decltype(z.inflate)>(dlsym(h, "inflate"));
      z.inflate_end = reinterpret_cast<decltype(z.inflate_end)>(
          dlsym(h, "inflateEnd"));
      if (!z.version || !z.inflate || !z.inflate_end) z.inflate_init2 = nullptr;
    }
    return z;
  }();
  return lib;
}

// Decode one chunk into out (chunk_nbytes destination bytes).
int decode_one(const uint8_t* src, int64_t src_size, int32_t codec,
               uint8_t* out, int64_t chunk_nbytes) {
  switch (codec) {
    case CODEC_RAW: {
      if (src_size != chunk_nbytes) return ERR_RAW_SIZE;
      std::memcpy(out, src, chunk_nbytes);
      return OK;
    }
    case CODEC_BLOSC: {
      const Blosc& b = blosc();
      if (!b.decompress_ctx) return ERR_NO_BLOSC;
      int n = b.decompress_ctx(src, out, (size_t)chunk_nbytes, 1);
      return n == chunk_nbytes ? OK : ERR_BLOSC;
    }
    case CODEC_ZLIB: {
      const Zlib& z = zlib();
      if (!z.inflate_init2) return ERR_NO_ZLIB;
      ZStream zs;
      std::memset(&zs, 0, sizeof(zs));
      // 47 = 15 | 32: a zlib or a gzip header, detected
      if (z.inflate_init2(&zs, 47, z.version(), (int)sizeof(ZStream)) != Z_OK)
        return ERR_ZLIB_INIT;
      zs.next_in = src;
      zs.avail_in = (unsigned int)src_size;
      zs.next_out = out;
      zs.avail_out = (unsigned int)chunk_nbytes;
      int ret = z.inflate(&zs, Z_FINISH);
      z.inflate_end(&zs);
      return ret == Z_STREAM_END && zs.total_out == (unsigned long)chunk_nbytes
                 ? OK
                 : ERR_ZLIB;
    }
    default:
      return ERR_CODEC;
  }
}

}  // namespace

extern "C" {

// Decode n_chunks buffers in parallel.
//   srcs:         n_chunks pointers to compressed buffers
//   src_sizes:    their sizes in bytes
//   codecs:       per-chunk codec id (Codec)
//   out:          chunk i decodes into out + i * chunk_nbytes
//   chunk_nbytes: decoded bytes of every chunk (a uniform chunk grid)
//   n_threads:    worker threads (<= 0: one per hardware thread)
// Returns 0, or the first non-zero per-chunk error code (Error).
int decode_chunks(const uint8_t** srcs, const int64_t* src_sizes,
                  const int32_t* codecs, int64_t n_chunks, uint8_t* out,
                  int64_t chunk_nbytes, int32_t n_threads) {
  if (n_threads <= 0) {
    n_threads = (int32_t)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = 4;
  }
  if (n_threads > n_chunks) n_threads = (int32_t)n_chunks;

  std::atomic<int64_t> next(0);
  std::atomic<int> error(OK);

  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n_chunks || error.load() != OK) return;
      int rc = decode_one(srcs[i], src_sizes[i], codecs[i],
                          out + i * chunk_nbytes, chunk_nbytes);
      if (rc != OK) {
        int expected = OK;
        error.compare_exchange_strong(expected, rc);
      }
    }
  };

  if (n_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    for (int32_t t = 0; t < n_threads; ++t) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
  }
  return error.load();
}

}  // extern "C"
