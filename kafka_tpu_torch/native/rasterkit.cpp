// rasterkit — thread-pooled tile codec for the GeoTIFF pipeline.
//
// A copy of kafka_tpu/native/rasterkit.cpp for the PyTorch port (built
// at first use by kafka_tpu_torch/native/__init__.py).  The codec hot
// path of the GeoTIFF pipeline: batch zlib inflate/deflate of
// TIFF tiles across a worker pool, callable from Python via ctypes with
// zero per-tile Python overhead.  A 10980x10980 Sentinel-2 tile-year is
// ~10^5 tile inflations — embarrassingly parallel, GIL-free here.
//
// C ABI:
//   rk_inflate_batch(n, in_ptrs, in_sizes, out_buf, out_stride, out_sizes,
//                    n_threads) -> 0 on success
//   rk_deflate_batch(n, in_ptrs, in_sizes, level, out_buf, out_stride,
//                    out_sizes, n_threads) -> 0 on success
//
// Each output slot i is out_buf + i*out_stride with capacity out_stride;
// actual byte counts land in out_sizes.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

template <typename Fn>
void parallel_for(int64_t n, int n_threads, Fn fn) {
  if (n_threads <= 1 || n <= 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> workers;
  int n_workers = static_cast<int>(
      std::min<int64_t>(n, static_cast<int64_t>(n_threads)));
  workers.reserve(n_workers);
  for (int t = 0; t < n_workers; ++t) {
    workers.emplace_back([&] {
      while (true) {
        int64_t i = next.fetch_add(1);
        if (i >= n) break;
        fn(i);
      }
    });
  }
  for (auto& w : workers) w.join();
}

// TIFF LZW decode (MSB-first bit order with the early-change quirk) —
// mirrors the Python reference decoder in io/geotiff.py bit for bit.
// Returns 0 on success, -1 on a corrupt stream / overfull output.
int lzw_decode_one(const uint8_t* in, int64_t in_size, uint8_t* out,
                   int64_t out_cap, int64_t* out_len) {
  constexpr int kClear = 256, kEoi = 257;
  uint16_t prefix[4096];
  uint8_t suffix[4096];
  uint8_t stack[4097];
  int next = 258;
  int nbits = 9;
  int64_t bitpos = 0;
  const int64_t total_bits = in_size * 8;
  int prev = -1;
  int64_t len = 0;
  while (bitpos + nbits <= total_bits) {
    const int64_t byte_idx = bitpos >> 3;
    uint32_t chunk = 0;
    for (int b = 0; b < 4; ++b) {
      chunk = (chunk << 8) |
              (byte_idx + b < in_size ? in[byte_idx + b] : 0);
    }
    const int code = static_cast<int>(
        (chunk >> (32 - nbits - (bitpos & 7))) & ((1u << nbits) - 1));
    bitpos += nbits;
    if (code == kEoi) break;
    if (code == kClear) {
      next = 258;
      nbits = 9;
      prev = -1;
      continue;
    }
    int sp = 0;
    uint8_t first;
    if (prev < 0) {
      if (code > 255) return -1;
      if (len >= out_cap) return -1;
      out[len++] = static_cast<uint8_t>(code);
      first = static_cast<uint8_t>(code);
      prev = code;
      // (no table append on the first code after a clear — matches the
      // Python decoder; early-change check still runs below)
      if (next >= (1 << nbits) - 1 && nbits < 12) ++nbits;
      continue;
    }
    int walk;
    if (code < next) {
      walk = code;
    } else if (code == next) {
      // KwKwK: emission = string(prev) + first(string(prev))
      walk = prev;
    } else {
      return -1;
    }
    while (walk >= 258) {
      if (sp >= 4096) return -1;
      stack[sp++] = suffix[walk];
      walk = prefix[walk];
    }
    stack[sp++] = static_cast<uint8_t>(walk);
    first = stack[sp - 1];
    if (len + sp + (code == next ? 1 : 0) > out_cap) return -1;
    while (sp) out[len++] = stack[--sp];
    if (code == next) out[len++] = first;
    if (next < 4096) {
      prefix[next] = static_cast<uint16_t>(prev);
      suffix[next] = first;
      ++next;
    }
    prev = code;
    if (next >= (1 << nbits) - 1 && nbits < 12) ++nbits;
  }
  *out_len = len;
  return 0;
}

// TIFF LZW encode — matched to the decoders above: width switch one
// append later than the decoder (its table lags by one entry), clear at
// 4094, and the LZWPostEncode-style final width bump before the EOI.
int lzw_encode_one(const uint8_t* in, int64_t n, uint8_t* out,
                   int64_t cap, int64_t* out_len) {
  constexpr int kHSize = 18013;  // prime, ~4.4x load for 4096 codes
  std::vector<int32_t> hkey(kHSize, -1);
  std::vector<uint16_t> hval(kHSize);
  int64_t len = 0;
  uint32_t bitbuf = 0;
  int bitcnt = 0;
  int nbits = 9;
  int next = 258;
  bool ok = true;
  auto put = [&](int code) {
    bitbuf = (bitbuf << nbits) | static_cast<uint32_t>(code);
    bitcnt += nbits;
    while (bitcnt >= 8) {
      if (len >= cap) { ok = false; return; }
      out[len++] = static_cast<uint8_t>((bitbuf >> (bitcnt - 8)) & 0xFF);
      bitcnt -= 8;
    }
  };
  put(256);
  int w = -1;
  for (int64_t i = 0; i < n && ok; ++i) {
    const int c = in[i];
    if (w < 0) {
      w = c;
      continue;
    }
    const int32_t key = (w << 8) | c;
    int h = static_cast<int>(
        (static_cast<uint32_t>(key) * 2654435761u) % kHSize);
    int found = -1;
    while (hkey[h] != -1) {
      if (hkey[h] == key) {
        found = hval[h];
        break;
      }
      h = (h + 1) % kHSize;
    }
    if (found >= 0) {
      w = found;
      continue;
    }
    put(w);
    hkey[h] = key;
    hval[h] = static_cast<uint16_t>(next);
    ++next;
    if (next >= 4094) {
      put(256);
      std::fill(hkey.begin(), hkey.end(), -1);
      next = 258;
      nbits = 9;
    } else if (next >= (1 << nbits) && nbits < 12) {
      ++nbits;
    }
    w = c;
  }
  if (w >= 0 && ok) {
    put(w);
    if (next >= (1 << nbits) - 1 && nbits < 12) ++nbits;
  }
  if (ok) put(257);
  if (ok && bitcnt) {
    if (len >= cap) {
      ok = false;
    } else {
      out[len++] = static_cast<uint8_t>((bitbuf << (8 - bitcnt)) & 0xFF);
    }
  }
  if (!ok) return -1;
  *out_len = len;
  return 0;
}

// TIFF predictor-3 inverse (libtiff fpAcc): per row, byte-wise prefix sum
// with stride nb over the 4 byte-significance planes (MSB plane first),
// then unshuffle planes back into little-endian float32 samples.
void fp3_accumulate(const uint8_t* raw, int rows, int cols, int nb,
                    float* out, std::vector<uint8_t>& scratch) {
  const int cn = cols * nb;
  const int rowbytes = 4 * cn;
  scratch.resize(rowbytes);
  for (int r = 0; r < rows; ++r) {
    const uint8_t* src = raw + static_cast<size_t>(r) * rowbytes;
    uint8_t* acc = scratch.data();
    std::memcpy(acc, src, rowbytes);
    for (int i = nb; i < rowbytes; ++i)
      acc[i] = static_cast<uint8_t>(acc[i] + acc[i - nb]);
    uint8_t* o = reinterpret_cast<uint8_t*>(out
                                            + static_cast<size_t>(r) * cn);
    const uint8_t* p0 = acc;            // MSB plane
    const uint8_t* p1 = acc + cn;
    const uint8_t* p2 = acc + 2 * cn;
    const uint8_t* p3 = acc + 3 * cn;   // LSB plane
    for (int j = 0; j < cn; ++j) {
      o[4 * j + 0] = p3[j];
      o[4 * j + 1] = p2[j];
      o[4 * j + 2] = p1[j];
      o[4 * j + 3] = p0[j];
    }
  }
}

// TIFF predictor-3 forward (libtiff fpDiff): shuffle float32 samples into
// byte-significance planes (MSB first) per row, then byte-wise
// horizontal differencing with stride nb.
void fp3_difference(const float* in, int rows, int cols, int nb,
                    uint8_t* out) {
  const int cn = cols * nb;
  const int rowbytes = 4 * cn;
  for (int r = 0; r < rows; ++r) {
    const uint8_t* s = reinterpret_cast<const uint8_t*>(
        in + static_cast<size_t>(r) * cn);
    uint8_t* dst = out + static_cast<size_t>(r) * rowbytes;
    uint8_t* p0 = dst;
    uint8_t* p1 = dst + cn;
    uint8_t* p2 = dst + 2 * cn;
    uint8_t* p3 = dst + 3 * cn;
    for (int j = 0; j < cn; ++j) {
      p0[j] = s[4 * j + 3];
      p1[j] = s[4 * j + 2];
      p2[j] = s[4 * j + 1];
      p3[j] = s[4 * j + 0];
    }
    for (int i = rowbytes - 1; i >= nb; --i)
      dst[i] = static_cast<uint8_t>(dst[i] - dst[i - nb]);
  }
}

}  // namespace

extern "C" {

// Batch TIFF-LZW inflate across the worker pool (GDAL's default
// compression for real-world S2 trees; the Python fallback decodes at
// ~1 MB/s, crippling at tile-year scale).
int rk_lzw_inflate_batch(int64_t n, const uint8_t** in_ptrs,
                         const int64_t* in_sizes, uint8_t* out_buf,
                         int64_t out_stride, int64_t* out_sizes,
                         int n_threads) {
  std::atomic<int> status(0);
  parallel_for(n, n_threads, [&](int64_t i) {
    int64_t out_len = 0;
    int rc = lzw_decode_one(in_ptrs[i], in_sizes[i],
                            out_buf + i * out_stride, out_stride,
                            &out_len);
    if (rc != 0) {
      status.store(rc);
      out_sizes[i] = 0;
    } else {
      out_sizes[i] = out_len;
    }
  });
  return status.load();
}

// Batch TIFF-LZW deflate across the worker pool (makes the writer's
// compress="lzw" GDAL-compatibility mode a parallel production path
// instead of the serial Python encoder).
int rk_lzw_deflate_batch(int64_t n, const uint8_t** in_ptrs,
                         const int64_t* in_sizes, uint8_t* out_buf,
                         int64_t out_stride, int64_t* out_sizes,
                         int n_threads) {
  std::atomic<int> status(0);
  parallel_for(n, n_threads, [&](int64_t i) {
    int64_t out_len = 0;
    int rc = lzw_encode_one(in_ptrs[i], in_sizes[i],
                            out_buf + i * out_stride, out_stride,
                            &out_len);
    if (rc != 0) {
      status.store(rc);
      out_sizes[i] = 0;
    } else {
      out_sizes[i] = out_len;
    }
  });
  return status.load();
}

// Fused tile decode for float32 predictor-3 tiles: (optional) zlib
// inflate + fpAcc + byte unshuffle, one parallel pass over n tiles.
// in_sizes[i] == 0 means a sparse/absent tile -> zero-filled output.
// Short payloads are zero-padded (the Python codec's ljust contract).
int rk_decode_fp3_batch(int64_t n, const uint8_t** in_ptrs,
                        const int64_t* in_sizes, int rows, int cols,
                        int nb, int compressed, float* out,
                        int64_t out_stride_floats, int n_threads) {
  std::atomic<int> status(0);
  const size_t rawbytes = static_cast<size_t>(rows) * 4 * cols * nb;
  parallel_for(n, n_threads, [&](int64_t i) {
    float* dst = out + i * out_stride_floats;
    if (in_sizes[i] == 0) {
      std::memset(dst, 0, rawbytes);
      return;
    }
    std::vector<uint8_t> raw(rawbytes, 0);
    if (compressed) {
      uLongf dest_len = static_cast<uLongf>(rawbytes);
      int rc = uncompress(raw.data(), &dest_len, in_ptrs[i],
                          static_cast<uLong>(in_sizes[i]));
      if (rc != Z_OK) {
        status.store(rc);
        std::memset(dst, 0, rawbytes);
        return;
      }
    } else {
      std::memcpy(raw.data(), in_ptrs[i],
                  std::min(rawbytes, static_cast<size_t>(in_sizes[i])));
    }
    std::vector<uint8_t> scratch;
    fp3_accumulate(raw.data(), rows, cols, nb, dst, scratch);
  });
  return status.load();
}

// Fused tile encode: fpDiff + zlib deflate, one parallel pass.  Input is
// n contiguous float32 tiles at in_stride_floats; output slot i is
// out_buf + i*out_stride with capacity out_stride, byte counts in
// out_sizes.
int rk_encode_fp3_batch(int64_t n, const float* in,
                        int64_t in_stride_floats, int rows, int cols,
                        int nb, int level, uint8_t* out_buf,
                        int64_t out_stride, int64_t* out_sizes,
                        int n_threads) {
  std::atomic<int> status(0);
  const size_t rawbytes = static_cast<size_t>(rows) * 4 * cols * nb;
  parallel_for(n, n_threads, [&](int64_t i) {
    std::vector<uint8_t> raw(rawbytes);
    fp3_difference(in + i * in_stride_floats, rows, cols, nb, raw.data());
    uLongf dest_len = static_cast<uLongf>(out_stride);
    int rc = compress2(out_buf + i * out_stride, &dest_len, raw.data(),
                       static_cast<uLong>(rawbytes), level);
    if (rc != Z_OK) {
      status.store(rc);
      out_sizes[i] = 0;
    } else {
      out_sizes[i] = static_cast<int64_t>(dest_len);
    }
  });
  return status.load();
}

int rk_inflate_batch(int64_t n, const uint8_t** in_ptrs,
                     const int64_t* in_sizes, uint8_t* out_buf,
                     int64_t out_stride, int64_t* out_sizes,
                     int n_threads) {
  std::atomic<int> status(0);
  parallel_for(n, n_threads, [&](int64_t i) {
    uLongf dest_len = static_cast<uLongf>(out_stride);
    int rc = uncompress(out_buf + i * out_stride, &dest_len, in_ptrs[i],
                        static_cast<uLong>(in_sizes[i]));
    if (rc != Z_OK) {
      status.store(rc);
      out_sizes[i] = 0;
    } else {
      out_sizes[i] = static_cast<int64_t>(dest_len);
    }
  });
  return status.load();
}

int rk_deflate_batch(int64_t n, const uint8_t** in_ptrs,
                     const int64_t* in_sizes, int level, uint8_t* out_buf,
                     int64_t out_stride, int64_t* out_sizes,
                     int n_threads) {
  std::atomic<int> status(0);
  parallel_for(n, n_threads, [&](int64_t i) {
    uLongf dest_len = static_cast<uLongf>(out_stride);
    int rc = compress2(out_buf + i * out_stride, &dest_len, in_ptrs[i],
                       static_cast<uLong>(in_sizes[i]), level);
    if (rc != Z_OK) {
      status.store(rc);
      out_sizes[i] = 0;
    } else {
      out_sizes[i] = static_cast<int64_t>(dest_len);
    }
  });
  return status.load();
}


}  // extern "C"
