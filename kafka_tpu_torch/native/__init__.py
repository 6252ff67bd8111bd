"""Native (C++) raster codec of the port, loaded via ctypes (a copy of
``kafka_tpu/native`` that builds into the checkout's ``build/`` folder).

``rasterkit.cpp``: a thread-pooled TIFF tile codec (zlib inflate/deflate,
float32 predictor 3, LZW).  ``build()`` compiles it with the host C++
compiler at first use into ``build/kafka_tpu_torch/native/`` at the root
of the checkout, keyed by a hash of the source and flags — never into the
package directory.  ``load_library()`` returns None when the build fails,
and the codec callers (``io.native_codec``) then use Python's zlib, the
JAX package's own codec semantics (both decode to the same array);
``load_library(strict=True)`` raises instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence

_DIR = Path(__file__).resolve().parent
SOURCE = _DIR / "rasterkit.cpp"
BUILD_DIR = _DIR.parents[1] / "build" / "kafka_tpu_torch" / "native"
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
LDFLAGS = ("-lz", "-lpthread")

_DEFAULT_THREADS = min(16, os.cpu_count() or 1)


def library_path() -> Path:
    """Where this source and these flags build to."""
    h = hashlib.sha256(" ".join(CXXFLAGS + LDFLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"librasterkit-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``rasterkit.cpp`` unless this exact build exists; return
    the library's path.  Raises with the compiler's output on failure."""
    lib = library_path()
    if lib.is_file():
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or c++) on PATH to build "
                           f"{SOURCE}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f".{lib.name}.{os.getpid()}")
    cmd = [cxx, *CXXFLAGS, str(SOURCE), "-o", str(tmp), *LDFLAGS]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {SOURCE} failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


class RasterKit:
    """ctypes wrapper over librasterkit with list-of-bytes interfaces."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.rk_inflate_batch.restype = ctypes.c_int
        lib.rk_inflate_batch.argtypes = [
            ctypes.c_int64, ctypes.POINTER(u8p),
            ctypes.POINTER(ctypes.c_int64), u8p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ]
        lib.rk_deflate_batch.restype = ctypes.c_int
        lib.rk_deflate_batch.argtypes = [
            ctypes.c_int64, ctypes.POINTER(u8p),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int, u8p,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ]
        # Optional entry points: a library without them degrades to the
        # Python paths.
        self.has_lzw = hasattr(lib, "rk_lzw_inflate_batch")
        if self.has_lzw:
            lib.rk_lzw_inflate_batch.restype = ctypes.c_int
            lib.rk_lzw_inflate_batch.argtypes = [
                ctypes.c_int64, ctypes.POINTER(u8p),
                ctypes.POINTER(ctypes.c_int64), u8p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ]
        self.has_lzw_enc = hasattr(lib, "rk_lzw_deflate_batch")
        if self.has_lzw_enc:
            lib.rk_lzw_deflate_batch.restype = ctypes.c_int
            lib.rk_lzw_deflate_batch.argtypes = [
                ctypes.c_int64, ctypes.POINTER(u8p),
                ctypes.POINTER(ctypes.c_int64), u8p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ]
        self.has_fp3 = hasattr(lib, "rk_decode_fp3_batch")
        if not self.has_fp3:
            return
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.rk_decode_fp3_batch.restype = ctypes.c_int
        lib.rk_decode_fp3_batch.argtypes = [
            ctypes.c_int64, ctypes.POINTER(u8p),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, f32p, ctypes.c_int64,
            ctypes.c_int,
        ]
        lib.rk_encode_fp3_batch.restype = ctypes.c_int
        lib.rk_encode_fp3_batch.argtypes = [
            ctypes.c_int64, f32p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ]

    def _run_bytes_batch(self, segments: Sequence[bytes], stride: int,
                         entry, errmsg: str, n_threads: int,
                         allow_empty: bool = False,
                         extra_args: tuple = ()) -> List[bytes]:
        """Shared bytes-in/bytes-out batch epilogue: marshal segments,
        allocate the strided output, run ``entry``, raise on nonzero rc,
        slice per-item results.  ``extra_args`` are inserted after the
        sizes argument (the deflate entry's ``level``)."""
        n, bufs, ptrs, sizes = self._in_arrays(segments, allow_empty)
        if n == 0:
            return []
        out = ctypes.create_string_buffer(n * stride)
        out_sizes = (ctypes.c_int64 * n)()
        u8p = ctypes.POINTER(ctypes.c_uint8)
        rc = entry(
            n, ptrs, sizes, *extra_args, ctypes.cast(out, u8p), stride,
            out_sizes, n_threads,
        )
        if rc != 0:
            raise ValueError("%s (code %d)" % (errmsg, rc))
        raw = out.raw  # single copy; .raw copies the whole buffer
        return [
            raw[i * stride: i * stride + out_sizes[i]] for i in range(n)
        ]

    def lzw_inflate_many(self, segments: Sequence[bytes],
                         expected_size: int,
                         n_threads: int = _DEFAULT_THREADS
                         ) -> List[bytes]:
        """Batch TIFF-LZW decode on the worker pool (~60x the Python
        decoder per tile, times the pool width)."""
        return self._run_bytes_batch(
            segments, int(expected_size) + 16,
            self._lib.rk_lzw_inflate_batch,
            "TIFF LZW decode failed", n_threads, allow_empty=True,
        )

    def lzw_deflate_many(self, segments: Sequence[bytes],
                         n_threads: int = _DEFAULT_THREADS
                         ) -> List[bytes]:
        """Batch TIFF-LZW encode on the worker pool — bit-identical
        streams to the Python ``lzw_encode`` (same width/clear policy),
        ~4000x faster per tile."""
        if not segments:
            return []
        # Worst case: ~12 bits/code, one code per input byte, plus
        # clear/EOI overhead.
        stride = 2 * max(len(s) for s in segments) + 64
        return self._run_bytes_batch(
            segments, stride, self._lib.rk_lzw_deflate_batch,
            "TIFF LZW encode failed", n_threads, allow_empty=True,
        )

    def decode_fp3_many(self, segments: Sequence[bytes], rows: int,
                        cols: int, nb: int, compressed: bool,
                        n_threads: int = _DEFAULT_THREADS):
        """Fused float32 predictor-3 tile decode: (optional) inflate +
        fpAcc + byte unshuffle per tile, parallel over tiles.  Empty
        segments decode to zero tiles.  Returns a (n, rows, cols, nb)
        float32 array."""
        import numpy as np

        n = len(segments)
        out = np.zeros((n, rows, cols, nb), np.float32)
        if n == 0:
            return out
        n, bufs, ptrs, sizes = self._in_arrays(segments,
                                               allow_empty=True)
        stride = rows * cols * nb
        rc = self._lib.rk_decode_fp3_batch(
            n, ptrs, sizes, rows, cols, nb, int(bool(compressed)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            stride, n_threads,
        )
        if rc != 0:
            raise ValueError(
                "fp3 tile decode failed with zlib code %d" % rc
            )
        return out

    def encode_fp3_many(self, tiles, level: int = 1,
                        n_threads: int = _DEFAULT_THREADS) -> List[bytes]:
        """Fused float32 predictor-3 tile encode: fpDiff + deflate per
        tile, parallel over tiles.  ``tiles`` is a contiguous
        (n, rows, cols, nb) float32 array; returns the n compressed
        segments."""
        import numpy as np

        tiles = np.ascontiguousarray(tiles, np.float32)
        n, rows, cols, nb = tiles.shape
        if n == 0:
            return []
        rawbytes = rows * cols * nb * 4
        stride = rawbytes + rawbytes // 1000 + 64
        out = ctypes.create_string_buffer(n * stride)
        out_sizes = (ctypes.c_int64 * n)()
        u8p = ctypes.POINTER(ctypes.c_uint8)
        rc = self._lib.rk_encode_fp3_batch(
            n, tiles.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            rows * cols * nb, rows, cols, nb, int(level),
            ctypes.cast(out, u8p), stride, out_sizes, n_threads,
        )
        if rc != 0:
            raise ValueError(
                "fp3 tile encode failed with zlib code %d" % rc
            )
        raw = out.raw
        return [
            raw[i * stride: i * stride + out_sizes[i]] for i in range(n)
        ]

    @staticmethod
    def _in_arrays(segments: Sequence[bytes], allow_empty: bool = False):
        n = len(segments)
        if allow_empty:
            # create_string_buffer needs size >= 1; empty segments are
            # signalled by size 0 and never dereferenced natively.
            bufs = [
                ctypes.create_string_buffer(s if s else b"\x00",
                                            max(len(s), 1))
                for s in segments
            ]
        else:
            bufs = [
                ctypes.create_string_buffer(s, len(s)) for s in segments
            ]
        u8p = ctypes.POINTER(ctypes.c_uint8)
        ptrs = (u8p * n)(
            *[ctypes.cast(b, u8p) for b in bufs]
        )
        sizes = (ctypes.c_int64 * n)(*[len(s) for s in segments])
        return n, bufs, ptrs, sizes

    def inflate_many(self, segments: Sequence[bytes],
                     expected_size: int,
                     n_threads: int = _DEFAULT_THREADS) -> List[bytes]:
        return self._run_bytes_batch(
            segments, int(expected_size), self._lib.rk_inflate_batch,
            "zlib inflate failed", n_threads,
        )

    def deflate_many(self, segments: Sequence[bytes], level: int = 6,
                     n_threads: int = _DEFAULT_THREADS) -> List[bytes]:
        if not segments:
            return []
        max_in = max(len(s) for s in segments)
        # zlib worst case: input + input/1000 + 64
        stride = max_in + max_in // 1000 + 64
        return self._run_bytes_batch(
            segments, stride, self._lib.rk_deflate_batch,
            "zlib deflate failed", n_threads, extra_args=(level,),
        )


_loaded: Optional[RasterKit] = None
#: the error of the last failed build, when there was one.
build_error: Optional[BaseException] = None


def load_library(strict: bool = False) -> Optional[RasterKit]:
    """Load (building if needed) the native codec; None if it does not
    build or load, or, with ``strict``, raise."""
    global _loaded, build_error
    if _loaded is None:
        try:
            _loaded = RasterKit(ctypes.CDLL(str(build())))
        except (OSError, RuntimeError) as exc:
            build_error = exc
            _loaded = False  # type: ignore[assignment]
    if strict and not _loaded:
        raise RuntimeError("the native raster codec is unavailable") \
            from build_error
    return _loaded or None
