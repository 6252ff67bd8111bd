"""Dispatch layer for the raster codec hot path (port of
``kafka_tpu/io/native_codec.py``).

Batch DEFLATE encode/decode of TIFF tiles.  Uses the C++ thread-pooled codec
(``kafka_tpu_torch/native/rasterkit.cpp``, built at first use into the
checkout's ``build/`` folder) when it builds, and Python's zlib (serial)
otherwise; both decode to the same array.  ``codec_path()`` says which
one this process uses.
"""

from __future__ import annotations

import zlib
from typing import List, Sequence

_native = None


def _load_native():
    global _native
    if _native is None:
        from ..native import load_library

        _native = load_library() or False
    return _native


def codec_path() -> str:
    """``"native"`` when the C++ codec is loaded, else ``"zlib"``."""
    return "native" if _load_native() else "zlib"


def inflate_many(segments: Sequence[bytes], expected_size: int) -> List[bytes]:
    lib = _load_native()
    if lib:
        return lib.inflate_many(segments, expected_size)
    return [zlib.decompress(bytes(s)) for s in segments]


def deflate_many(segments: Sequence[bytes], level: int = 6) -> List[bytes]:
    lib = _load_native()
    if lib:
        return lib.deflate_many(segments, level)
    return [zlib.compress(s, level) for s in segments]


def lzw_inflate_many(segments: Sequence[bytes], expected_size: int):
    """Batch TIFF-LZW decode on the native pool, or None when the
    library (with LZW support) is unavailable — callers fall back to the
    pure-Python decoder."""
    lib = _load_native()
    if lib and getattr(lib, "has_lzw", False):
        return lib.lzw_inflate_many(segments, expected_size)
    return None


def lzw_deflate_many(segments: Sequence[bytes]):
    """Batch TIFF-LZW encode on the native pool (bit-identical to the
    Python ``geotiff.lzw_encode``), or None when unavailable."""
    lib = _load_native()
    if lib and getattr(lib, "has_lzw_enc", False):
        return lib.lzw_deflate_many(segments)
    return None


def has_fp3() -> bool:
    """Whether the fused native predictor-3 chain is available (library
    built and carrying its entry points)."""
    lib = _load_native()
    return bool(lib) and getattr(lib, "has_fp3", False)


def decode_fp3_many(segments: Sequence[bytes], rows: int, cols: int,
                    nb: int, compressed: bool):
    """Fused float32 predictor-3 decode (inflate + fpAcc + unshuffle) on
    the native pool; returns a (n, rows, cols, nb) float32 array, or
    None when the native library (with fp3 support) is unavailable —
    callers fall back to the numpy predictor path."""
    lib = _load_native()
    if lib and getattr(lib, "has_fp3", False):
        return lib.decode_fp3_many(segments, rows, cols, nb, compressed)
    return None


def encode_fp3_many(tiles, level: int = 1):
    """Fused float32 predictor-3 encode (fpDiff + deflate); None when
    native fp3 is unavailable."""
    lib = _load_native()
    if lib and getattr(lib, "has_fp3", False):
        return lib.encode_fp3_many(tiles, level)
    return None
