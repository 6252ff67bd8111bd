"""Self-contained GeoTIFF reader/writer (a copy of ``kafka_tpu/io/geotiff.py``,
which imports no JAX; files written by either package read in the other).

The TIFF 6.0 container (classic + BigTIFF) with striped/tiled layout,
DEFLATE (zlib) compression, horizontal-differencing predictor, and the
GeoTIFF tags needed for georeferenced outputs (pixel scale, tiepoint, geokey
directory, projection citation) plus GDAL-style nodata.

Container parsing/assembly is pure Python + NumPy; the per-tile
compress/decompress/predictor hot path is dispatched to the port's C++
codec (``kafka_tpu_torch/native``: thread-pooled zlib, fused
float32-predictor-3 chain, batch LZW) when it builds, else Python zlib and
the decoders here — both decode to the same array.

Capabilities: float32/float64/uint8/int16/uint16/int32/uint32 samples,
single- or multi-band (band-interleaved-by-pixel), compression
none/deflate(8)/adobe-deflate(32946)/LZW(5) read AND write (LZW write is
the GDAL-default-compatibility mode), predictor 1/2/3.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import native_codec
from ..resilience import faults

# --- TIFF constants -------------------------------------------------------

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
               10: 8, 11: 4, 12: 8, 16: 8, 17: 8, 18: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 8: "h", 9: "i", 11: "f", 12: "d",
             16: "Q", 17: "q"}

T_WIDTH, T_HEIGHT = 256, 257
T_BITS, T_COMPRESSION, T_PHOTOMETRIC = 258, 259, 262
T_STRIP_OFFSETS, T_SAMPLES_PER_PIXEL, T_ROWS_PER_STRIP = 273, 277, 278
T_STRIP_BYTECOUNTS = 279
T_PLANAR = 284
T_PREDICTOR = 317
T_TILE_WIDTH, T_TILE_HEIGHT, T_TILE_OFFSETS, T_TILE_BYTECOUNTS = (
    322, 323, 324, 325
)
T_SAMPLE_FORMAT = 339
T_PIXEL_SCALE, T_TIEPOINT = 33550, 33922
T_GEO_KEYS, T_GEO_DOUBLES, T_GEO_ASCII = 34735, 34736, 34737
T_GDAL_METADATA, T_GDAL_NODATA = 42112, 42113

_SAMPLE_DTYPES = {
    (8, 1): np.uint8, (16, 1): np.uint16, (32, 1): np.uint32,
    (8, 2): np.int8, (16, 2): np.int16, (32, 2): np.int32,
    (32, 3): np.float32, (64, 3): np.float64,
}


@dataclass
class GeoInfo:
    """Georeferencing: GDAL-style geotransform + projection description.

    ``geotransform`` = (origin_x, pixel_w, 0, origin_y, 0, -pixel_h), the
    exact 6-tuple contract of the reference's ``define_output``
    (``Sentinel2_Observations.py:100-113``).  ``projection`` is stored in
    the GeoASCII tag; EPSG codes go in the geokey directory.
    """

    geotransform: Tuple[float, ...] = (0.0, 1.0, 0.0, 0.0, 0.0, -1.0)
    projection: str = ""
    epsg: Optional[int] = None
    nodata: Optional[float] = None


@dataclass
class TiffInfo:
    width: int
    height: int
    n_bands: int
    dtype: np.dtype
    compression: int
    predictor: int
    tiled: bool
    tile_shape: Optional[Tuple[int, int]]
    geo: GeoInfo
    tags: Dict[int, tuple] = field(default_factory=dict)
    #: byte order of the file ("<" or ">") — sample data in an "MM" TIFF
    #: must be decoded big-endian regardless of host order.
    byte_order: str = "<"


# --- reading --------------------------------------------------------------
#
# All parsing is seek-based: only the header, the IFD, and the out-of-line
# tag values are read up front, so opening a multi-GB BigTIFF costs a few KB
# of I/O and windowed reads touch only the tiles they intersect.


def _read_ifd(read, offset, endian, big):
    """Parse one IFD via ``read(offset, size) -> bytes``."""
    entries = {}
    if big:
        (count,) = struct.unpack(endian + "Q", read(offset, 8))
        pos = offset + 8
        entry_size, cnt_fmt = 20, "Q"
    else:
        (count,) = struct.unpack(endian + "H", read(offset, 2))
        pos = offset + 2
        entry_size, cnt_fmt = 12, "I"
    block = read(pos, count * entry_size + (8 if big else 4))
    for i in range(count):
        epos = i * entry_size
        tag, typ = struct.unpack_from(endian + "HH", block, epos)
        (n,) = struct.unpack_from(endian + cnt_fmt, block, epos + 4)
        val_off = epos + (12 if big else 8)
        size = _TYPE_SIZES.get(typ, 1) * n
        inline = 8 if big else 4
        if size <= inline:
            data = block[val_off:val_off + size]
        else:
            (data_pos,) = struct.unpack_from(
                endian + ("Q" if big else "I"), block, val_off
            )
            data = read(data_pos, size)
        if typ in (2, 7):  # ascii / undefined
            values = bytes(data[:n])
        elif typ == 5 or typ == 10:  # rational
            raw = struct.unpack(endian + ("iI"[typ == 5] * 2 * n), data)
            values = tuple(raw[2 * i] / max(raw[2 * i + 1], 1)
                           for i in range(n))
        else:
            fmt = _TYPE_FMT.get(typ)
            if fmt is None:
                continue
            values = struct.unpack(endian + fmt * n, data)
        entries[tag] = values
    (next_ifd,) = struct.unpack(
        endian + ("Q" if big else "I"),
        block[count * entry_size:count * entry_size + (8 if big else 4)],
    )
    return entries, next_ifd


def _tag1(tags, tag, default=None):
    v = tags.get(tag)
    if v is None:
        return default
    return v[0] if isinstance(v, tuple) else v


def read_info(path: str) -> TiffInfo:
    """Header + IFD only — cheap even for multi-GB files."""
    with open(path, "rb") as f:
        return _parse_info_f(f)[0]


def _parse_info_f(f):
    def read(off, size):
        f.seek(off)
        return f.read(size)

    head = read(0, 16)
    endian = {b"II": "<", b"MM": ">"}.get(bytes(head[:2]))
    if endian is None:
        raise ValueError("not a TIFF file")
    magic = struct.unpack_from(endian + "H", head, 2)[0]
    if magic == 42:
        big = False
        (ifd_off,) = struct.unpack_from(endian + "I", head, 4)
    elif magic == 43:
        big = True
        (ifd_off,) = struct.unpack_from(endian + "Q", head, 8)
    else:
        raise ValueError("bad TIFF magic %d" % magic)
    tags, _ = _read_ifd(read, ifd_off, endian, big)

    width = _tag1(tags, T_WIDTH)
    height = _tag1(tags, T_HEIGHT)
    n_bands = _tag1(tags, T_SAMPLES_PER_PIXEL, 1)
    bits = _tag1(tags, T_BITS, 8)
    fmt = _tag1(tags, T_SAMPLE_FORMAT, 1)
    dtype = np.dtype(_SAMPLE_DTYPES.get((bits, fmt), np.uint8))
    compression = _tag1(tags, T_COMPRESSION, 1)
    predictor = _tag1(tags, T_PREDICTOR, 1)
    tiled = T_TILE_OFFSETS in tags

    geo = GeoInfo()
    if T_PIXEL_SCALE in tags and T_TIEPOINT in tags:
        sx, sy = tags[T_PIXEL_SCALE][0], tags[T_PIXEL_SCALE][1]
        tp = tags[T_TIEPOINT]
        # tiepoint: (i, j, k, x, y, z) raster->model
        ox = tp[3] - tp[0] * sx
        oy = tp[4] + tp[1] * sy
        geo.geotransform = (ox, sx, 0.0, oy, 0.0, -sy)
    if T_GEO_ASCII in tags:
        geo.projection = tags[T_GEO_ASCII].rstrip(b"\x00|").decode(
            "ascii", "replace"
        )
    if T_GEO_KEYS in tags:
        keys = tags[T_GEO_KEYS]
        for i in range(4, len(keys), 4):
            key_id, loc, cnt, val = keys[i:i + 4]
            if key_id in (3072, 2048) and loc == 0:  # Projected/Geog CS
                geo.epsg = int(val)
    if T_GDAL_NODATA in tags:
        try:
            geo.nodata = float(
                tags[T_GDAL_NODATA].rstrip(b"\x00").strip()
            )
        except ValueError:
            pass

    info = TiffInfo(
        width=int(width), height=int(height), n_bands=int(n_bands),
        dtype=dtype, compression=int(compression), predictor=int(predictor),
        tiled=tiled,
        tile_shape=(
            (int(_tag1(tags, T_TILE_HEIGHT)), int(_tag1(tags, T_TILE_WIDTH)))
            if tiled else None
        ),
        geo=geo, tags=tags, byte_order=endian,
    )
    return info, endian, big


def _fp_predict_encode(tile: np.ndarray) -> bytes:
    """TIFF predictor 3 (floating-point horizontal differencing) encode.

    Per row, the float bytes are rearranged into byte-significance planes
    (MSB plane first) and then byte-wise horizontally differenced with a
    stride of the sample count — the libtiff ``fpDiff`` layout, so GDAL
    reads these files.  Splitting exponent and mantissa bytes into planes
    makes smooth float rasters compress several times better AND faster
    than raw bytes: the writer's dominant cost in the output path.
    """
    th, tw, nb = tile.shape
    b = tile.astype("<f4", copy=False).view(np.uint8).reshape(th, tw * nb, 4)
    planes = np.transpose(b[:, :, ::-1], (0, 2, 1))  # (th, 4, tw*nb), MSB 1st
    buf = np.ascontiguousarray(planes).reshape(th, 4 * tw * nb)
    out = buf.copy()
    out[:, nb:] -= buf[:, :-nb]  # uint8 arithmetic wraps mod 256
    return out.tobytes()


def _fp_predict_decode(raw: bytes, rows: int, cols: int, nb: int,
                       ) -> np.ndarray:
    """Inverse of :func:`_fp_predict_encode` (libtiff ``fpAcc``)."""
    buf = np.frombuffer(raw, np.uint8).reshape(rows, 4 * cols * nb).copy()
    acc = np.add.accumulate(
        buf.reshape(rows, 4 * cols, nb), axis=1, dtype=np.uint8
    ).reshape(rows, 4, cols * nb)
    b = np.transpose(acc, (0, 2, 1))[:, :, ::-1]  # back to LE byte order
    return (
        np.ascontiguousarray(b)
        .view("<f4")
        .reshape(rows, cols, nb)
        .astype(np.float32)
    )


def _decode_segments(segments, info, seg_shape):
    """Decompress + de-predict a list of raw byte segments into arrays of
    ``seg_shape`` (rows, cols, bands).  Empty segments (sparse-file tiles,
    offset/bytecount 0) decode to zeros."""
    rows, cols = seg_shape
    itemsize = info.dtype.itemsize
    expected = rows * cols * info.n_bands * itemsize
    if (
        info.predictor == 3 and itemsize == 4
        and info.compression in (1, 8, 32946)
    ):
        # Fused native chain: inflate + fpAcc + byte unshuffle in one
        # parallel C++ pass over all tiles (the per-tile numpy
        # accumulate/transpose below is the decode hot path at
        # tile-year scale).  The byte-plane layout is endian-neutral,
        # matching the numpy path exactly.
        decoded = native_codec.decode_fp3_many(
            segments, rows, cols, info.n_bands,
            compressed=info.compression != 1,
        )
        if decoded is not None:
            return [
                decoded[i].astype(info.dtype, copy=False)
                for i in range(len(segments))
            ]
    present = [(i, s) for i, s in enumerate(segments) if len(s)]
    if info.compression in (8, 32946):
        raw_present = native_codec.inflate_many(
            [s for _, s in present], expected
        )
    elif info.compression == 1:
        raw_present = [bytes(s) for _, s in present]
    elif info.compression == 5:
        raw_present = None
        try:
            raw_present = native_codec.lzw_inflate_many(
                [s for _, s in present], expected
            )
        except ValueError:
            # The native decoder hard-caps its output at expected+16;
            # a stream with trailing post-EOI bytes (foreign encoders)
            # can exceed it.  The Python reference decoder tolerates
            # and truncates — fall through to it rather than failing
            # the whole read.
            raw_present = None
        if raw_present is None:
            raw_present = [_lzw_decode(bytes(s)) for _, s in present]
    else:
        raise NotImplementedError(
            "TIFF compression %d not supported" % info.compression
        )
    raw = [b""] * len(segments)
    for (i, _), r in zip(present, raw_present):
        raw[i] = r
    # Decode with the FILE's byte order, then return native-endian arrays.
    file_dtype = info.dtype.newbyteorder(info.byte_order)
    out = []
    for r in raw:
        padded = r[:expected].ljust(expected, b"\x00")
        if info.predictor == 3:
            if itemsize != 4:
                raise NotImplementedError(
                    "TIFF predictor 3 is supported for 32-bit floats "
                    f"only (file has {itemsize * 8}-bit samples)"
                )
            out.append(
                _fp_predict_decode(padded, rows, cols, info.n_bands)
                .astype(info.dtype)
            )
            continue
        arr = np.frombuffer(padded, dtype=file_dtype)
        arr = arr.reshape(rows, cols, info.n_bands).astype(info.dtype)
        if info.predictor == 2:
            np.cumsum(arr, axis=1, out=arr, dtype=arr.dtype)
        out.append(arr)
    return out


def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW encode (MSB-first, early-change) — the inverse of
    ``_lzw_decode``, used to build LZW fixtures without GDAL.  The
    encoder's width switch runs one append later than the decoder's
    (``next_code >= 1 << nbits``): the decoder's table lags the
    encoder's by exactly one entry."""
    out = bytearray()
    bitbuf = bitcnt = 0
    nbits = 9

    def put(code):
        nonlocal bitbuf, bitcnt
        bitbuf = (bitbuf << nbits) | code
        bitcnt += nbits
        while bitcnt >= 8:
            out.append((bitbuf >> (bitcnt - 8)) & 0xFF)
            bitcnt -= 8

    table = {bytes([i]): i for i in range(256)}
    next_code = 258
    put(256)
    w = b""
    for ch in data:
        wc = w + bytes([ch])
        if wc in table:
            w = wc
            continue
        put(table[w])
        table[wc] = next_code
        next_code += 1
        if next_code >= 4094:
            put(256)
            table = {bytes([i]): i for i in range(256)}
            next_code = 258
            nbits = 9
        elif next_code >= (1 << nbits) and nbits < 12:
            nbits += 1
        w = bytes([ch])
    if w:
        put(table[w])
        # The decoder appends its (lagged) table entry upon receiving
        # this final code, closing the one-entry lag — so the EOI must
        # be written at the width the decoder will READ it with
        # (libtiff's LZWPostEncode does the same final bump).  Without
        # this, streams whose final code lands the decoder's table
        # exactly on a width boundary (511/1023/2047) decode with
        # trailing garbage.
        if next_code >= (1 << nbits) - 1 and nbits < 12:
            nbits += 1
    put(257)
    if bitcnt:
        out.append((bitbuf << (8 - bitcnt)) & 0xFF)
    return bytes(out)


def _lzw_decode(data: bytes) -> bytes:
    """TIFF LZW (MSB-first, early-change) — needed for fixtures written by
    GDAL's default creation options."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    table: List[bytes] = []

    def reset():
        nonlocal table
        table = [bytes([i]) for i in range(256)] + [b"", b""]

    reset()
    bitpos = 0
    nbits = 9
    prev = b""
    total_bits = len(data) * 8
    while bitpos + nbits <= total_bits:
        byte_idx = bitpos >> 3
        chunk = int.from_bytes(
            data[byte_idx:byte_idx + 4].ljust(4, b"\x00"), "big"
        )
        code = (chunk >> (32 - nbits - (bitpos & 7))) & ((1 << nbits) - 1)
        bitpos += nbits
        if code == EOI:
            break
        if code == CLEAR:
            reset()
            nbits = 9
            prev = b""
            continue
        if prev == b"":
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        else:
            entry = prev + prev[:1]
            table.append(entry)
        out += entry
        prev = entry
        if len(table) >= (1 << nbits) - 1 and nbits < 12:
            nbits += 1
    return bytes(out)


def read_geotiff(path: str) -> Tuple[np.ndarray, TiffInfo]:
    """Read a whole GeoTIFF.  Returns ``(array, info)`` with array shaped
    (height, width) single-band or (height, width, bands)."""
    faults.fault_point("io.read_band", path=path)
    with open(path, "rb") as f:
        info, _, _ = _parse_info_f(f)
        arr = _read_window_f(f, info, 0, 0, info.height, info.width)
    return arr, info


def read_geotiff_window(path: str, row0: int, col0: int, nrows: int,
                        ncols: int, info: Optional[TiffInfo] = None,
                        ) -> Tuple[np.ndarray, TiffInfo]:
    """Read only the pixels of a window — decodes just the tiles/strips it
    intersects, so reading a 256x256 chunk of a 10980x10980 BigTIFF costs
    window-sized I/O instead of a whole-file decode (the streaming-read
    half of the reference's ``gdal.Translate(srcWin=...)`` /
    ``gdal.Warp`` usage, ``kafka_test_S2.py:155-158``).

    The window may extend past the raster edge; out-of-raster pixels come
    back zero-filled.  Pass a previously obtained ``info`` (``read_info``)
    to skip re-parsing the header/IFD on repeated windows of one file.
    Returns ``(array, info)`` with array shaped ``(nrows, ncols[, bands])``."""
    faults.fault_point("io.read_band", path=path)
    with open(path, "rb") as f:
        if info is None:
            info, _, _ = _parse_info_f(f)
        arr = _read_window_f(f, info, row0, col0, nrows, ncols)
    return arr, info


def _read_window_f(f, info: TiffInfo, row0: int, col0: int, nrows: int,
                   ncols: int) -> np.ndarray:
    tags = info.tags
    h, w, nb = info.height, info.width, info.n_bands
    out = np.zeros((nrows, ncols, nb), info.dtype)

    def read_seg(off, cnt):
        if cnt == 0 or off == 0:
            return b""
        f.seek(off)
        return f.read(cnt)

    if info.tiled:
        th, tw = info.tile_shape
        offsets = tags[T_TILE_OFFSETS]
        counts = tags[T_TILE_BYTECOUNTS]
        tiles_across = (w + tw - 1) // tw
        tiles_down = (h + th - 1) // th
        ty0 = max(0, row0 // th)
        ty1 = min(tiles_down, (row0 + nrows + th - 1) // th)
        tx0 = max(0, col0 // tw)
        tx1 = min(tiles_across, (col0 + ncols + tw - 1) // tw)
        wanted = [
            ty * tiles_across + tx
            for ty in range(ty0, ty1) for tx in range(tx0, tx1)
        ]
        segs = [read_seg(offsets[i], counts[i]) for i in wanted]
        arrays = _decode_segments(segs, info, (th, tw))
        for idx, arr in zip(wanted, arrays):
            ty, tx = divmod(idx, tiles_across)
            y0, x0 = ty * th, tx * tw
            # overlap of this tile with the window, in window coords
            oy0 = max(y0, row0)
            oy1 = min(y0 + th, row0 + nrows, h)
            ox0 = max(x0, col0)
            ox1 = min(x0 + tw, col0 + ncols, w)
            if oy1 <= oy0 or ox1 <= ox0:
                continue
            out[oy0 - row0:oy1 - row0, ox0 - col0:ox1 - col0] = (
                arr[oy0 - y0:oy1 - y0, ox0 - x0:ox1 - x0]
            )
    else:
        rps = int(_tag1(tags, T_ROWS_PER_STRIP, h))
        offsets = tags[T_STRIP_OFFSETS]
        counts = tags.get(T_STRIP_BYTECOUNTS, (None,) * len(offsets))
        s0 = max(0, row0 // rps)
        s1 = min(len(offsets), (row0 + nrows + rps - 1) // rps)
        for si in range(s0, s1):
            o = offsets[si]
            c = counts[si]
            if c is None:
                f.seek(0, 2)
                c = f.tell() - o
            y0 = si * rps
            rows = min(rps, h - y0)
            if rows <= 0:
                continue
            arr = _decode_segments([read_seg(o, c)], info, (rows, w))[0]
            oy0 = max(y0, row0)
            oy1 = min(y0 + rows, row0 + nrows)
            ox0 = max(col0, 0)
            ox1 = min(w, col0 + ncols)
            if oy1 <= oy0 or ox1 <= ox0:
                continue
            out[oy0 - row0:oy1 - row0, ox0 - col0:ox1 - col0] = (
                arr[oy0 - y0:oy1 - y0, ox0:ox1]
            )
    if nb == 1:
        out = out[:, :, 0]
    return out


# --- writing --------------------------------------------------------------


def _geo_tags(geo: GeoInfo):
    ox, sx, _, oy, _, nsy = geo.geotransform
    tags = [
        (T_PIXEL_SCALE, 12, (float(sx), float(abs(nsy)), 0.0)),
        (T_TIEPOINT, 12, (0.0, 0.0, 0.0, float(ox), float(oy), 0.0)),
    ]
    keys = [1, 1, 0, 0]  # version, rev, minor, n_keys (patched below)
    n_keys = 0
    # Geographic CRS codes (EPSG 4000-4999, e.g. 4326/WGS84) get
    # ModelTypeGeographic + GeographicTypeGeoKey; everything else is
    # treated as projected (ProjectedCSTypeGeoKey).
    geographic = geo.epsg is not None and 4000 <= geo.epsg < 5000
    keys += [1024, 0, 1, 2 if geographic else 1]
    n_keys += 1
    keys += [1025, 0, 1, 1]  # RasterPixelIsArea
    n_keys += 1
    if geo.epsg is not None:
        keys += [2048 if geographic else 3072, 0, 1, int(geo.epsg)]
        n_keys += 1
    ascii_blob = b""
    if geo.projection:
        text = geo.projection.encode("ascii", "replace") + b"|"
        keys += [1026, T_GEO_ASCII, len(text), 0]
        n_keys += 1
        ascii_blob = text
    keys[3] = n_keys
    tags.append((T_GEO_KEYS, 3, tuple(keys)))
    if ascii_blob:
        tags.append((T_GEO_ASCII, 2, ascii_blob + b"\x00"))
    if geo.nodata is not None:
        tags.append(
            (T_GDAL_NODATA, 2, (repr(float(geo.nodata)).encode() + b"\x00"))
        )
    return tags


_DTYPE_TO_TAGS = {
    np.dtype(np.uint8): (8, 1), np.dtype(np.uint16): (16, 1),
    np.dtype(np.uint32): (32, 1), np.dtype(np.int16): (16, 2),
    np.dtype(np.int32): (32, 2), np.dtype(np.float32): (32, 3),
    np.dtype(np.float64): (64, 3),
}


class TiledTiffWriter:
    """Streaming tiled GeoTIFF writer.

    Tiles are compressed and appended to the file as they are produced —
    nothing accumulates in memory — and the IFD is written at end-of-file
    on :meth:`close` (the libtiff append layout: the header's IFD pointer
    is patched last, so a crashed write is detectable as a zero pointer).
    This is what makes multi-GB BigTIFF tile-year outputs writable from a
    host that is simultaneously holding the assimilation state.

    Tiles may be written in any order; unwritten tiles become sparse
    (offset/bytecount 0, reading as zeros — GDAL's sparse-file convention).
    """

    def __init__(
        self,
        path: str,
        height: int,
        width: int,
        n_bands: int = 1,
        dtype=np.float32,
        geo: Optional[GeoInfo] = None,
        tile_size: int = 256,
        compress="deflate",  # True|"deflate" (fast, native) | "lzw" (interop) | False
        level: int = 6,
        predictor: int = 1,
        bigtiff: Optional[bool] = None,
    ):
        self.h, self.w, self.nb = int(height), int(width), int(n_bands)
        self.dtype = np.dtype(dtype)
        if self.dtype not in _DTYPE_TO_TAGS:
            raise ValueError(f"unsupported sample dtype {self.dtype}")
        if predictor == 2 and self.dtype.kind == "f":
            # TIFF predictor 2 is integer-only (floats use predictor 3); a
            # float-diff file would be unreadable by libtiff/GDAL.
            raise ValueError(
                "predictor=2 requires an integer dtype; floats must use "
                "predictor 1 or 3 (got %s)" % self.dtype
            )
        if predictor == 3 and self.dtype != np.dtype(np.float32):
            raise ValueError(
                "predictor=3 (floating-point differencing) is implemented "
                "for float32 samples only (got %s)" % self.dtype
            )
        self.geo = geo or GeoInfo()
        self.ts = int(tile_size)
        # compress: True/"deflate" (the reference's KafkaOutput choice),
        # "lzw" (GDAL's default creation option — native pool-parallel
        # encoder when built, serial Python fallback otherwise), or
        # False.
        if compress == "lzw":
            self.codec = "lzw"
        elif compress in (True, "deflate"):
            self.codec = "deflate"
        elif not compress:
            self.codec = None
        else:
            raise ValueError(f"compress={compress!r}")
        self.level = int(level)
        self.predictor = int(predictor)
        self.tiles_down = (self.h + self.ts - 1) // self.ts
        self.tiles_across = (self.w + self.ts - 1) // self.ts
        n_tiles = self.tiles_down * self.tiles_across
        raw_size = self.h * self.w * self.nb * self.dtype.itemsize
        if bigtiff is None:
            bigtiff = raw_size > 3_500_000_000
        self.big = bool(bigtiff)
        self._offsets = [0] * n_tiles
        self._counts = [0] * n_tiles
        self._f = open(path, "wb")
        # Header with a zero IFD pointer (patched on close).
        if self.big:
            self._f.write(struct.pack("<2sHHHQ", b"II", 43, 8, 0, 0))
        else:
            self._f.write(struct.pack("<2sHI", b"II", 42, 0))
        self._pos = self._f.tell()
        self._closed = False

    def _pad_tile(self, tile: np.ndarray) -> np.ndarray:
        """Pad a (possibly clipped edge) tile to the full tile grid."""
        arr = np.asarray(tile)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        full = np.zeros((self.ts, self.ts, self.nb), self.dtype)
        full[:arr.shape[0], :arr.shape[1]] = arr.astype(self.dtype)
        return full

    def _prep_tile(self, tile: np.ndarray) -> bytes:
        """Pad to the tile grid + apply the predictor; returns raw bytes."""
        full = self._pad_tile(tile)
        if self.predictor == 3:
            return _fp_predict_encode(full)
        if self.predictor == 2:
            full = np.diff(
                np.concatenate(
                    [np.zeros((self.ts, 1, self.nb), self.dtype), full],
                    axis=1,
                ),
                axis=1,
            ).astype(self.dtype)
        return full.tobytes()

    def _append_segment(self, idx: int, seg: bytes) -> None:
        if not self.big and self._pos + len(seg) > 0xFFFFFFFF:
            raise ValueError(
                "classic TIFF offset overflow — pass bigtiff=True"
            )
        self._offsets[idx] = self._pos
        self._counts[idx] = len(seg)
        self._f.seek(self._pos)
        self._f.write(seg)
        self._pos += len(seg)

    def write_tile(self, ty: int, tx: int, tile: np.ndarray) -> None:
        """Write one tile (row ``ty``, col ``tx``).  ``tile`` may be the
        full ``tile_size`` square or the clipped edge shape; it is
        zero-padded to the tile grid."""
        if not (0 <= ty < self.tiles_down and 0 <= tx < self.tiles_across):
            raise IndexError(f"tile ({ty}, {tx}) outside grid")
        seg = self._prep_tile(tile)
        if self.codec == "lzw":
            native = native_codec.lzw_deflate_many([seg])
            seg = native[0] if native is not None else lzw_encode(seg)
        elif self.codec == "deflate":
            seg = native_codec.deflate_many([seg], self.level)[0]
        self._append_segment(ty * self.tiles_across + tx, seg)

    def write_rows(self, row0: int, rows: np.ndarray) -> None:
        """Write a horizontal band of complete tile rows starting at pixel
        row ``row0`` (must be tile-aligned and a multiple of ``tile_size``
        tall, except the last band).  All tiles of the band go through ONE
        batched deflate call so the native codec's thread pool gets the
        whole row at once."""
        if row0 % self.ts:
            raise ValueError("row0 must be tile-aligned")
        ty0 = row0 // self.ts
        arr = np.asarray(rows)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        indices, tiles = [], []
        for dy in range(0, arr.shape[0], self.ts):
            for tx in range(self.tiles_across):
                x0 = tx * self.ts
                indices.append((ty0 + dy // self.ts) * self.tiles_across + tx)
                tiles.append(arr[dy:dy + self.ts, x0:x0 + self.ts])
        if not tiles:
            return
        segs = None
        if self.codec == "deflate" and self.predictor == 3 \
                and native_codec.has_fp3():
            # Fused native chain: fpDiff + deflate in one parallel C++
            # pass over the whole tile band.  Capability is probed BEFORE
            # building the padded stack so fallback systems don't pay for
            # an allocation the native call would just discard.
            stacked = np.stack([
                self._pad_tile(t).astype(np.float32, copy=False)
                for t in tiles
            ])
            segs = native_codec.encode_fp3_many(stacked, self.level)
        if segs is None:
            raws = [self._prep_tile(t) for t in tiles]
            if self.codec == "lzw":
                segs = native_codec.lzw_deflate_many(raws)
                if segs is None:
                    segs = [lzw_encode(r) for r in raws]
            elif self.codec == "deflate":
                segs = native_codec.deflate_many(raws, self.level)
            else:
                segs = raws
        for idx, seg in zip(indices, segs):
            self._append_segment(idx, seg)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        bits, fmt = _DTYPE_TO_TAGS[self.dtype]
        off_type = 16 if self.big else 4  # LONG8 vs LONG
        entries = [
            (T_WIDTH, 3, (self.w,)), (T_HEIGHT, 3, (self.h,)),
            (T_BITS, 3, (bits,) * self.nb),
            (T_COMPRESSION, 3,
             ({"deflate": 8, "lzw": 5, None: 1}[self.codec],)),
            (T_PHOTOMETRIC, 3, (1,)),
            (T_SAMPLES_PER_PIXEL, 3, (self.nb,)),
            (T_PLANAR, 3, (1,)),
            (T_PREDICTOR, 3, (self.predictor,)),
            (T_TILE_WIDTH, 3, (self.ts,)), (T_TILE_HEIGHT, 3, (self.ts,)),
            (T_SAMPLE_FORMAT, 3, (fmt,) * self.nb),
            (T_TILE_OFFSETS, off_type, tuple(self._offsets)),
            (T_TILE_BYTECOUNTS, off_type, tuple(self._counts)),
        ]
        entries += _geo_tags(self.geo)
        entries.sort(key=lambda e: e[0])
        endian = "<"
        inline_max = 8 if self.big else 4
        ifd_entry = 20 if self.big else 12

        def value_bytes(typ, values):
            if typ == 2 or typ == 7:
                return bytes(values)
            fmt_ch = {3: "H", 4: "I", 12: "d", 16: "Q"}[typ]
            return struct.pack(endian + fmt_ch * len(values), *values)

        ifd_start = (self._pos + 1) & ~1
        n = len(entries)
        ifd_size = (8 if self.big else 2) + n * ifd_entry + \
            (8 if self.big else 4)
        ov_pos = ifd_start + ifd_size
        if not self.big and ov_pos > 0xFFFFFFFF:
            raise ValueError(
                "classic TIFF offset overflow — pass bigtiff=True"
            )
        f = self._f
        f.seek(ifd_start)
        f.write(struct.pack(endian + ("Q" if self.big else "H"), n))
        ov_chunks = []
        for tag, typ, values in entries:
            raw = value_bytes(typ, values)
            f.write(struct.pack(endian + "HH", tag, typ))
            f.write(struct.pack(endian + ("Q" if self.big else "I"),
                                len(values)))
            if len(raw) <= inline_max:
                f.write(raw.ljust(inline_max, b"\x00"))
            else:
                f.write(struct.pack(endian + ("Q" if self.big else "I"),
                                    ov_pos))
                ov_chunks.append((ov_pos, raw))
                ov_pos += (len(raw) + 1) & ~1
        f.write(struct.pack(endian + ("Q" if self.big else "I"), 0))
        for pos_, raw in ov_chunks:
            f.seek(pos_)
            f.write(raw)
        # Patch the header's IFD pointer last: a file with a zero pointer
        # is an unfinished write.
        f.seek(8 if self.big else 4)
        f.write(struct.pack(endian + ("Q" if self.big else "I"), ifd_start))
        f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_geotiff(
    path: str,
    array: np.ndarray,
    geo: Optional[GeoInfo] = None,
    tile_size: int = 256,
    compress="deflate",  # True|"deflate" (fast, native) | "lzw" (interop) | False
    level: int = 6,
    predictor: int = 1,
    bigtiff: Optional[bool] = None,
) -> None:
    """Write a single/multi-band GeoTIFF: tiled, DEFLATE by default — the
    writer-side contract of the reference's ``KafkaOutput``
    (``observations.py:360-365``: COMPRESS=DEFLATE, TILED=YES, PREDICTOR=1,
    BIGTIFF=YES; BigTIFF here switches on automatically past 3.5 GB or can
    be forced).  ``compress="lzw"`` writes GDAL's default creation option
    instead (native pool-parallel encoder when built; Python fallback
    is serial — fine for masks/fixtures).  Rasters up to 64 MB raw
    encode as ONE pool batch (peak memory ~ one padded + one compressed
    copy of the raster); larger rasters stream through
    :class:`TiledTiffWriter` tile-row by tile-row, bounding peak memory
    at one row of compressed tiles."""
    arr = np.asarray(array)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.dtype not in _DTYPE_TO_TAGS:
        arr = arr.astype(np.float32)
    h, w, nb = arr.shape
    # Hand the codec pool as many tiles per call as memory sensibly
    # allows: per-tile-row batches of a ~1000-px-wide raster are only
    # 4-5 tiles, starving a wide native pool.  Up to ~64 MB raw, encode
    # the WHOLE raster in one batch (peak memory = one compressed copy);
    # larger rasters stream per tile row as before.
    raw_bytes = h * w * nb * arr.dtype.itemsize
    step = (h or tile_size) if raw_bytes <= (64 << 20) else tile_size
    with TiledTiffWriter(
        path, h, w, n_bands=nb, dtype=arr.dtype, geo=geo,
        tile_size=tile_size, compress=compress, level=level,
        predictor=predictor, bigtiff=bigtiff,
    ) as writer:
        for y0 in range(0, h, step):
            writer.write_rows(y0, arr[y0:y0 + step])
