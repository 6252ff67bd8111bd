"""Spatial chunking (a copy of ``kafka_tpu/io/tiling.py``, which imports
no JAX): the unit the chunked drivers run one at a time.

``get_chunks`` reproduces the reference's block tiler
(``kafka/input_output/utils.py:12-40`` of the original KaFKA):
column-major blocks, 1-based chunk numbering, trailing blocks shrunk to
fit.  Both packages number and cut the chunks of a mask the same way, so
their per-chunk output prefixes and restart markers agree.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Tuple


class Chunk(NamedTuple):
    x0: int
    y0: int
    nx_valid: int
    ny_valid: int
    chunk_no: int


def get_chunks(nx: int, ny: int,
               block_size: Tuple[int, int] = (256, 256)) -> Iterator[Chunk]:
    bx, by = block_size
    nx_blocks = (nx + bx - 1) // bx
    ny_blocks = (ny + by - 1) // by
    chunk_no = 0
    for ix in range(nx_blocks):
        nx_valid = bx if ix < nx_blocks - 1 else nx - ix * bx
        for iy in range(ny_blocks):
            ny_valid = by if iy < ny_blocks - 1 else ny - iy * by
            chunk_no += 1
            yield Chunk(ix * bx, iy * by, nx_valid, ny_valid, chunk_no)


def chunk_mask(state_mask, chunk: Chunk):
    """Slice a chunk's window out of the full state mask (the VRT-submask
    trick of the S2 driver, ``kafka_test_S2.py:152-158``)."""
    return state_mask[
        chunk.y0:chunk.y0 + chunk.ny_valid,
        chunk.x0:chunk.x0 + chunk.nx_valid,
    ]


def chunk_geotransform(geotransform, chunk: Chunk):
    """Shift a GDAL-style geotransform to a chunk's origin."""
    ox, sx, rx, oy, ry, sy = geotransform
    return (
        ox + chunk.x0 * sx + chunk.y0 * rx,
        sx, rx,
        oy + chunk.x0 * ry + chunk.y0 * sy,
        ry, sy,
    )
