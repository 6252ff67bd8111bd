"""Raster I/O of the port: the GeoTIFF codec, the output writer and the
multi-sensor observation composite."""

from .geotiff import (GeoInfo, TiffInfo, TiledTiffWriter, read_geotiff,
                      read_geotiff_window, read_info, write_geotiff)
from .multi import CompositeObservations
from .output import GeoTIFFOutput

__all__ = ["CompositeObservations", "GeoInfo", "GeoTIFFOutput", "TiffInfo",
           "TiledTiffWriter", "read_geotiff", "read_geotiff_window",
           "read_info", "write_geotiff"]
