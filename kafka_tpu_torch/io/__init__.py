"""Raster I/O of the port: the GeoTIFF codec and the output writer."""

from .geotiff import GeoInfo, read_geotiff, write_geotiff
from .output import GeoTIFFOutput

__all__ = ["GeoInfo", "GeoTIFFOutput", "read_geotiff", "write_geotiff"]
