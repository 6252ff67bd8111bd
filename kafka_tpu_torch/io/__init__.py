"""Raster I/O of the port: the GeoTIFF codec, warping, the sensor readers
(Sentinel-2, MCD43 BHR and Synergy, MOD09GA, Sentinel-1),
the output writer, chunk tiling and the multi-sensor observation
composite.  ``h5py`` (the Sentinel-1 decoder) is imported only when a
NetCDF file is read."""

from .geotiff import (GeoInfo, TiffInfo, TiledTiffWriter, read_geotiff,
                      read_geotiff_window, read_info, write_geotiff)
from .mod09 import MOD09Observations, decode_state_qa, zoom2_nearest
from .modis import BHRObservations, SynergyKernels
from .multi import CompositeObservations
from .output import GeoTIFFOutput
from .sentinel1 import S1Observations
from .sentinel2 import (Sentinel2Observations, find_nearest_geometry,
                        geometry_bank_aux_builder, parse_s2_xml)
from .tiling import Chunk, chunk_geotransform, chunk_mask, get_chunks
from .warp import (from_lonlat, grid_mapping, lonlat_to_utm,
                   reproject_raster, resample, to_lonlat, utm_to_lonlat)

__all__ = ["BHRObservations", "Chunk", "CompositeObservations", "GeoInfo",
           "GeoTIFFOutput", "MOD09Observations", "S1Observations",
           "Sentinel2Observations", "SynergyKernels", "TiffInfo",
           "TiledTiffWriter", "chunk_geotransform", "chunk_mask",
           "decode_state_qa", "find_nearest_geometry", "from_lonlat",
           "geometry_bank_aux_builder", "get_chunks", "grid_mapping",
           "lonlat_to_utm", "parse_s2_xml", "read_geotiff",
           "read_geotiff_window", "read_info", "reproject_raster",
           "resample", "to_lonlat", "utm_to_lonlat", "write_geotiff",
           "zoom2_nearest"]
