"""Chunk scheduling of the port: one process runs every pending chunk of
a chunked run, with the JAX package's restart markers (``scheduler``)."""

from .scheduler import (ChunkAssignment, assign_chunks, failed_marker_path,
                        mark_done, mark_failed, marker_path, pending_chunks,
                        run_chunks, sweep_stale_tmp)

__all__ = ["ChunkAssignment", "assign_chunks", "failed_marker_path",
           "mark_done", "mark_failed", "marker_path", "pending_chunks",
           "run_chunks", "sweep_stale_tmp"]
