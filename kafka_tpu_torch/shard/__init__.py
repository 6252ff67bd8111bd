"""Pixel-mesh sharding and multi-process chunk scheduling (port of
``kafka_tpu/shard``).

Pixels within a chunk split over a device mesh (``mesh``, ``step``: one
thread per shard, the convergence norm the one collective); whole chunks
spread over processes by a deterministic round-robin (``scheduler``) or,
self-healingly, by the lease-based shared chunk queue (``queue``:
claims, heartbeats and crash-reclaim, so a dead worker's chunks are
picked up by the survivors).
"""

from .mesh import (
    PIXEL_AXIS,
    PixelMesh,
    PixelShards,
    initialize_distributed,
    make_pixel_mesh,
    pad_for_mesh,
    pixel_sharding,
    process_count,
    process_index,
    replicated,
    shard_bands,
    shard_state,
)
from .queue import (
    DEFAULT_LEASE_TTL_S,
    lease_path,
    queue_status,
    run_queue,
)
from .scheduler import (
    ChunkAssignment,
    assign_chunks,
    failed_marker_path,
    mark_done,
    mark_failed,
    marker_path,
    pending_chunks,
    run_chunks,
    sweep_stale_tmp,
)
from .step import make_sharded_forward, make_sharded_step

__all__ = [
    "PIXEL_AXIS",
    "PixelMesh",
    "PixelShards",
    "initialize_distributed",
    "make_pixel_mesh",
    "pad_for_mesh",
    "pixel_sharding",
    "process_count",
    "process_index",
    "replicated",
    "shard_bands",
    "shard_state",
    "ChunkAssignment",
    "DEFAULT_LEASE_TTL_S",
    "assign_chunks",
    "failed_marker_path",
    "lease_path",
    "mark_done",
    "mark_failed",
    "marker_path",
    "pending_chunks",
    "queue_status",
    "run_chunks",
    "run_queue",
    "sweep_stale_tmp",
    "make_sharded_forward",
    "make_sharded_step",
]
