"""The pixel mesh and pixel-axis sharding (port of
``kafka_tpu/shard/mesh.py``).

Every pixel's update is independent, so the only intra-node parallel
axis is the pixel batch.  A mesh here is an ordered list of
``torch.device``s on that one axis; shard ``k`` of a pixel-batched array
holds the ``k``-th equal slice of its pixel axis on ``devices[k]``.
Entries may repeat: torch's one CPU device stands in for the eight
forced host devices of the JAX tests (``["cpu"] * 8``), and one H100
can hold several shards (``["cuda:0", "cuda:0"]``).  What GSPMD does for
the JAX package — run the per-date program on every shard — the
sharded step does shard by shard (``shard.step``); the only collective
is the convergence norm.

Across processes (hosts), ``initialize_distributed`` brings up
``torch.distributed`` with the ``gloo`` backend over a TCP rendezvous,
the counterpart of ``jax.distributed.initialize``: whole chunks then
round-robin over the ranks (``shard.scheduler``).  ``gloo``, not NCCL:
NCCL refuses two ranks on one GPU, and the scheduler needs no device
collective.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

PIXEL_AXIS = "pixels"


class PixelMesh:
    """A 1-D mesh: the devices of the pixel axis, in shard order."""

    def __init__(self, devices: Sequence):
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a pixel mesh needs at least one device")
        for d in devs:
            if d.type == "cuda":
                if not torch.cuda.is_available():
                    raise RuntimeError(
                        f"mesh device {d} needs CUDA and no CUDA device is "
                        "available; pass device='cpu' entries to run on the "
                        "CPU explicitly")
                if d.index is not None and \
                        d.index >= torch.cuda.device_count():
                    raise RuntimeError(
                        f"mesh device {d} does not exist: this process "
                        f"sees {torch.cuda.device_count()} CUDA device(s)")
        self.devices = tuple(torch.device(d.type, 0) if d.type == "cuda"
                             and d.index is None else d for d in devs)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"PixelMesh({[str(d) for d in self.devices]})"


class PixelShards:
    """A tensor split on its pixel axis over a mesh: ``shards[k]`` lies
    on ``mesh.devices[k]``.  ``axis`` is the pixel axis (0 for the state,
    1 for band-major arrays); ``full()`` gathers the whole tensor on one
    device, ``numpy.asarray`` reads it."""

    def __init__(self, shards: Sequence[torch.Tensor], axis: int = 0):
        self.shards = tuple(shards)
        self.axis = int(axis)

    @property
    def devices(self) -> tuple:
        return tuple(s.device for s in self.shards)

    @property
    def shape(self) -> tuple:
        first = list(self.shards[0].shape)
        first[self.axis] = sum(s.shape[self.axis] for s in self.shards)
        return tuple(first)

    def map(self, fn) -> "PixelShards":
        """``fn`` applied to every shard (pixel axis unchanged)."""
        return PixelShards([fn(s) for s in self.shards], self.axis)

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor, concatenated on ``device`` (default: the
        first shard's)."""
        dev = self.shards[0].device if device is None else device
        if len(self.shards) == 1:
            return self.shards[0].to(dev)
        return torch.cat([s.to(dev) for s in self.shards], dim=self.axis)

    def __array__(self, dtype=None, copy=None):
        # kafkalint: disable=host-transfer-in-jit — numpy conversion of a
        # sharded value is a host read by request of the caller.
        out = np.concatenate([s.detach().cpu().numpy() for s in self.shards],
                             axis=self.axis)
        return out if dtype is None else out.astype(dtype)

    def __repr__(self) -> str:
        return (f"PixelShards(shape={self.shape}, axis={self.axis}, "
                f"devices={[str(d) for d in self.devices]})")


class PixelSharding:
    """Where an array goes on the mesh: split on ``batch_axis``
    (``ndim`` dimensions), or replicated on every mesh entry when
    ``batch_axis`` is None."""

    def __init__(self, mesh: PixelMesh, batch_axis: Optional[int],
                 ndim: int = 0):
        self.mesh = mesh
        self.batch_axis = batch_axis
        self.ndim = ndim

    def put(self, arr):
        """Place ``arr`` (tensor, numpy array or ``PixelShards``): a
        ``PixelShards`` for a split, a tuple of per-entry copies for a
        replica."""
        if isinstance(arr, PixelShards):
            arr = arr.full()
        t = torch.as_tensor(arr)
        if self.batch_axis is None:
            return tuple(t.to(d) for d in self.mesh.devices)
        return split_pixels(self.mesh, t, self.batch_axis)


def make_pixel_mesh(devices: Optional[Iterable] = None) -> PixelMesh:
    """1-D mesh over the given devices, or every local CUDA device (raises
    without one)."""
    if devices is None:
        devices = local_devices("cuda")
    return PixelMesh(list(devices))


def local_devices(kind: str = "cuda") -> List[torch.device]:
    """The local devices of ``kind`` a ``"local"`` mesh spans: every CUDA
    device this process sees (raises without one), or the one CPU."""
    if kind == "cpu":
        return [torch.device("cpu")]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA mesh needs a CUDA device and none is available; pass "
            "device='cpu' to run on the CPU explicitly")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def shard_bounds(n: int, size: int) -> List[tuple]:
    """``[(start, stop)]`` of each shard's slice of ``n`` pixels (equal
    slices; raises unless ``size`` divides ``n``)."""
    if n % size:
        raise ValueError(f"{n} pixels do not split into {size} equal "
                         "shards; pad with pad_for_mesh")
    m = n // size
    return [(k * m, (k + 1) * m) for k in range(size)]


def split_pixels(mesh: PixelMesh, t: torch.Tensor, axis: int = 0
                 ) -> PixelShards:
    """``t`` split on ``axis`` into the mesh's shards, each moved to its
    device (a view where it already lies there)."""
    t = torch.as_tensor(t)
    bounds = shard_bounds(t.shape[axis], mesh.size)
    return PixelShards([t.narrow(axis, a, b - a).to(dev)
                        for (a, b), dev in zip(bounds, mesh.devices)], axis)


def pixel_sharding(mesh: PixelMesh, batch_axis: int = 0,
                   ndim: int = 2) -> PixelSharding:
    """Split axis ``batch_axis`` of an ``ndim``-array over the mesh.
    State arrays are pixel-leading (``batch_axis=0``); band batches are
    band-leading (``batch_axis=1``)."""
    return PixelSharding(mesh, batch_axis, ndim)


def replicated(mesh: PixelMesh) -> PixelSharding:
    return PixelSharding(mesh, None)


def shard_state(mesh: PixelMesh, x, p_inv=None):
    """The state arrays split on their pixel axis (0)."""
    x = pixel_sharding(mesh, 0, np.ndim(x)).put(x)
    if p_inv is not None:
        p_inv = pixel_sharding(mesh, 0, np.ndim(p_inv)).put(p_inv)
    return x, p_inv


def shard_bands(mesh: PixelMesh, bands):
    """A ``BandBatch`` (all fields ``(n_bands, n_pix)``) split on its
    pixel axis (1)."""
    sharding = pixel_sharding(mesh, 1, 2)
    return type(bands)(*(sharding.put(f) for f in bands))


def pad_for_mesh(n: int, mesh: PixelMesh, lane: int = 128) -> int:
    """Smallest padded pixel count >= n that is divisible by the mesh size
    with every shard a multiple of ``lane``."""
    quantum = mesh.size * lane
    return max(int(np.ceil(max(n, 1) / quantum)) * quantum, quantum)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Multi-process bring-up: ``torch.distributed.init_process_group``
    with the ``gloo`` backend, rendezvous at ``tcp://<coordinator>``
    (``host:port``).  ``num_processes <= 1`` skips it, as in the JAX
    package; otherwise all three arguments are needed (nothing here
    discovers a cluster)."""
    if num_processes is not None and num_processes <= 1:
        return
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "initialize_distributed needs coordinator_address, "
            "num_processes and process_id")
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id))


def process_count() -> int:
    """World size of the process group, 1 when none is initialised."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    """This process's rank, 0 when no process group is initialised."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0
