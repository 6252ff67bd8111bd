"""Packed Cholesky factor and substitution per pixel as one kernel launch
(port of ``kafka_tpu/core/pallas_solve.py:solve_rows`` and its Pallas
kernel ``_solve_kernel``, with ``solve_spd_packed_pallas``).

- :func:`solve_rows_plain` — the plain PyTorch version (``linalg``'s
  packed Cholesky and substitution on the rows), any device and dtype;
- :func:`solve_rows` — the JAX signature: CPU tensors run the plain
  version, CUDA tensors launch ``csrc/solve_rows.cu`` (p in
  ``INSTANCES``) or raise.  ``solve_rows.launches`` counts launches and
  ``solve_rows.route_launches`` counts them by route;
- :func:`launch_plan` — how the kernel covers n pixels: persistent CTAs
  (one per SM) walking tiles of ``tile`` pixels through a ring of
  ``stages`` tiles in shared memory, filled by TMA (route ``"tma"``) or
  by 4-byte ``cp.async`` copies (route ``"cp_async"``, for any n and any
  base address);
- :func:`solve_spd_packed_kernel` — the drop-in for
  ``linalg.solve_spd_packed`` (``solve_spd_packed_pallas`` in the JAX
  package).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .linalg import cholesky_packed, solve_chol_vectors, tri_rows

#: state sizes of the CUDA kernel's instances.
INSTANCES = (2, 7, 10)
#: p -> (consumer warpgroups, ring stages) of the instance
#: (csrc/solve_rows.cu: Config<P>).  Each warpgroup takes one CHUNK-px
#: chunk of a tile, one pixel per thread.
GEOMETRY = {2: (4, 8), 7: (4, 3), 10: (2, 3)}
#: pixels per consumer warpgroup and per TMA box, and the producer
#: warpgroup's threads (csrc: kChunk).
CHUNK = 128
#: bytes of dynamic shared memory ahead of the ring, for the mbarriers.
BARRIER_BYTES = 128
ROUTES = ("tma", "cp_async")


def check_instance(p: int) -> None:
    """Raise unless the CUDA kernel has an instance for ``p``."""
    if p not in INSTANCES:
        raise NotImplementedError(
            f"the CUDA packed solve has no instance for p={p}; instances: "
            f"{INSTANCES}")


def route(n: int, *base_ptrs: int) -> str:
    """``"tma"`` when a 2-D tensor map can cover the (rows, n) inputs —
    a row pitch of n * 4 bytes that is a multiple of 16 and 16-byte
    aligned bases — else ``"cp_async"``."""
    aligned = all(ptr % 16 == 0 for ptr in base_ptrs)
    return "tma" if n % 4 == 0 and aligned else "cp_async"


def launch_plan(p: int, n: int, base_ptrs, sms: int) -> dict:
    """The launch of the p instance over ``n`` pixels whose input rows
    start at ``base_ptrs``, on a card with ``sms`` SMs: the route, the
    geometry (``csrc/solve_rows.cu`` computes the same) and the tiles —
    ``tiles`` of ``tile`` px cover n, the last holds ``tail`` px."""
    check_instance(p)
    if n < 1:
        raise ValueError(f"n={n}: nothing to solve")
    groups, stages = GEOMETRY[p]
    tile = groups * CHUNK
    tiles = -(-n // tile)
    warps = 4 * groups
    return {"route": route(n, *base_ptrs), "tile": tile, "stages": stages,
            "consumer_warps": warps, "threads": 32 * warps + CHUNK,
            "smem_bytes": BARRIER_BYTES + stages * tile
            * (tri_rows(p) + p) * 4,
            "tiles": tiles, "tail": n - (tiles - 1) * tile,
            "grid": min(sms, tiles)}


def solve_rows_plain(a_rows, b_rows):
    """Plain version: ``a_rows`` (tri(p), n) packed lower triangle,
    ``b_rows`` (p, n) -> x (p, n)."""
    p = b_rows.shape[0]
    a_pk = [[None] * p for _ in range(p)]
    for i in range(p):
        for j in range(i + 1):
            a_pk[i][j] = a_pk[j][i] = a_rows[i * (i + 1) // 2 + j]
    l = cholesky_packed(a_pk)
    return torch.stack(solve_chol_vectors(l, [b_rows[i] for i in range(p)]))


@functools.cache
def _sm_count(dev: torch.device) -> int:
    """The SMs of CUDA device ``dev`` (read once per device)."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _launch_cuda(a_rows, b_rows):
    """Launch ``csrc/solve_rows.cu`` on the current stream of the
    inputs' device (no sync)."""
    from . import _build

    p, n = b_rows.shape
    check_instance(p)
    dev = b_rows.device
    _build.check_rows("a_rows", a_rows, tri_rows(p), n, dev)
    _build.check_rows("b_rows", b_rows, p, n, dev)
    x = torch.empty((p, n), dtype=torch.float32, device=dev)
    plan = launch_plan(p, n, (a_rows.data_ptr(), b_rows.data_ptr()),
                       _sm_count(dev))
    lib = _build.load("solve_rows")
    fn = lib.kafka_solve_rows
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    with _build.on_device(dev) as stream:
        rc = fn(p, a_rows.data_ptr(), b_rows.data_ptr(), x.data_ptr(), n,
                int(plan["route"] == "tma"), plan["grid"], stream)
    _build.raise_on_error(lib, rc, "solve_rows")
    _build.count_launch(solve_rows, plan["route"], by="route_launches")
    return x


def kernel_attributes(p: int, n: int) -> dict:
    """The compiled p instance for ``n`` pixels on the current device:
    registers, spill bytes, static and dynamic shared bytes, threads,
    consumer warps, tile, stages, SMs, CTAs one SM holds and the grid
    (builds it if needed)."""
    from . import _build

    check_instance(p)
    lib = _build.load("solve_rows")
    fn = lib.kafka_solve_rows_attributes
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    out = (ctypes.c_int * 11)()
    rc = fn(p, n, ctypes.addressof(out))
    _build.raise_on_error(lib, rc, "solve_rows attributes")
    keys = ("registers", "local_bytes", "static_shared_bytes", "smem_bytes",
            "threads", "consumer_warps", "tile", "stages", "sms",
            "ctas_per_sm", "grid")
    return dict(zip(keys, out))


def solve_rows(a_rows, b_rows, block: int = 1024):
    """Solve the packed batch in row layout: ``a_rows`` (tri(p), n),
    ``b_rows`` (p, n) -> x (p, n).  ``block`` is accepted for the JAX
    signature only."""
    if tri_rows(b_rows.shape[0]) != a_rows.shape[0]:
        raise ValueError(f"{a_rows.shape[0]} coefficient rows for "
                         f"p={b_rows.shape[0]}")
    dev = b_rows.device
    if dev.type == "cpu":
        return solve_rows_plain(a_rows, b_rows)
    if dev.type == "cuda":
        return _launch_cuda(a_rows, b_rows)
    raise ValueError(f"no packed solve for {dev}")


#: CUDA kernel launches of this process (plain-version calls excluded),
#: in all and by route.
solve_rows.launches = 0
solve_rows.route_launches = dict.fromkeys(ROUTES, 0)


def solve_spd_packed_kernel(a_packed, b: torch.Tensor) -> torch.Tensor:
    """Drop-in for ``linalg.solve_spd_packed``: packed list-of-lists ``A``
    of ``(n,)`` vectors and ``b`` (n, p) -> x (n, p)."""
    p = len(a_packed)
    a_rows = torch.stack([a_packed[i][j] for i in range(p)
                          for j in range(i + 1)]).to(torch.float32)
    return solve_rows(a_rows, b.T.to(torch.float32).contiguous()).T
