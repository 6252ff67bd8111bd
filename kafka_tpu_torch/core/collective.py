"""The one collective of a pixel-sharded Gauss-Newton solve.

A sharded date runs one thread per mesh shard (``shard.step``); each
thread runs the ordinary solver on its shard's pixels.  Nothing couples
pixels but the loop's global tests: the step norm ``||dx||_2 / numel``
over every pixel, the per-pixel mode's "every pixel frozen", and the
fused Gauss-Newton kernel's reported trip count and norm.  Those sites
call :func:`all_reduce`, which outside a shard group returns its input
unchanged and inside one combines the shards' partial values — the
counterpart of the ``psum`` GSPMD inserts into the JAX program.

Every thread sums the shards' partials itself, in shard order, on its
own device, so all shards see the same bits and take the same branch.

Inside a program census (``kafka_tpu_torch.analysis``) every shard's
:func:`all_reduce` and :func:`all_gather` is recorded by name, as one
opaque node; outside one the hook costs a thread-local lookup.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Optional

import torch

from . import _build

_LOCAL = threading.local()
#: held around each ``torch.func`` transform: forward-mode AD keeps its
#: dual level in process-wide state, so two threads' ``jvp`` / ``jacfwd``
#: at once break each other (a mesh's shards, or two in-process serving
#: replicas each solving on its own worker thread).
_TRANSFORM_LOCK = threading.RLock()


class ShardGroup:
    """The shards of one sharded solve: ``size`` threads that meet at
    every :meth:`all_reduce`.  A failing shard calls :meth:`abort`, so
    the others raise ``threading.BrokenBarrierError`` instead of
    waiting for it."""

    def __init__(self, size: int, timeout_s: Optional[float] = None):
        self.size = int(size)
        self._barrier = threading.Barrier(self.size, timeout=timeout_s)
        self._slots = [None] * self.size

    def all_reduce(self, rank: int, value: torch.Tensor, op: str = "sum"
                   ) -> torch.Tensor:
        self._slots[rank] = value
        self._barrier.wait()          # every partial deposited
        parts = list(self._slots)
        self._barrier.wait()          # every partial read: slots reusable
        dev = value.device
        out = parts[0].to(dev)
        for part in parts[1:]:
            part = part.to(dev)
            if op == "sum":
                out = out + part
            elif op == "max":
                out = torch.maximum(out, part)
            elif op == "min":
                out = torch.minimum(out, part)
            else:
                raise ValueError(f"unknown reduction {op!r}")
        return out

    def all_gather(self, rank: int, value) -> list:
        """Every shard's ``value``, in shard order."""
        self._slots[rank] = value
        self._barrier.wait()
        parts = list(self._slots)
        self._barrier.wait()
        return parts

    def abort(self) -> None:
        self._barrier.abort()


@dataclass(frozen=True)
class Member:
    """This thread's place in a shard group: its rank and the whole
    batch's pixel count ``n_total`` (the unsharded ``n``)."""

    group: ShardGroup
    rank: int
    n_total: int


def current() -> Optional[Member]:
    """This thread's shard membership, None outside a sharded solve (or
    in a group of one, which needs no collective)."""
    return getattr(_LOCAL, "member", None)


@contextlib.contextmanager
def member(group: ShardGroup, rank: int, n_total: int):
    """Run the body as shard ``rank`` of ``group``."""
    prev = current()
    _LOCAL.member = Member(group, rank, n_total) if group.size > 1 else None
    try:
        yield
    finally:
        _LOCAL.member = prev


def _recorded(name: str):
    """The census's record of one collective call on this thread, a
    no-op outside a census."""
    census = _build.current_census()
    if census is None:
        return contextlib.nullcontext()
    return census.collective(name)


def all_reduce(value: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``value`` combined over this thread's shard group (``sum``, ``max``
    or ``min``); ``value`` itself outside one."""
    m = current()
    if m is None:
        return value
    with _recorded("all_reduce"):
        return m.group.all_reduce(m.rank, value, op)


def all_gather(value) -> list:
    """Every shard's ``value`` (any object), in shard order; ``[value]``
    outside a shard group."""
    m = current()
    if m is None:
        return [value]
    with _recorded("all_gather"):
        return m.group.all_gather(m.rank, value)


def step_norm(step: torch.Tensor, numel_t: torch.Tensor) -> torch.Tensor:
    """The Gauss-Newton loop's global step norm ``||dx||_2 / numel``.
    Unsharded it is ``vector_norm`` as before; sharded, the square root
    of the shards' summed squares."""
    if current() is None:
        return torch.linalg.vector_norm(step) / numel_t
    return torch.sqrt(all_reduce((step * step).sum())) / numel_t


def all_true_flag(flags: torch.Tensor) -> torch.Tensor:
    """``flags.all()`` over every shard's pixels, as a device bool: the
    caller decides when the host reads it."""
    ok = flags.all()
    if current() is None:
        return ok
    return all_reduce(ok.to(torch.int32), "min") != 0


def transforms():
    """A context that serialises ``torch.func`` transforms (linearisation,
    Hessians) across the threads of the process: the shards of a sharded
    solve, and any other threads that solve at once."""
    return _TRANSFORM_LOCK
