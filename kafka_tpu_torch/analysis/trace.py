"""The operator census of one run of a registered program (the port's
counterpart of ``kafka_tpu/analysis/trace.py``).

The JAX package traces a program abstractly (``jax.make_jaxpr``); the
port runs eagerly, so its census records ONE run of each program at a
canonical shape, its builder pinning the trip count.  Two modes watch
the run, on every thread it uses (a mesh's shards carry the census into
theirs, ``core._build.census_thread``):

- a ``TorchDispatchMode`` counts the ATen operators (``aten.mul``, ...)
  and the dtypes of their outputs, and records the operators that read
  device memory on the host (``HOST_READ_OPS``);
- a ``TorchFunctionMode`` sees the Python calls that move data between
  host and device (``torch.tensor(..., device=...)``, ``Tensor.to``,
  ``.cpu()``, ``.tolist()``, ``.numpy()``) and which tensors are host
  data by design (a factory called without a device).

Each hand-kernel call is one opaque node (``core._build.kernel_region``:
the ``ctypes`` launch on the card, the plain version on the CPU), as is
each collective call (``core.collective``), so the census does not
depend on the device.  Host and device data share one memory on the
CPU, so the census tracks placement itself: a tensor is host data when
a factory made it without a device, when ``.cpu()`` read it back, or
when every tensor it was computed from is host data; everything else is
device data.  On the card that tracking is held to where each tensor
really lies (``placement_mismatches``).  Tensors that hold no data —
``torch.func``'s symbolic zero tangents and its ``meta`` shape probes —
are counted under their own dtype keys (``@zero``, ``@meta``), not as
device data.

A first run, uncounted and unwatched, warms the caches (gather indices,
built kernels), so the census is the steady state and does not depend
on what ran before it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
from collections import Counter
from typing import Dict, List, Optional

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from ..core import _build
from .registry import BuiltProgram, ProgramSpec

#: ATen operators that read device memory on the host: each one is a
#: synchronising transfer on the card (``_local_scalar_dense`` is what
#: ``.item()``, ``bool()`` and ``float()`` of a tensor reach).
HOST_READ_OPS = (
    "aten._local_scalar_dense", "aten.nonzero", "aten._linalg_check_errors",
    "aten.equal", "aten.masked_select", "aten.unique_consecutive",
    "aten._unique", "aten._unique2", "aten.unique_dim", "aten.bincount",
)
#: operators that read a boolean index on the host (a mask index needs
#: its count of true entries before the output can be allocated).
MASK_INDEX_OPS = ("aten.index", "aten.index_put", "aten.index_put_",
                  "aten._index_put_impl_")
#: operators that materialise their source: a copy of a non-contiguous
#: rank-3 tensor is a relayout.  ``contiguous()`` and a copying
#: ``reshape`` reach ``aten.clone``; the source of ``copy_`` is its
#: second argument.
COPY_OPS = {"aten.clone": 0, "aten._to_copy": 0, "aten.copy_": 1,
            "aten.copy": 1}
#: reduce/dot operators the bf16 accumulate rule applies to.
REDUCE_DOT_OPS = (
    "aten.sum", "aten.mean", "aten.prod", "aten.cumsum", "aten.mm",
    "aten.bmm", "aten.addmm", "aten.baddbmm", "aten.mv", "aten.dot",
    "aten.linalg_vector_norm",
)
#: the factories of ``torch`` (a call without a device makes host data).
FACTORY_NAMES = frozenset((
    "arange", "empty", "empty_strided", "eye", "full", "linspace",
    "logspace", "ones", "rand", "randint", "randn", "randperm", "range",
    "scalar_tensor", "zeros", "tril_indices", "triu_indices",
))
#: the transfer keys of ``host_syncs`` recorded at the Python level.
H2D, D2H, TOLIST = "h2d", "d2h", "tolist"


@dataclasses.dataclass
class TracedProgram:
    """One program's census: ATen operators by packet (``primitives``),
    their outputs by dtype (``dtypes``; host data's keys end in
    ``@host``), hand-kernel nodes (``kernels``), host reads and
    synchronising transfers (``host_syncs``), host callbacks on device
    data (``callbacks``: a ``.numpy()`` of device data), collective calls
    of a mesh program (``collectives``, None for a single-device one),
    the operator count (``n_eqns``), notable operators (``events``: the
    first producer of each device dtype, relayout copies, bf16
    reductions) and, on the card, the tensors whose tracked placement
    was not where they lay (``placement_mismatches``)."""

    spec: ProgramSpec
    device: str
    primitives: Dict[str, int]
    dtypes: Dict[str, int]
    kernels: Dict[str, int]
    host_syncs: Dict[str, int]
    callbacks: Dict[str, int]
    n_eqns: int
    torch_version: str
    events: List[dict] = dataclasses.field(default_factory=list)
    mesh_devices: int = 0
    collectives: Optional[Dict[str, int]] = None
    collectives_skipped_reason: Optional[str] = None
    placement_mismatches: int = 0


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


_PACKETS: Dict[object, str] = {}


def _packet(func) -> str:
    name = _PACKETS.get(func)
    if name is None:
        name = _PACKETS[func] = f"aten.{func.overloadpacket.__name__}"
    return name


def _tensors(values) -> list:
    """The tensors among an operator's arguments (and in their lists)."""
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(t for t in v if isinstance(t, torch.Tensor))
    return out


def _dataless(t) -> Optional[str]:
    """``"zero"`` / ``"meta"`` for a tensor that holds no data, else
    None."""
    if t.device.type == "meta":
        return "meta"
    if t._is_zerotensor():
        return "zero"
    return None


def _host_scalar(t) -> bool:
    """A 0-d host tensor: a scalar a CUDA operator reads on the host as a
    launch argument (``torch.func``'s derivative formulas make them),
    neither device data nor a transfer.  The placement check on the card
    leaves them out; the census counts them under their dtype as the
    CPU's census does."""
    return t.ndim == 0 and t.device.type == "cpu"


#: one attribute name per census: where it keeps a tensor's placement.
_CENSUS_IDS = itertools.count()


class Census:
    """The counters of one run and the placement of every tensor it
    made.  ``device`` is the program's device; ``counting`` is False
    while the builder and the warm-up run (placement is tracked all the
    same)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.counting = False
        self.lock = threading.Lock()
        self.local = threading.local()
        self.attr = f"_kafka_census_{next(_CENSUS_IDS)}"
        self.primitives: Counter = Counter()
        self.dtypes: Counter = Counter()
        self.kernels: Counter = Counter()
        self.host_syncs: Counter = Counter()
        self.callbacks: Counter = Counter()
        self.collectives: Counter = Counter()
        self.events: List[dict] = []
        self.device_dtypes: set = set()
        self.mismatches = 0

    # -- per-thread state -------------------------------------------------
    def _state(self):
        st = self.local
        if not hasattr(st, "opaque"):
            st.opaque = 0       # kernel and collective regions entered
            st.quiet = 0        # transfers whose operators are not counted
            st.placing = None   # "host" / "device" forced on new outputs
        return st

    def _counts(self) -> bool:
        st = self._state()
        return self.counting and st.opaque == 0 and st.quiet == 0

    # -- placement --------------------------------------------------------
    def kind(self, t) -> str:
        """``"device"``, ``"host"`` or ``"readback"`` (host data read back
        from the device) for a tensor."""
        return getattr(t, self.attr, "device")

    def _mark(self, t, kind: str) -> None:
        if kind != "device":
            setattr(t, self.attr, kind)
        elif hasattr(t, self.attr):
            delattr(t, self.attr)

    def on_program_device(self, dev) -> bool:
        return dev is not None and torch.device(dev).type == self.device.type

    @contextlib.contextmanager
    def placing(self, kind: Optional[str], quiet: bool = False):
        st = self._state()
        prev = st.placing
        st.placing = kind
        st.quiet += int(quiet)
        try:
            yield
        finally:
            st.placing = prev
            st.quiet -= int(quiet)

    def record(self, counter: Counter, key: str) -> None:
        if self._counts():
            with self.lock:
                counter[key] += 1

    # -- the hooks of core._build and core.collective ---------------------
    def enter_kernel(self, name: str) -> None:
        self.record(self.kernels, name)
        self._state().opaque += 1

    def exit_kernel(self) -> None:
        self._state().opaque -= 1

    @contextlib.contextmanager
    def collective(self, name: str):
        self.record(self.collectives, name)
        st = self._state()
        st.opaque += 1
        try:
            yield
        finally:
            st.opaque -= 1

    @contextlib.contextmanager
    def on_thread(self):
        """Run the body under this census on the calling thread."""
        holder = _build._CENSUS
        prev = getattr(holder, "census", None)
        holder.census = self
        try:
            with _FunctionMode(self), _DispatchMode(self):
                yield
        finally:
            holder.census = prev

    # -- the dispatch-level observer --------------------------------------
    def observe(self, func, args, kwargs, out) -> None:
        st = self._state()
        name = _packet(func)
        ins = _tensors(args) + _tensors(kwargs.values())
        kinds = [self.kind(t) for t in ins]
        if st.placing is not None:
            out_kind = st.placing
        elif ins and all(k != "device" for k in kinds):
            out_kind = "readback" if "readback" in kinds else "host"
        else:
            out_kind = "device"
        outs = _tensors(out if isinstance(out, (tuple, list)) else (out,))
        tags = [_dataless(t) for t in outs]
        for t, tag in zip(outs, tags):
            self._mark(t, out_kind)
            if st.quiet == 0 and tag is None:
                self._check_placement(name, t, out_kind)
        if not self._counts():
            return
        device_in = any(k == "device" for k in kinds)
        with self.lock:
            self.primitives[name] += 1
            for t, tag in zip(outs, tags):
                dt = _dtype_name(t.dtype)
                if tag is not None:
                    self.dtypes[f"{dt}@{tag}"] += 1
                elif out_kind == "device":
                    self.dtypes[dt] += 1
                    if dt not in self.device_dtypes:
                        self.device_dtypes.add(dt)
                        self.events.append({
                            "kind": "dtype", "op": name, "dtype": dt,
                            "shape": list(t.shape)})
                else:
                    self.dtypes[f"{dt}@host"] += 1
            if not device_in:
                return
            if name in HOST_READ_OPS:
                self.host_syncs[name] += 1
            elif name in MASK_INDEX_OPS and any(
                    i.dtype in (torch.bool, torch.uint8)
                    for i in _tensors(args[1:])):
                self.host_syncs[f"{name}(mask)"] += 1
            src_at = COPY_OPS.get(name)
            if src_at is not None and len(args) > src_at:
                src = args[src_at]
                if isinstance(src, torch.Tensor) and src.ndim >= 3 and \
                        not src.is_contiguous():
                    self.events.append({
                        "kind": "relayout", "op": name,
                        "dtype": _dtype_name(src.dtype),
                        "shape": list(src.shape),
                        "stride": list(src.stride())})
            if name in REDUCE_DOT_OPS and any(
                    t.dtype == torch.bfloat16 for t in ins) and any(
                    t.dtype == torch.bfloat16 for t in outs):
                self.events.append({"kind": "bf16_reduce", "op": name})

    def _check_placement(self, name: str, t, kind: str) -> None:
        """On the card: count (and keep the first few of) the tensors
        whose tracked placement ``kind`` is not where they lie."""
        if self.device.type != "cuda" or not self.counting or \
                _host_scalar(t) or \
                (kind == "device") == (t.device.type == "cuda"):
            return
        with self.lock:
            self.mismatches += 1
            if self.mismatches <= 4:
                self.events.append({
                    "kind": "placement", "op": name, "placed": kind,
                    "device": str(t.device), "shape": list(t.shape)})

    # -- the Python-level transfers ---------------------------------------
    def transfer(self, key: str, kind: str, fn, source=None):
        """``fn()``, a host<->device transfer: recorded under ``key`` in
        ``host_syncs`` (``key`` None: not a read), its operators not
        counted, its result marked ``kind``.  A result that is its
        ``source`` (a move to the device it is on, on the CPU) is copied
        first, so the source keeps its own placement."""
        if key is not None:
            self.record(self.host_syncs, key)
        with self.placing(kind, quiet=True):
            out = fn()
            if source is not None and out is source:
                out = out.clone()
        if isinstance(out, torch.Tensor):
            self._mark(out, kind)
            if _dataless(out) is None:
                self._check_placement(key or "transfer", out, kind)
        return out


def _device_arg(args, kwargs, at: int):
    """The ``device`` of a call: the keyword, else positional ``at``."""
    if "device" in kwargs:
        return kwargs["device"]
    if at is not None and len(args) > at and \
            isinstance(args[at], (str, torch.device)):
        return args[at]
    return None


def _to_target(args, kwargs):
    """Where ``Tensor.to(...)`` sends its tensor: a device, or a tensor
    whose device and dtype it takes; None for a dtype-only move."""
    if kwargs.get("device") is not None:
        return kwargs["device"]
    for a in args[1:]:
        if isinstance(a, (str, torch.device)):
            return a
        if isinstance(a, torch.Tensor):
            return a
    return None


class _FunctionMode(TorchFunctionMode):
    """Placement and transfers at the Python level (see the module
    docstring); every other call passes through untouched."""

    def __init__(self, census: Census):
        super().__init__()
        self.census = census

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        c = self.census
        if c._state().opaque:
            return func(*args, **kwargs)
        name = getattr(func, "__name__", "")
        if name in ("tensor", "as_tensor", "asarray") and \
                func in (torch.tensor, torch.as_tensor, torch.asarray):
            dev = _device_arg(args, kwargs, 2 if name != "tensor" else None)
            data = args[0] if args else kwargs.get("data")
            return self._create(func, args, kwargs, data,
                                None if dev is None
                                else c.on_program_device(dev))
        if name == "new_tensor" and func is torch.Tensor.new_tensor:
            dev = kwargs.get("device")
            data = args[1] if len(args) > 1 else kwargs.get("data")
            return self._create(func, args, kwargs, data,
                                c.kind(args[0]) == "device" if dev is None
                                else c.on_program_device(dev))
        if name in FACTORY_NAMES and func is getattr(torch, name, None):
            dev = kwargs.get("device")
            with c.placing("device" if c.on_program_device(dev)
                           else "host"):
                out = func(*args, **kwargs)
            if isinstance(out, torch.Tensor):
                c._mark(out, "device" if c.on_program_device(dev)
                        else "host")
            return out
        if not args or not isinstance(args[0], torch.Tensor):
            return func(*args, **kwargs)
        t = args[0]
        if name in ("to", "cpu", "cuda") and \
                func in (torch.Tensor.to, torch.Tensor.cpu,
                         torch.Tensor.cuda):
            if name == "cpu":
                to_device = False
            elif name == "cuda":
                to_device = True
            else:
                target = _to_target(args, kwargs)
                if target is None:
                    return func(*args, **kwargs)
                if isinstance(target, torch.Tensor):
                    to_device = c.kind(target) == "device"
                else:
                    to_device = c.on_program_device(target)
            src_device = c.kind(t) == "device"
            if to_device == src_device:
                return func(*args, **kwargs)
            if to_device:
                return c.transfer(H2D, "device",
                                  lambda: func(*args, **kwargs), t)
            return c.transfer(D2H, "readback",
                              lambda: func(*args, **kwargs), t)
        if name == "tolist" and func is torch.Tensor.tolist:
            if c.kind(t) == "device":
                return c.transfer(TOLIST, "host",
                                  lambda: func(*args, **kwargs))
            return func(*args, **kwargs)
        if name == "numpy" and func is torch.Tensor.numpy:
            if c.kind(t) != "host":
                c.record(c.callbacks, "numpy")
            return func(*args, **kwargs)
        return func(*args, **kwargs)

    def _create(self, func, args, kwargs, data, to_device):
        """``torch.tensor`` / ``as_tensor`` / ``new_tensor`` of ``data``:
        device data when ``to_device`` (a copy from the host, unless the
        data already lies there), host data when False; None (no device
        named) keeps a tensor's placement and makes host data of the
        rest."""
        c = self.census

        def call():
            return func(*args, **kwargs)

        if isinstance(data, torch.Tensor):
            src_device = c.kind(data) == "device"
            if to_device is None or to_device == src_device:
                return call()
            if to_device:
                return c.transfer(H2D, "device", call, data)
            return c.transfer(D2H, "readback", call, data)
        if to_device:
            return c.transfer(H2D, "device", call)
        with c.placing("host"):
            out = call()
        c._mark(out, "host")
        return out


class _DispatchMode(TorchDispatchMode):
    def __init__(self, census: Census):
        super().__init__()
        self.census = census

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        # Inside a kernel or collective region nothing is counted, and
        # what the region returns is device data: not even placement.
        if not self.census._state().opaque:
            self.census.observe(func, args, kwargs, out)
        return out


@contextlib.contextmanager
def _default_dtype(dtype):
    prev = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        torch.set_default_dtype(prev)


def trace_program(spec: ProgramSpec, device,
                  compile_collectives: bool = True, run_context=None,
                  **overrides) -> TracedProgram:
    """Build one registered program on ``device`` and take its census:
    one uncounted warm-up run, then one counted run.  ``run_context``
    (a callable returning a context manager) wraps the counted run alone
    (``chip_smoke.py`` counts the card's synchronising warnings there);
    ``compile_collectives`` False skips the collective inventory (the
    JAX flag's name, kept for the CLI's ``--no-collectives``);
    ``overrides`` go to the builder (e.g. ``n_pix``).

    Raises whatever the builder or the run raises — callers wrap this in
    a per-program try/except and surface failures as findings."""
    census = Census(device)
    dtype = torch.float64 if spec.x64 else torch.get_default_dtype()
    with _default_dtype(dtype):
        with census.on_thread():
            built: BuiltProgram = spec.build(census.device, **overrides)
        built.fn(*built.args)
        with census.on_thread():
            census.counting = True
            try:
                with (run_context() if run_context is not None
                      else contextlib.nullcontext()):
                    built.fn(*built.args)
            finally:
                census.counting = False

    collectives: Optional[Dict[str, int]] = None
    skipped: Optional[str] = None
    if built.mesh_devices >= 2:
        if compile_collectives:
            collectives = dict(sorted(census.collectives.items()))
        else:
            skipped = "collective inventory disabled (--no-collectives)"
    elif built.mesh_devices == 1:
        skipped = "single-shard mesh: no collective runs"
    return TracedProgram(
        spec=spec, device=str(census.device),
        primitives=dict(sorted(census.primitives.items())),
        dtypes=dict(sorted(census.dtypes.items())),
        kernels=dict(sorted(census.kernels.items())),
        host_syncs=dict(sorted(census.host_syncs.items())),
        callbacks=dict(sorted(census.callbacks.items())),
        n_eqns=sum(census.primitives.values()),
        torch_version=torch.__version__,
        events=census.events, mesh_devices=built.mesh_devices,
        collectives=collectives, collectives_skipped_reason=skipped,
        placement_mismatches=census.mismatches,
    )
