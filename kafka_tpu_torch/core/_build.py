"""Build the CUDA sources in ``kafka_tpu_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` (with the ``csrc/*.cuh`` headers it includes)
has a plain C interface and is compiled by ``nvcc`` into
``build/kafka_tpu_torch/<name>-<hash>/lib<name>.so`` at the root of the
checkout, keyed by a hash of the sources and flags, then loaded with
``ctypes``.  ``build_all`` compiles several sources in parallel, one
``nvcc`` each.  A missing ``nvcc`` or a failed compile raises
with the compiler's output; nothing falls back.

``BUILD_ROOT`` is the persistent kernel cache:
``utils.compilation_cache.enable_compilation_cache`` points it elsewhere.
Every build, cached or compiled, is reported to the callables in
``BUILD_LISTENERS`` (``telemetry.compilemon``).

Two hooks serve the program census (``kafka_tpu_torch.analysis``): each
kernel wrapper runs both of its branches inside :class:`kernel_region`,
which the census records as one opaque node (the ``ctypes`` launch on
the card, the plain version on the CPU), and :func:`census_thread`
carries a census into the threads of a mesh's shards.  With no census
running, a region costs one thread-local lookup.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "kafka_tpu_torch"

# sm_90a: Hopper with its architecture-specific features.  No
# --use_fast_math: the solve-health flags need exact isfinite, IEEE
# division and IEEE square root.  -Xptxas -v records registers, shared
# memory and spills in the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
#: flags of one source beside NVCC_FLAGS.  The per-iteration kernels
#: (fused update, packed solve) make every product and sum its own IEEE
#: operation, without FMA contraction, in their plain versions' order:
#: kernel and plain version then round alike.
SOURCE_FLAGS = {
    "fused_update": ("-fmad=false",),
    "solve_rows": ("-fmad=false",),
}
#: callables ``(name, cached, seconds)`` told of every build.
BUILD_LISTENERS: list = []

_LOADED: dict = {}
_LOAD_LOCK = threading.Lock()
#: guards the wrappers' launch counts: shards of a pixel mesh launch
#: from one thread each (``shard.step``).
_COUNT_LOCK = threading.Lock()
#: every kernel source of the package (``csrc/<name>.cu``).
KERNEL_SOURCES = ("fused_gn", "fused_update", "solve_rows")
#: name -> {"path", "seconds", "log", "cached"} of the builds made or
#: found by this process.
BUILDS: dict = {}


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``); raises when neither exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME "
        f"({home}); the CUDA kernels of kafka_tpu_torch are compiled "
        "from source at first use and need the CUDA toolkit"
    )


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def _source_hash(name: str) -> str:
    h = hashlib.sha256(" ".join(_flags(name)).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _notify(name: str) -> None:
    for listener in BUILD_LISTENERS:
        listener(name, BUILDS[name]["cached"], BUILDS[name]["seconds"])


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless this exact build exists; return
    the shared library's path."""
    src = CSRC / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(src)
    out_dir = BUILD_ROOT / f"{name}-{_source_hash(name)}"
    lib = out_dir / f"lib{name}.so"
    log = out_dir / "build.log"
    if lib.is_file():
        BUILDS[name] = {"path": str(lib), "seconds": 0.0, "cached": True,
                        "log": log.read_text() if log.is_file() else ""}
        _notify(name)
        return lib
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".lib{name}.{os.getpid()}.so"
    cmd = [nvcc, *_flags(name), "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    text = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {src}:\n"
            f"{' '.join(cmd)}\n{text}"
        )
    log.write_text(text)
    os.replace(tmp, lib)
    BUILDS[name] = {"path": str(lib), "seconds": seconds, "cached": False,
                    "log": text}
    _notify(name)
    return lib


def build_all(names) -> dict:
    """``build`` every name at once, one ``nvcc`` process each; returns
    name -> library path and raises the first failure."""
    names = list(names)
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        futures = {nm: pool.submit(build, nm) for nm in names}
        return {nm: fut.result() for nm, fut in futures.items()}


def check_rows(name, t, rows, n, dev) -> None:
    """Raise unless ``t`` is a contiguous float32 ``(rows, n)`` tensor on
    ``dev``: what a kernel's C interface takes."""
    import torch

    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != dev:
        raise ValueError(f"{name} lies on {t.device}, expected {dev}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != (rows, n):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{(rows, n)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


@contextlib.contextmanager
def on_device(dev):
    """Make ``dev`` (the device of a launch's inputs) the calling
    thread's current CUDA device for the launch and yield the handle of
    its current stream.  A kernel then runs where its tensors lie,
    whatever device the caller had current: a mesh shard on ``cuda:1``
    launched from a thread with ``cuda:0`` current would otherwise fail
    or run on the wrong card."""
    import torch

    with torch.cuda.device(dev):
        yield torch.cuda.current_stream(dev).cuda_stream


def count_launch(wrapper, key=None, by: str = "launches_by_instance"
                 ) -> None:
    """Add one to ``wrapper.launches`` (and to ``getattr(wrapper,
    by)[key]`` when ``key`` is given), under a lock; then, unless a
    shard group is live, run the jobs queued by
    :func:`after_next_launch` on this thread."""
    with _COUNT_LOCK:
        wrapper.launches += 1
        if key is not None:
            by_key = getattr(wrapper, by)
            by_key[key] = by_key.get(key, 0) + 1
        jobs = [] if _SHARD_GROUPS[0] else _take_jobs()
    for job in jobs:
        job()


#: one-shot jobs for the next thread that launches a kernel.
_AFTER_LAUNCH: list = []
#: shard groups whose threads run now (``shard_group``), in a list so
#: the count changes in place under ``_COUNT_LOCK``.
_SHARD_GROUPS = [0]


def _take_jobs() -> list:
    jobs = _AFTER_LAUNCH[:]
    del _AFTER_LAUNCH[:]
    return jobs


def after_next_launch(job) -> None:
    """Queue ``job()`` to run once, on the next thread that launches one
    of the package's kernels, just after its launch returned: a point
    where that thread is inside no CUDA call.  While a shard group is
    live the job waits for the group's end instead (:func:`shard_group`).
    ``job`` must not raise."""
    with _COUNT_LOCK:
        _AFTER_LAUNCH.append(job)


@contextlib.contextmanager
def shard_group():
    """Wrap the start and join of a mesh's shard threads
    (``shard.step.run_shards``).  While a group is live no launching
    thread runs the :func:`after_next_launch` jobs: a shard that
    launched could switch CUDA tracing while another shard is inside a
    CUDA call, which can lose that shard's GPU records.  The jobs queued
    meanwhile run on this (the caller's) thread when the last live group
    ends, after its shards were joined: no shard is inside a CUDA call
    then."""
    with _COUNT_LOCK:
        _SHARD_GROUPS[0] += 1
    try:
        yield
    finally:
        with _COUNT_LOCK:
            _SHARD_GROUPS[0] -= 1
            jobs = [] if _SHARD_GROUPS[0] else _take_jobs()
        for job in jobs:
            job()


def discard_launch_job(job) -> bool:
    """Unqueue ``job`` if no launch has run it yet and no shard group is
    live (a live group's end runs it); returns whether it was
    unqueued."""
    with _COUNT_LOCK:
        if job in _AFTER_LAUNCH and not _SHARD_GROUPS[0]:
            _AFTER_LAUNCH.remove(job)
            return True
        return False


#: the program census that runs on this thread, if any
#: (``analysis.trace``).
_CENSUS = threading.local()


def current_census():
    """The census running on this thread, None outside one."""
    return getattr(_CENSUS, "census", None)


class kernel_region:
    """The body of one kernel call, ``name`` its census node
    (``fused_gn``, ``fused_update[p,b]``, ``solve_rows[route]``; a
    callable is asked for it only while a census runs): a running census
    records the node once and counts none of the operations inside, on
    the card (the launch, its output buffers) as on the CPU (the plain
    version)."""

    __slots__ = ("name", "census")

    def __init__(self, name):
        self.name = name
        self.census = getattr(_CENSUS, "census", None)

    def __enter__(self):
        if self.census is not None:
            self.census.enter_kernel(
                self.name() if callable(self.name) else self.name)
        return self

    def __exit__(self, *exc):
        if self.census is not None:
            self.census.exit_kernel()
        return False


def census_thread(census):
    """A context that runs the body of a new thread (a mesh shard) under
    ``census``, the caller's :func:`current_census`; a no-op for None."""
    if census is None:
        return contextlib.nullcontext()
    return census.on_thread()


def raise_on_error(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise with the CUDA error string when a launch returned ``rc`` != 0
    (every library exports ``kafka_cuda_error_string``)."""
    if rc == 0:
        return
    lib.kafka_cuda_error_string.restype = ctypes.c_char_p
    lib.kafka_cuda_error_string.argtypes = [ctypes.c_int]
    msg = lib.kafka_cuda_error_string(rc).decode()
    raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} "
                       f"({msg})")


def attributes(name: str, symbol: str, *int_args) -> dict:
    """Registers, spill bytes, static shared bytes and threads per block
    of a compiled kernel, from the library's ``symbol(*int_args, out)``
    (builds it if needed)."""
    lib = load(name)
    out = (ctypes.c_int * 4)()
    fn = getattr(lib, symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * len(int_args) + [ctypes.c_void_p]
    rc = fn(*int_args, ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: {rc}")
    return {"registers": out[0], "local_bytes": out[1],
            "static_shared_bytes": out[2], "threads": out[3]}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed (one
    thread builds; the others wait for it)."""
    with _LOAD_LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = _LOADED[name] = ctypes.CDLL(str(build(name)))
        return lib
