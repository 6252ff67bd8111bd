"""Build the CUDA sources in ``kafka_tpu_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` (with the ``csrc/*.cuh`` headers it includes)
has a plain C interface and is compiled by ``nvcc`` into
``build/kafka_tpu_torch/<name>-<hash>/lib<name>.so`` at the root of the
checkout, keyed by a hash of the sources and flags, then loaded with
``ctypes``.  ``build_all`` compiles several sources in parallel, one
``nvcc`` each.  A missing ``nvcc`` or a failed compile raises
with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import concurrent.futures
import threading
import ctypes
import hashlib
import os
import shutil
import subprocess
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

_LOADED: dict = {}
_LOAD_LOCK = threading.Lock()
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
