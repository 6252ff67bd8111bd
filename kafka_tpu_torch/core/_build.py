"""Build the CUDA sources in ``kafka_tpu_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` into ``build/kafka_tpu_torch/<name>-<hash>/lib<name>.so`` at the
root of the checkout, keyed by a hash of the sources and flags, then
loaded with ``ctypes``.  A missing ``nvcc`` or a failed compile raises
with the compiler's output; nothing falls back.
"""

from __future__ import annotations

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

_LOADED: dict = {}
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


def _source_hash(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
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
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
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


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = ctypes.CDLL(str(build(name)))
    return lib
