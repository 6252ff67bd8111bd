"""The persistent kernel-build cache (port of
``kafka_tpu/utils/compilation_cache.py``).

The port's compiled programs are its hand kernels: ``core._build``
compiles each ``csrc/<name>.cu`` with ``nvcc`` into
``BUILD_ROOT/<name>-<hash>/`` (the hash covers the sources and flags)
and every later process that finds the library there loads it instead
of compiling.  ``BUILD_ROOT`` defaults to ``build/kafka_tpu_torch/`` at
the root of the checkout.

Called by the CLI drivers; safe to call several times.  Redirect with
``KAFKA_TPU_COMPILE_CACHE_DIR``; opt out with
``KAFKA_TPU_NO_COMPILE_CACHE=1``, which builds into a directory of this
process's own under the temporary directory, so nothing is reused.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path
from typing import Optional


def enable_compilation_cache(cache_dir: Optional[str] = None,
                             ) -> Optional[str]:
    """Point the kernel builds at ``cache_dir`` (else
    ``$KAFKA_TPU_COMPILE_CACHE_DIR``, else the default build directory).
    Returns the cache directory, or None when opted out."""
    from ..core import _build

    if os.environ.get("KAFKA_TPU_NO_COMPILE_CACHE"):
        _build.BUILD_ROOT = Path(tempfile.mkdtemp(prefix="kafka_build_"))
        return None
    path = cache_dir or os.environ.get("KAFKA_TPU_COMPILE_CACHE_DIR")
    if path:
        _build.BUILD_ROOT = Path(path)
    os.makedirs(_build.BUILD_ROOT, exist_ok=True)
    return str(_build.BUILD_ROOT)
