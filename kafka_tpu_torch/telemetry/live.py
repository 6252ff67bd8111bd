"""Live status facts of a process (the status half of
``kafka_tpu/telemetry/live.py``).

Role-specific facts (serve root, tiles, the last requests) are
contributed through :func:`update_status` and read back with
:func:`current_status`; ``request_log.record`` keeps the compact
``recent_requests`` fact here.  The JAX module's other half — the
heartbeat publisher (``LivePublisher``, ``start_publisher``,
``build_snapshot``), which reads ``devprof``, ``perf`` and ``slo`` —
waits for the device-plane slice (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import threading
from typing import Any, Dict

_status_lock = threading.Lock()
_status: Dict[str, Any] = {}


def update_status(**fields) -> None:
    """Merge JSON-serialisable facts into this process's status
    (``None`` values are ignored)."""
    with _status_lock:
        _status.update(
            {k: v for k, v in fields.items() if v is not None}
        )


def current_status() -> Dict[str, Any]:
    with _status_lock:
        return dict(_status)
