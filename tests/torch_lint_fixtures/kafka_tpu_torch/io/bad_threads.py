"""Seeded untracked-thread violations plus the compliant shape."""

import threading

from kafka_tpu_torch.telemetry import tracing


def _bare_worker():
    while True:
        pass


def spawn_untracked():
    t = threading.Thread(target=_bare_worker, daemon=True)  # expect: untracked-thread
    u = threading.Thread(target=lambda: None)  # expect: untracked-thread
    return t, u


class Owner:
    """The convention: capture at construction, re-install in the target."""

    def __init__(self):
        self._ctx = tracing.current_context()
        self._worker = threading.Thread(target=self._drain, daemon=True)

    def _drain(self):
        tracing.set_context(self._ctx)
        tracing.set_lane("writer")
