"""Seeded violations: serving-daemon worker threads and response polls
are subject to the same runtime conventions as everyone else —
untracked-thread (tracing) and ad-hoc-retry (resilience)."""

import threading
import time


def _serve_worker():
    # No tracing.set_context — this worker's spans detach from the run.
    return None


def spawn_worker():
    t = threading.Thread(target=_serve_worker, daemon=True)  # expect: untracked-thread
    t.start()
    return t


def wait_for_response(path_exists):
    while not path_exists():
        time.sleep(0.05)  # expect: ad-hoc-retry
