"""Seeded ``ad-hoc-retry`` violations: hand-rolled backoff loops and
straight-line waits that must go through resilience.RetryPolicy."""

import time
from time import sleep


def flaky_read(read):
    for attempt in range(3):
        try:
            return read()
        except OSError:
            time.sleep(2 ** attempt)  # expect: ad-hoc-retry
    return None


def poll_until(done):
    while not done():
        sleep(0.5)  # expect: ad-hoc-retry


def wait_then_read(read):
    time.sleep(5.0)  # expect: ad-hoc-retry
    return read()
