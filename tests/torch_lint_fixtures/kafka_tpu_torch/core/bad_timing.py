"""Fixture: ad-hoc timing in a device-adjacent module.

Raw clock reads and device flushes used as timing barriers in core/ must
go through telemetry.spans (span / stopwatch); each seeded violation is
annotated with the rule expected to report it.
"""

import time
from time import monotonic

import torch


def timed_solve(solve, x):
    t0 = time.perf_counter()  # expect: ad-hoc-timing
    y = solve(x)
    torch.cuda.synchronize()  # expect: ad-hoc-timing
    return y, time.perf_counter() - t0  # expect: ad-hoc-timing


def poll_wall():
    start = monotonic()  # expect: ad-hoc-timing
    return start


def sanctioned_wall_clock():
    # time.time() is wall-clock bookkeeping (timestamps, deadlines),
    # not an interval measurement — stays legal.
    return time.time()


def suppressed_probe(solve, x):
    # kafkalint: disable=ad-hoc-timing — justified one-off calibration
    t0 = time.perf_counter()
    solve(x)
    return time.perf_counter() - t0  # kafkalint: disable=ad-hoc-timing
