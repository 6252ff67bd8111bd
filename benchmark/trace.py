"""One ``torch.profiler`` capture of the timed window, reduced to what the
per-layer metrics read: the device's busy time (the union of kernel,
memcpy and memset intervals), each kernel launch's name and duration,
the top device operations and the idle gaps named by the host range
(``kafka/<phase>`` of the program, ``benchmark/<step>`` of the harness)
the host was in."""

from __future__ import annotations

import contextlib

WINDOW_RANGE = "benchmark/window"
MAX_BREAKDOWN = 10


@contextlib.contextmanager
def capture(enabled: bool):
    """Profile the enclosed block (CPU ranges and CUDA activity); yields
    the profiler, or None when ``enabled`` is false."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=False, with_stack=False,
                 profile_memory=False) as prof:
        yield prof


def _activity(evt) -> str:
    kind = getattr(evt, "activity_type", None)
    return "" if kind is None else str(kind()).lower()


def _annotation(evt) -> bool:
    """A ``record_function`` range (or, where the profiler cannot say,
    possibly one)."""
    check = getattr(evt, "is_user_annotation", None)
    return True if check is None else bool(check())


def _kind(evt) -> str:
    kind = _activity(evt)
    if kind:
        if "memcpy" in kind:
            return "memcpy"
        if "memset" in kind:
            return "memset"
        if "kernel" in kind:
            return "kernel"
    name = evt.name().lower()
    if name.startswith("memcpy"):
        return "memcpy"
    if name.startswith("memset"):
        return "memset"
    return "kernel"


def _union(intervals):
    """Merged, sorted ``[start, end]`` intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(prof) -> dict:
    """The capture's window (the harness's ``benchmark/window`` range),
    its device intervals clipped to it, and the host ranges inside it."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    window = None
    device, ranges = [], []
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() == cuda:
            name = evt.name()
            if name.startswith(("kafka/", "benchmark/")) or \
                    "annotation" in _activity(evt):
                continue  # a host range mirrored on the device's track
            device.append((evt.start_ns(), evt.start_ns()
                           + evt.duration_ns(), name, _kind(evt)))
            continue
        if not _annotation(evt):
            continue  # an operator of the host, not a range
        name = evt.name()
        if name == WINDOW_RANGE:
            window = (evt.start_ns(), evt.start_ns() + evt.duration_ns())
        elif name.startswith(("kafka/", "benchmark/")):
            ranges.append((evt.start_ns(), evt.start_ns()
                           + evt.duration_ns(), name))
    if window is None:
        return {"window_s": None}
    w0, w1 = window
    inside = [(max(s, w0), min(e, w1), n, k) for s, e, n, k in device
              if e > w0 and s < w1]
    busy = _union([[s, e] for s, e, _, _ in inside])
    busy_ns = sum(e - s for s, e in busy)
    kernels = [(n, (e - s) * 1e-9) for s, e, n, k in inside
               if k == "kernel"]
    by_name = {}
    for s, e, n, _ in inside:
        by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-9
    gaps, prev = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    # Each gap goes to the innermost host range holding its middle: a
    # sweep over the ranges by start, keeping the open ones as a stack
    # (the ranges of the launching thread nest).
    idle_by_range = {}
    ranges.sort()
    stack, r = [], 0
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        while r < len(ranges) and ranges[r][0] <= mid:
            stack.append(ranges[r])
            r += 1
        stack = [x for x in stack if x[1] >= mid]
        label = stack[-1][2] if stack else "none"
        idle_by_range[label] = idle_by_range.get(label, 0.0) \
            + (g1 - g0) * 1e-9
    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": busy_ns * 1e-9,
        "kernels": kernels,
        "device_ops": sorted(([n[:120], t] for n, t in by_name.items()),
                             key=lambda r: -r[1])[:MAX_BREAKDOWN],
        "idle_gaps": sorted(([n, t] for n, t in idle_by_range.items()),
                            key=lambda r: -r[1])[:MAX_BREAKDOWN],
    }
