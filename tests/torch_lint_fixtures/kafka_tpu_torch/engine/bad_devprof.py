"""Seeded violations: raw device introspection outside the telemetry
funnel (``raw-device-introspection``).  CUDA memory queries and resets
and the profiler belong in
``kafka_tpu_torch/telemetry/{device,devprof,perf}.py`` — scattered call
sites duplicate the watermark gauges, reset the ledger's peak, and
collide with the one-capture-per-process profiler contract."""

import torch
from torch import cuda, profiler


def adhoc_watermark(device):
    return torch.cuda.memory_stats(device)  # expect: raw-device-introspection


def adhoc_peak(device):
    torch.cuda.reset_peak_memory_stats(device)  # expect: raw-device-introspection
    return cuda.max_memory_allocated(device)  # expect: raw-device-introspection


def adhoc_headroom(device):
    return torch.cuda.mem_get_info(device)  # expect: raw-device-introspection


def adhoc_capture():
    with torch.profiler.profile() as prof:  # expect: raw-device-introspection
        with profiler.record_function("step"):  # expect: raw-device-introspection
            pass
    with torch.autograd.profiler.record_function("x"):  # expect: raw-device-introspection
        pass
    return prof


def reading_the_gauges_is_fine(reg):
    # The sanctioned path: consume what the funnel published.
    return reg.value("kafka_device_memory_headroom_bytes")
