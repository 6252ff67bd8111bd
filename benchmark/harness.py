"""Runs one cell of ``BENCHMARK.json`` once: data from the seed, a warm-up
of the cell's own shapes, the timed window over back-to-back jobs of
``KalmanFilter.run``, the check against the plain reference, and the
result line.

Everything that belongs to one configuration, cell or per-layer metric
is found by its name: ``configs/<config>.json`` (whose ``scenario``
names the module under ``scenarios/`` that builds its data, its jobs and
its reference), ``workloads/<cell>.json`` (the traffic, the sample and
the limits of the check) and ``metrics/<metric>.py`` (a ``read(run)``
that returns the metric's value or None).
"""

from __future__ import annotations

import copy
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
#: top-level module names no run may hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "kafka_tpu")


class CellError(RuntimeError):
    """The cell cannot run here (no card, too few cards)."""


class ForbiddenModules(RuntimeError):
    """A module of the JAX stack was loaded in the run's process."""


def manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else copy.deepcopy(v)
    return out


def cell(name: str, man: dict = None, here: Path = HERE) -> dict:
    """The cell's manifest entry with its workload file, its
    configuration file and its per-layer metrics' entries (a metric
    without ``workloads`` belongs to every cell)."""
    man = man if man is not None else manifest(here.parent)
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    work = _json(here / "workloads" / f"{name}.json")
    if (work["config"], work["traffic"]) != (entry["config"],
                                             entry["traffic"]):
        raise ValueError(f"workloads/{name}.json names "
                         f"{work['config']}/{work['traffic']}, the "
                         f"manifest {entry['config']}/{entry['traffic']}")
    conf = next(c for c in man["configs"] if c["name"] == entry["config"])
    config = _json(here.parent / conf["file"])
    metrics = [m for m in man["per_layer"]
               if name in m.get("workloads", [name])]
    return {"entry": entry, "workload": work, "config": config,
            "per_layer": metrics}


def metric_reader(name: str, here: Path = HERE):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def scenario_class(config: dict):
    return importlib.import_module(
        f"benchmark.scenarios.{config['scenario']}").Scenario


def forbidden_modules() -> list:
    loaded = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(loaded.intersection(FORBIDDEN))


def card_line() -> str:
    """The card's name, power limit and clocks (``nvidia-smi``)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc!r}"


def _phase_seconds(phase: str) -> float:
    from kafka_tpu_torch.telemetry import get_registry

    st = get_registry().value("kafka_engine_phase_seconds", phase=phase)
    return 0.0 if st is None else float(st["sum"])


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_jobs(scn, sink, device, first_job: int, seconds: float,
             whole_jobs: bool, records: list, max_jobs: int = None):
    """Back-to-back jobs from ``first_job`` until ``seconds`` have passed:
    at the first completed window at or after it, or with
    ``whole_jobs`` at the first job end.  Appends each job's per-date
    records (``n_pad`` beside the engine's own).  Returns ``(t0, t_end,
    jobs)``."""
    from torch.profiler import record_function

    from .sink import StopWindow

    t0 = time.perf_counter()
    sink.stop_at = None if whole_jobs else t0 + seconds
    job = first_job
    try:
        while True:
            kind = job % scn.kinds
            sink.start_job(job, scn.windows(kind), scn.sample(kind))
            sink.job_filter = None
            try:
                with record_function("benchmark/job"):
                    scn.run_job(kind, sink)
            finally:
                kf = sink.job_filter
                if kf is not None:
                    records.extend(dict(r, n_pad=kf.gather.n_pad,
                                        job=job)
                                   for r in kf.diagnostics_log)
                sink.job_filter = None
            if not sink.job_finished():
                raise RuntimeError(f"job {job} ended without dumping "
                                   "every window")
            job += 1
            done = job - first_job
            if max_jobs is not None:
                if done >= max_jobs:
                    break
            elif whole_jobs and time.perf_counter() - t0 >= seconds:
                break
    except StopWindow:
        job += 1
    _sync(device)
    return t0, time.perf_counter(), job - first_job


def pairs(scn, sink, dtype) -> tuple:
    """``(pairs, failed)``: each window completed in the window, its
    sampled outputs beside the reference of its job's kind."""
    from .sink import finite_rows

    refs, out, failed = {}, [], 0
    for job, k, _, _ in sink.completed:
        kind = job % scn.kinds
        if kind not in refs:
            refs[kind] = scn.reference(kind, dtype)
        got = sink.kept[(job, k)]
        failed += not finite_rows(got)
        out.append((got, refs[kind][k]))
    return out, failed


def check(scn, sink, limits: dict, dtype, share_over=None) -> tuple:
    """``(values, correct, checks, failed)``: the sampled outputs of
    every window completed in the window against the reference of its
    job's kind."""
    from . import compare

    done, failed = pairs(scn, sink, dtype)
    values = compare.numbers(done, share_over)
    correct, checks = compare.judge(values, limits)
    return values, correct and bool(done), checks, failed


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device=None, overrides: dict = None, t_start: float = None,
             log=sys.stderr) -> dict:
    """Run the cell once; returns the result line as a dict.  ``device``
    None means the card (and requires as many cards as the cell asks
    for); ``overrides`` (tests) merge into the configuration
    (``"config"``) and the workload (``"workload"``)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    spec = cell(name)
    overrides = overrides or {}
    config = _merge(spec["config"], overrides.get("config"))
    work = _merge(spec["workload"], overrides.get("workload"))
    chips = int(spec["entry"]["chips"])
    if device is None:
        if not torch.cuda.is_available():
            raise CellError("no CUDA device: torch.cuda.is_available() is "
                            "false")
        if torch.cuda.device_count() < chips:
            raise CellError(f"the cell asks for {chips} cards; "
                            f"{torch.cuda.device_count()} visible")
        device = torch.device("cuda", 0)
        print(f"card: {card_line()}", file=log)
    device = torch.device(device)
    cuda = device.type == "cuda"

    from .sink import HostSink, pixel_dates

    t_data = time.perf_counter()
    scn = scenario_class(config)(config, work, seed, device)
    sink = HostSink(scn.n_pad, len(scn.cfg.parameter_list), scn.n_valid,
                    pinned=cuda)
    _sync(device)
    t_warm = time.perf_counter()
    # Warm-up: the cell's own paths, then the timed window.
    sink.stop_after = int(work["warmup_windows"])
    run_jobs(scn, sink, device, 0, float("inf"), False, [])
    sink.reset()
    _sync(device)
    setup_s = time.perf_counter() - t_start
    print(f"setup: start {t_data - t_start!r} s, data "
          f"{t_warm - t_data!r} s, warm-up "
          f"{time.perf_counter() - t_warm!r} s", file=log)
    records = []
    dump0 = _phase_seconds("dump")
    from .trace import WINDOW_RANGE, capture

    # A traced run profiles whole jobs for at least the workload's
    # ``trace_seconds`` (at most ``seconds``): the capture's reduction
    # grows with its events, and the run must end in its allowance.
    window = min(seconds, float(work.get("trace_seconds", seconds))) \
        if trace else seconds
    with capture(trace) as prof:
        from torch.profiler import record_function

        with record_function(WINDOW_RANGE):
            t0, t1, jobs = run_jobs(scn, sink, device, 0, window, trace,
                                    records)
    dump_s = _phase_seconds("dump") - dump0
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    px, span = pixel_dates(sink.completed, scn.n_valid, t0, float("inf"))
    run = {"window_wall_s": t1 - t0, "dump_s": dump_s, "dates": records,
           "config": config, "jobs": jobs}
    if prof is not None:
        from .trace import reduce

        t_red = time.perf_counter()
        run["trace"] = reduce(prof)
        del prof
        print(f"trace: {time.perf_counter() - t_red!r} s to reduce, "
              f"{len(run['trace'].get('kernels', ()))} kernels", file=log)

    # The check: the reference's inputs, then the program's state freed.
    scn.reference_inputs()
    scn.release()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    values, correct, checks, failed = check(
        scn, sink, work.get("limits", {}), torch.float64,
        work.get("share_over"))
    print(f"reference: {time.perf_counter() - t_ref!r} s", file=log)
    for k, v in values.items():
        lim = checks.get(k, {}).get("limit")
        print(f"check {k} = {v!r}" + ("" if lim is None else
                                      f" (limit {lim!r})"), file=log)

    metrics = {}
    if trace:
        for m in spec["per_layer"]:
            value = metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics["px_dates_per_s"] = {
            "value": px / span if span > 0 else 0.0, "unit": "px-dates/s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": chips if cuda else 0, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(sink.completed),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace and run["trace"].get("window_s"):
        dev["busy_s"] = run["trace"]["busy_s"]
        dev["window_s"] = run["trace"]["window_s"]
        result["breakdown"] = {
            "device_ops": run["trace"]["device_ops"],
            "idle_gaps": run["trace"]["idle_gaps"]}
    ends = [t for _, _, _, t in sink.completed]
    print("window completions (s from start): "
          + " ".join(f"{t - t0:.3f}" for t in ends[::max(1, len(ends)
                                                          // 40)]),
          file=log)
    print(f"window: {jobs} jobs, {len(sink.completed)} windows, "
          f"{len(records)} dates, {px} pixel-dates in {span!r} s; "
          f"setup {setup_s!r} s; peak {peak} B", file=log)
    for k, c in checks.items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=log)
    result["checks"] = checks
    # Last: whatever the check and the metric readers loaded counts too.
    bad = forbidden_modules()
    if bad:
        raise ForbiddenModules(f"modules of the JAX stack are loaded: "
                               f"{bad}")
    return result
