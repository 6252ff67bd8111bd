"""Load generator for the assimilation-as-a-service daemon.

The port of ``tools/loadgen.py``.  Makes the serving story measurable
like the solve story: fires concurrent tile requests at a serving
target, measures per-request submit-to-response wall time, and emits the
BENCH JSON serving rows —

    serve_p50_ms / serve_p99_ms   latency percentiles over OK responses
    serve_smoothed_p50/p99_ms     same, over smoothed=true (reanalysis)
                                  requests when --smoothed mixes them in
    serve_rejected_total          requests shed at admission
    (+ serve_ok/cancelled/error/requests totals and serve_cold_ms, the
     one cold-start solve paid before the timed phase)

Two targets:

- ``--root DIR`` drives a RUNNING ``kafka-serve`` daemon over its
  filesystem inbox/responses transport (cross-process: what production
  looks like);
- ``--synthetic`` (default when no --root) builds an in-process
  ``AssimilationService`` over synthetic tiles and drives it directly —
  the self-contained mode a benchmark embeds.

The in-process modes (``--synthetic``, ``--concurrency-sweep``,
``--fleet N``) solve on ``--device`` (CUDA by default; ``cpu`` runs on
the CPU) and raise without one; ``--root`` touches no device.

Usage:
    python -m kafka_tpu_torch.tools.loadgen --root /tmp/serve \\
        --requests 64 --concurrency 8
    python -m kafka_tpu_torch.tools.loadgen --synthetic --requests 32

Exit codes: 0 ok, 1 when any request timed out or errored hard.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from typing import List, Optional

import numpy as np


class _MetricsScraper:
    """Background ``/metrics`` sampler: scrapes a live telemetry
    endpoint (``kafka_tpu_torch.telemetry.httpd``) every ``interval_s``
    while the load runs and keeps the ``kafka_serve_*`` series as a time
    series — the BENCH JSON's ``live_telemetry`` block, so an artifact
    shows HOW the queue depth and admission counters moved under load,
    not just the final totals."""

    PREFIX = "kafka_serve_"

    def __init__(self, url: str, interval_s: float = 0.25,
                 max_samples: int = 240):
        self.url = url.rstrip("/") + "/metrics"
        self.interval_s = interval_s
        self.max_samples = max_samples
        self.samples: List[dict] = []
        self.errors = 0
        self._stop = threading.Event()
        # Client-side thread by design, like the loadgen workers: it
        # models an external Prometheus scraper, not daemon internals.
        # kafkalint: disable=untracked-thread — external-scraper model;
        # must not join the daemon's trace timeline.
        self._thread = threading.Thread(
            target=self._run, name="loadgen-scraper", daemon=True,
        )

    def scrape_once(self) -> Optional[dict]:
        import urllib.request

        from ..telemetry.aggregate import parse_prom_text

        try:
            with urllib.request.urlopen(self.url, timeout=2.0) as resp:
                families = parse_prom_text(
                    resp.read().decode("utf-8")
                )
        except (OSError, ValueError):
            self.errors += 1
            return None
        sample = {"t": round(time.time(), 3)}
        for name, fam in families.items():
            if not name.startswith(self.PREFIX):
                continue
            for s in fam["samples"]:
                labels = s["labels"]
                tag = name
                if labels:
                    tag += "{" + ",".join(
                        f"{k}={v}" for k, v in sorted(labels.items())
                    ) + "}"
                sample[tag] = s["value"]
        return sample

    def _run(self) -> None:
        while not self._stop.is_set():
            sample = self.scrape_once()
            if sample is not None and len(self.samples) < \
                    self.max_samples:
                self.samples.append(sample)
            self._stop.wait(self.interval_s)

    def start(self) -> "_MetricsScraper":
        self._thread.start()
        return self

    def stop(self) -> dict:
        """Stop sampling (one final scrape included) and return the
        ``live_telemetry`` block."""
        self._stop.set()
        self._thread.join(timeout=5.0)
        final = self.scrape_once()
        if final is not None and len(self.samples) < self.max_samples:
            self.samples.append(final)
        series: dict = {}
        for sample in self.samples:
            for key, v in sample.items():
                if key == "t":
                    continue
                series.setdefault(key, []).append(v)
        return {
            "scrape_url": self.url,
            "samples": len(self.samples),
            "scrape_errors": self.errors,
            "series": series,
        }


def _percentiles(latencies_ms: List[float]) -> tuple:
    if not latencies_ms:
        return None, None
    arr = np.asarray(latencies_ms, np.float64)
    return (
        round(float(np.percentile(arr, 50)), 3),
        round(float(np.percentile(arr, 99)), 3),
    )


class _Target:
    """Uniform submit/result face over the two transports."""

    def __init__(self, root: Optional[str] = None, service=None,
                 poll_interval_s: float = 0.01):
        if (root is None) == (service is None):
            raise ValueError("exactly one of root/service")
        self.root = root
        self.service = service
        self.poll = poll_interval_s

    def submit(self, payload: dict) -> dict:
        if self.service is not None:
            return self.service.submit(payload)
        from ..serve import submit_request

        rid = submit_request(self.root, payload)
        return {"request_id": rid, "status": "queued"}

    def result(self, request_id: str, timeout_s: float) -> Optional[dict]:
        if self.service is not None:
            return self.service.result(request_id, timeout_s=timeout_s)
        from ..serve import read_response

        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            got = read_response(self.root, request_id)
            if got is not None:
                return got
            # kafkalint: disable=ad-hoc-retry — client-side poll of a
            # cross-process filesystem response file: there is no failure
            # to classify and no backoff series, just a wait for another
            # process; a RetryPolicy would add machinery without
            # changing behaviour.
            time.sleep(self.poll)
        return None


def run_load(
    target: _Target,
    requests: List[dict],
    concurrency: int = 8,
    timeout_s: float = 300.0,
    backoff_budget: int = 0,
    backoff_cap_s: float = 5.0,
) -> dict:
    """Fire ``requests`` with ``concurrency`` client threads; returns
    the serving rows.  A rejected submission is terminal immediately
    (that IS the response — fast rejection is the overload contract) —
    UNLESS the rejection carries a ``retry_after_s`` backoff hint and
    ``backoff_budget`` > 0, in which case the client waits the hinted
    time and resubmits (each wait counted into ``serve_backoff_total``,
    at most ``backoff_budget`` waits per request) instead of hammering
    a shedding replica."""
    results = []
    health_totals: dict = {}
    backoff_total = [0]
    lock = threading.Lock()
    it = iter(list(enumerate(requests)))

    def worker():
        while True:
            with lock:
                nxt = next(it, None)
            if nxt is None:
                return
            i, payload = nxt
            payload = dict(payload)
            payload.setdefault("request_id", f"load{i:05d}")
            base_id = payload["request_id"]
            is_smoothed = bool(payload.get("smoothed"))
            t0 = time.perf_counter()
            backoffs = 0
            while True:
                ack = target.submit(payload)
                got = None
                if ack.get("status") != "rejected":
                    got = target.result(payload["request_id"],
                                        timeout_s=timeout_s)
                rejected = ack if ack.get("status") == "rejected" else (
                    got if got is not None
                    and got.get("status") == "rejected" else None
                )
                if rejected is not None:
                    hint = rejected.get("retry_after_s")
                    if hint and backoffs < backoff_budget:
                        backoffs += 1
                        # Fresh id per retry: in the filesystem
                        # transport a stale rejected response file must
                        # not alias the resubmission's answer.
                        payload["request_id"] = f"{base_id}b{backoffs}"
                        # kafkalint: disable=ad-hoc-retry — honouring
                        # the server's retry_after_s hint IS the backoff
                        # protocol; the wait length is the server's
                        # decision, not a client policy.
                        time.sleep(min(float(hint), backoff_cap_s))
                        continue
                    with lock:
                        backoff_total[0] += backoffs
                        results.append(
                            ("rejected", rejected.get("reason"),
                             0.0, None, None, is_smoothed, None, None,
                             None)
                        )
                    break
                wall_ms = (time.perf_counter() - t0) * 1e3
                status = "timeout" if got is None \
                    else got.get("status", "?")
                health = (got or {}).get("solver_health") or {}
                # Per-request tracing attribution: the server's trace
                # block carries the named phases and the server-side
                # e2e — covered means the named spans explain the
                # request's wall time (request_log's fraction bar with
                # the absolute noise floor).
                from ..telemetry import request_log

                trace = (got or {}).get("trace") or {}
                server_ms = trace.get("e2e_ms")
                covered = request_log.is_covered(trace)
                # Coalesced-serving stamps: batch_size rides the response
                # trace when the request was admitted into a micro-batch;
                # queue_wait_ms is the phase the batching exists to
                # shrink under load.
                batch_size = trace.get("batch_size")
                queue_wait = (trace.get("phases") or {}).get(
                    "queue_wait_ms"
                )
                served_from = (got or {}).get("served_from")
                with lock:
                    backoff_total[0] += backoffs
                    results.append(
                        (status, None, wall_ms, covered, server_ms,
                         is_smoothed, batch_size, queue_wait,
                         served_from)
                    )
                    for key, v in health.items():
                        health_totals[key] = \
                            health_totals.get(key, 0) + int(v or 0)
                break

    threads = [
        # kafkalint: disable=untracked-thread — loadgen threads are the
        # CLIENT side of the wire: they model independent external users
        # and must not join the daemon's trace timeline.
        threading.Thread(target=worker, name=f"loadgen-{k}", daemon=True)
        for k in range(max(1, concurrency))
    ]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall_s = time.perf_counter() - t_start
    # Forward and reanalysis latencies are DIFFERENT products under the
    # same roof: serve_p50/p99 keep meaning "forward analysis latency"
    # even when --smoothed mixes reanalysis reads into the load.
    ok_lat = [w for s, _, w, _, _, sm, _, _, _ in results
              if s == "ok" and not sm]
    smoothed_lat = [w for s, _, w, _, _, sm, _, _, _ in results
                    if s == "ok" and sm]
    p50, p99 = _percentiles(ok_lat)
    smoothed_p50, smoothed_p99 = _percentiles(smoothed_lat)
    count = lambda s: sum(
        1 for st, _, _, _, _, _, _, _, _ in results if st == s
    )
    n_ok = count("ok")
    # Tracing-coverage rows: the fraction of OK requests whose named
    # spans explain their server-side wall time, and the slowest single
    # request — the exemplar trace_report breaks down.
    covs = [c for s, _, _, c, _, _, _, _, _ in results if s == "ok" and
            c is not None]
    trace_coverage = (
        round(sum(1 for c in covs if c) / len(covs), 4)
        if covs else None
    )
    slowest = [sm if sm is not None else w
               for s, _, w, _, sm, _, _, _, _ in results if s == "ok"]
    slowest_ms = round(max(slowest), 3) if slowest else None
    # Coalesced-serving rows over OK forward requests: the mean
    # admission-group size (1 for requests served alone — the mean is
    # > 1 exactly when the micro-window coalesces under this load) and
    # the queue_wait p99 the batching exists to shrink.
    sizes = [bs or 1 for s, _, _, _, _, sm, bs, _, _ in results
             if s == "ok" and not sm]
    batch_mean = (
        round(sum(sizes) / len(sizes), 3) if sizes else None
    )
    coalesced = sum(1 for v in sizes if v >= 2)
    waits = [qw for s, _, _, _, _, sm, _, qw, _ in results
             if s == "ok" and not sm and qw is not None]
    _, queue_wait_p99 = _percentiles(waits)
    # Requests that paid a device solve (cold chain build or warm
    # incremental) — the numerator of a solve-throughput rate;
    # warm_noop and cache reads move no pixels.
    solved = sum(1 for s, _, _, _, _, _, _, _, sf in results
                 if s == "ok" and sf in ("cold", "warm"))
    return {
        "serve_p50_ms": p50,
        "serve_p99_ms": p99,
        "serve_smoothed_p50_ms": smoothed_p50,
        "serve_smoothed_p99_ms": smoothed_p99,
        "serve_smoothed_ok_total": len(smoothed_lat),
        "serve_requests_total": len(results),
        "serve_ok_total": n_ok,
        "serve_rejected_total": count("rejected"),
        "serve_cancelled_total": count("cancelled"),
        "serve_error_total": count("error") + count("timeout"),
        "serve_rps": round(n_ok / wall_s, 2) if wall_s > 0 else None,
        "serve_wall_s": round(wall_s, 3),
        # Backoff waits taken on retry_after_s rejection hints — the
        # client-side view of admission shedding under load.
        "serve_backoff_total": backoff_total[0],
        # Request-tracing rows: how much of the served latency the
        # per-request traces explain, and the single worst request
        # (server-side e2e).
        "serve_trace_coverage": trace_coverage,
        "serve_slowest_ms": slowest_ms,
        # Coalesced-serving rows.
        "serve_batch_mean_size": batch_mean,
        "serve_batch_coalesced_total": coalesced,
        "serve_queue_wait_p99_ms": queue_wait_p99,
        "serve_solved_total": solved,
        # Result QUALITY rows, summed over answered requests from the
        # per-response solver_health blocks: latency numbers alone would
        # hide a service answering fast with quarantined pixels.
        "serve_quarantined_pixels": health_totals.get("quarantined", 0),
        "serve_cap_bailouts": health_totals.get("cap_bailouts", 0),
        "serve_damped_recovered": health_totals.get(
            "damped_recovered", 0
        ),
    }


def synthetic_request_plan(dates, tiles, n_requests: int,
                           smoothed_every: int = 0) -> List[dict]:
    """A deterministic request mix cycling tiles x dates (newest date
    most often — the interactive-traffic shape the warm path serves).
    ``smoothed_every=K`` turns every Kth request into a ``smoothed=true``
    reanalysis read of the same tile/date (0 disables)."""
    plan = []
    for i in range(n_requests):
        tile = tiles[i % len(tiles)]
        # Bias 3:1 towards the newest date; the rest walk the ladder.
        date = dates[-1] if i % 4 else dates[i % len(dates)]
        req = {"tile": tile, "date": date.isoformat()}
        if smoothed_every and i % smoothed_every == smoothed_every - 1:
            req["smoothed"] = True
        plan.append(req)
    return plan


def bench_serve(
    tmpdir: str,
    requests: int = 24,
    concurrency: int = 4,
    tiles: int = 1,
    warm: bool = True,
    smoothed_every: int = 4,
    device=None,
) -> dict:
    """Self-contained serving bench (the benchmark embed): build an
    in-process service over synthetic tiles on ``device`` (default
    CUDA; raises without one), pay the cold start outside the timed
    window (reported as ``serve_cold_ms``), then measure the warm
    serving mix."""
    import os

    from .. import resolve_device
    from ..serve import (
        AdmissionPolicy, AssimilationService, TileSession,
        make_synthetic_tile, synthetic_dates,
    )
    from ..serve.synthetic import DEFAULT_BASE_DATE

    dev = resolve_device(device)
    sessions = {}
    for i in range(max(1, tiles)):
        name = f"tile{i}"
        spec = make_synthetic_tile(
            name, ckpt_dir=os.path.join(tmpdir, f"ckpt_{name}"),
            seed=i, device=dev,
        )
        sessions[name] = TileSession(spec)
    dates = synthetic_dates(DEFAULT_BASE_DATE, days=16, obs_every=2)
    service = AssimilationService(
        sessions, tmpdir,
        policy=AdmissionPolicy(max_queue_depth=max(64, requests + 1)),
    ).start()
    # Live observability ride-along: an ephemeral /metrics endpoint over
    # the in-process registry, scraped MID-RUN so the artifact carries a
    # live_telemetry time series next to the latency rows.
    from ..telemetry.httpd import TelemetryHTTPd

    httpd = TelemetryHTTPd(port=0, role="serve").start()
    scraper = None
    try:
        target = _Target(service=service)
        cold_ms = None
        if warm:
            t0 = time.perf_counter()
            rows = run_load(
                target,
                [{"tile": n, "date": dates[-1].isoformat()}
                 for n in sessions],
                concurrency=1, timeout_s=600.0,
            )
            cold_ms = round((time.perf_counter() - t0) * 1e3, 3)
            if rows["serve_ok_total"] != len(sessions):
                raise RuntimeError(f"serve warm-up failed: {rows}")
        # The default mix folds reanalysis reads in (every 4th request
        # asks smoothed=true): the warm-up above built the checkpoint
        # chain those reads answer from, so the serve_smoothed_* rows
        # measure the chain-walk+RTS path, not a cold failure.
        plan = synthetic_request_plan(
            dates[-4:], sorted(sessions), requests,
            smoothed_every=smoothed_every,
        )
        scraper = _MetricsScraper(httpd.url).start()
        # SLO ride-along (telemetry.slo): a fast-windowed
        # evaluator over the bench registry, started AFTER the cold
        # warm-up (its first sample is the measured window's baseline)
        # — the artifact carries whether the bench burned any error
        # budget next to how fast it went.
        from ..telemetry import slo as _slo

        engine = _slo.SLOEngine(
            fast_window_s=30.0, slow_window_s=120.0, interval_s=0.25,
        ).start()
        try:
            rows = run_load(target, plan, concurrency=concurrency,
                            timeout_s=600.0)
        finally:
            engine.stop()
        summary = engine.summary()
        remaining = [
            (o.get("budget") or {}).get("remaining")
            for o in summary["objectives"].values()
            if (o.get("budget") or {}).get("remaining") is not None
        ]
        rows["serve_slo_alerts_total"] = summary["alerts_fired"]
        rows["serve_slo_budget_remaining"] = (
            round(min(remaining), 6) if remaining else None
        )
        rows["serve_cold_ms"] = cold_ms
        rows["live_telemetry"] = scraper.stop()
        scraper = None
        return rows
    finally:
        if scraper is not None:
            scraper.stop()
        httpd.close()
        service.close()


def bench_concurrency_sweep(
    tmpdir: str,
    concurrencies=(1, 8, 32),
    tiles: int = 8,
    batch_window_ms: float = 25.0,
    max_batch: int = 8,
    device=None,
) -> dict:
    """Coalesced-serving sweep (the benchmark embed): ONE in-process
    service over ``tiles`` same-bucket synthetic tiles on ``device``
    (default CUDA; raises without one) with the admission micro-window
    on,
    driven at each concurrency level against a FRESH observation date
    (so every level pays real solves, not cache hits), then once more
    at the top level with the window off — the unbatched baseline from
    the very same warm sessions.

    Emits per-level rows (``serve_sweep``) plus the headline rows
    ``serve_batched_px_s`` (device launch throughput at the top
    concurrency),
    ``serve_batch_mean_size`` and the batched-vs-unbatched
    ``serve_queue_wait_p99_ms`` pair."""
    import os

    from .. import resolve_device
    from ..serve import (
        AdmissionPolicy, AssimilationService, TileSession,
        make_synthetic_tile, synthetic_dates,
    )
    from ..serve.synthetic import DEFAULT_BASE_DATE

    dev = resolve_device(device)
    # The kernel build cache, as kafka-serve points it at daemon start:
    # the cold start below builds the kernels there once (or loads
    # them), so no timed level pays an nvcc run.
    from ..utils.compilation_cache import enable_compilation_cache

    enable_compilation_cache()
    levels = [max(1, int(c)) for c in concurrencies]
    # One fresh GRID WINDOW per level + warm-up + the unbatched
    # baseline: consecutive observation dates can share a grid window
    # (step_days=4, obs_every=2 packs two obs per window), and serving
    # any date in a window assimilates the whole window — a level
    # whose date the previous level already covered would measure
    # warm_noop reads, not solves.  Stride past the window.
    stride = 2  # obs dates per grid window at the synthetic defaults
    n_dates_needed = stride * (len(levels) + 1) + 1
    days = 2 * (n_dates_needed + 1)
    sessions = {}
    for i in range(max(2, tiles)):
        name = f"tile{i}"
        sessions[name] = TileSession(make_synthetic_tile(
            name, ckpt_dir=os.path.join(tmpdir, f"ckpt_{name}"),
            days=days, seed=i, device=dev,
        ))
    dates = synthetic_dates(DEFAULT_BASE_DATE, days=days, obs_every=2)
    names = sorted(sessions)
    service = AssimilationService(
        sessions, tmpdir,
        policy=AdmissionPolicy(max_queue_depth=4096),
        batch_window_ms=batch_window_ms, max_batch=max_batch,
    ).start()
    executor = service._executor
    try:
        # Cold start outside every timed window: build each tile's
        # chain through dates[0] (pays the kernel builds too).
        t0 = time.perf_counter()
        warm = run_load(
            _Target(service=service),
            [{"tile": n, "date": dates[0].isoformat(),
              "request_id": f"sweepwarm{i:03d}"}
             for i, n in enumerate(names)],
            concurrency=1, timeout_s=600.0,
        )
        cold_ms = round((time.perf_counter() - t0) * 1e3, 3)
        if warm["serve_ok_total"] != len(names):
            raise RuntimeError(f"sweep warm-up failed: {warm}")
        # Pixels per launch member: the bucket's padded pixel count —
        # what one member of a device launch actually solves over.
        bucket = sessions[names[0]].serve_bucket()
        n_pad = bucket.n_pad if bucket is not None else None
        # Warm the batched program sizes a level can form (outside
        # every timed window, like the daemon's startup warm-up does):
        # a level whose first coalesced launch paid the K-member
        # program's first run would measure the warm-up, not serving.
        from ..serve import batch as serve_batch

        cap = min(len(names), max_batch)
        serve_batch.aot_compile_buckets(
            sessions, batch_sizes=tuple(range(1, cap + 1)),
        )

        def run_level(concurrency: int, date, tag: str) -> dict:
            # Explicit per-level request ids: run_load's default
            # load%05d ids REPEAT across calls, and a repeated id reads
            # the previous level's stale response file back.
            n_requests = max(concurrency, len(names))
            plan = [{"tile": names[i % len(names)],
                     "date": date.isoformat(),
                     "request_id": f"sweep{tag}n{i:04d}"}
                    for i in range(n_requests)]
            m = executor.metrics()
            launches0 = m["launches"].value() or 0
            members0 = m["launch_members"].value() or 0
            rows = run_load(_Target(service=service), plan,
                            concurrency=concurrency, timeout_s=600.0)
            launches = (m["launches"].value() or 0) - launches0
            members = (m["launch_members"].value() or 0) - members0
            wall = rows["serve_wall_s"]
            return {
                "concurrency": concurrency,
                "serve_p50_ms": rows["serve_p50_ms"],
                "serve_p99_ms": rows["serve_p99_ms"],
                "serve_queue_wait_p99_ms":
                    rows["serve_queue_wait_p99_ms"],
                "serve_batch_mean_size": rows["serve_batch_mean_size"],
                "serve_batch_coalesced_total":
                    rows["serve_batch_coalesced_total"],
                "serve_rps": rows["serve_rps"],
                "serve_ok_total": rows["serve_ok_total"],
                "serve_error_total": rows["serve_error_total"],
                # Device-level view from the executor counters (mean
                # members per coalesced launch) and the level's solve
                # throughput in padded pixels per second over requests
                # that actually paid a solve (warm_noop/cache excluded
                # — they move no pixels).
                "serve_device_batch_mean": (
                    round(members / launches, 3) if launches else None
                ),
                "serve_solved_total": rows["serve_solved_total"],
                "serve_px_s": (
                    round(rows["serve_solved_total"] * n_pad / wall, 1)
                    if n_pad and wall and wall > 0 else None
                ),
            }

        sweep = [run_level(c, dates[stride * (1 + i)], f"c{c}i{i}")
                 for i, c in enumerate(levels)]
        top = sweep[-1]
        # The unbatched baseline, SAME run, same warm sessions: window
        # off, a fresh grid window, the top concurrency again.
        service.set_batch_window(0.0)
        baseline = run_level(levels[-1], dates[stride * (1 + len(levels))],
                             "base")
        service.set_batch_window(batch_window_ms)
        errors = sum(lv["serve_error_total"] for lv in sweep) \
            + baseline["serve_error_total"]
        return {
            "serve_sweep": sweep,
            "serve_sweep_concurrencies": levels,
            "serve_cold_ms": cold_ms,
            "serve_batched_px_s": top["serve_px_s"],
            "serve_batch_mean_size": top["serve_batch_mean_size"],
            "serve_device_batch_mean": top["serve_device_batch_mean"],
            "serve_queue_wait_p99_ms": top["serve_queue_wait_p99_ms"],
            "serve_unbatched_p99_ms": baseline["serve_p99_ms"],
            "serve_unbatched_queue_wait_p99_ms":
                baseline["serve_queue_wait_p99_ms"],
            "serve_unbatched_px_s": baseline["serve_px_s"],
            "serve_error_total": errors,
        }
    finally:
        service.close()


def bench_fleet(
    tmpdir: str,
    replicas: int = 3,
    requests: int = 24,
    concurrency: int = 4,
    tiles: int = 4,
    backoff_budget: int = 4,
    device=None,
) -> dict:
    """Self-contained FLEET bench (the benchmark embed's elastic twin
    of :func:`bench_serve`): N in-process kafka-serve replicas on
    ``device`` (default CUDA; raises without one) over a SHARED
    checkpoint root, fronted by a consistent-hash ``TileRouter``, all
    driven through the router's filesystem transport — the
    serve_fleet_* BENCH rows measure the one serving surface a client
    of the elastic fleet actually sees."""
    import os

    from .. import resolve_device
    from ..serve import (
        AdmissionPolicy, AssimilationService, ServeDaemon, TileRouter,
        TileSession, make_synthetic_tile, synthetic_dates,
    )
    from ..serve.synthetic import DEFAULT_BASE_DATE
    from ..telemetry import get_registry

    dev = resolve_device(device)

    ckpt_root = os.path.join(tmpdir, "ckpt")
    tile_names = [f"tile{t}" for t in range(max(1, tiles))]
    replica_roots = {}
    daemons = []
    threads = []
    for i in range(max(2, replicas)):
        root = os.path.join(tmpdir, f"rep{i}")
        sessions = {
            name: TileSession(make_synthetic_tile(
                name,
                ckpt_dir=os.path.join(ckpt_root, f"ckpt_{name}"),
                seed=t, device=dev,
            ))
            for t, name in enumerate(tile_names)
        }
        svc = AssimilationService(
            sessions, root,
            policy=AdmissionPolicy(
                max_queue_depth=max(64, requests + 1)
            ),
        )
        daemons.append(ServeDaemon(svc, root, poll_interval_s=0.01))
        replica_roots[f"rep{i}"] = root
        # kafkalint: disable=untracked-thread — bench-harness carrier
        # for an in-process replica daemon; the daemon's own service
        # worker follows the tracing convention.
        threads.append(threading.Thread(
            target=daemons[-1].run, name=f"fleet-rep{i}", daemon=True,
        ))
    router_root = os.path.join(tmpdir, "router")
    router = TileRouter(replica_roots, router_root,
                        poll_interval_s=0.01)
    # kafkalint: disable=untracked-thread — bench-harness carrier for
    # the in-process router loop.
    router_thread = threading.Thread(
        target=router.run, name="fleet-router", daemon=True,
    )
    for t in threads:
        t.start()
    router_thread.start()
    dates = synthetic_dates(DEFAULT_BASE_DATE, days=16, obs_every=2)
    target = _Target(root=router_root)
    try:
        t0 = time.perf_counter()
        warm = run_load(
            target,
            [{"tile": n, "date": dates[-1].isoformat()}
             for n in tile_names],
            concurrency=2, timeout_s=600.0,
        )
        cold_ms = round((time.perf_counter() - t0) * 1e3, 3)
        if warm["serve_ok_total"] != len(tile_names):
            raise RuntimeError(f"fleet warm-up failed: {warm}")
        plan = synthetic_request_plan(dates[-4:], tile_names, requests)
        rows = run_load(
            target, plan, concurrency=concurrency, timeout_s=600.0,
            backoff_budget=backoff_budget,
        )
        flat = get_registry().flat()
        rerouted = int(sum(
            v for k, v in flat.items()
            if k.startswith("kafka_route_rerouted_total")
        ))
        return {
            "serve_fleet_p50_ms": rows["serve_p50_ms"],
            "serve_fleet_p99_ms": rows["serve_p99_ms"],
            "serve_fleet_requests_total": rows["serve_requests_total"],
            "serve_fleet_ok_total": rows["serve_ok_total"],
            "serve_fleet_rejected_total": rows["serve_rejected_total"],
            "serve_fleet_error_total": rows["serve_error_total"],
            "serve_fleet_rps": rows["serve_rps"],
            "serve_fleet_rerouted_total": rerouted,
            "serve_fleet_replicas": len(replica_roots),
            "serve_fleet_cold_ms": cold_ms,
            "serve_backoff_total": rows["serve_backoff_total"],
            "serve_trace_coverage": rows["serve_trace_coverage"],
            "serve_slowest_ms": rows["serve_slowest_ms"],
        }
    finally:
        router.drain()
        router_thread.join(timeout=120.0)
        for d in daemons:
            d.drain()
        for t in threads:
            t.join(timeout=120.0)


def main(argv=None) -> int:
    from ..cli import add_device_arg

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", default=None,
                    help="serve root of a RUNNING kafka-serve daemon "
                         "(or kafka-route front door)")
    ap.add_argument("--synthetic", action="store_true",
                    help="self-contained in-process service (default "
                         "when --root is not given)")
    ap.add_argument("--fleet", type=int, default=0, metavar="N",
                    help="self-contained ELASTIC-FLEET mode: N "
                         "in-process replicas behind a consistent-hash "
                         "router, emitting the serve_fleet_* rows")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument("--concurrency-sweep", default=None, metavar="LIST",
                    help="comma-separated concurrency levels (e.g. "
                         "1,8,32): run the self-contained coalesced-"
                         "serving sweep — per-level serve_p99_ms / "
                         "queue_wait / batch-size rows plus the gated "
                         "serve_batched_px_s throughput and an "
                         "unbatched same-run baseline (synthetic "
                         "mode only)")
    ap.add_argument("--backoff", type=int, default=0, metavar="K",
                    help="honor retry_after_s rejection hints with up "
                         "to K backoff waits per request (counted into "
                         "serve_backoff_total)")
    ap.add_argument("--smoothed", type=int, default=0, metavar="K",
                    help="every Kth request asks for the RTS reanalysis "
                         "(smoothed=true) instead of the forward "
                         "analysis — emits the serve_smoothed_* rows "
                         "(0 disables; synthetic mode defaults to 4)")
    ap.add_argument("--tiles", default="tile0",
                    help="comma-separated tile names (--root mode)")
    ap.add_argument("--dates", default=None,
                    help="comma-separated ISO dates to request (--root "
                         "mode; default: the synthetic default ladder)")
    ap.add_argument("--deadline-s", type=float, default=None)
    ap.add_argument("--timeout-s", type=float, default=300.0)
    ap.add_argument("--scrape-url", default=None,
                    help="a running daemon's live endpoint (e.g. "
                         "http://127.0.0.1:8080 from kafka-serve "
                         "--http-port); /metrics is scraped mid-run and "
                         "embedded as the live_telemetry series "
                         "(--root mode)")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    if args.concurrency_sweep:
        if args.root:
            print("--concurrency-sweep is self-contained (synthetic "
                  "mode); drop --root", file=sys.stderr)
            return 2
        import shutil
        import tempfile

        levels = [int(c) for c in args.concurrency_sweep.split(",")
                  if c.strip()]
        tmp = tempfile.mkdtemp(prefix="kafka_loadgen_sweep_")
        try:
            rows = bench_concurrency_sweep(tmp, concurrencies=levels,
                                           device=args.device)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print(json.dumps(rows))
        return 1 if rows.get("serve_error_total") else 0

    if args.root:
        from ..serve.synthetic import DEFAULT_BASE_DATE, synthetic_dates

        if args.dates:
            import datetime

            dates = [datetime.datetime.fromisoformat(d.strip())
                     for d in args.dates.split(",") if d.strip()]
        else:
            dates = synthetic_dates(DEFAULT_BASE_DATE, 16, 2)
        tiles = [t.strip() for t in args.tiles.split(",") if t.strip()]
        plan = synthetic_request_plan(dates, tiles, args.requests,
                                      smoothed_every=args.smoothed)
        if args.deadline_s:
            for p in plan:
                p["deadline_s"] = args.deadline_s
        scraper = _MetricsScraper(args.scrape_url).start() \
            if args.scrape_url else None
        rows = run_load(
            _Target(root=args.root), plan,
            concurrency=args.concurrency, timeout_s=args.timeout_s,
            backoff_budget=args.backoff,
        )
        if scraper is not None:
            rows["live_telemetry"] = scraper.stop()
    else:
        import tempfile
        import shutil

        tmp = tempfile.mkdtemp(prefix="kafka_loadgen_")
        try:
            if args.fleet:
                rows = bench_fleet(
                    tmp, replicas=args.fleet, requests=args.requests,
                    concurrency=args.concurrency,
                    backoff_budget=args.backoff or 4,
                    device=args.device,
                )
            else:
                rows = bench_serve(
                    tmp, requests=args.requests,
                    concurrency=args.concurrency,
                    smoothed_every=args.smoothed or 4,
                    device=args.device,
                )
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(rows))
    errors = rows.get("serve_error_total",
                      rows.get("serve_fleet_error_total", 0))
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
