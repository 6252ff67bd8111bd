"""The operator tools of the port (``tools/``'s operator half of the JAX
package, on ``kafka_tpu_torch``): drive load and read every report on a
machine that has no JAX.

- :mod:`loadgen` — concurrent requests at a ``kafka_serve`` /
  ``kafka_route`` root, or self-contained in-process serving benches
  (``--synthetic``, ``--concurrency-sweep``, ``--fleet N``);
- :mod:`fleet_status` — the fleet view over live heartbeat snapshots
  (router ring, queue counts, stitched traces, ``--watch``);
- :mod:`queue_status` — the lease-queue view of a chunk-queue outdir;
- :mod:`device_report` — the kernel table of a profiler capture;
- :mod:`trace_report` — slow-request forensics over the request logs;
- :mod:`slo_report` — error budgets and alert episodes from
  ``alerts.jsonl``;
- :mod:`quality_report` — per-tile scorecards from ``quality.jsonl``;
- :mod:`kafkalint` and :mod:`check_metric_names` — the source lints
  over the port's own source (``kafka_tpu_torch/``, ``chip_smoke.py``);
- :mod:`bench_compare` and :mod:`bench_history` — the gate and the trend
  ledger over bench artifacts (``python -m kafka_tpu_torch.bench``);
- :mod:`roofline` and :mod:`measure_baseline` — the share of bound of
  the date solve's components and the driver baseline rows.

Each runs as ``python -m kafka_tpu_torch.tools.<name>`` with the JAX
tool's flags, output and exit codes.  The report tools and the bench
readers touch no device; ``loadgen``'s in-process modes, ``roofline``
and ``measure_baseline`` take ``--device`` (CUDA by default); the lints
read source text only.
"""
