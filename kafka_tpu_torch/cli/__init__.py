"""Command-line drivers and tools of the port: run_synthetic, the
real-sensor drivers (run_s2, run_modis, run_mod09, run_s1, run_joint and
run_modis_distributed, over ``drivers.run_config``), the subprocess
chunk_worker, mosaic, import_emulators, kafka_smooth, kafka_serve and
kafka_route."""

from __future__ import annotations


def add_telemetry_arg(ap) -> None:
    """The drivers' shared ``--telemetry-dir`` flag: events stream to
    ``events.jsonl`` in the directory during the run; ``metrics.prom``
    and ``metrics.json`` snapshots are written at run end."""
    ap.add_argument(
        "--telemetry-dir", default=None,
        help="export run telemetry into this directory (events.jsonl "
             "streamed; metrics.prom/metrics.json written at run end)",
    )


def add_device_arg(ap) -> None:
    """The drivers' ``--device`` flag: CUDA by default (and an error
    without a card); ``cpu`` runs on the CPU."""
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' runs on the "
                         "CPU)")


def make_console(main_fn):
    """Wrap a driver ``main`` (which returns a result object for
    programmatic callers) into a console entry point.

    Exit codes, as in the JAX package: 0 on full success;
    ``EXIT_PARTIAL_SUCCESS`` (75) when the run completed but quarantined
    chunks (the result dict carries a nonzero ``"failed"``)."""

    def console():
        result = main_fn()
        if isinstance(result, dict) and result.get("failed"):
            from ..resilience import EXIT_PARTIAL_SUCCESS

            return EXIT_PARTIAL_SUCCESS
        return 0

    return console
