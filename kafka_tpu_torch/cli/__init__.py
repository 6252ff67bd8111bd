"""Command-line drivers of the port."""

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


def make_console(main_fn):
    """Wrap a driver ``main`` (which returns a result object for
    programmatic callers) into a console entry point returning 0."""

    def console():
        main_fn()
        return 0

    return console
