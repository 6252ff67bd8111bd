"""gp_rows.ms_per_date (ms/date): the device time of each date's
``gp_rows`` spans, one a launch of the GP bank's row kernel, timed by a
CUDA event pair around each launch (the engine's ``gp_rows_ms`` record
field, read after the date's packed diagnostic read; a fused block's
split evenly over its windows), averaged over the window's date
records.  Nothing to read where the program records no such field (the
CPU, another operator, or a program without the span)."""


def read(run):
    values = [r["gp_rows_ms"] for r in run.get("dates") or ()
              if r.get("gp_rows_ms") is not None]
    return sum(values) / len(values) if values else None
