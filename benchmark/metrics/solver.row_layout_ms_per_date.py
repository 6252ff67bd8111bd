"""solver.row_layout_ms_per_date (ms/date): the device time of each
date's ``linalg.pack_rows`` / ``unpack_rows`` copies, timed by a CUDA
event pair around each call (the engine's ``row_layout_ms`` record
field, read after the date's packed diagnostic read; a fused block's
split evenly over its windows), averaged over the window's date
records.  Nothing to read where the program records no such field (the
CPU, or a program without the events)."""


def read(run):
    values = [r["row_layout_ms"] for r in run.get("dates") or ()
              if r.get("row_layout_ms") is not None]
    return sum(values) / len(values) if values else None
