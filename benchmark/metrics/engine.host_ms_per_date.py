"""engine.host_ms_per_date (ms/date): the host wall of each date's
``date_fetch`` and ``date_record`` spans (the engine's ``date_host_ms``
record field; a fused block's split evenly over its windows), averaged
over the window's date records.  Nothing to read where the program
records no such field."""


def read(run):
    values = [r["date_host_ms"] for r in run.get("dates") or ()
              if r.get("date_host_ms") is not None]
    return sum(values) / len(values) if values else None
