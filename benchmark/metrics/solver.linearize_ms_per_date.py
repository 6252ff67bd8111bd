"""solver.linearize_ms_per_date (ms/date): the host wall of each date's
``linearize`` spans, one a Gauss-Newton round's linearisation call (the
engine's ``linearize_ms`` record field; 0 where the kernel linearises
in place; a fused block's split evenly over its windows), averaged over
the window's date records.  Nothing to read where the program records
no such field."""


def read(run):
    values = [r["linearize_ms"] for r in run.get("dates") or ()
              if r.get("linearize_ms") is not None]
    return sum(values) / len(values) if values else None
