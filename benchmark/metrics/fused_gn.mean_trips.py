"""fused_gn.mean_trips (trips/group): the mean Gauss-Newton trips over a
date's ``fused_gn`` convergence groups (the engine's ``mean_trips``
record field, read in the date's one packed diagnostic read), averaged
over the window's date records.  Nothing to read off the ``fused_gn``
route, or where the program records no such field."""


def read(run):
    values = [r["mean_trips"] for r in run.get("dates") or ()
              if r.get("mean_trips") is not None]
    return sum(values) / len(values) if values else None
