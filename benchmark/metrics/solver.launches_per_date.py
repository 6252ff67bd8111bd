"""solver.launches_per_date (launches/date): CUDA kernel launches in the
traced window over the dates the engine assimilated in it."""


def read(run):
    tr = run.get("trace") or {}
    dates = len(run.get("dates") or ())
    if not tr.get("window_s") or not dates:
        return None
    return len(tr["kernels"]) / dates
