"""fused_gn.roofline_share (%): the least time of the traced window's
``fused_gn`` launches over their device time.

One launch per assimilated date, over the date's padded pixels in
convergence groups of ``gcd(n_pad, group_block)`` px.  Bytes are counted
once per input and output; operations at two trips per group, the fewest
a date runs (the engine records only the largest group's trips, so this
does not count operations too high; bytes bound the launch until the
mean exceeds ~4.9 trips).  Nothing to read when the launches do not
match the dates one for one."""

import math

from benchmark.roofline import bound_s, fused_gn_work

KERNEL = "fused_gn_kernel"


def read(run):
    tr = run.get("trace") or {}
    if not tr.get("window_s"):
        return None
    times = [t for name, t in tr["kernels"] if KERNEL in name]
    dates = run.get("dates") or []
    if not times or len(times) != len(dates):
        return None
    block = int(run["config"]["solver"]["group_block"])
    least = 0.0
    for rec in dates:
        n = int(rec["n_pad"])
        group = math.gcd(n, block)
        least += bound_s(*fused_gn_work(n, group, 2.0 * (n // group)))
    return 100.0 * least / sum(times)
