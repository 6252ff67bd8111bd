"""fused_update.roofline_share (%): the least time of the traced window's
``fused_update`` launches of the (10, 10) instance over their device
time.  Each launch covers a date's padded pixels; the chunks of a cell
share one ``n_pad``, read from the engine's date records."""

import re

from benchmark.roofline import bound_s, fused_update_work

P, NB = 10, 10
KERNEL = re.compile(r"fused_update_kernel<\s*%d\s*,\s*%d\s*>" % (P, NB))


def read(run):
    tr = run.get("trace") or {}
    if not tr.get("window_s"):
        return None
    times = [t for name, t in tr["kernels"] if KERNEL.search(name)]
    pads = {int(r["n_pad"]) for r in run.get("dates") or []}
    if not times or len(pads) != 1:
        return None
    least = len(times) * bound_s(*fused_update_work(pads.pop(), P, NB))
    return 100.0 * least / sum(times)
