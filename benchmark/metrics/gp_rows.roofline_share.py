"""gp_rows.roofline_share (%): the least time of the traced window's
``gp_rows`` launches over their device time.

One launch per Gauss-Newton trip over a chunk's padded pixels; the
chunks of a cell share one ``n_pad``, read from the engine's date
records.  The bank's sizes are the configuration's (its state's
length, ``emulators``' bands, inputs and training points), counted by
``benchmark/gp_roofline.py``.  Nothing to read without such launches."""

from benchmark.gp_roofline import gp_rows_bound_s

KERNEL = "gp_rows_kernel"


def read(run):
    tr = run.get("trace") or {}
    if not tr.get("window_s"):
        return None
    times = [t for name, t in tr["kernels"] if KERNEL in name]
    pads = {int(r["n_pad"]) for r in run.get("dates") or []}
    em = run["config"].get("emulators")
    if not times or len(pads) != 1 or em is None:
        return None
    p = len(run["config"]["run_config"]["parameter_list"])
    least = len(times) * gp_rows_bound_s(
        pads.pop(), p, int(em["bands"]), int(em["training_points"]),
        int(em["inputs"]))
    return 100.0 * least / sum(times)
