"""The comparison that decides ``correct``: the program's dumped outputs
of the sampled pixels, window by window, against the plain reference.

Numbers over every completed window of every job in the timed window; a
value that is not finite counts as an infinite gap:

- ``x_gap_window_median``: of each window the median absolute state gap
  over its sampled pixels and parameters, the largest over windows;
- ``info_gap_window_median``: the same of the relative gap of the
  information diagonal;
- ``x_gap_p99``: the 99th percentile of the absolute state gap over
  everything sampled;
- ``qa_mismatch_share``: the share of sampled pixel-windows whose QA
  verdict differs from the reference's;
- ``x_gap_share`` (where the workload gives ``share_over``): the share of
  sampled pixel-windows whose largest state gap over the parameters is
  above ``share_over``.

A window's median stands for the window's answers as a whole: a few
pixels whose float32 Gauss-Newton is ill-conditioned (or caught in a
limit cycle at the two-stream's clip kink) do not move it, while a
window whose answers are wrong, stale or half missing does.  A fault that
spoils fewer than half of a window's answers leaves the median alone;
``x_gap_share`` counts them.  A cell's workload file names the numbers it
compares and their limits.
"""

from __future__ import annotations

import numpy as np

NUMBERS = ("x_gap_window_median", "info_gap_window_median", "x_gap_p99",
           "qa_mismatch_share")
#: the thresholds at which the calibration reports ``share_ladder``.
LADDER = (1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3)


def _gap(a, b):
    g = np.abs(np.asarray(a, np.float64) - b)
    return np.where(np.isfinite(g), g, np.inf)


def _median(v):
    return float(np.quantile(v, 0.5, method="higher"))


def pixel_gaps(pairs) -> np.ndarray:
    """Each sampled pixel-window's largest state gap over the parameters."""
    return np.concatenate([_gap(p["x"], r["x"]).max(axis=1)
                           for p, r in pairs])


def share_ladder(pairs, ladder=LADDER) -> dict:
    """``{threshold: share of pixel-windows whose gap is above it}``."""
    g = pixel_gaps(pairs)
    return {f"{t:g}": float((g > t).mean()) for t in ladder}


def numbers(pairs, share_over=None) -> dict:
    """The numbers of ``pairs``: ``(program, reference)`` dicts of one
    window each, ``{"x", "info", "qa"}`` over the sampled pixels (``x``
    and ``info`` (pixels, parameters))."""
    if not pairs:
        out = {k: float("inf") for k in NUMBERS}
        if share_over is not None:
            out["x_gap_share"] = float("inf")
        return out
    x = [_gap(p["x"], r["x"]).ravel() for p, r in pairs]
    info = [(_gap(p["info"], r["info"]) / np.abs(r["info"])).ravel()
            for p, r in pairs]
    qa = [(p["qa"] != r["qa"]).ravel() for p, r in pairs
          if r["qa"] is not None]
    qa = np.concatenate(qa) if qa else np.zeros(1, bool)
    out = {
        "x_gap_window_median": max(_median(v) for v in x),
        "info_gap_window_median": max(_median(v) for v in info),
        "x_gap_p99": float(np.quantile(np.concatenate(x), 0.99,
                                       method="higher")),
        "qa_mismatch_share": float(qa.mean()),
    }
    if share_over is not None:
        out["x_gap_share"] = float((pixel_gaps(pairs)
                                    > float(share_over)).mean())
    return out


def judge(values: dict, limits: dict) -> tuple:
    """``(correct, checks)``: every limited number at or under its limit;
    ``checks`` maps each to ``{"value", "limit"}``."""
    checks = {k: {"value": values[k], "limit": float(v)}
              for k, v in limits.items()}
    ok = bool(checks) and all(c["value"] <= c["limit"]
                              for c in checks.values())
    return ok, checks
