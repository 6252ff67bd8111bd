"""The least time of the hand kernels' launches on one H100: bytes over
the HBM roof or float32 operations over the peak rate, the larger.

Frozen copy of the port's arithmetic (``kafka_tpu_torch/tools/
roofline.py``: ``fused_gn_work``, ``fused_update_work``, ``bound``),
counted from ``csrc/``: each input read once, each output written once.
"""

from __future__ import annotations

#: NVIDIA's H100 SXM data sheet: HBM3 bandwidth and dense float32 rate
#: outside the tensor cores, at the 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def tri(p: int) -> int:
    return p * (p + 1) // 2


#: fused_gn (two-stream, p = 7, 2 bands), floats per pixel moved once:
#: reads y, r_inv, mask (2 bands each), x_f (7), packed P_f^-1 (28);
#: writes x (7), packed A (28), fwd (2), inn (2), the verdict (1).  Per
#: convergence group its trip count and step norm.
GN_FLOATS_PER_PIXEL = 6 + 7 + 28 + 7 + 28 + 2 + 2 + 1
GN_FLOATS_PER_GROUP = 2
#: float32 operations per pixel per Gauss-Newton trip and once per pixel.
GN_FLOPS_PER_PIXEL_TRIP = 670 + 30 + 168 + 42 + 28 + 147 + 98 + 35 + 46 + 21
GN_FLOPS_PER_PIXEL_ONCE = 91


def fused_gn_work(n_pix: int, group: int, trips: float) -> tuple:
    """(bytes, flops) of one ``fused_gn`` launch over ``n_pix`` px in
    groups of ``group`` px whose trip counts sum to ``trips``."""
    bytes_moved = 4 * (GN_FLOATS_PER_PIXEL * n_pix
                       + GN_FLOATS_PER_GROUP * (n_pix // group))
    flops = GN_FLOPS_PER_PIXEL_TRIP * trips * group \
        + GN_FLOPS_PER_PIXEL_ONCE * n_pix
    return bytes_moved, flops


def chol_solve_flops(p: int) -> int:
    """float32 operations of one packed Cholesky and substitution."""
    chol = sum(2 * j + 2 + (p - 1 - j) * (2 * j + 1) for j in range(p))
    return chol + 2 * p * p


def fused_update_work(n_pix: int, p: int, nb: int) -> tuple:
    """(bytes, flops) of one ``fused_update`` launch at (p, nb): reads J,
    H0, y, w, mask, x_lin, x_f, packed P_f^-1 and the escalation row;
    writes x, packed A, the innovations and the two flags."""
    floats = (nb * p + 4 * nb + 2 * p + tri(p) + 1) + (p + tri(p) + nb + 2)
    per_band = (2 * p - 1) + 3 + p + 2 * tri(p) + 2 * p
    flops = p * (2 * p - 1) + nb * per_band + 5 * p + chol_solve_flops(p)
    return 4.0 * floats * n_pix, flops * n_pix


def bound_s(bytes_moved: float, flops: float) -> float:
    """The least seconds of some work on the card."""
    return max(bytes_moved / HBM_BYTES_PER_S, flops / PEAK_F32_FLOPS)
