"""Core numerics of the port: types, packed linear algebra, solve health,
propagators, the fused Gauss-Newton kernel and the solvers.

Re-exports the names of ``kafka_tpu.core``.  Of the JAX package's 35,
one is not here: ``assimilate_date_jit``, whose counterpart is
``assimilate_date`` (PyTorch runs eagerly; nothing is compiled per
shape).
"""

from .hessian import hessian_correction

from .linalg import (
    batched_diag,
    batched_diagonal,
    solve_batched,
    solve_spd_batched,
    spd_inverse_batched,
)
from .propagators import (
    PixelPrior,
    advance,
    blend_gaussians,
    blend_prior,
    broadcast_prior,
    make_no_propagation,
    make_prior_reset_propagator,
    no_propagation,
    propagate_information_filter,
    propagate_information_filter_approx,
    propagate_information_filter_lai,
    propagate_standard_kalman,
    tip_prior,
)
from .solvers import (
    CONVERGENCE_TOL,
    MAX_ITERATIONS,
    MIN_ITERATIONS,
    assimilate_date,
    build_normal_equations,
    iterated_solve,
    kalman_update,
    linear_solve,
)
from .time_grid import iterate_time_grid
from .types import (
    BandBatch,
    GaussianState,
    Linearization,
    SolveDiagnostics,
    block_diag_to_batched,
    flat_to_pixel_major,
    pixel_major_to_flat,
)

__all__ = [
    "BandBatch", "CONVERGENCE_TOL", "GaussianState", "Linearization",
    "MAX_ITERATIONS", "MIN_ITERATIONS", "PixelPrior", "SolveDiagnostics",
    "advance", "assimilate_date", "batched_diag", "batched_diagonal",
    "blend_gaussians", "blend_prior", "block_diag_to_batched",
    "broadcast_prior", "build_normal_equations", "flat_to_pixel_major",
    "hessian_correction", "iterate_time_grid", "iterated_solve",
    "kalman_update", "linear_solve", "make_no_propagation",
    "make_prior_reset_propagator", "no_propagation",
    "pixel_major_to_flat", "propagate_information_filter",
    "propagate_information_filter_approx", "propagate_information_filter_lai",
    "propagate_standard_kalman", "solve_batched", "solve_spd_batched",
    "spd_inverse_batched", "tip_prior",
]
