"""Core numerics of the port: types, packed linear algebra, solve health,
propagators, the fused Gauss-Newton kernel and the solvers."""
