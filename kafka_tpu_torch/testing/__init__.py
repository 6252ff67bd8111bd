"""Synthetic problems and sinks for tests and smoke runs of the port."""

from .synthetic import (MemoryOutput, SyntheticObservations, joint_observations,
                        joint_truth, make_prosail_problem, make_tip_problem,
                        plant_solver_faults, run_s2_engine, run_tip_engine,
                        s2_observations)

__all__ = ["MemoryOutput", "SyntheticObservations", "joint_observations",
           "joint_truth", "make_prosail_problem", "make_tip_problem",
           "plant_solver_faults", "run_s2_engine", "run_tip_engine",
           "s2_observations"]
