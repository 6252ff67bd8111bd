"""Tiny sizes of the cells for the CPU tests: the same traffic, cut so a
run on the plain versions takes seconds."""

TINY = {
    "modis_tip.daily_year": {
        "config": {"tile": [32, 40], "n_valid": 1024,
                   "run_config": {"end": "2017-02-02T00:00:00"}},
        "workload": {"obs_step_days": 4},
    },
    "s2_prosail.july_chunks": {
        "config": {"chunk": [16, 16], "n_chunks": 2},
        "workload": {"sample_pixels": 128},
    },
}
CELLS = tuple(TINY)
SEED = 2 ** 31 + 17
