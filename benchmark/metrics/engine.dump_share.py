"""engine.dump_share (%): the engine's own ``dump`` span
(``kafka_engine_phase_seconds{phase="dump"}``) summed over the traced
window, over the window's wall time."""


def read(run):
    wall = run.get("window_wall_s")
    if not wall or "dump_s" not in run:
        return None
    return 100.0 * run["dump_s"] / wall
