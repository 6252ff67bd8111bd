"""Seeded telemetry-vocabulary violations (metric/event/phase rules)."""


def setup(reg, span):
    reg.counter("badName")  # expect: metric-name
    reg.counter("kafka_engine_dup_total")  # expect: metric-name
    reg.counter("kafka_engine_dup_total")
    reg.emit("chunkDone", n=1)  # expect: event-name, event-collision
    reg.emit("chunk_done", n=1)
    with span("dump"):  # expect: event-collision
        reg.emit("dump", n=1)
    reg.gauge("kafka_engine_fine_depth")
    reg.emit("run_done", n=2)
