"""The benchmark of the PyTorch and CUDA port (``kafka_tpu_torch``).

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything that belongs to one configuration, cell or
per-layer metric is a file of its own, found by its name:
``configs/<config>.json``, ``workloads/<cell>.json`` and
``metrics/<metric>.py``.  The yardstick (traffic generation, the plain
references, the comparison that decides ``correct``, the trace
reduction and the roofline arithmetic) lives here and imports nothing
of the JAX package.
"""
