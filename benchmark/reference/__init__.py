"""Plain references of the benchmark's configurations.

Plain PyTorch and NumPy only: nothing here imports the program under
test (``kafka_tpu_torch``) or the JAX package, and nothing takes a
table, weight or state the program made.
"""
