"""pytest settings of the benchmark's own tests (``python -m pytest
benchmark/tests``): the ``card`` marker of the tests that need a CUDA
card, which skip without one."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")
