"""Seeded unregistered-device-program violation.

Parsed by tests/test_torch_lint.py, never imported.  ``rogue_launch``
launches a hand kernel from a device package but its def name is NOT in
the fixture ``COVERED_ENTRY_POINTS`` — a device program no census
covers, which is exactly what the rule exists to flag.
"""

from . import _build


def rogue_launch(x):  # expect: unregistered-device-program
    _build.count_launch(rogue_launch)
    return x * 2.0
