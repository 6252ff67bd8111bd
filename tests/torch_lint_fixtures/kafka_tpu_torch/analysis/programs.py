"""Fixture registry twin: the AST-readable covered set for
``unregistered-device-program``.

Parsed (never imported) by ``rules_programs.covered_entry_points`` when
kafkalint runs over the fixture tree — the names below are the fixture
defs that count as registered device programs, so only the deliberately
unregistered ones get flagged.
"""

COVERED_ENTRY_POINTS = {
    "leaky_launch",
    "region_launch",
    "compliant_launch",
}
