"""Fixture: magic-slo-threshold violations — SLO literals
defined outside the sanctioned config block of
kafka_tpu_torch/telemetry/slo.py."""

FAST_BURN = 10.0  # expect: magic-slo-threshold


def over_budget(rate):
    budget = 0.001  # expect: magic-slo-threshold
    return rate > budget


def make_engine(engine_cls):
    # A locally-tuned burn threshold diverges from the fleet's page rule.
    return engine_cls(slow_burn=3.0)  # expect: magic-slo-threshold


def fine_names():
    # Vocabulary matches SEGMENTS, not substrings: these are not SLO
    # names even though 'slo' appears inside them.
    slowest = 4.2
    slopes = 1.5
    return slowest + slopes


def suppressed_threshold():
    # kafkalint: disable=magic-slo-threshold — fixture-local pin, never shipped
    slo_target = 0.95
    return slo_target
