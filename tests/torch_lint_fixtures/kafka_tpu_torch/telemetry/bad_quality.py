"""Fixture: magic-quality-threshold violations — quality
threshold literals defined outside the sanctioned config block of
kafka_tpu_torch/telemetry/quality.py."""

CHI2_CONSISTENT_HI = 2.75  # expect: magic-quality-threshold


def is_drifting(ratio):
    drift_threshold = 4.0  # expect: magic-quality-threshold
    return ratio > drift_threshold


def make_sentinel(sentinel_cls):
    # A locally-tuned CUSUM decision threshold diverges from the fleet's.
    return sentinel_cls(cusum_h=9.0)  # expect: magic-quality-threshold


def suppressed_threshold():
    # kafkalint: disable=magic-quality-threshold — fixture-local pin, never shipped
    ewma_band = 0.75
    return ewma_band
