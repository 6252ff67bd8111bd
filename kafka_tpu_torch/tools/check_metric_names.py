"""Static telemetry-name lint over the port — the shim over
``kafka_tpu_torch.tools.kafkalint``.

The port of ``tools/check_metric_names.py``: the checks run as the
kafkalint rules ``metric-name`` / ``event-name`` / ``event-collision``
(``kafka_tpu_torch/tools/kafkalint/rules_telemetry.py``); this module
keeps the JAX shim's CLI, exit codes (0 clean, 1 violations) and module
API (``check``, ``collect_registrations``, ``collect_names``, the
regexes) over ``kafka_tpu_torch/`` and ``chip_smoke.py``.

Usage:
    python -m kafka_tpu_torch.tools.check_metric_names [repo_root]
"""

from __future__ import annotations

import sys

from .kafkalint.rules_telemetry import (  # noqa: F401
    EMIT_RE,
    EVENT_NAME_RE,
    NAME_RE,
    REGISTRATION_RE,
    SCAN,
    SPAN_RE,
    check,
    check_event_and_phase_names,
    collect_names,
    collect_registrations,
    iter_sources,
    main,
)

if __name__ == "__main__":
    sys.exit(main())
