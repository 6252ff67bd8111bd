"""kafkalint for the port — AST static analysis of ``kafka_tpu_torch/``
and ``chip_smoke.py`` for device-path hazards and repo conventions.

Run it with::

    python -m kafka_tpu_torch.tools.kafkalint [root] [--json]
        [--rules a,b] [--list-rules]

Exit codes: 0 clean, 1 findings (or a stale baseline entry), 2 usage
error.  The rules are the JAX package's (``tools/kafkalint/``): the
host-side ones as they are, the JAX-idiom ones translated to the torch
constructs that carry the same hazard (``rules_torch.py``,
``torchscan.py``).  Suppress with ``# kafkalint: disable=<rule> —
reason``; grandfather with ``baseline.json`` beside this file.  It reads
source text only and imports neither ``jax`` nor ``torch``.
"""

from .core import (  # noqa: F401
    REGISTRY,
    FileContext,
    Finding,
    LintResult,
    Rule,
    iter_files,
    make_rules,
    register,
    run_lint,
)

__all__ = [
    "REGISTRY", "FileContext", "Finding", "LintResult", "Rule",
    "iter_files", "make_rules", "register", "run_lint",
]
