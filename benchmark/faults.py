"""Faults planted under the timed path, for the checks that ``correct``
must fail (the benchmark's own runs never plant one).  Each wraps
``kafka_tpu_torch.core.solvers.iterated_solve``, the date solve that
every route of the engine calls (``assimilate_date`` and the fused
windows' scan): on the card it wraps the ``fused_gn`` kernel and the row
loop with ``fused_update``, on the CPU their plain versions.

- ``unchanged``: the solve returns its forecast, the state unchanged;
- ``half_left_out``: the second half of the pixels keep their forecast,
  the answers of the first half only;
- ``answer_altered``: every answer moved by 0.02 where it is produced.
"""

from __future__ import annotations

import contextlib


def _unchanged(args, out):
    return (args[2].clone(),) + tuple(out[1:])


def _half_left_out(args, out):
    x = out[0].clone()
    half = x.shape[0] // 2
    x[half:] = args[2][half:]
    return (x,) + tuple(out[1:])


def _answer_altered(args, out):
    return (out[0] + 0.02,) + tuple(out[1:])


FAULTS = {"unchanged": _unchanged, "half_left_out": _half_left_out,
          "answer_altered": _answer_altered}


@contextlib.contextmanager
def planted(name: str):
    """Plant fault ``name`` for the enclosed block; yields a one-element
    list that counts the date solves it broke."""
    from kafka_tpu_torch.core import solvers

    fault, real, calls = FAULTS[name], solvers.iterated_solve, [0]

    def broken(*args, **kwargs):
        out = real(*args, **kwargs)
        calls[0] += 1
        return fault(args, out)

    solvers.iterated_solve = broken
    try:
        yield calls
    finally:
        solvers.iterated_solve = real
