"""Device-program registry: canonical seeded programs for contract
analysis (port of ``kafka_tpu/analysis/registry.py``).

Every entry point whose device behaviour the port's perf story depends
on — the per-date solve, the fused window scan, the smoother sweep,
each operator's linearize, the mesh-sharded step — is registered here
with a *builder* that reconstructs the callable plus concrete seeded
arguments on a given device.  An eager program has to run to be traced:
``kafka_tpu_torch.cli.programlint`` runs each registered program once
under an operator census (:mod:`kafka_tpu_torch.analysis.trace`) and
verifies machine-checkable contracts over it
(:mod:`kafka_tpu_torch.analysis.checkers`): dtype hygiene, a pinned
budget of host reads, no Jacobian relayout copies, and — for mesh
programs — a manifest of permitted collectives.

The registry is declarative and import-light: builders run lazily at
trace time, so importing this module (e.g. for
``programs.COVERED_ENTRY_POINTS``) costs nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple


@dataclasses.dataclass
class BuiltProgram:
    """What a builder returns: the callable and its canonical arguments,
    concrete tensors on the program's device.  ``mesh_devices`` is the
    shard count the builder's mesh spans (0 = no mesh — the program is
    single-device and the collective checker does not apply)."""

    fn: Callable
    args: Tuple[Any, ...]
    mesh_devices: int = 0


@dataclasses.dataclass(frozen=True)
class ProgramSpec:
    """One registered device program.

    ``builder`` — callable ``builder(device, **overrides)`` returning a
    :class:`BuiltProgram` (or a plain ``(fn, args)`` tuple) with its
    tensors on ``device``.  Runs lazily at trace time; ``overrides``
    (e.g. ``n_pix``) resize a program where its builder takes them.

    ``relayout_clean`` — this program promises NO materialising copy of
    a non-contiguous rank-3 (Jacobian-shaped) intermediate; the relayout
    checker enforces it.

    ``collectives`` — the manifest of collective ops
    (``core.collective``: ``all_reduce``, ``all_gather``) the program may
    call; anything else is a finding.  Only meaningful for mesh builders
    (``mesh_devices >= 2``).

    ``x64`` — build and run with float64 as torch's default dtype.
    Production programs never set this; the fixture specs use it so a
    seeded float64 leak is what a leak would be, and it arms the dtype
    checker for any future one.
    """

    name: str
    builder: Callable[..., Any]
    description: str = ""
    relayout_clean: bool = False
    collectives: Tuple[str, ...] = ()
    x64: bool = False

    def build(self, device, **overrides) -> BuiltProgram:
        built = self.builder(device, **overrides)
        if isinstance(built, BuiltProgram):
            return built
        fn, args = built
        return BuiltProgram(fn=fn, args=tuple(args))


#: name -> spec, in registration order (dicts preserve it).
REGISTRY: Dict[str, ProgramSpec] = {}


def register_program(name: str, *, description: str = "",
                     relayout_clean: bool = False,
                     collectives: Sequence[str] = (),
                     x64: bool = False,
                     registry: Optional[Dict[str, ProgramSpec]] = None):
    """Decorator registering a builder as a named program spec.

    ``registry`` defaults to the production :data:`REGISTRY`; fixture
    modules pass their own dict so seeded-violation specs never leak into
    the production analysis set.
    """
    target = REGISTRY if registry is None else registry

    def deco(builder: Callable[..., Any]) -> Callable[..., Any]:
        if name in target:
            raise ValueError(f"duplicate program name {name!r}")
        target[name] = ProgramSpec(
            name=name, builder=builder, description=description,
            relayout_clean=relayout_clean,
            collectives=tuple(collectives), x64=x64,
        )
        return builder

    return deco


def get_specs(names: Optional[Sequence[str]] = None,
              registry: Optional[Dict[str, ProgramSpec]] = None,
              ) -> Tuple[ProgramSpec, ...]:
    """The selected specs (all, in registration order, when ``names`` is
    None).  Unknown names raise ``KeyError`` with the known set."""
    reg = REGISTRY if registry is None else registry
    if names is None:
        return tuple(reg.values())
    unknown = [n for n in names if n not in reg]
    if unknown:
        raise KeyError(
            f"unknown program(s) {unknown}; known: {sorted(reg)}"
        )
    return tuple(reg[n] for n in names)
