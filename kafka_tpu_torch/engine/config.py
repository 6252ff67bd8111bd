"""Run configuration (port of ``kafka_tpu/engine/config.py``).

A ``RunConfig`` names the five injection points of a run (observations,
output, observation operator, state propagation, prior) and its grid,
chunking and solver knobs; registries resolve the names to the port's
constructors, so the drivers stay thin.  The JSON schema of ``to_json``
/ ``from_json`` is the JAX one, field for field: a config saved by
either package loads in the other.

Differences from the JAX module:

- no ``device`` field (it would break the shared schema): the device
  reaches a run through ``make_observations``/``make_prior``/
  ``make_initial_prior`` and the drivers' ``run_config(..., device=)``;
- no bench-artifact gate (``pallas_default_ready``): the port's kernel
  rule decides the solve route.  An unset ``use_pallas`` means the fused
  path where the packed small-state path applies (the CUDA kernels on
  the card, their plain versions on the CPU) and the dense library path
  above it (the 21-parameter ``kernels`` state); ``{"use_pallas":
  False}`` means the plain loop.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..core import propagators as prop

PROPAGATORS: Dict[str, Optional[Callable]] = {
    # The five reference propagation schemes, plus prior-only advance.
    "none": None,
    "standard_kalman": prop.propagate_standard_kalman,
    "information_filter": prop.propagate_information_filter,
    "information_filter_approx": prop.propagate_information_filter_approx,
    "information_filter_lai": prop.propagate_information_filter_lai,
    "no_propagation": prop.no_propagation,
}


def _operator_registry() -> Dict[str, Callable]:
    from ..obsops import IdentityOperator, TwoStreamOperator, WCMOperator

    return {
        "identity": lambda cfg: IdentityOperator(
            n_params=cfg.n_params,
            obs_indices=tuple(range(cfg.n_params)),
        ),
        "twostream": lambda cfg: TwoStreamOperator(),
        "wcm": lambda cfg: WCMOperator(),
        "prosail": lambda cfg: _make_prosail(cfg),
        "kernels": lambda cfg: _make_kernels(cfg),
        "prosail_joint": lambda cfg: _joint_op("ProsailJointOperator"),
        "wcm_joint": lambda cfg: _joint_op("WCMJointOperator"),
        # Converted gp_emulator banks as the S2 operator: per-date
        # geometry selects a bank through the aux builder,
        # extra["emulator_folder"] points at the pickles/.npz files.
        "gp_bank": lambda cfg: _make_gp_bank(cfg),
    }


def _make_gp_bank(cfg):
    from ..obsops.gp import GPBankOperator

    return GPBankOperator(
        n_params=cfg.n_params,
        n_bands=int(cfg.extra.get("gp_n_bands", 10)),
    )


def _joint_op(name):
    from ..obsops import joint

    return getattr(joint, name)()


def _kernel_bands(cfg, what: str) -> int:
    """MODIS band count of a kernel-weight config: 3 weights per band."""
    n_bands, rem = divmod(cfg.n_params, 3)
    if rem:
        raise ValueError(
            f"the kernels {what} needs 3 weights per band; "
            f"parameter_list has {cfg.n_params} entries"
        )
    return n_bands


def _make_kernels(cfg):
    from ..obsops.kernels import KernelsOperator

    return KernelsOperator(n_modis_bands=_kernel_bands(cfg, "operator"))


def _make_prosail(cfg):
    from ..obsops.prosail import ProsailOperator

    return ProsailOperator()


def _named_prior(name: Optional[str], cfg: Optional["RunConfig"] = None,
                 device=None):
    """The named prior on ``device`` (None means CUDA), or None."""
    from .priors import (jrc_prior, joint_prior, kernels_prior, sail_prior,
                         wcm_prior)

    if name is None:
        return None
    if name == "kernels":
        # The band count follows the state size, as for the operator.
        n_bands = 7 if cfg is None else _kernel_bands(cfg, "prior")
        return kernels_prior(n_modis_bands=n_bands, device=device)
    return {
        "tip": jrc_prior,
        "jrc": jrc_prior,
        "sail": sail_prior,
        "joint": joint_prior,
        "wcm": wcm_prior,
    }[name](device)


@dataclasses.dataclass
class RunConfig:
    """One assimilation run, declaratively.  The fields, their defaults
    and their meaning are those of the JAX ``RunConfig``, and the port
    reads them the same way."""

    parameter_list: Sequence[str]
    start: datetime.datetime
    end: datetime.datetime
    step_days: int = 1
    operator: str = "identity"
    propagator: str = "none"
    prior: Optional[str] = None
    #: prior used only for the initial state when ``prior`` is None
    initial_prior: Optional[str] = None
    q_diag: Optional[Sequence[float]] = None
    chunk_size: Tuple[int, int] = (128, 128)
    output_folder: str = "."
    data_folder: Optional[str] = None
    state_mask: Optional[str] = None
    observations: str = "synthetic"
    pad_multiple: int = 256
    #: each chunk's pixel mesh (``cli.drivers.make_run_mesh``): "local"
    #: spans every local device of the run's type, "auto" does so from
    #: two of them (one H100 gives none), "none" never
    device_mesh: str = "auto"
    hessian_correction: bool = False
    #: observation prefetch depth; 0 = synchronous reads
    prefetch_depth: int = 2
    #: concurrent prefetch reader threads (ordered delivery)
    prefetch_workers: int = 1
    #: device->host wire format of output rasters: "float32" (bit-exact)
    #: or "float16" (``io.output.GeoTIFFOutput``)
    wire_dtype: str = "float32"
    #: temporal fusion: consecutive one-acquisition windows run as one
    #: fused block of up to this many; 1 disables
    scan_window: int = 8
    band_sequential: bool = False
    #: solver knobs (``core.solvers``), resolved through
    #: :meth:`resolved_solver_options`
    solver_options: Optional[dict] = None
    #: folder for per-timestep state checkpoints (prefixed per chunk): a
    #: restarted run resumes each unfinished chunk from its latest
    #: complete checkpoint.  ``extra["checkpoint_shards"]`` splits each
    #: checkpoint's pixel axis across that many files.
    checkpoint_folder: Optional[str] = None
    #: save a checkpoint at most every N grid windows (the last always)
    checkpoint_every_n: int = 1
    #: telemetry export directory (``events.jsonl`` streamed,
    #: ``metrics.prom`` / ``metrics.json`` / ``trace.json`` at run end)
    telemetry_dir: Optional[str] = None
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def n_params(self) -> int:
        return len(self.parameter_list)

    def time_grid(self) -> List[datetime.datetime]:
        """The assimilation time grid, ``start`` to ``end`` inclusive in
        steps of ``step_days``."""
        out = []
        t = self.start
        while t <= self.end:
            out.append(t)
            t = t + datetime.timedelta(days=self.step_days)
        return out

    def make_operator(self):
        return _operator_registry()[self.operator](self)

    def make_propagator(self):
        return PROPAGATORS[self.propagator]

    def make_prior(self, device=None):
        return _named_prior(self.prior, self, device)

    def make_initial_prior(self, device=None):
        """The prior providing x0/P0^-1: ``initial_prior`` if set, else
        ``prior``."""
        return _named_prior(self.initial_prior or self.prior, self, device)

    def resolved_solver_options(self) -> Optional[dict]:
        """``solver_options`` as the engine takes them, or None when
        empty.  Nothing is read from disk: an unset ``use_pallas`` already
        means the fused path in the port's solver, and an explicit
        ``{"use_pallas": False}`` keeps the plain loop."""
        return dict(self.solver_options or {}) or None

    def make_observations(self, operator, state_geo=None, aux_builder=None,
                          device=None):
        """Build the observation source named by ``observations``, making
        its tensors on ``device`` (None means CUDA).

        ``state_geo`` — ``(geotransform, crs)`` of the (chunk) state grid;
        required by grid-warping readers (sentinel2, sentinel1, joint).
        ``aux_builder`` is a runtime callable (not serialisable, so not a
        config field); serialisable reader knobs live in ``extra``.
        """
        rel = self.extra.get("relative_uncertainty", 0.05)
        if self.observations == "sentinel2":
            from ..io.sentinel2 import Sentinel2Observations

            return Sentinel2Observations(
                self.data_folder, operator, state_geo,
                aux_builder=aux_builder, relative_uncertainty=rel,
                device=device,
            )
        if self.observations == "bhr":
            from ..io.modis import BHRObservations

            return BHRObservations(
                self.data_folder, operator,
                start_time=self.start, end_time=self.end,
                period=self.extra.get("period", 16), device=device,
            )
        if self.observations == "mod09":
            from ..io.mod09 import MOD09Observations

            return MOD09Observations(
                self.data_folder, operator,
                start_time=self.start, end_time=self.end, device=device,
            )
        if self.observations == "synergy":
            from ..io.modis import SynergyKernels

            return SynergyKernels(
                self.data_folder, operator,
                start_time=self.start, end_time=self.end, device=device,
            )
        if self.observations == "sentinel1":
            from ..io.sentinel1 import S1Observations

            return S1Observations(
                self.data_folder, state_geo, operator=operator,
                relative_uncertainty=rel,
                # ENL speckle statistics: a number, "auto" (per-scene
                # estimate), or None (file attribute / 5% placeholder).
                enl=self.extra.get("s1_enl"),
                noise_floor=self.extra.get("s1_noise_floor", 0.0),
                device=device,
            )
        if self.observations == "joint":
            # S2 optical + S1 SAR on the 11-parameter joint state:
            # data_folder is the S2 granule tree, extra["s1_folder"] the
            # S1 NetCDF folder.  ``operator`` (normally "prosail_joint")
            # serves the S2 dates, the WCM joint operator the S1 dates.
            from ..io.multi import CompositeObservations
            from ..io.sentinel1 import S1Observations
            from ..io.sentinel2 import Sentinel2Observations
            from ..obsops.joint import WCMJointOperator

            s2 = Sentinel2Observations(
                self.data_folder, operator, state_geo,
                aux_builder=aux_builder, relative_uncertainty=rel,
                device=device,
            )
            # ONE WCM instance per config, shared by every chunk, as the
            # S2 operator is.
            if not hasattr(self, "_wcm_joint_op"):
                self._wcm_joint_op = WCMJointOperator()
            s1 = S1Observations(
                self.extra["s1_folder"], state_geo,
                operator=self._wcm_joint_op,
                relative_uncertainty=self.extra.get(
                    "s1_relative_uncertainty", 0.05),
                enl=self.extra.get("s1_enl"),
                noise_floor=self.extra.get("s1_noise_floor", 0.0),
                device=device,
            )
            return CompositeObservations([s2, s1])
        raise KeyError(
            f"no observation-source factory for {self.observations!r}"
        )

    # -- (de)serialisation ------------------------------------------------

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["start"] = self.start.isoformat()
        d["end"] = self.end.isoformat()
        d["parameter_list"] = list(self.parameter_list)
        d["chunk_size"] = list(self.chunk_size)
        return json.dumps(d, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "RunConfig":
        d = json.loads(text)
        d["start"] = datetime.datetime.fromisoformat(d["start"])
        d["end"] = datetime.datetime.fromisoformat(d["end"])
        d["chunk_size"] = tuple(d.get("chunk_size", (128, 128)))
        return cls(**d)

    @classmethod
    def load(cls, path: str) -> "RunConfig":
        with open(path) as f:
            return cls.from_json(f.read())

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())
