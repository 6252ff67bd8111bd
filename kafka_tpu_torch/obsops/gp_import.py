"""Ingest the reference's ``gp_emulator`` pickle artifacts (the port's
own copy of ``kafka_tpu/obsops/gp_import.py``, with numpy and torch in
place of ``jax.numpy``).

The reference ships its PROSAIL emulators as pickled dicts of
``gp_emulator.GaussianProcess`` objects, one file per viewing geometry,
keyed ``b"S2A_MSI_NN"`` per band and selected by filename-encoded angles.
This module converts them into ``GPParams`` without the ``gp_emulator``
package installed.

Format mapping (the public ``gp_emulator`` GaussianProcess contract):

- ``inputs`` (M, D): the inducing/training inputs;
- ``targets`` (M,): raw training targets (no centering);
- ``theta`` (D+2,): log-hyperparameters ``[log w_1..log w_D,
  log sigma_f^2, log sigma_n^2]`` where ``w_d`` are INVERSE SQUARED
  length scales — its kernel is
  ``k(x, x') = e^{theta[D]} exp(-0.5 sum_d e^{theta[d]} (x_d-x'_d)^2)``;
- ``invQt`` (M,): the precomputed ``(K + sigma_n^2 I)^{-1} y`` weight
  vector its ``predict`` matvecs against.

``obsops.gp`` parameterises ``k = e^{log_amp} exp(-0.5 sum
((x-x')/ell)^2)``, so ``log_ell_d = -theta[d]/2``, ``log_amp =
theta[D]``, ``alpha = invQt`` (recomputed from the training set when a
pickle lacks it), ``y_mean = 0``.  Every loader takes the ``device`` its
tensors go to (None means CUDA, as everywhere in the port).
"""

from __future__ import annotations

import glob
import io
import logging
import os
import pickle
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from .gp import GPParams, stack_gp_bank

LOG = logging.getLogger(__name__)

#: emulator band keys use the MSI band numbering of the reference's
#: ``emulator_band_map`` (``Sentinel2_Observations.py:171-182``).
EMULATOR_BAND_MAP = (2, 3, 4, 5, 6, 7, 8, 9, 12, 13)


class _StubUnpickled:
    """Attribute bag standing in for any class the pickle references —
    ``__setstate__``/``__reduce__`` state lands in ``__dict__``."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        elif isinstance(state, tuple):
            for part in state:
                if isinstance(part, dict):
                    self.__dict__.update(part)


class _EmulatorUnpickler(pickle.Unpickler):
    """Unpickler that resolves classes from the (absent) ``gp_emulator``
    package — and any other missing module — to attribute stubs, while
    letting numpy and the standard library load normally."""

    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            LOG.debug("stubbing unpicklable class %s.%s", module, name)
            return type(name, (_StubUnpickled,), {})


def load_emulator_pickle(path: str) -> Any:
    """Unpickle a gp_emulator artifact without gp_emulator installed
    (latin1 encoding, matching the reference's py2->py3 load,
    ``Sentinel2_Observations.py:158-159``)."""
    with open(path, "rb") as f:
        data = f.read()
    return _EmulatorUnpickler(io.BytesIO(data),
                              encoding="latin1").load()


def _params(x_train, alpha, log_ell, log_amp, device) -> GPParams:
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return GPParams(x_train=t(x_train), alpha=t(alpha),
                    log_lengthscales=t(log_ell), log_amplitude=t(log_amp),
                    y_mean=torch.zeros((), dtype=torch.float32, device=dev))


def gp_params_from_emulator(gp: Any, device=None) -> GPParams:
    """One ``gp_emulator.GaussianProcess`` (or stub) -> ``GPParams`` on
    ``device``."""
    inputs = np.asarray(getattr(gp, "inputs"), np.float32)
    targets = np.asarray(getattr(gp, "targets"), np.float32).ravel()
    theta = np.asarray(getattr(gp, "theta"), np.float64).ravel()
    m, d = inputs.shape
    if theta.size < d + 1:
        raise ValueError(
            f"theta has {theta.size} entries for {d}-dim inputs; "
            "expected D+1 (no noise) or D+2"
        )
    log_ell = (-theta[:d] / 2.0).astype(np.float32)
    log_amp = np.float32(theta[d])
    noise = float(np.exp(theta[d + 1])) if theta.size > d + 1 else 1e-8

    alpha = getattr(gp, "invQt", None)
    if alpha is not None and np.asarray(alpha).size == m:
        alpha = np.asarray(alpha, np.float32).ravel()
    else:
        # Recompute (K + sigma_n^2 I)^-1 y from the training set with the
        # pickle's own hyperparameters (float64: K can be ill-conditioned
        # at small noise).
        w = np.exp(theta[:d])
        z = inputs.astype(np.float64) * np.sqrt(w)
        d2 = (
            (z * z).sum(1)[:, None] + (z * z).sum(1)[None, :]
            - 2.0 * z @ z.T
        )
        k = np.exp(float(theta[d])) * np.exp(-0.5 * np.maximum(d2, 0.0))
        k[np.diag_indices_from(k)] += max(noise, 1e-10)
        alpha = np.linalg.solve(k, targets.astype(np.float64)).astype(
            np.float32
        )
    return _params(inputs, alpha, log_ell, log_amp, device)


def _normalise_band_key(key: Any) -> Optional[int]:
    """``b"S2A_MSI_02"``/"S2B_MSI_8"/plain int -> MSI band number."""
    if isinstance(key, (int, np.integer)):
        return int(key)
    text = key.decode("latin1") if isinstance(key, bytes) else str(key)
    m = re.search(r"(\d+)\s*$", text)
    return int(m.group(1)) if m else None


def _pad_inducing(params: List[GPParams]) -> List[GPParams]:
    """Pad inducing sets to a common size so per-band GPs stack into one
    bank: padding rows get ``alpha = 0``, contributing exactly nothing to
    the predictive matvec."""
    m_max = max(int(p.x_train.shape[0]) for p in params)
    out = []
    for p in params:
        pad = m_max - int(p.x_train.shape[0])
        if pad == 0:
            out.append(p)
            continue
        out.append(p._replace(
            x_train=torch.cat([p.x_train, p.x_train.new_zeros(
                (pad, p.x_train.shape[1]))]),
            alpha=torch.cat([p.alpha, p.alpha.new_zeros((pad,))]),
        ))
    return out


def load_emulator_bank_file(
    path: str,
    band_numbers: Tuple[int, ...] = EMULATOR_BAND_MAP,
    device=None,
) -> GPParams:
    """One per-geometry pickle (dict of per-band GPs) -> stacked
    ``GPParams`` with a leading band axis in ``band_numbers`` order — the
    aux ``GPBankOperator`` consumes."""
    raw = load_emulator_pickle(path)
    if not isinstance(raw, dict):
        # a single-GP pickle: treat as a one-band bank
        return stack_gp_bank([gp_params_from_emulator(raw, device)])
    by_band: Dict[int, Any] = {}
    for key, gp in raw.items():
        num = _normalise_band_key(key)
        if num is not None:
            by_band[num] = gp
    missing = [b for b in band_numbers if b not in by_band]
    if missing:
        raise KeyError(
            f"{path}: no emulator for MSI band(s) {missing}; "
            f"found {sorted(by_band)}"
        )
    params = [gp_params_from_emulator(by_band[b], device)
              for b in band_numbers]
    return stack_gp_bank(_pad_inducing(params))


#: ``..._{vza}_{sza}_{raa}.pkl`` — the reference's filename-encoded
#: geometry grid (``Sentinel2_Observations.py:133-145``).
_GEOM_RE = re.compile(
    r"_(?P<vza>\d+(?:\.\d+)?)_(?P<sza>\d+(?:\.\d+)?)_"
    r"(?P<raa>\d+(?:\.\d+)?)\.[^.]+$"
)


def geometry_from_filename(path: str) -> Tuple[float, float, float]:
    """(sza, vza, raa) parsed from an emulator filename, using the
    reference's field convention: vza third-from-last, sza second-from-
    last, raa last (``Sentinel2_Observations.py:135-140``)."""
    m = _GEOM_RE.search(os.path.basename(path))
    if not m:
        raise ValueError(
            f"{path}: filename does not end in _vza_sza_raa.<ext>"
        )
    return (
        float(m.group("sza")), float(m.group("vza")), float(m.group("raa"))
    )


def save_bank_npz(path: str, params: GPParams) -> None:
    """Persist a stacked per-geometry bank as a plain ``.npz`` — the
    reproducible artifact replacing the reference's opaque pickles
    (loads ~instantly, no unpickling of foreign classes)."""
    np.savez(
        path,
        **{f: torch.as_tensor(getattr(params, f)).detach().cpu().numpy()
           for f in GPParams._fields},
    )


def load_bank_npz(path: str, device=None) -> GPParams:
    """A ``save_bank_npz`` file (of either package) on ``device``."""
    dev = resolve_device(device)
    data = np.load(path)
    return GPParams(
        **{f: torch.as_tensor(data[f], device=dev) for f in GPParams._fields}
    )


def load_emulator_directory(
    folder: str,
    pattern: str = "*.pkl",
    band_numbers: Tuple[int, ...] = EMULATOR_BAND_MAP,
    device=None,
) -> Dict[Tuple[float, float, float], GPParams]:
    """A directory of per-geometry emulator files -> a dict of banks
    keyed ``(sza, vza, raa)`` (the ``banks`` of the JAX package's
    ``io.sentinel2.geometry_bank_aux_builder``, which comes to the port
    with the Sentinel-2 reader): each date's scene angles select the
    nearest bank, like the reference's per-geometry unpickling.

    Accepts the reference's pickles AND this package's converted
    ``.npz`` banks; when both carry the same geometry the ``.npz`` wins
    (it IS the converted pickle, and loads without the per-band
    unpickle/recompute cost)."""
    banks: Dict[Tuple[float, float, float], GPParams] = {}
    pkl_paths = sorted(
        p for p in glob.glob(os.path.join(folder, pattern))
        if not p.endswith(".npz")
    )
    npz_paths = sorted(glob.glob(os.path.join(folder, "*.npz")))
    npz_keys = set()
    for path in npz_paths:
        try:
            key = geometry_from_filename(path)
        except ValueError:
            LOG.warning("skipping %s: no geometry in filename", path)
            continue
        banks[key] = load_bank_npz(path, device)
        npz_keys.add(key)
        LOG.info("loaded emulator bank %s -> geometry %s", path, key)
    for path in pkl_paths:
        try:
            key = geometry_from_filename(path)
        except ValueError:
            LOG.warning("skipping %s: no geometry in filename", path)
            continue
        if key in npz_keys:
            LOG.debug("%s: geometry %s already loaded from .npz", path,
                      key)
            continue
        banks[key] = load_emulator_bank_file(
            path, band_numbers=band_numbers, device=device
        )
        LOG.info("converted emulator bank %s -> geometry %s", path, key)
    if not banks:
        raise IOError(
            f"no emulator files ({pattern} or *.npz) in {folder}"
        )
    return banks
