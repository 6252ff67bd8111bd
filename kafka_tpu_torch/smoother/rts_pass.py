"""The RTS backward pass over a checkpoint chain (port of
``kafka_tpu/smoother/rts_pass.py``).

Recursion (information form — ``p_analysis_inverse`` is what the chain
stores; covariances only ever exist as batched per-pixel ``p x p``
inverses on the device):

    P_a(t)   = P_a_inv(t)^-1
    G(t)     = P_a(t) M^T P_f_inv(t+1)
    x_s(t)   = x_a(t) + G(t) (x_s(t+1) - x_f(t+1))
    P_s(t)   = P_a(t) + G(t) (P_s(t+1) - P_f(t+1)) G(t)^T

anchored at the newest analysis: ``x_s(T) = x_a(T)``,
``P_s(T) = P_a_inv(T)^-1`` — the final date is the filter's own bytes.

The JAX package runs the sweep as one reverse ``lax.scan`` of
``jnp.linalg.inv`` under ``vmap`` — an XLA library call, no Pallas
kernel.  Here it is a reverse loop over the stacked dates on
``(n, p, p)`` tensors with ``torch.linalg.inv`` (LU, as
``jnp.linalg.inv``; :func:`batched_inverse`).  The recursion is
independent per pixel, so the sweep runs in pixel blocks of
``SWEEP_BLOCK``: a tile's chain (4.6 M px, p = 7, eight dates) would
otherwise hold tens of GB of stacked matrices on the card at once.

The forecast pair ``(x_f(t+1), P_f_inv(t+1))`` comes from the
checkpoint's forecast sidecar when present and is otherwise re-derived
by running the configured propagator forward from the previous analysis
(``_derive_forecast``).

Reported uncertainty stays in the filter's convention
(``sigma = 1/sqrt(diag(P_inv))``); the smoothed information diagonal is
clamped to the filter's from below (``QA_CLAMPED`` where it engaged).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import datetime
import hashlib
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.propagators import propagate_information_filter
from ..engine.checkpoint import _UNREADABLE_ERRORS, Checkpointer
from ..telemetry import get_registry
from ..telemetry.tracing import trace_span

#: smoother QA bitmask (0 outside the state mask, like the forward
#: solver-QA band).
QA_SMOOTHED = 1    #: pixel carries a smoothed value
QA_CLAMPED = 2     #: sigma clamped at the filter floor (f32 roundoff)
QA_REDERIVED = 4   #: forecast re-derived via the propagator (no sidecar)
QA_TERMINAL = 8    #: newest date: smoothed == analysis by construction

#: pixels per block of the backward sweep (the whole recursion of a
#: block runs on the device before the next block is copied in).
SWEEP_BLOCK = 1 << 20


class SmootherError(RuntimeError):
    """The chain cannot support a smoothing pass (empty, no information
    matrices, or sidecar-less with no propagator configuration)."""


@dataclasses.dataclass
class ChainNode:
    """One intact checkpoint set, loaded: the analysis state plus the
    optional forecast sidecar ``(x_forecast, p_forecast_inverse)``."""

    timestep: datetime.datetime
    x_analysis: np.ndarray
    p_analysis_inverse: Optional[np.ndarray]
    sidecar: Optional[Tuple[np.ndarray, np.ndarray]] = None


@dataclasses.dataclass
class SmootherResult:
    """The backward pass, oldest first: smoothed means, smoothed
    marginal information diagonals (filter sigma convention), per-pixel
    QA bitmasks, and the dates whose forecast had to be re-derived."""

    timesteps: List[datetime.datetime]
    x_smoothed: np.ndarray          # (T, n, p)
    p_inv_diag: np.ndarray          # (T, n, p) smoothed marginal info
    p_inv_diag_filter: np.ndarray   # (T, n, p) the FILTER's, for QA
    qa: np.ndarray                  # (T, n) uint8 bitmask
    rederived: List[datetime.datetime]
    skipped: List[datetime.datetime]

    def index_of(self, timestep: datetime.datetime) -> int:
        for i, ts in enumerate(self.timesteps):
            if ts == timestep:
                return i
        raise KeyError(f"{timestep} not in smoothed chain")

    def sigma_shrink(self, t: int) -> List[float]:
        """Per-parameter mean ``sigma_smoothed / sigma_filter`` at step
        ``t`` over pixels carrying information — <= 1 for a correct
        pass (the quality-ledger signal for smoothed records)."""
        f = self.p_inv_diag_filter[t]
        s = self.p_inv_diag[t]
        out = []
        for k in range(f.shape[-1]):
            ok = np.isfinite(f[:, k]) & np.isfinite(s[:, k]) \
                & (f[:, k] > 0) & (s[:, k] > 0)
            if not ok.any():
                out.append(float("nan"))
                continue
            out.append(float(np.mean(
                np.sqrt(f[ok, k] / s[ok, k])
            )))
        return out


def state_sha256(x: np.ndarray) -> str:
    """Digest of a smoothed state plane over ALL stored pixel rows (the
    chain's layout), so the offline driver and the serve path hash the
    same bytes without either knowing the other's pixel mask."""
    return hashlib.sha256(
        np.ascontiguousarray(np.asarray(x, np.float32)).tobytes()
    ).hexdigest()


def _load_or_error(checkpointer: Checkpointer, paths):
    try:
        return checkpointer._load_set(paths, with_sidecar=True), None
    except _UNREADABLE_ERRORS as exc:
        return None, exc


def load_chain(checkpointer: Checkpointer,
               shard: Optional[int] = None) -> Tuple[List[ChainNode],
                                                     List[datetime.datetime]]:
    """Walk the chain newest -> oldest with ``load_latest``'s corruption
    fallback semantics — an unreadable, incomplete or shape-inconsistent
    set is skipped with the same logged event/counter and the walk
    continues — then return the intact nodes OLDEST first plus the
    skipped timesteps (the recursion bridges them via the propagator).

    The sets are read on a thread per core (inflating a tile's set is
    seconds of zlib, which releases the interpreter lock); the walk over
    the results, and so every skip and its event, keeps the JAX
    package's order."""
    sets = list(reversed(checkpointer._scan_sets()))
    reads = [None if paths is None
             else ([paths[shard]] if shard is not None else paths)
             for _, paths, _ in sets]
    workers = max(1, min(len([r for r in reads if r]), os.cpu_count() or 1))
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        loaded = [None if use is None
                  else pool.submit(_load_or_error, checkpointer, use)
                  for use in reads]
        loaded = [None if f is None else f.result() for f in loaded]
    nodes: List[ChainNode] = []
    skipped: List[datetime.datetime] = []
    for (ts, paths, strays), use, got in zip(sets, reads, loaded):
        if paths is None:
            checkpointer._note_unreadable(
                ts, strays,
                "incomplete shard set (missing shard files)",
            )
            skipped.append(ts)
            continue
        result, exc = got
        if exc is not None:
            checkpointer._note_unreadable(ts, use, repr(exc)[:300])
            skipped.append(ts)
            continue
        x, p_inv, sidecar = result
        nodes.append(ChainNode(ts, x, p_inv, sidecar))
    nodes.reverse()
    skipped.reverse()
    return nodes, skipped


def batched_inverse(a: torch.Tensor) -> torch.Tensor:
    """Per-pixel inverses of an ``(..., p, p)`` batch: ``torch.linalg.inv``
    (LU with partial pivoting), the counterpart of ``jnp.linalg.inv``."""
    return torch.linalg.inv(a)


def _pixel_step(x_a, p_a_inv, x_f, p_f_inv, x_s_next, p_s_next, m_matrix):
    """One date's backward update over a pixel batch."""
    p_a = batched_inverse(p_a_inv)
    gain = p_a @ m_matrix.T @ p_f_inv
    x_s = x_a + (gain @ (x_s_next - x_f)[..., None])[..., 0]
    p_f = batched_inverse(p_f_inv)
    p_s = p_a + gain @ (p_s_next - p_f) @ gain.transpose(-1, -2)
    # Symmetrise against accumulated roundoff: the recursion preserves
    # symmetry exactly, float32 does not.
    return x_s, 0.5 * (p_s + p_s.transpose(-1, -2))


def rts_sweep(x_a, p_a_inv, x_f_next, p_f_inv_next, m_matrix, x_anchor,
              p_anchor_inv):
    """The whole backward pass over one pixel batch (the JAX
    ``_rts_sweep``): a reverse loop over the stacked steps ``t = 0..T-2``
    (oldest first, ``(T-1, n, ...)``), carry anchored at the newest
    analysis.  Returns the smoothed means, the smoothed marginal
    INFORMATION diagonals clamped at the filter's, and the per-pixel
    clamp flags.  Runs in the dtype and on the device of its inputs."""
    x_s_next = x_anchor
    p_s_next = batched_inverse(p_anchor_inv)
    xs = [None] * x_a.shape[0]
    ps = [None] * x_a.shape[0]
    for t in range(x_a.shape[0] - 1, -1, -1):
        x_s_next, p_s_next = _pixel_step(
            x_a[t], p_a_inv[t], x_f_next[t], p_f_inv_next[t], x_s_next,
            p_s_next, m_matrix,
        )
        xs[t], ps[t] = x_s_next, p_s_next
    xs = torch.stack(xs)
    # Marginal sigma in the filter's convention needs diag(P_s^-1): one
    # more batched inverse over the stacked smoothed covariances.
    diag_s = torch.diagonal(batched_inverse(torch.stack(ps)),
                            dim1=-2, dim2=-1)
    diag_a = torch.diagonal(p_a_inv, dim1=-2, dim2=-1)
    # Smoothing adds information; the clamp restores the invariant under
    # float32 roundoff (QA records where it engaged).
    clamped = torch.any(diag_s < diag_a, dim=-1)
    return xs, torch.maximum(diag_s, diag_a), clamped


def _derive_forecast(node: ChainNode, m_matrix, q_diag, state_propagator,
                     device):
    """Propagator fallback: the forecast at ``t+1`` re-derived from the
    analysis at ``t`` — what the forward run computed, when it used the
    same propagator and no date-varying prior."""
    f32 = torch.float32
    x_f, p_f, p_f_inv = state_propagator(
        torch.as_tensor(node.x_analysis, dtype=f32, device=device), None,
        torch.as_tensor(node.p_analysis_inverse, dtype=f32, device=device),
        m_matrix, q_diag,
    )
    if p_f_inv is None:
        p_f_inv = batched_inverse(p_f)
    return x_f.cpu().numpy(), p_f_inv.cpu().numpy()


def smooth_chain(nodes: Sequence[ChainNode],
                 m_matrix: Optional[np.ndarray] = None,
                 q_diag: Optional[np.ndarray] = None,
                 state_propagator=propagate_information_filter,
                 skipped: Sequence[datetime.datetime] = (),
                 device=None) -> SmootherResult:
    """Run the fixed-interval RTS recursion over loaded chain nodes
    (oldest first).  ``m_matrix`` defaults to identity (the reference's
    trajectory model); ``q_diag``/``state_propagator`` configure the
    fallback used wherever a node carries no forecast sidecar.  The
    sweep runs on ``device`` (default CUDA; raises without one); the
    result is host arrays."""
    from .. import resolve_device

    dev = resolve_device(device)
    f32 = torch.float32
    nodes = list(nodes)
    if not nodes:
        raise SmootherError("checkpoint chain is empty")
    for node in nodes:
        if node.p_analysis_inverse is None:
            raise SmootherError(
                f"checkpoint {node.timestep} carries no information "
                "matrix; the smoother gain needs the analysis in "
                "information form"
            )
    p = nodes[0].x_analysis.shape[-1]
    widths = {n.x_analysis.shape for n in nodes}
    if len(widths) > 1:
        raise SmootherError(
            f"chain nodes disagree on the state shape: {sorted(widths)}"
        )
    m = (torch.eye(p, dtype=f32, device=dev) if m_matrix is None
         else torch.as_tensor(np.asarray(m_matrix, np.float32), device=dev))
    reg = get_registry()
    rederived: List[datetime.datetime] = []
    timesteps = [n.timestep for n in nodes]

    if len(nodes) == 1:
        only = nodes[0]
        diag = np.ascontiguousarray(np.diagonal(
            only.p_analysis_inverse, axis1=-2, axis2=-1), np.float32)
        qa = np.full((1, only.x_analysis.shape[0]),
                     QA_SMOOTHED | QA_TERMINAL, np.uint8)
        return SmootherResult(
            timesteps, only.x_analysis[None].astype(np.float32),
            diag[None], diag[None].copy(), qa, rederived, list(skipped),
        )

    # Forecast at t+1 for every pair (t, t+1): sidecar when present,
    # propagator fallback otherwise.  A sidecar is NOT usable across a
    # bridged gap (a skipped corrupt set between the pair): it was
    # propagated from the skipped analysis, not from ``prev``.
    x_f_next, p_f_inv_next = [], []
    for prev, node in zip(nodes[:-1], nodes[1:]):
        gap = any(prev.timestep < ts < node.timestep for ts in skipped)
        if node.sidecar is not None and not gap:
            x_f, p_f_inv = node.sidecar
        else:
            if q_diag is None or state_propagator is None:
                raise SmootherError(
                    f"checkpoint {node.timestep} has no forecast "
                    "sidecar; pass q_diag (and the forward run's "
                    "propagator) so the smoother can re-derive it"
                )
            with trace_span("smooth_rederive",
                            timestep=str(node.timestep)):
                x_f, p_f_inv = _derive_forecast(
                    prev, m,
                    torch.as_tensor(np.asarray(q_diag, np.float32),
                                    device=dev),
                    state_propagator, dev,
                )
            rederived.append(node.timestep)
        x_f_next.append(np.asarray(x_f, np.float32))
        p_f_inv_next.append(np.asarray(p_f_inv, np.float32))

    last = nodes[-1]
    n_pix = last.x_analysis.shape[0]
    t_total = len(nodes)
    x_out = np.empty((t_total, n_pix, p), np.float32)
    d_out = np.empty((t_total, n_pix, p), np.float32)
    qa = np.full((t_total, n_pix), QA_SMOOTHED, np.uint8)
    with trace_span("smooth_sweep", windows=len(nodes)):
        for lo in range(0, n_pix, SWEEP_BLOCK):
            hi = min(n_pix, lo + SWEEP_BLOCK)

            def stacked(arrays):
                return torch.stack([
                    torch.as_tensor(np.asarray(a[lo:hi], np.float32))
                    for a in arrays]).to(dev)

            xs, diag_s, clamped = rts_sweep(
                stacked([n.x_analysis for n in nodes[:-1]]),
                stacked([n.p_analysis_inverse for n in nodes[:-1]]),
                stacked(x_f_next), stacked(p_f_inv_next), m,
                torch.as_tensor(np.asarray(last.x_analysis[lo:hi],
                                           np.float32)).to(dev),
                torch.as_tensor(np.asarray(
                    last.p_analysis_inverse[lo:hi], np.float32)).to(dev),
            )
            x_out[:-1, lo:hi] = xs.cpu().numpy()
            d_out[:-1, lo:hi] = diag_s.cpu().numpy()
            qa[:-1, lo:hi][clamped.cpu().numpy()] |= QA_CLAMPED
            del xs, diag_s, clamped
    # Newest date: EXACT passthrough of the filter analysis (never
    # routed through inv(inv(.)) — the bit-identity pin).
    x_out[-1] = np.asarray(last.x_analysis, np.float32)
    d_out[-1] = np.ascontiguousarray(np.diagonal(
        last.p_analysis_inverse, axis1=-2, axis2=-1), np.float32)
    qa[-1] |= QA_TERMINAL
    for ts in rederived:
        qa[timesteps.index(ts)] |= QA_REDERIVED
    d_filter = np.stack([
        np.ascontiguousarray(np.diagonal(
            n.p_analysis_inverse, axis1=-2, axis2=-1), np.float32)
        for n in nodes
    ])

    reg.counter(
        "kafka_smoother_windows_total",
        "checkpointed windows smoothed by RTS backward passes",
    ).inc(t_total)
    if rederived:
        reg.counter(
            "kafka_smoother_rederived_total",
            "smoothed windows whose forecast had no sidecar and was "
            "re-derived through the propagator",
        ).inc(len(rederived))
    reg.emit(
        "smooth_pass", windows=t_total,
        rederived=len(rederived), skipped=len(skipped),
        newest=str(last.timestep),
    )
    return SmootherResult(timesteps, x_out, d_out, d_filter, qa,
                          rederived, list(skipped))


def smooth_checkpoints(checkpointer: Checkpointer,
                       m_matrix: Optional[np.ndarray] = None,
                       q_diag: Optional[np.ndarray] = None,
                       state_propagator=propagate_information_filter,
                       shard: Optional[int] = None,
                       device=None) -> SmootherResult:
    """``load_chain`` + ``smooth_chain`` in one call — the entry point
    both ``kafka_smooth`` and the ``smoothed=true`` serve path use, so
    their outputs are the same sweep over the same bytes."""
    nodes, skipped = load_chain(checkpointer, shard=shard)
    return smooth_chain(nodes, m_matrix=m_matrix, q_diag=q_diag,
                        state_propagator=state_propagator,
                        skipped=skipped, device=device)
