"""Reanalysis: fixed-interval RTS smoothing over the checkpoint chain
(port of ``kafka_tpu/smoother``).

The forward filter conditions every date on the PAST only.  This
package runs the Rauch–Tung–Striebel backward recursion over the
per-timestep analysis states the :class:`~kafka_tpu_torch.engine.Checkpointer`
already persists, and turns the same run into a reanalysis product:
``kafka_smooth`` (offline driver) and the ``smoothed=true`` serve
request kind both answer from it.  The smoother only reads the chain;
it never writes a checkpoint.
"""

from .rts_pass import (
    QA_CLAMPED,
    QA_REDERIVED,
    QA_SMOOTHED,
    QA_TERMINAL,
    ChainNode,
    SmootherError,
    SmootherResult,
    load_chain,
    smooth_chain,
    smooth_checkpoints,
    state_sha256,
)

__all__ = [
    "QA_CLAMPED",
    "QA_REDERIVED",
    "QA_SMOOTHED",
    "QA_TERMINAL",
    "ChainNode",
    "SmootherError",
    "SmootherResult",
    "load_chain",
    "smooth_chain",
    "smooth_checkpoints",
    "state_sha256",
]
