"""MODIS BHR distributed driver — the chunked prior-blend configuration
(port of ``kafka_tpu/cli/run_modis_distributed.py``).

The MODIS BHR pipeline of the reference's dask driver
(``kafka_test_Py36.py:147-255``) chunked 256 x 256 over the tile,
prior-only advance (no propagator, the JRC prior, Q[TeLAI] = 0.025),
each chunk an independent restartable unit with prefixed outputs.  Where
the reference fans chunks over a dask cluster, ``shard.run_chunks``
round-robins them over processes: run one process per host (or several
on one card), each executes only its own pending chunks, and ``.done``
markers make restarts cheap.

Usage:
    python -m kafka_tpu_torch.cli.run_modis_distributed \\
        --data-folder /path/mcd43 --state-mask mask.tif \\
        --outdir /tmp/kafka_modis_dist [--num-processes 2 --process-index 0
        --coordinator localhost:29500] [--device cpu]

``--num-processes`` / ``--process-index`` set this process's share of the
round-robin.  With ``--coordinator host:port`` the processes also meet
in a ``torch.distributed`` process group (``gloo`` over TCP; the rank is
``--process-index``): after the run each rank's counts (chunks run,
skipped, failed, pixels, dates) are summed over the ranks by an
``all_reduce`` and printed under ``"all_ranks"``, so every process
reports the whole run; ``peak_device_bytes`` is this process's peak CUDA
allocation.  ``--device`` defaults to CUDA; several ranks may share one
card.
"""

from __future__ import annotations

import argparse
import datetime
import json
import logging
import sys

from ..engine.config import RunConfig
from ..engine.priors import TIP_PARAMETER_LIST
from . import add_device_arg, add_telemetry_arg, make_console
from .drivers import run_config

#: the counts a rank contributes to the run-wide ``all_reduce``.
SUMMED = ("run", "skipped", "failed", "chunks_with_pixels", "pixels",
          "dates_assimilated")


def default_config() -> RunConfig:
    """The reference's distributed-MODIS constants
    (``kafka_test_Py36.py:159-255``)."""
    return RunConfig(
        parameter_list=TIP_PARAMETER_LIST,
        start=datetime.datetime(2017, 1, 1),
        end=datetime.datetime(2017, 12, 31),
        step_days=16,
        operator="twostream",
        propagator="none",
        prior="jrc",                       # prior-only advance, :173-177
        q_diag=[0, 0, 0, 0, 0, 0, 0.025],  # Q[6::7]=0.025, :180-181
        chunk_size=(256, 256),             # kafka_test_Py36.py:241
        observations="bhr",
        extra={"period": 16},
    )


def all_ranks(stats: dict) -> dict:
    """``SUMMED`` of ``stats`` summed over the process group (an
    ``all_reduce`` over ``gloo``)."""
    import torch
    import torch.distributed as dist

    t = torch.tensor([float(stats[k]) for k in SUMMED], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return {k: int(v) for k, v in zip(SUMMED, t.tolist())}


def _peak_device_bytes(device):
    """This process's peak CUDA allocation on ``device`` (None off
    CUDA)."""
    from .. import resolve_device
    from ..telemetry import device as device_tel

    dev = resolve_device(device)
    return device_tel.peak_bytes(dev) if dev.type == "cuda" else None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default=None,
                    help="RunConfig JSON overriding the defaults")
    ap.add_argument("--data-folder", default=None)
    ap.add_argument("--state-mask", default=None)
    ap.add_argument("--outdir", default=None)
    ap.add_argument("--num-processes", type=int, default=None,
                    help="override the process group's size for the "
                         "round-robin")
    ap.add_argument("--process-index", type=int, default=None,
                    help="override the process group's rank")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of a torch.distributed (gloo) "
                         "rendezvous; needs --num-processes and "
                         "--process-index")
    add_device_arg(ap)
    add_telemetry_arg(ap)
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING
    )

    cfg = RunConfig.load(args.config) if args.config else default_config()
    if args.data_folder:
        cfg.data_folder = args.data_folder
    if args.state_mask:
        cfg.state_mask = args.state_mask
    if args.outdir:
        cfg.output_folder = args.outdir
    if args.telemetry_dir:
        cfg.telemetry_dir = args.telemetry_dir

    group = args.coordinator is not None and (args.num_processes or 1) > 1
    if group:
        from ..shard.mesh import initialize_distributed

        initialize_distributed(args.coordinator, args.num_processes,
                               args.process_index)
    try:
        stats = run_config(
            cfg,
            num_processes=args.num_processes,
            process_index=args.process_index,
            device=args.device,
        )
        if group:
            stats["all_ranks"] = all_ranks(stats)
        stats["peak_device_bytes"] = _peak_device_bytes(args.device)
    finally:
        if group:
            import torch.distributed as dist

            dist.destroy_process_group()
    print(json.dumps(stats))
    return stats


console = make_console(main)


if __name__ == "__main__":
    sys.exit(console())
