"""Multi-process worker for the distributed tests (port of
``kafka_tpu/testing/multiprocess_worker.py``).

Run as ``python -m kafka_tpu_torch.testing.multiprocess_worker`` in N
coordinated processes.  Exercises the multi-process bring-up end to end:

1. ``torch.distributed`` with the ``gloo`` backend against a localhost
   TCP rendezvous (``shard.mesh.initialize_distributed``);
2. a real cross-process collective: every process splits its part of a
   global pixel axis over a local mesh, and the ``all_reduce`` of the
   per-shard sums must equal the global sum;
3. ``shard.scheduler.run_chunks`` with the process group's true rank,
   writing per-chunk outputs and ``.done`` markers into a shared
   directory.

Each process writes ``result_<rank>.json`` with everything the parent
test asserts on.  Exit code 0 only if every local check passes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)  # host:port
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--shards-per-process", type=int, default=2)
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from kafka_tpu_torch.io.tiling import get_chunks
    from kafka_tpu_torch.shard.mesh import (initialize_distributed,
                                            make_pixel_mesh, process_count,
                                            process_index, split_pixels)
    from kafka_tpu_torch.shard.scheduler import run_chunks

    initialize_distributed(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
    )
    try:
        if process_count() != args.num_processes:
            raise RuntimeError(f"world size {process_count()}")
        me = process_index()
        if me != args.process_id:
            raise RuntimeError(f"rank {me} != {args.process_id}")

        # --- cross-process collective over every shard -----------------
        per = args.shards_per_process
        n_global = args.num_processes * per * 8
        mesh = make_pixel_mesh(["cpu"] * per)
        mine = torch.arange(n_global, dtype=torch.float64).reshape(
            args.num_processes, -1)[me]
        shards = split_pixels(mesh, mine, 0)
        total = torch.stack([s.sum() for s in shards.shards]).sum()
        dist.all_reduce(total, op=dist.ReduceOp.SUM)
        expect = float(n_global * (n_global - 1) / 2)
        if float(total) != expect:
            raise RuntimeError(f"all_reduce {float(total)} != {expect}")

        # --- chunk scheduler with the true rank -------------------------
        chunks = list(get_chunks(64, 64, (32, 32)))  # 4 chunks
        ran = []

        def run_one(chunk, prefix):
            ran.append(prefix)
            with open(os.path.join(args.outdir, f"out_{prefix}.json"),
                      "w") as f:
                json.dump({"chunk": chunk.chunk_no, "process": me}, f)

        stats = run_chunks(chunks, run_one, args.outdir)
        with open(os.path.join(args.outdir, f"result_{me}.json"), "w") as f:
            json.dump({
                "process_index": me,
                "process_count": process_count(),
                "local_shards": mesh.size,
                "collective_sum": float(total),
                "collective_expected": expect,
                "chunks_run": sorted(ran),
                "stats": stats,
            }, f)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
