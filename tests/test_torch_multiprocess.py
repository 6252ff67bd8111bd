"""Two real OS processes through the port's multi-process bring-up
(mirroring tests/test_multiprocess.py): they meet at a localhost
``gloo`` rendezvous, check a cross-process ``all_reduce`` of their mesh
shards' sums against the global sum, and split the chunk scheduler's work
by their true ranks (``kafka_tpu_torch.testing.multiprocess_worker``)."""

import json
import os
import pathlib
import socket
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_run(tmp_path):
    port = _free_port()
    outdir = str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    # Children log to files, not pipes: two piped children meeting at a
    # collective can deadlock on a full OS pipe buffer while the parent
    # drains them one after the other.
    log_paths = [os.path.join(outdir, f"worker_{i}.log") for i in range(2)]
    logs = [open(p, "wb") for p in log_paths]
    try:
        procs = [
            subprocess.Popen(
                [sys.executable, "-m",
                 "kafka_tpu_torch.testing.multiprocess_worker",
                 "--coordinator", f"localhost:{port}",
                 "--num-processes", "2", "--process-id", str(i),
                 "--outdir", outdir],
                env=env, stdout=logs[i], stderr=subprocess.STDOUT)
            for i in range(2)
        ]
        try:
            for p in procs:
                p.wait(timeout=120)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
    finally:
        for f in logs:
            f.close()

    def logs_text():
        return "\n".join(
            f"--- worker {i} ---\n" + open(p, errors="replace").read()
            for i, p in enumerate(log_paths))

    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{logs_text()}"
    results = {}
    for i in range(2):
        with open(os.path.join(outdir, f"result_{i}.json")) as f:
            results[i] = json.load(f)
    for i, r in results.items():
        assert r["process_index"] == i and r["process_count"] == 2
        assert r["local_shards"] == 2
        # The cross-process all_reduce saw every shard of both processes.
        assert r["collective_sum"] == r["collective_expected"]
        # Round-robin: each process owned and ran 2 of the 4 chunks.
        assert r["stats"]["assigned"] == 2 and r["stats"]["run"] == 2
    both = results[0]["chunks_run"] + results[1]["chunks_run"]
    assert sorted(both) == ["0001", "0002", "0003", "0004"]
    assert results[0]["chunks_run"] == ["0001", "0003"]
    markers = [f for f in os.listdir(outdir) if f.endswith(".done")]
    assert len(markers) == 4
