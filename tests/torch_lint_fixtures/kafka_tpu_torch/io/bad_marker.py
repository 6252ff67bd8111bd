"""Fixture: naive (non-atomic) marker writes — the queue-protocol
violations naive-marker-write must catch.  The .done/.failed/.lease
markers are the multi-host coordination protocol; a plain open(..., "w")
can be read half-written by a racing host."""

import json
import os


def mark_done_naively(outdir, prefix):
    with open(os.path.join(outdir, f".chunk_{prefix}.done"), "w") as f:  # expect: naive-marker-write
        json.dump({"finished": True}, f)


def grab_lease_naively(outdir, prefix, payload):
    open(outdir + f"/.chunk_{prefix}.lease", "w").write(  # expect: naive-marker-write
        json.dumps(payload)
    )


def _write_marker(path, payload):
    # The sanctioned helper itself may touch marker paths directly —
    # not flagged even though the literal names a marker suffix.
    with open(path + ".failed", "w") as f:
        json.dump(payload, f)


def read_is_fine(outdir, prefix):
    # Reads are not writes: no finding.
    with open(os.path.join(outdir, f".chunk_{prefix}.done")) as f:
        return json.load(f)
