"""Crash-safe request journal + atomic response store (copy of
``kafka_tpu/serve/journal.py``, which imports no JAX; the files are the
JAX package's, so a journal or response written by either package
reads back in the other).

The daemon's durable memory is two filesystem structures under its
serve root:

``requests.jsonl``
    append-only journal: every ADMITTED request is recorded before it
    enters the work queue (rejected requests are answered, not
    journaled — there is nothing to recover).  One JSON object per
    line; a torn final line (crash mid-append) is skipped with an
    event, never a crashed restart.

``responses/<request_id>.json``
    one atomic file per answered request (unique tmp + ``os.replace``,
    the marker-write discipline of the chunk queue) — the client-visible
    result AND the journal's completion marker.

**Replay.**  On restart, every journaled request with no response file
is re-enqueued in submission order.  Serving is deterministic and the
response write is atomic, so replay is idempotent: a request that
crashed after its solve but before its respond simply re-runs from the
warm checkpoint and overwrites nothing (its response did not exist);
a request that crashed mid-response-write left only a tmp file, which
is ignored.  Duplicate journal lines (same id) replay once.

**Compaction.**  A long-lived daemon's journal grows without bound,
so ``rotate_bytes`` caps it (mirroring the events.jsonl rotation):
once the live journal passes the cap, every ANSWERED entry — its
response file is the completion marker, and the serve that produced it
already checkpointed — is moved into a rotated segment
(``requests.jsonl.1`` newest, shifted up to ``keep`` segments) and the
live journal is atomically rewritten with only the pending entries.
Replay scans the rotated segments too (oldest first), so an entry is
recoverable wherever the rotation boundary fell.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
from typing import Dict, List, Optional

from ..telemetry import get_registry

LOG = logging.getLogger(__name__)

JOURNAL_NAME = "requests.jsonl"
RESPONSES_DIR = "responses"

#: per-process unique response tmp names (pid + counter), same twin as
#: the scheduler/checkpoint atomic writers.
_TMP_COUNTER = itertools.count()


class RequestJournal:
    """One serve root's journal + response store.

    ``rotate_bytes=None`` (the default) disables compaction; ``keep``
    bounds the rotated answered-entry segments kept on disk.
    """

    def __init__(self, root: str, rotate_bytes: Optional[int] = None,
                 keep: int = 3):
        self.root = root
        self.journal_path = os.path.join(root, JOURNAL_NAME)
        self.responses_dir = os.path.join(root, RESPONSES_DIR)
        os.makedirs(self.responses_dir, exist_ok=True)
        self._rotate_bytes = rotate_bytes
        self._keep = int(keep)
        self._fh = open(self.journal_path, "a", buffering=1)
        try:
            self._bytes = os.path.getsize(self.journal_path)
        except OSError:
            self._bytes = 0

    # -- journal --------------------------------------------------------

    def record(self, payload: dict) -> None:
        """Append one admitted request; flushed + fsynced so an admitted
        request survives a crash that follows immediately."""
        line = json.dumps(payload, default=str) + "\n"
        self._fh.write(line)
        self._fh.flush()
        os.fsync(self._fh.fileno())
        self._bytes += len(line)
        if self._rotate_bytes is not None and \
                self._bytes >= self._rotate_bytes:
            self._compact()

    def _segment_paths(self) -> List[str]:
        """Existing rotated segments, OLDEST first (.N is oldest —
        the shift direction of the events.jsonl rotation)."""
        out = []
        i = 1
        while os.path.exists(f"{self.journal_path}.{i}"):
            out.append(f"{self.journal_path}.{i}")
            i += 1
        return list(reversed(out))

    def _compact(self) -> None:
        """Rotate answered entries out of the live journal (see module
        docstring).  A compaction pass that finds nothing answered is a
        no-op — the journal cannot shrink below its pending set."""
        answered: List[str] = []
        pending: List[str] = []
        try:
            with open(self.journal_path) as f:
                lines = f.readlines()
        except OSError:
            return
        for line in lines:
            stripped = line.strip()
            if not stripped:
                continue
            try:
                payload = json.loads(stripped)
                rid = payload.get("request_id")
            except ValueError:
                rid = None
            if isinstance(rid, str) and \
                    os.path.exists(self.response_path(rid)):
                answered.append(stripped)
            else:
                # Pending work and forensic residue (torn/id-less
                # lines) stay in the live journal — compaction must
                # never make an unanswered request unreplayable.
                pending.append(stripped)
        if not answered:
            return
        # Shift the keep-window (newest rotated segment is .1), write
        # the freshly-answered batch as the new .1, then atomically
        # rewrite the live journal with only the pending lines.
        for i in range(self._keep - 1, 0, -1):
            src = f"{self.journal_path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self.journal_path}.{i + 1}")
        drop = f"{self.journal_path}.{self._keep + 1}"
        if os.path.exists(drop):
            os.unlink(drop)
        if self._keep > 0:
            seg_tmp = f"{self.journal_path}.1.tmp.{os.getpid()}"
            with open(seg_tmp, "w") as f:
                f.write("".join(s + "\n" for s in answered))
                f.flush()
                os.fsync(f.fileno())
            os.replace(seg_tmp, f"{self.journal_path}.1")
        live_tmp = f"{self.journal_path}.tmp.{os.getpid()}." \
                   f"{next(_TMP_COUNTER)}"
        with open(live_tmp, "w") as f:
            f.write("".join(s + "\n" for s in pending))
            f.flush()
            os.fsync(f.fileno())
        self._fh.close()
        os.replace(live_tmp, self.journal_path)
        self._fh = open(self.journal_path, "a", buffering=1)
        try:
            self._bytes = os.path.getsize(self.journal_path)
        except OSError:
            self._bytes = 0
        reg = get_registry()
        reg.counter(
            "kafka_serve_journal_compactions_total",
            "requests.jsonl compaction passes (answered entries "
            "rotated into size-capped segments)",
        ).inc()
        reg.emit(
            "journal_compacted", rotated=len(answered),
            retained=len(pending), path=self.journal_path,
        )

    def _iter_journal_lines(self):
        """(path, lineno, raw_line) over rotated segments oldest-first,
        then the live journal — submission order across rotations."""
        for path in self._segment_paths() + [self.journal_path]:
            if not os.path.exists(path):
                continue
            try:
                with open(path) as f:
                    for lineno, line in enumerate(f, start=1):
                        yield path, lineno, line
            except OSError:
                continue

    def replay(self) -> List[dict]:
        """Journaled request payloads with no response, oldest first —
        rotated segments included, so replay is correct wherever the
        compaction boundary fell."""
        seen: Dict[str, dict] = {}
        for path, lineno, line in self._iter_journal_lines():
            line = line.strip()
            if not line:
                continue
            try:
                payload = json.loads(line)
            except ValueError:
                # A torn tail is the signature of a crash mid-append;
                # the work it described was never acked as queued.
                get_registry().emit(
                    "journal_torn_line", line_no=lineno, path=path,
                )
                LOG.warning(
                    "skipping torn journal line %d in %s", lineno, path,
                )
                continue
            rid = payload.get("request_id")
            if isinstance(rid, str) and rid not in seen:
                seen[rid] = payload
        return [p for rid, p in seen.items()
                if not os.path.exists(self.response_path(rid))]

    # -- responses ------------------------------------------------------

    def response_path(self, request_id: str) -> str:
        return os.path.join(self.responses_dir, f"{request_id}.json")

    def respond(self, request_id: str, payload: dict) -> str:
        """Atomically publish one response (unique tmp + os.replace —
        a reader can never observe a torn response)."""
        path = self.response_path(request_id)
        tmp = f"{path}.tmp.{os.getpid()}.{next(_TMP_COUNTER)}"
        with open(tmp, "w") as f:
            json.dump(payload, f, default=str)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return path

    def response(self, request_id: str) -> Optional[dict]:
        try:
            with open(self.response_path(request_id)) as f:
                return json.load(f)
        except FileNotFoundError:
            return None
        except (OSError, ValueError):
            # Unreadable response = no response; replay will re-serve.
            return None

    def close(self) -> None:
        try:
            self._fh.close()
        except OSError:  # already closed / torn down — nothing held
            pass
