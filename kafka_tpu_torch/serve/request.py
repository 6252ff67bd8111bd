"""Serve-request vocabulary: the one wire format of the serving layer
(copy of ``kafka_tpu/serve/request.py``, which imports no JAX).

A request is a small JSON object::

    {"request_id": "a1b2", "tile": "tile0", "date": "2017-07-05",
     "deadline_s": 30.0, "smoothed": false}

``request_id`` must be filesystem-safe (it names the response file);
``date`` is the observation date whose analysis the client wants —
ISO ``YYYY-MM-DD`` or a full isoformat timestamp.  ``smoothed=true``
asks for the REANALYSIS estimate instead: the RTS-smoothed state for
that date, answered from the tile's checkpoint chain.  Anything
malformed raises :class:`BadRequest`, which the service converts into a
counted rejection (a bad request must never crash a daemon that other
tenants share).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import re
import time
from typing import Optional

from ..resilience import Deadline

#: response-file-safe request ids (the id becomes ``responses/<id>.json``).
_ID_RE = re.compile(r"^[A-Za-z0-9_.\-]{1,64}$")


class BadRequest(ValueError):
    """A request the daemon must reject, not die on."""

    kafka_failure_class = "poison"


def new_request_id() -> str:
    """The one request-id origin: a request id doubles as the
    per-request trace key, so it is minted exactly once — here, at
    admission — and propagated on the wire."""
    return os.urandom(8).hex()


@dataclasses.dataclass
class ServeRequest:
    """One admitted unit of serving work."""

    request_id: str
    tile: str
    date: datetime.datetime
    deadline_s: Optional[float]
    submitted_ts: float
    #: live wall-clock budget (resilience.Deadline); None for requests
    #: replayed from the journal — replay exists to recover work a crash
    #: interrupted, so its age must not cancel it.
    deadline: Optional[Deadline] = None
    replayed: bool = False
    #: wall-clock admission stamp (set by the admitting process, rides
    #: the journal line and the wire so admission_wait attribution and
    #: trace continuation survive crash replay and forwarding).
    admitted_ts: Optional[float] = None
    #: perf_counter reading at enqueue (process-local, NOT serialised) —
    #: the queue_wait span's start endpoint.
    admitted_perf: Optional[float] = None
    #: reanalysis request kind: answer with the RTS-smoothed state from
    #: the checkpoint chain instead of the live filter analysis.
    smoothed: bool = False
    #: coalesced-serving stamps, set by the worker when this request was
    #: served as a member of an admission micro-batch (process-local;
    #: they ride the response trace and the request_log wide event).
    batch_id: Optional[str] = None
    batch_size: Optional[int] = None

    def payload(self) -> dict:
        """The journal line (and the client-visible echo)."""
        out = {
            "request_id": self.request_id,
            "tile": self.tile,
            "date": self.date.isoformat(),
            "deadline_s": self.deadline_s,
            "submitted_ts": round(self.submitted_ts, 6),
        }
        if self.smoothed:
            out["smoothed"] = True
        if self.admitted_ts is not None:
            out["admitted_ts"] = round(self.admitted_ts, 6)
        return out


def parse_date(text) -> datetime.datetime:
    if isinstance(text, datetime.datetime):
        return text
    if not isinstance(text, str):
        raise BadRequest(f"date must be an ISO string, got {type(text)}")
    try:
        return datetime.datetime.fromisoformat(text)
    except ValueError as exc:
        raise BadRequest(f"unparseable date {text!r}") from exc


def parse_request(payload, default_tile: Optional[str] = None,
                  default_deadline_s: Optional[float] = None,
                  replayed: bool = False) -> ServeRequest:
    """Validate one raw payload into a :class:`ServeRequest`.

    ``replayed=True`` marks a journal-recovered request: the original
    ``submitted_ts`` is kept for the record but no live deadline is
    attached (see :class:`ServeRequest.deadline`).
    """
    if not isinstance(payload, dict):
        raise BadRequest(f"request must be a JSON object, got "
                         f"{type(payload).__name__}")
    request_id = payload.get("request_id") or new_request_id()
    if not isinstance(request_id, str) or not _ID_RE.match(request_id):
        raise BadRequest(f"request_id {request_id!r} is not a short "
                         "filesystem-safe token")
    tile = payload.get("tile", default_tile)
    if not isinstance(tile, str) or not tile:
        raise BadRequest("request names no tile")
    if "date" not in payload:
        raise BadRequest("request names no observation date")
    date = parse_date(payload["date"])
    deadline_s = payload.get("deadline_s", default_deadline_s)
    if deadline_s is not None:
        try:
            deadline_s = float(deadline_s)
        except (TypeError, ValueError) as exc:
            raise BadRequest(
                f"deadline_s {payload.get('deadline_s')!r} is not a "
                "number") from exc
        if deadline_s <= 0:
            raise BadRequest(f"deadline_s must be positive, got "
                             f"{deadline_s}")
    smoothed = payload.get("smoothed", False)
    if not isinstance(smoothed, bool):
        raise BadRequest(
            f"smoothed must be a JSON boolean, got {smoothed!r}"
        )
    submitted = payload.get("submitted_ts")
    if not isinstance(submitted, (int, float)):
        submitted = time.time()
    admitted = payload.get("admitted_ts")
    if not isinstance(admitted, (int, float)):
        admitted = None
    deadline = None
    if deadline_s is not None and not replayed:
        deadline = Deadline(deadline_s)
    return ServeRequest(
        request_id=request_id, tile=tile, date=date,
        deadline_s=deadline_s, submitted_ts=float(submitted),
        deadline=deadline, replayed=replayed,
        admitted_ts=None if admitted is None else float(admitted),
        smoothed=smoothed,
    )
