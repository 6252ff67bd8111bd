"""Assimilation-as-a-service: the crash-safe warm-state serving layer
(port of ``kafka_tpu/serve``).

Request queue -> admission control -> incremental warm-state solve ->
result cache, exposed by the ``kafka_serve`` daemon
(``cli.kafka_serve``); compatible concurrent requests coalesce into one
device round (``serve.batch``).  N daemons sit behind one front door,
the consistent-hash router (``serve.router``: ``HashRing``,
``RoutePolicy``, ``TileRouter``, ``FleetWatch``, ``stable_hash``;
``cli.kafka_route``), which fails over on the replicas' live snapshots
(``ServeDaemon(fleet_dir=...)`` reads the same snapshots for its
dead-host gauge).
"""

from .admission import AdmissionController, AdmissionPolicy
from .daemon import ServeDaemon, read_response, submit_request
from .journal import RequestJournal
from .request import BadRequest, ServeRequest, parse_request
from .router import HashRing, RoutePolicy, TileRouter, stable_hash
from .service import AssimilationService
from .session import TileSession, TileSpec, UnknownDateError
from .synthetic import make_synthetic_tile, synthetic_dates

__all__ = [
    "AdmissionController",
    "AdmissionPolicy",
    "AssimilationService",
    "BadRequest",
    "HashRing",
    "RequestJournal",
    "RoutePolicy",
    "ServeDaemon",
    "ServeRequest",
    "TileRouter",
    "TileSession",
    "TileSpec",
    "UnknownDateError",
    "make_synthetic_tile",
    "parse_request",
    "read_response",
    "stable_hash",
    "submit_request",
    "synthetic_dates",
]
