"""Assimilation-as-a-service: the crash-safe warm-state serving layer
(port of ``kafka_tpu/serve``, one daemon).

Request queue -> admission control -> incremental warm-state solve ->
result cache, exposed by the ``kafka_serve`` daemon
(``cli.kafka_serve``); compatible concurrent requests coalesce into one
device round (``serve.batch``).

The daemon's fleet awareness (``ServeDaemon(fleet_dir=...)``: the
dead-host gauge from the fleet's live snapshots) is here.  Not ported
yet: the router — ``HashRing``, ``RoutePolicy``, ``TileRouter``,
``FleetWatch``, ``stable_hash`` (``serve/router.py``) and
``cli/kafka_route.py`` — item 16b of ROADMAP.md's Queue 1, which its
failover reads those snapshots for.
"""

from .admission import AdmissionController, AdmissionPolicy
from .daemon import ServeDaemon, read_response, submit_request
from .journal import RequestJournal
from .request import BadRequest, ServeRequest, parse_request
from .service import AssimilationService
from .session import TileSession, TileSpec, UnknownDateError
from .synthetic import make_synthetic_tile, synthetic_dates

__all__ = [
    "AdmissionController",
    "AdmissionPolicy",
    "AssimilationService",
    "BadRequest",
    "RequestJournal",
    "ServeDaemon",
    "ServeRequest",
    "TileSession",
    "TileSpec",
    "UnknownDateError",
    "make_synthetic_tile",
    "parse_request",
    "read_response",
    "submit_request",
    "synthetic_dates",
]
