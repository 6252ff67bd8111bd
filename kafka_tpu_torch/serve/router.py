"""Consistent-hash tile routing across an elastic kafka_serve fleet
(port of ``kafka_tpu/serve/router.py``; host code, no tensors).

One ``kafka_serve`` daemon is a single host's throughput and a single
point of failure.  This module is the front door that turns N daemons
into ONE serving surface:

- :func:`stable_hash` / :class:`HashRing` — the tile keyspace is
  partitioned by a consistent-hash ring over STABLE digests
  (``hashlib.blake2b`` of the tile string), never Python's builtin
  ``hash()`` (salted per process: two routers would disagree about
  every tile), never ``random`` and nothing of torch.  So this ring and
  the JAX package's put every tile on the same replica, and a router of
  either package replays the other's journal.  Each replica owns
  ``vnodes`` points on the ring; a tile belongs to the first replica
  point at or clockwise of its digest.  Adding or removing a replica
  moves ONLY the ring segments adjacent to its points.

- :class:`TileRouter` — the routing daemon.  Same wire as the replicas
  (the shared filesystem): clients drop requests into the ROUTER's
  ``inbox/`` and read the ROUTER's ``responses/``; the router journals
  every admitted request (``requests.jsonl``: durable before forward,
  so a router crash replays unanswered requests on restart), forwards
  it into the owning replica's inbox, and relays the replica's response
  back.  Because every replica resumes tiles from the SHARED checkpoint
  set, re-routing a tile is warm-state migration for free: the new
  owner picks up from the bytes the old owner checkpointed.

- **Fleet-aware failover** — the router watches the replicas' live
  snapshots under ``fleet_dir`` (``telemetry.live``): a replica whose
  heartbeat went stale without a ``final`` marker is DEAD (flagged
  within one heartbeat TTL); a replica whose ``kafka_serve_rejected_
  total{reason="queue_full"}`` counter is climbing or whose queue-depth
  gauge is over the policy bound is SHEDDING (deprioritised, not
  excluded).  Dead replicas are dropped from the ring view (ownership
  rebalances to the survivors), their in-flight requests are
  re-forwarded to the next owner, and a replica answering ``rejected:
  queue_full`` gets the same treatment reactively even with no fleet
  dir at all.
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib
import json
import logging
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..resilience import faults
from ..telemetry import get_registry, live, request_log, tracing
from ..telemetry.tracing import trace_span
from .daemon import INBOX_DIR, _install_drain, _restore_drain, \
    read_response, submit_request
from .journal import RequestJournal
from .request import BadRequest, parse_request

LOG = logging.getLogger(__name__)

#: ring points per replica — enough that ownership splits evenly across
#: a handful of replicas without making ring rebuilds expensive.
DEFAULT_VNODES = 64

#: replica-side rejection reasons worth retrying SOMEWHERE ELSE — they
#: describe the replica's state, not the request's.  Anything else
#: (bad_request, unknown_tile, ...) is terminal and relayed as-is.
RETRYABLE_REJECTIONS = frozenset({
    "queue_full", "prefetch_backlog", "writer_backlog", "unhealthy",
    "fleet_degraded", "quality_degraded", "slo_burn", "draining",
})


def stable_hash(text: str) -> int:
    """64-bit digest of ``text``, identical in every process on every
    host — the ONE sanctioned hash for placement decisions (builtin
    ``hash()`` is salted per process and would shred ring agreement)."""
    digest = hashlib.blake2b(text.encode("utf-8"), digest_size=8)
    return int.from_bytes(digest.digest(), "big")


class HashRing:
    """Consistent-hash ring: ``vnodes`` points per replica, tiles owned
    by the first point at or clockwise of their digest."""

    def __init__(self, replicas: Iterable[str] = (),
                 vnodes: int = DEFAULT_VNODES):
        self.vnodes = int(vnodes)
        self._replicas: List[str] = []
        #: sorted parallel arrays: point digest -> owning replica.
        self._points: List[int] = []
        self._owners: List[str] = []
        for rid in replicas:
            self.add(rid)

    @property
    def replicas(self) -> List[str]:
        return sorted(self._replicas)

    def __len__(self) -> int:
        return len(self._replicas)

    def __contains__(self, replica_id: str) -> bool:
        return replica_id in self._replicas

    def _rebuild(self) -> None:
        pts: List[Tuple[int, str]] = []
        for rid in self._replicas:
            for v in range(self.vnodes):
                pts.append((stable_hash(f"{rid}#{v}"), rid))
        pts.sort()
        self._points = [p for p, _ in pts]
        self._owners = [r for _, r in pts]

    def add(self, replica_id: str) -> None:
        if replica_id in self._replicas:
            return
        self._replicas.append(replica_id)
        self._rebuild()

    def remove(self, replica_id: str) -> None:
        if replica_id not in self._replicas:
            return
        self._replicas.remove(replica_id)
        self._rebuild()

    def preference(self, tile: str) -> List[str]:
        """Every replica in ring-walk order from the tile's digest —
        element 0 is the owner, the rest are the failover order."""
        if not self._points:
            return []
        start = bisect.bisect_left(self._points, stable_hash(tile))
        seen: List[str] = []
        n = len(self._points)
        for i in range(n):
            rid = self._owners[(start + i) % n]
            if rid not in seen:
                seen.append(rid)
                if len(seen) == len(self._replicas):
                    break
        return seen

    def owner(self, tile: str,
              exclude: Iterable[str] = ()) -> Optional[str]:
        """The tile's owner, skipping ``exclude`` along the ring walk."""
        excluded = set(exclude)
        for rid in self.preference(tile):
            if rid not in excluded:
                return rid
        return None

    def assignments(self, tiles: Iterable[str]) -> Dict[str, List[str]]:
        """``replica -> sorted tiles owned`` over the given tile set."""
        out: Dict[str, List[str]] = {rid: [] for rid in self._replicas}
        for tile in tiles:
            rid = self.owner(tile)
            if rid is not None:
                out[rid].append(tile)
        return {rid: sorted(ts) for rid, ts in out.items()}


@dataclasses.dataclass(frozen=True)
class RoutePolicy:
    """The routing contract, as data.

    ``ttl_s`` overrides the dead-replica heartbeat TTL (default: 3x
    each snapshot's own publish interval, the fleet-view convention);
    ``refresh_s`` throttles fleet-view reads; ``max_queue_depth``
    deprioritises replicas whose live queue-depth gauge is at or past
    the bound; ``shed_backoff_s`` is how long a replica observed
    shedding (counter climb or an actual ``queue_full`` answer) stays
    deprioritised; ``retry_after_s`` rides router-level rejections as
    the client backoff hint.
    """

    vnodes: int = DEFAULT_VNODES
    refresh_s: float = 1.0
    ttl_s: Optional[float] = None
    max_queue_depth: Optional[int] = None
    shed_backoff_s: float = 2.0
    retry_after_s: float = 0.5
    #: shed new submissions (reason ``slo_burn``) while any
    #: PAGE-severity SLO alert fires on the ROUTER's own registry
    #: (``kafka_slo_alerts_firing{severity="page"}``,
    #: ``telemetry.slo``) — the fleet front door's opt-in version of
    #: ``AdmissionPolicy.shed_on_slo`` (``kafka-route --shed-slo``).
    shed_on_slo: bool = False


class FleetWatch:
    """Per-replica liveness/load view derived from the fleet's live
    snapshots (``live_<host>_<pid>.json`` under ``fleet_dir``), matched
    to replicas by the ``serve_root`` status fact every kafka-serve
    publishes.  With no fleet dir every replica reads as routable —
    the reactive rejection path still covers shedding."""

    #: the live-snapshot counter tag of queue_full shed rejections.
    SHED_TAG = 'kafka_serve_rejected_total{reason="queue_full"}'
    DEPTH_TAG = "kafka_serve_queue_depth"

    def __init__(self, fleet_dir: Optional[str],
                 replica_roots: Dict[str, str],
                 policy: RoutePolicy):
        self.fleet_dir = fleet_dir
        self.policy = policy
        self._root_to_rid = {
            os.path.abspath(root): rid
            for rid, root in replica_roots.items()
        }
        self._shed_seen: Dict[str, float] = {}
        self._shed_until: Dict[str, float] = {}

    def note_shedding(self, replica_id: str,
                      now: Optional[float] = None) -> None:
        """Reactive signal: the replica just ANSWERED a retryable
        rejection — deprioritise it for ``shed_backoff_s``."""
        now = time.monotonic() if now is None else now
        self._shed_until[replica_id] = now + self.policy.shed_backoff_s

    def shedding(self, replica_id: str,
                 now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        return now < self._shed_until.get(replica_id, 0.0)

    def refresh(self) -> Dict[str, dict]:
        """``replica_id -> {"dead", "final", "queue_depth"}`` for every
        replica a snapshot was found for (absent = no signal yet)."""
        if not self.fleet_dir:
            return {}
        from ..telemetry.aggregate import load_live_snapshots

        now_wall = time.time()
        now_mono = time.monotonic()
        newest: Dict[str, dict] = {}
        for snap in load_live_snapshots(self.fleet_dir):
            root = (snap.get("status") or {}).get("serve_root")
            rid = self._root_to_rid.get(os.path.abspath(root)) \
                if root else None
            if rid is None:
                continue
            if rid not in newest or snap.get("ts", 0) > \
                    newest[rid].get("ts", 0):
                newest[rid] = snap
        view: Dict[str, dict] = {}
        for rid, snap in newest.items():
            ttl = self.policy.ttl_s if self.policy.ttl_s is not None \
                else 3.0 * float(snap.get("interval_s") or 2.0)
            stale = (now_wall - float(snap.get("ts", 0))) > ttl
            final = bool(snap.get("final"))
            shed_count = float(
                (snap.get("counters") or {}).get(self.SHED_TAG, 0.0)
            )
            if rid in self._shed_seen and \
                    shed_count > self._shed_seen[rid]:
                # The replica shed queue_full load since the last look:
                # deprioritise it for a backoff window.  (The first
                # sighting is the baseline, not a climb — a counter's
                # absolute value is history, its delta is load.)
                self.note_shedding(rid, now=now_mono)
            self._shed_seen[rid] = shed_count
            view[rid] = {
                "dead": stale and not final,
                "final": final,
                "queue_depth": (snap.get("gauges") or {}).get(
                    self.DEPTH_TAG
                ),
            }
        return view


def _route_metrics(reg):
    """Single registration site for the router's metric vocabulary."""
    return {
        "forwarded": reg.counter(
            "kafka_route_forwarded_total",
            "requests forwarded into a replica inbox, labelled by "
            "replica",
        ),
        "relayed": reg.counter(
            "kafka_route_relayed_total",
            "replica responses relayed back to the router's response "
            "store",
        ),
        "rerouted": reg.counter(
            "kafka_route_rerouted_total",
            "in-flight requests re-forwarded to another replica, "
            "labelled by reason (dead / rejected)",
        ),
        "rejected": reg.counter(
            "kafka_route_rejected_total",
            "requests the router itself rejected, labelled by reason "
            "(bad_request / fleet_degraded / draining)",
        ),
        "rebalanced": reg.counter(
            "kafka_route_rebalanced_total",
            "ring-ownership rebalances (the routable replica set "
            "changed: a replica joined, left, died or recovered)",
        ),
        "replayed": reg.counter(
            "kafka_route_replayed_total",
            "journaled requests re-forwarded by router crash-recovery "
            "replay",
        ),
        "inflight": reg.gauge(
            "kafka_route_inflight",
            "requests forwarded but not yet relayed",
        ),
        "routable": reg.gauge(
            "kafka_route_replicas_routable",
            "replicas currently routable (configured minus dead)",
        ),
        "latency": reg.histogram(
            "kafka_route_latency_seconds",
            "router-admission to relayed-response seconds per request",
        ),
    }


@dataclasses.dataclass
class _InFlight:
    payload: dict
    tile: str
    replica: str
    admitted_ts: float
    tried: List[str]
    #: wall-clock stamp of the LAST forward (this attempt) and of the
    #: FIRST — their difference is the failover_ms phase: the time the
    #: request lost to dead/shedding replicas before landing.
    forwarded_ts: float = 0.0
    first_forward_ts: float = 0.0
    #: reroute history ({"reason", "replica", "held_ms"} per hop) —
    #: rides the response trace and the request_log row (failover
    #: forensics).
    reroutes: List[dict] = dataclasses.field(default_factory=list)


class TileRouter:
    """The ``kafka-route`` front door: one inbox/responses surface over
    N ``kafka-serve`` replica roots (see module docstring)."""

    def __init__(
        self,
        replicas: Dict[str, str],
        root: str,
        fleet_dir: Optional[str] = None,
        policy: Optional[RoutePolicy] = None,
        poll_interval_s: float = 0.05,
        exit_when_idle: bool = False,
        idle_grace_s: float = 1.0,
        replicas_file: Optional[str] = None,
    ):
        self.policy = policy or RoutePolicy()
        self.replica_roots = {
            rid: os.path.abspath(r) for rid, r in replicas.items()
        }
        self.ring = HashRing(self.replica_roots,
                             vnodes=self.policy.vnodes)
        self.root = root
        self.inbox = os.path.join(root, INBOX_DIR)
        os.makedirs(self.inbox, exist_ok=True)
        self.journal = RequestJournal(root)
        self.watch = FleetWatch(fleet_dir, self.replica_roots,
                                self.policy)
        self.poll_interval_s = float(poll_interval_s)
        self.exit_when_idle = bool(exit_when_idle)
        self.idle_grace_s = float(idle_grace_s)
        #: optional elastic-membership file ({"rid": "root"}); re-read
        #: when its mtime changes, so replicas join/leave a RUNNING
        #: router without a restart.
        self.replicas_file = replicas_file
        self._replicas_file_mtime: Optional[float] = None
        self._inflight: Dict[str, _InFlight] = {}
        self._view: Dict[str, dict] = {}
        self._routable: List[str] = sorted(self.replica_roots)
        self._tiles_seen: set = set()
        self._last_failover_ts: Optional[float] = None
        self._refresh_next = 0.0
        self._drain = threading.Event()
        self._m = _route_metrics(get_registry())
        self._m["routable"].set(len(self._routable))

    # -- status ---------------------------------------------------------

    def drain(self) -> None:
        """Programmatic SIGTERM equivalent."""
        self._drain.set()

    def pending(self) -> int:
        return len(self._inflight)

    def status(self) -> dict:
        """Router facts for ``/statusz`` and the live snapshots — the
        ``tools/fleet_status.py`` router view renders these."""
        reg = get_registry()
        flat = reg.flat()
        return {
            "router_root": os.path.abspath(self.root),
            "router_replicas": dict(self.replica_roots),
            "router_routable": list(self._routable),
            "router_dead": sorted(
                rid for rid, v in self._view.items() if v["dead"]
            ),
            "router_ring": self.ring.assignments(
                sorted(self._tiles_seen)
            ),
            "router_inflight": len(self._inflight),
            "router_rerouted_total": int(sum(
                v for k, v in flat.items()
                if k.startswith("kafka_route_rerouted_total")
            )),
            "router_rebalanced_total": int(
                flat.get("kafka_route_rebalanced_total", 0)
            ),
            "router_last_failover_ts": self._last_failover_ts,
        }

    # -- fleet view / rebalance ----------------------------------------

    def _dead(self, replica_id: str) -> bool:
        view = self._view.get(replica_id)
        return bool(view and view["dead"])

    def _deprioritised(self, replica_id: str) -> bool:
        if self.watch.shedding(replica_id):
            return True
        view = self._view.get(replica_id)
        bound = self.policy.max_queue_depth
        if view and bound is not None:
            depth = view.get("queue_depth")
            if depth is not None and depth >= bound:
                return True
        return False

    def _refresh(self) -> None:
        now = time.monotonic()
        if now < self._refresh_next:
            return
        self._refresh_next = now + self.policy.refresh_s
        self._reload_replicas_file()
        self._view = self.watch.refresh()
        routable = sorted(
            rid for rid in self.replica_roots if not self._dead(rid)
        )
        if routable != self._routable:
            joined = sorted(set(routable) - set(self._routable))
            left = sorted(set(self._routable) - set(routable))
            self._routable = routable
            self._m["rebalanced"].inc()
            self._m["routable"].set(len(routable))
            get_registry().emit(
                "route_rebalanced", routable=routable, joined=joined,
                left=left,
            )
            self._failover(left)
        self._publish_status()

    def _reload_replicas_file(self) -> None:
        """Elastic membership: pick up replica joins/leaves from the
        config file without restarting the router."""
        path = self.replicas_file
        if not path:
            return
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            return
        if mtime == self._replicas_file_mtime:
            return
        self._replicas_file_mtime = mtime
        try:
            with open(path) as f:
                desired = json.load(f)
        except (OSError, ValueError) as exc:
            get_registry().emit(
                "route_replicas_file_unreadable", path=path,
                error=repr(exc)[:200],
            )
            return
        if not isinstance(desired, dict):
            return
        desired = {str(k): os.path.abspath(str(v))
                   for k, v in desired.items()}
        added = sorted(set(desired) - set(self.replica_roots))
        removed = sorted(set(self.replica_roots) - set(desired))
        if not added and not removed:
            return
        self.replica_roots = desired
        for rid in added:
            self.ring.add(rid)
        for rid in removed:
            self.ring.remove(rid)
        self.watch = FleetWatch(self.watch.fleet_dir,
                                self.replica_roots, self.policy)
        get_registry().emit(
            "route_membership_changed", added=added, removed=removed,
        )
        if removed:
            self._failover(removed)
        # Force the routable set to be recomputed against the new
        # membership on this same refresh pass.
        self._view = self.watch.refresh()

    def _failover(self, lost: Sequence[str]) -> None:
        """Re-forward every in-flight request assigned to a lost
        replica — warm-state migration by checkpoint resume on the new
        owner."""
        if not lost:
            return
        lost_set = set(lost)
        victims = [rid for rid, inf in self._inflight.items()
                   if inf.replica in lost_set]
        if not victims:
            return
        self._last_failover_ts = time.time()
        get_registry().emit(
            "route_failover", lost=sorted(lost_set),
            rerouted=len(victims),
        )
        for rid in victims:
            inf = self._inflight.pop(rid)
            self._m["rerouted"].inc(reason="dead")
            held_ms = max(0.0, time.time() - inf.forwarded_ts) * 1e3
            reroutes = inf.reroutes + [{
                "reason": "dead", "replica": inf.replica,
                "held_ms": round(held_ms, 3),
            }]
            # The failover is a named span ON the request's trace: the
            # stitched waterfall shows router-side re-forwarding, not a
            # gap, and trace_report attributes the added tail latency
            # to the failover phase.
            with tracing.push(request_id=rid), \
                    trace_span("route_failover", tile=inf.tile,
                               replica=inf.replica):
                self._forward(inf.payload, inf.tile, inf.admitted_ts,
                              tried=inf.tried + [inf.replica],
                              reroutes=reroutes,
                              first_forward_ts=inf.first_forward_ts)
        self._set_inflight()

    def _publish_status(self) -> None:
        st = self.status()
        live.update_status(**{k: v for k, v in st.items()
                              if k.startswith("router_")})

    # -- admission / forwarding ----------------------------------------

    def submit(self, payload: dict) -> dict:
        """Admit-or-reject one raw payload (the inbox scanner and
        in-process callers both land here)."""
        rid = payload.get("request_id") if isinstance(payload, dict) \
            else None
        try:
            req = parse_request(payload)
        except BadRequest as exc:
            return self._reject(rid, "bad_request",
                               detail=repr(exc)[:200])
        if self._drain.is_set():
            return self._reject(req.request_id, "draining")
        if self.policy.shed_on_slo and get_registry().value(
            "kafka_slo_alerts_firing", severity="page"
        ):
            return self._reject(req.request_id, "slo_burn")
        if req.request_id in self._inflight:
            # Duplicate submission of an in-flight id: the original
            # forward already covers it.
            return {"request_id": req.request_id, "status": "queued"}
        req.admitted_ts = time.time()
        with tracing.push(request_id=req.request_id), \
                trace_span("route_admit", tile=req.tile):
            self.journal.record(req.payload())
        get_registry().emit(
            "route_admitted", request_id=req.request_id, tile=req.tile,
        )
        request_log.note_inflight(
            req.request_id, tile=req.tile, date=req.date.isoformat(),
            stage="routing", submitted_ts=req.submitted_ts,
        )
        self._tiles_seen.add(req.tile)
        return self._forward(req.payload(), req.tile, req.admitted_ts)

    def _candidates(self, tile: str,
                    exclude: Iterable[str]) -> List[str]:
        """Failover-ordered forward targets: ring preference, minus
        dead and already-tried replicas, shedding/overloaded ones
        deprioritised to the back."""
        excluded = set(exclude)
        alive = [rid for rid in self.ring.preference(tile)
                 if rid not in excluded and not self._dead(rid)
                 and rid in self.replica_roots]
        good = [rid for rid in alive if not self._deprioritised(rid)]
        return good + [rid for rid in alive if rid not in good]

    def _forward(self, payload: dict, tile: str, admitted_ts: float,
                 tried: Optional[List[str]] = None,
                 reroutes: Optional[List[dict]] = None,
                 first_forward_ts: Optional[float] = None) -> dict:
        tried = list(tried or ())
        rid = payload["request_id"]
        candidates = self._candidates(tile, tried)
        if not candidates:
            return self._reject(rid, "fleet_degraded", admitted=True,
                                tile=tile)
        target = candidates[0]
        faults.fault_point("route.forward", request=rid, replica=target)
        now = time.time()
        with tracing.push(request_id=rid), \
                trace_span("route_forward", tile=tile, replica=target,
                           attempt=len(tried) + 1):
            submit_request(self.replica_roots[target], payload)
        self._inflight[rid] = _InFlight(
            payload=payload, tile=tile, replica=target,
            admitted_ts=admitted_ts, tried=tried,
            forwarded_ts=now,
            first_forward_ts=(first_forward_ts if first_forward_ts
                              is not None else now),
            reroutes=list(reroutes or ()),
        )
        request_log.note_inflight(rid, stage="forwarded",
                                  replica=target)
        self._m["forwarded"].inc(replica=target)
        self._set_inflight()
        get_registry().emit(
            "route_forwarded", request_id=rid, tile=tile,
            replica=target, attempt=len(tried) + 1,
        )
        return {"request_id": rid, "status": "queued",
                "replica": target}

    def _reject(self, request_id: Optional[str], reason: str,
                detail: Optional[str] = None, admitted: bool = False,
                tile: Optional[str] = None) -> dict:
        self._m["rejected"].inc(reason=reason)
        get_registry().emit(
            "route_rejected", request_id=str(request_id), reason=reason,
        )
        ack = {"request_id": request_id, "status": "rejected",
               "reason": reason}
        if reason in RETRYABLE_REJECTIONS:
            ack["retry_after_s"] = self.policy.retry_after_s
        if detail:
            ack["detail"] = detail
        if request_id and isinstance(request_id, str):
            try:
                self.journal.respond(request_id, ack)
            except OSError as exc:
                LOG.warning("could not write router rejection for %s: "
                            "%r", request_id, exc)
            if admitted:
                # An ADMITTED request that ends rejected (fleet fully
                # degraded) still gets its wide event — 100% of
                # admitted requests leave a request_log row.
                request_log.record(request_log.build_record(
                    "route", request_id, status="rejected",
                    e2e_ms=None, tile=tile, reason=reason,
                ))
        return ack

    # -- relay ----------------------------------------------------------

    def _poll_inflight(self) -> int:
        """Relay every in-flight response that arrived; re-route
        replica-state rejections.  Returns how many were settled."""
        settled = 0
        for rid in list(self._inflight):
            inf = self._inflight.get(rid)
            if inf is None:
                continue
            got = read_response(self.replica_roots[inf.replica], rid)
            if got is None:
                continue
            reason = got.get("reason")
            if got.get("status") == "rejected" and \
                    reason in RETRYABLE_REJECTIONS:
                # The replica's state, not the request's: try the next
                # replica on the ring (it resumes the tile warm from
                # the shared checkpoints).
                self.watch.note_shedding(inf.replica)
                del self._inflight[rid]
                self._m["rerouted"].inc(reason="rejected")
                get_registry().emit(
                    "route_rerouted", request_id=rid,
                    replica=inf.replica, reason=reason,
                )
                held_ms = max(0.0,
                              time.time() - inf.forwarded_ts) * 1e3
                ack = self._forward(
                    inf.payload, inf.tile, inf.admitted_ts,
                    tried=inf.tried + [inf.replica],
                    reroutes=inf.reroutes + [{
                        "reason": reason, "replica": inf.replica,
                        "held_ms": round(held_ms, 3),
                    }],
                    first_forward_ts=inf.first_forward_ts,
                )
                if ack["status"] == "rejected":
                    settled += 1
                continue
            body = dict(got)
            body["replica"] = inf.replica
            body["trace"] = self._merged_trace(rid, inf, got)
            with tracing.push(request_id=rid), \
                    trace_span("route_relay", replica=inf.replica):
                self.journal.respond(rid, body)
            del self._inflight[rid]
            self._m["relayed"].inc()
            if got.get("status") == "ok":
                self._m["latency"].observe(
                    max(0.0, time.time() - inf.admitted_ts)
                )
            self._record_request(rid, inf, body)
            settled += 1
        if settled:
            self._set_inflight()
        return settled

    def _merged_trace(self, rid: str, inf: _InFlight, got: dict) -> dict:
        """The client-visible per-request attribution, end to end: the
        router's waits composed with the replica's phases into ONE
        non-overlapping breakdown of submit -> relay.

        The replica's own ``admission_wait_ms`` is dropped (it spans the
        ORIGINAL client submit, which overlaps the router's admission
        and forward phases); ``forward_ms`` (last forward -> replica
        admission, the filesystem-wire hop) and ``relay_ms`` (replica
        publish -> this relay) replace it, and ``failover_ms`` (first
        forward -> last forward) accounts for every dead/shedding hop —
        the phase a SIGKILL's added tail latency lands in.
        """
        t_relay = time.time()
        rep = got.get("trace") if isinstance(got.get("trace"), dict) \
            else {}
        rep_phases = rep.get("phases") or {}
        submitted = float(inf.payload.get("submitted_ts")
                          or inf.admitted_ts)
        phases = {
            # Everything before the FIRST forward: client inbox wait,
            # parse, journal fsync — admission seen from the client.
            "admission_wait_ms":
                max(0.0, inf.first_forward_ts - submitted) * 1e3,
        }
        if inf.reroutes:
            phases["failover_ms"] = max(
                0.0, inf.forwarded_ts - inf.first_forward_ts,
            ) * 1e3
        rep_admitted = rep.get("admitted_ts")
        if isinstance(rep_admitted, (int, float)):
            phases["forward_ms"] = \
                max(0.0, rep_admitted - inf.forwarded_ts) * 1e3
        for key in ("queue_wait_ms", "resume_ms", "solve_ms",
                    "dump_ms"):
            if isinstance(rep_phases.get(key), (int, float)):
                phases[key] = rep_phases[key]
        responded = rep.get("responded_ts")
        if isinstance(responded, (int, float)):
            phases["relay_ms"] = max(0.0, t_relay - responded) * 1e3
        trace = {
            "request_id": rid,
            "phases": {k: round(v, 3) for k, v in phases.items()},
            "e2e_ms": round(max(0.0, t_relay - submitted) * 1e3, 3),
        }
        if inf.reroutes:
            trace["reroutes"] = list(inf.reroutes)
        if rep.get("replayed"):
            trace["replayed"] = True
        return trace

    def _record_request(self, rid: str, inf: _InFlight,
                        body: dict) -> None:
        """The router half of request_log.jsonl: one wide event per
        relayed request, with the merged end-to-end phases and the
        reroute history attached."""
        trace = body.get("trace") or {}
        request_log.record(request_log.build_record(
            "route", rid, status=body.get("status", "?"),
            e2e_ms=trace.get("e2e_ms"), phases=trace.get("phases"),
            tile=inf.tile, date=body.get("date"),
            served_from=body.get("served_from"),
            replica=inf.replica,
            reroutes=trace.get("reroutes"),
            solver_health=body.get("solver_health"),
            quality=body.get("quality"),
        ))

    def requestz(self, n: int = 32) -> dict:
        """The ``/requestz`` payload: in-flight + last-N relayed."""
        return request_log.requestz(n)

    def _set_inflight(self) -> None:
        self._m["inflight"].set(len(self._inflight))

    # -- the loop --------------------------------------------------------

    def _scan_inbox(self) -> int:
        try:
            names = sorted(
                n for n in os.listdir(self.inbox) if n.endswith(".json")
            )
        except OSError:
            return 0
        consumed = 0
        for name in names:
            path = os.path.join(self.inbox, name)
            try:
                with open(path) as f:
                    payload = json.load(f)
            except FileNotFoundError:
                continue
            except (OSError, ValueError) as exc:
                get_registry().emit(
                    "request_unparseable", file=name,
                    error=repr(exc)[:200],
                )
                self._unlink(path)
                consumed += 1
                continue
            self.submit(payload)
            self._unlink(path)
            consumed += 1
        return consumed

    @staticmethod
    def _unlink(path: str) -> None:
        try:
            os.unlink(path)
        except OSError:  # raced another consumer — outcome identical
            pass

    def _replay(self) -> None:
        """Router crash recovery: every journaled request with no
        relayed response is re-forwarded — zero admitted requests lost
        across a router restart."""
        for payload in self.journal.replay():
            try:
                req = parse_request(payload, replayed=True)
            except BadRequest:
                get_registry().emit(
                    "request_unreplayable",
                    request_id=str(payload.get("request_id")),
                )
                continue
            self._m["replayed"].inc()
            self._tiles_seen.add(req.tile)
            get_registry().emit(
                "route_replayed", request_id=req.request_id,
                tile=req.tile,
            )
            self._forward(req.payload(), req.tile, time.time())

    def run(self) -> dict:
        """The routing loop; returns the run summary."""
        reg = get_registry()
        prev_handler = _install_drain(self._drain)
        self._refresh()
        self._replay()
        reg.emit("route_started", root=self.root,
                 replicas=sorted(self.replica_roots))
        t0 = time.time()
        idle_since: Optional[float] = None
        try:
            while not self._drain.is_set():
                self._refresh()
                consumed = self._scan_inbox()
                self._poll_inflight()
                if consumed == 0 and not self._inflight:
                    if self.exit_when_idle:
                        now = time.monotonic()
                        if idle_since is None:
                            idle_since = now
                        elif now - idle_since >= self.idle_grace_s:
                            break
                else:
                    idle_since = None
                self._drain.wait(self.poll_interval_s)
            if self._drain.is_set():
                # Graceful drain: latecomer inbox files are answered
                # ``rejected: draining`` (submit() checks the flag),
                # in-flight requests finish relaying.
                while self._inflight:
                    self._refresh()
                    self._scan_inbox()
                    self._poll_inflight()
                    if self._inflight:
                        self._drain.wait(
                            max(self.poll_interval_s, 0.02)
                        )
                self._scan_inbox()
        finally:
            self._publish_status()
            self.journal.close()
            _restore_drain(prev_handler)
        flat = reg.flat()
        summary = {
            "mode": "route",
            "root": self.root,
            "drained": self._drain.is_set(),
            "wall_s": round(time.time() - t0, 3),
            "replicas": sorted(self.replica_roots),
            "forwarded": int(sum(
                v for k, v in flat.items()
                if k.startswith("kafka_route_forwarded_total")
            )),
            "relayed": int(flat.get("kafka_route_relayed_total", 0)),
            "rerouted": int(sum(
                v for k, v in flat.items()
                if k.startswith("kafka_route_rerouted_total")
            )),
            "rebalanced": int(
                flat.get("kafka_route_rebalanced_total", 0)
            ),
            "replayed": int(
                flat.get("kafka_route_replayed_total", 0)
            ),
            "rejected": int(sum(
                v for k, v in flat.items()
                if k.startswith("kafka_route_rejected_total")
            )),
        }
        reg.emit("route_stopped", **summary)
        return summary
