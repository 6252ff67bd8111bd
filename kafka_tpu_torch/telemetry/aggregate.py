"""Fleet aggregation: many per-process telemetry surfaces, one view
(port of ``kafka_tpu/telemetry/aggregate.py``).

The live plane's write side is per-process by design (``telemetry.live``
snapshots, per-process ``trace.json`` fragments, the PR 7 lease queue's
marker files).  This module is the read side — pure functions, no
daemon, rendered by ``tools/fleet_status.py``:

- :func:`load_live_snapshots` / :func:`aggregate_fleet` — merge every
  ``live_<host>_<pid>.json`` under a telemetry root into one fleet
  view: counters SUMMED across processes (with the per-worker breakdown
  kept for forensics), gauges PER-HOST (summing a queue-depth gauge
  across hosts would be a lie), histograms merged bucket-wise into
  fleet p50/p99, and hosts whose heartbeat went stale without a
  ``final`` marker flagged DEAD;
- :func:`worker_liveness` — the (host:pid -> liveness) join
  ``tools/queue_status.py`` uses to print heartbeat age next to lease
  ownership;
- :func:`stitch_traces` — merge per-process Chrome-trace fragments for
  one ``run_id`` into a single timeline: each source file becomes its
  own pid track (named after its telemetry subdirectory), timestamps
  are aligned on the shared wall-clock epoch every ``TraceBuffer``
  exports (``otherData.epoch_unix_s``), so the scheduler's reclaim and
  the victim's last span line up in one Perfetto window; profiler
  capture dirs under the same root contribute DEVICE lanes
  (``telemetry.devprof`` — device kernel spans aligned on the
  ``capture_meta.json`` epoch sidecar) beside the host phase spans;
- :func:`parse_prom_text` — the mini Prometheus text-format parser the
  exposition round-trip test and the loadgen mid-run scraper use.
"""

from __future__ import annotations

import json
import math
import os
import re
import time
from typing import Any, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Prometheus text-format parsing (v0.0.4, the subset the registry emits).
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?\s+(?P<value>\S+)\s*$"
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape_label(value: str) -> str:
    return (value.replace("\\n", "\n")
                 .replace('\\"', '"')
                 .replace("\\\\", "\\"))


def _parse_value(text: str) -> float:
    if text == "+Inf":
        return math.inf
    if text == "-Inf":
        return -math.inf
    if text == "NaN":
        return math.nan
    return float(text)


def parse_prom_text(text: str) -> Dict[str, dict]:
    """Parse a text exposition into ``{name: {"type", "help",
    "samples": [{"labels": {...}, "value": float}]}}``.

    Histogram/summary child series (``_bucket``/``_sum``/``_count``)
    appear under their own sample names, exactly as scraped — the
    round-trip test reassembles them.  Raises ``ValueError`` on a line
    that is neither a comment nor a well-formed sample, which is the
    point: the parser doubles as the conformance check.
    """
    out: Dict[str, dict] = {}

    def family(name: str) -> dict:
        return out.setdefault(
            name, {"type": None, "help": None, "samples": []}
        )

    for lineno, line in enumerate(text.splitlines(), start=1):
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
                fam = family(parts[2])
                if parts[1] == "TYPE":
                    fam["type"] = parts[3] if len(parts) > 3 else None
                else:
                    fam["help"] = parts[3] if len(parts) > 3 else ""
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(
                f"line {lineno} is not valid Prometheus text "
                f"exposition: {line!r}"
            )
        labels: Dict[str, str] = {}
        raw = m.group("labels")
        if raw:
            consumed = 0
            for lm in _LABEL_RE.finditer(raw):
                labels[lm.group(1)] = _unescape_label(lm.group(2))
                consumed = lm.end()
            rest = raw[consumed:].strip().strip(",")
            if rest:
                raise ValueError(
                    f"line {lineno} has malformed labels: {raw!r}"
                )
        family(m.group("name"))["samples"].append(
            {"labels": labels, "value": _parse_value(m.group("value"))}
        )
    return out


# ---------------------------------------------------------------------------
# Live-snapshot loading and fleet aggregation.
# ---------------------------------------------------------------------------

_LIVE_RE = re.compile(r"^live_.+_\d+\.json$")


def load_live_snapshots(root: str) -> List[dict]:
    """Every parseable ``live_*.json`` under ``root`` (recursive).  Each
    snapshot gains ``_path``/``_rel`` so the fleet view can point back
    at its source; unreadable files are skipped — a torn write (there
    should be none: writes are atomic) must not kill the fleet view."""
    snaps: List[dict] = []
    if not os.path.isdir(root):
        return snaps
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for fn in sorted(filenames):
            if not _LIVE_RE.match(fn):
                continue
            path = os.path.join(dirpath, fn)
            try:
                with open(path) as f:
                    snap = json.load(f)
            except (OSError, ValueError):
                continue
            if not isinstance(snap, dict) or "ts" not in snap:
                continue
            snap["_path"] = path
            snap["_rel"] = os.path.relpath(path, root).replace(
                os.sep, "/"
            )
            snaps.append(snap)
    return snaps


def _worker_key(snap: dict) -> str:
    return f"{snap.get('host', '?')}:{snap.get('pid', '?')}"


def _dedupe_newest(snapshots: List[dict]) -> List[dict]:
    newest: Dict[str, dict] = {}
    for snap in snapshots:
        key = _worker_key(snap)
        if key not in newest or snap.get("ts", 0) > \
                newest[key].get("ts", 0):
            newest[key] = snap
    return [newest[k] for k in sorted(newest)]


def _is_dead(snap: dict, now: float, ttl_s: Optional[float]) -> bool:
    """Stale heartbeat + no final marker = presumed dead.  The TTL
    defaults to 3x the snapshot's own publish interval (miss three
    beats, same policy as the lease heartbeat)."""
    if snap.get("final"):
        return False
    ttl = ttl_s if ttl_s is not None else \
        3.0 * float(snap.get("interval_s") or 2.0)
    return (now - float(snap.get("ts", 0))) > ttl


def quantile_from_buckets(le: List[float], cumulative: List[int],
                          count: int, q: float) -> Optional[float]:
    """``histogram_quantile``-style linear interpolation over cumulative
    buckets.  Observations beyond the last finite bucket resolve to that
    bucket's bound (the standard Prometheus convention)."""
    if count <= 0 or not le:
        return None
    rank = q * count
    prev_le, prev_cum = 0.0, 0
    for bound, cum in zip(le, cumulative):
        if cum >= rank:
            if cum == prev_cum:
                return bound
            return prev_le + (bound - prev_le) * \
                (rank - prev_cum) / (cum - prev_cum)
        prev_le, prev_cum = bound, cum
    return le[-1]


def aggregate_fleet(snapshots: List[dict], now: Optional[float] = None,
                    ttl_s: Optional[float] = None) -> dict:
    """Merge per-process live snapshots into the fleet view (see module
    docstring for the counter/gauge/histogram semantics)."""
    now = time.time() if now is None else now
    snaps = _dedupe_newest(snapshots)
    workers: List[dict] = []
    counters: Dict[str, float] = {}
    counters_by_worker: Dict[str, Dict[str, float]] = {}
    gauges: Dict[str, Dict[str, float]] = {}
    hist_acc: Dict[str, dict] = {}
    crash_dumps: List[dict] = []
    run_ids = set()
    for snap in snaps:
        key = _worker_key(snap)
        age = now - float(snap.get("ts", 0))
        dead = _is_dead(snap, now, ttl_s)
        if snap.get("run_id"):
            run_ids.add(snap["run_id"])
        for name in snap.get("crash_dumps") or ():
            crash_dumps.append({"worker": key, "file": name})
        workers.append({
            "key": key,
            "host": snap.get("host"),
            "pid": snap.get("pid"),
            "role": snap.get("role"),
            "run_id": snap.get("run_id"),
            "age_s": round(age, 3),
            "final": bool(snap.get("final")),
            "dead": dead,
            "unhealthy": (snap.get("health") or {}).get("unhealthy"),
            # Per-host assimilation-quality summary (telemetry.quality;
            # absent on pre-quality snapshots).
            "quality": snap.get("quality"),
            # Per-host performance attribution (telemetry.perf; absent
            # on pre-perf snapshots).
            "perf": snap.get("perf"),
            # Per-host SLO alert state (telemetry.slo; absent on
            # pre-SLO snapshots).
            "slo": snap.get("slo"),
            # Per-host device-plane state (telemetry.devprof; absent
            # on pre-devprof snapshots).
            "devprof": snap.get("devprof"),
            "crash_dumps": list(snap.get("crash_dumps") or ()),
            "status": snap.get("status") or {},
            "path": snap.get("_rel") or snap.get("_path"),
        })
        for tag, val in (snap.get("counters") or {}).items():
            counters[tag] = counters.get(tag, 0) + val
            counters_by_worker.setdefault(tag, {})[key] = val
        for tag, val in (snap.get("gauges") or {}).items():
            gauges.setdefault(tag, {})[key] = val
        for tag, h in (snap.get("histograms") or {}).items():
            acc = hist_acc.get(tag)
            le = list(h.get("le") or ())
            if acc is None:
                hist_acc[tag] = {
                    "le": le,
                    "buckets": list(h.get("buckets") or ()),
                    "sum": float(h.get("sum") or 0.0),
                    "count": int(h.get("count") or 0),
                    "mergeable": True,
                }
            else:
                acc["sum"] += float(h.get("sum") or 0.0)
                acc["count"] += int(h.get("count") or 0)
                if acc["le"] == le and le:
                    acc["buckets"] = [
                        a + b for a, b in
                        zip(acc["buckets"], h.get("buckets") or ())
                    ]
                else:
                    # Bucket layouts disagree (different registry
                    # configs): count/sum still merge, quantiles don't.
                    acc["mergeable"] = False
    histograms: Dict[str, dict] = {}
    for tag, acc in hist_acc.items():
        entry = {
            "count": acc["count"],
            "sum": round(acc["sum"], 6),
            "p50": None,
            "p99": None,
        }
        if acc["mergeable"] and acc["count"]:
            for q, field in ((0.5, "p50"), (0.99, "p99")):
                v = quantile_from_buckets(
                    acc["le"], acc["buckets"], acc["count"], q
                )
                entry[field] = None if v is None else round(v, 6)
        histograms[tag] = entry
    # Fleet quality roll-up: which hosts' drift sentinels are alarming
    # and the distribution of last verdicts — the science-side health
    # column of the fleet view (dead_hosts is the process-side one).
    verdict_counts: Dict[str, int] = {}
    drifting_workers = []
    for w in workers:
        q = w.get("quality") or {}
        if q.get("drift_active"):
            drifting_workers.append(w["key"])
        v = q.get("last_verdict")
        if v:
            verdict_counts[v] = verdict_counts.get(v, 0) + 1
    # Fleet SLO roll-up: an objective firing on ANY worker fires
    # fleet-wide, deduped to one (objective, severity) entry carrying
    # the workers it fires on — the fleet alert line fleet_status
    # renders above the per-worker rows.
    slo_firing: Dict[Tuple[str, str], List[str]] = {}
    n_alerts_fired = 0
    for w in workers:
        s = w.get("slo") or {}
        n_alerts_fired += int(s.get("alerts_fired") or 0)
        for a in s.get("firing") or ():
            key = (str(a.get("objective")), str(a.get("severity")))
            slo_firing.setdefault(key, []).append(w["key"])
    return {
        "generated_ts": round(now, 6),
        "n_workers": len(workers),
        "workers": workers,
        "dead_hosts": sorted(w["key"] for w in workers if w["dead"]),
        "run_ids": sorted(run_ids),
        "counters": counters,
        "counters_by_worker": counters_by_worker,
        "gauges": gauges,
        "histograms": histograms,
        "crash_dumps": crash_dumps,
        "quality": {
            "drifting_workers": sorted(drifting_workers),
            "last_verdicts": verdict_counts,
        },
        "slo": {
            "firing": [
                {
                    "objective": obj, "severity": sev,
                    "workers": sorted(wkeys),
                }
                for (obj, sev), wkeys in sorted(slo_firing.items())
            ],
            "alerts_fired": n_alerts_fired,
        },
    }


def worker_liveness(snapshots: List[dict], now: Optional[float] = None,
                    ttl_s: Optional[float] = None) -> Dict[str, dict]:
    """``host:pid -> {age_s, dead, final, role, path}`` — the join key
    is exactly the queue's default worker id, so lease ownership lines
    match up with heartbeats for free."""
    now = time.time() if now is None else now
    out: Dict[str, dict] = {}
    for snap in _dedupe_newest(snapshots):
        out[_worker_key(snap)] = {
            "age_s": round(now - float(snap.get("ts", 0)), 3),
            "dead": _is_dead(snap, now, ttl_s),
            "final": bool(snap.get("final")),
            "role": snap.get("role"),
            "path": snap.get("_rel") or snap.get("_path"),
        }
    return out


def discover_queue_outdir(snapshots: List[dict]) -> Optional[str]:
    """The queue outdir the fleet serves, read from worker status
    contributions (``shard.queue.run_queue`` publishes it) — so
    ``fleet_status`` needs no ``--queue-dir`` when snapshots carry it."""
    for snap in _dedupe_newest(snapshots):
        outdir = (snap.get("status") or {}).get("queue_outdir")
        if outdir:
            return outdir
    return None


# ---------------------------------------------------------------------------
# Trace stitching: per-process fragments -> one Chrome trace.
# ---------------------------------------------------------------------------

def find_trace_files(root: str) -> List[str]:
    """Every ``trace.json`` under ``root`` (recursive, sorted)."""
    found: List[str] = []
    if not os.path.isdir(root):
        return found
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        if "trace.json" in filenames:
            found.append(os.path.join(dirpath, "trace.json"))
    return sorted(found)


def _trace_matches(doc: dict, run_id: Optional[str]) -> bool:
    if run_id is None:
        return True
    other = doc.get("otherData") or {}
    if run_id in (other.get("run_ids") or ()):
        return True
    return any(
        (e.get("args") or {}).get("run_id") == run_id
        for e in doc.get("traceEvents") or ()
    )


def _request_events(doc: dict, request_id: str) -> Optional[dict]:
    """``doc`` filtered to one request's events (metadata kept so the
    track names survive); None when the fragment never saw the
    request — that process plays no part in this waterfall."""
    matched = [
        e for e in doc.get("traceEvents") or ()
        if (e.get("args") or {}).get("request_id") == request_id
    ]
    if not matched:
        return None
    meta = [e for e in doc.get("traceEvents") or ()
            if e.get("ph") == "M"]
    return {**doc, "traceEvents": meta + matched}


def request_flow_events(events: List[dict]) -> List[dict]:
    """Chrome flow events (``ph: "s"``/``"f"``) threading one request's
    spans across process boundaries: every time the request's timeline
    hops pids (router -> replica -> router), an arrow binds the last
    span on the old track to the first span on the new one — the
    forward/relay hops read as one path in Perfetto, not three
    disconnected tracks."""
    spans = sorted(
        (e for e in events if e.get("ph") == "X"),
        key=lambda e: (e.get("ts", 0), -(e.get("dur") or 0)),
    )
    flows: List[dict] = []
    flow_id = 1
    for prev, nxt in zip(spans, spans[1:]):
        if prev.get("pid") == nxt.get("pid"):
            continue
        base = {"name": "request", "cat": "flow", "id": flow_id}
        flows.append({
            **base, "ph": "s",
            "ts": round(prev.get("ts", 0) + (prev.get("dur") or 0), 1),
            "pid": prev.get("pid"), "tid": prev.get("tid"),
        })
        flows.append({
            **base, "ph": "f", "bp": "e",
            "ts": nxt.get("ts", 0),
            "pid": nxt.get("pid"), "tid": nxt.get("tid"),
        })
        flow_id += 1
    return flows


def stitch_traces(root: str, run_id: Optional[str] = None,
                  request_id: Optional[str] = None) -> dict:
    """Merge every per-process ``trace.json`` under ``root`` (optionally
    only fragments carrying ``run_id``) into ONE Chrome trace document.

    Each source fragment gets its own remapped pid track named after its
    telemetry subdirectory, and its timestamps are shifted onto the
    shared wall-clock axis via the ``epoch_unix_s`` anchor every
    ``TraceBuffer`` exports — cross-process ordering (claim, crash,
    reclaim) is real, not per-process-relative.

    ``request_id`` stitches ONE request's waterfall instead (ISSUE 14):
    only spans carrying that id survive (plus track metadata), only
    processes that touched the request contribute a track, and flow
    events thread the forward/relay hops across the pid boundaries.
    """
    sources: List[Tuple[str, dict]] = []
    for path in find_trace_files(root):
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        if not isinstance(doc, dict) or "traceEvents" not in doc:
            continue
        if not _trace_matches(doc, run_id):
            continue
        if request_id is not None:
            filtered = _request_events(doc, request_id)
            if filtered is None:
                continue
            doc = filtered
        sources.append((path, doc))
    epoch0 = min(
        (float((doc.get("otherData") or {}).get("epoch_unix_s") or 0)
         for _, doc in sources),
        default=0.0,
    )
    events: List[dict] = []
    out_sources: List[dict] = []
    run_ids = set()
    for idx, (path, doc) in enumerate(sources):
        pid = idx + 1
        other = doc.get("otherData") or {}
        epoch = float(other.get("epoch_unix_s") or 0)
        shift_us = (epoch - epoch0) * 1e6
        rel_dir = os.path.relpath(os.path.dirname(path), root).replace(
            os.sep, "/"
        )
        label = rel_dir if rel_dir != "." else os.path.basename(root)
        run_ids.update(other.get("run_ids") or ())
        named = False
        for e in doc.get("traceEvents") or ():
            e = dict(e)
            e["pid"] = pid
            if e.get("ph") == "M" and e.get("name") == "process_name":
                e = {**e, "args": {"name": f"kafka_tpu {label}"}}
                named = True
            elif isinstance(e.get("ts"), (int, float)):
                e["ts"] = round(e["ts"] + shift_us, 1)
            events.append(e)
        if not named:
            events.append({
                "name": "process_name", "ph": "M", "ts": 0.0,
                "pid": pid, "tid": 0,
                "args": {"name": f"kafka_tpu {label}"},
            })
        out_sources.append({
            "pid": pid,
            "path": os.path.relpath(path, root).replace(os.sep, "/"),
            "epoch_unix_s": epoch,
        })
    if request_id is not None:
        events.extend(request_flow_events(events))
    else:
        # Device lanes (telemetry.devprof): every profiler capture
        # session under the root joins as its own pid track, device kernel
        # spans aligned on the host phase spans their kafka/<phase>
        # ranges match (else on the capture_meta.json epoch sidecar) —
        # the host phase spans and the kernels they dispatched share one
        # Perfetto window.  Request waterfalls skip this: kernels carry
        # no request_id.  Late import keeps aggregate importable
        # standalone (it has no other package dependencies).
        from . import devprof

        dev_events, dev_sources = devprof.device_lane_tracks(
            root, epoch0, first_pid=len(sources) + 1,
            host_spans=[e for e in events if e.get("ph") == "X"
                        and e.get("cat") == "phase"],
        )
        events.extend(dev_events)
        out_sources.extend(dev_sources)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "stitched": True,
            "run_id_filter": run_id,
            "request_id_filter": request_id,
            "run_ids": sorted(run_ids),
            "sources": out_sources,
        },
    }
