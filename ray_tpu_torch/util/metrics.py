"""User-defined application metrics.

Analog of the reference's ``ray.util.metrics``
(python/ray/util/metrics.py Counter/Gauge/Histogram) plus the per-node
metrics-agent export path (_private/metrics_agent.py:46 →
prometheus_exporter.py): metric instruments register in a process-local
registry; a background thread pushes snapshots into the GCS KV under
``metrics:<worker_id>``; ``prometheus_text()`` aggregates every process's
snapshot into the Prometheus text exposition format (served by the dashboard
at ``/metrics``).
"""

from __future__ import annotations

import json
import re
import threading
import time

_REGISTRY_LOCK = threading.Lock()
_REGISTRY: dict[str, "Metric"] = {}
_FLUSHER: threading.Thread | None = None
# Collector hooks: called right before every flush/snapshot so cheap plain-int
# hot-path counters (e.g. rpc.WIRE wire stats) can be folded into instruments
# at flush frequency instead of paying instrument-lock costs per frame.
_COLLECTORS: list = []
# Fallback flush target for processes with no CoreWorker (a standalone
# raylet): (gcs_client, node_id, entity_id).
_FALLBACK_TARGET: tuple | None = None


def _tag_key(tags: dict | None) -> tuple:
    return tuple(sorted((tags or {}).items()))


class Metric:
    """Base instrument. Values are kept per tag-set."""

    kind = "untyped"

    def __init__(self, name: str, description: str = "", tag_keys: tuple = ()):
        # Prometheus metric names: [a-zA-Z_:][a-zA-Z0-9_:]* — one bad name
        # would make the whole exposition body unparseable to scrapers.
        if not re.fullmatch(r"[a-zA-Z_:][a-zA-Z0-9_:]*", name or ""):
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._default_tags: dict = {}
        self._lock = threading.Lock()
        self._values: dict[tuple, float] = {}
        with _REGISTRY_LOCK:
            existing = _REGISTRY.get(name)
            if existing is not None:
                if existing.kind != self.kind:
                    raise ValueError(
                        f"metric {name!r} already registered as {existing.kind}, "
                        f"cannot re-register as {self.kind}"
                    )
                # Same name re-registered (e.g. two actors in one worker):
                # share storage so updates through either instrument export.
                self._share_from(existing)
            _REGISTRY[name] = self
        _ensure_flusher()

    def _share_from(self, existing: "Metric"):
        self._lock = existing._lock
        self._values = existing._values

    def set_default_tags(self, tags: dict):
        self._default_tags = dict(tags)
        return self

    def _merged(self, tags: dict | None) -> dict:
        merged = dict(self._default_tags)
        merged.update(tags or {})
        extra = set(merged) - set(self.tag_keys)
        if extra:
            raise ValueError(f"unknown tag keys {extra} for metric {self.name}")
        return merged

    def _snapshot(self) -> dict:
        with self._lock:
            return {
                "kind": self.kind,
                "description": self.description,
                "values": [[list(k), v] for k, v in self._values.items()],
            }


class Counter(Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, tags: dict | None = None):
        if value < 0:
            raise ValueError("Counter.inc() requires value >= 0")
        key = _tag_key(self._merged(tags))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: float, tags: dict | None = None):
        key = _tag_key(self._merged(tags))
        with self._lock:
            self._values[key] = float(value)


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name, description="", boundaries=None, tag_keys=()):
        # Histogram storage must exist before super().__init__ publishes this
        # instrument to the registry — a concurrent flush would otherwise
        # snapshot a half-constructed object.
        self.boundaries = sorted(boundaries or [0.01, 0.1, 1, 10, 100])
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}
        self._totals: dict[tuple, int] = {}
        super().__init__(name, description, tag_keys)

    def _share_from(self, existing: "Histogram"):
        if self.boundaries != existing.boundaries:
            raise ValueError(
                f"histogram {self.name!r} already registered with boundaries "
                f"{existing.boundaries}, cannot re-register with {self.boundaries}"
            )
        super()._share_from(existing)
        self._counts = existing._counts
        self._sums = existing._sums
        self._totals = existing._totals

    def observe(self, value: float, tags: dict | None = None):
        key = _tag_key(self._merged(tags))
        with self._lock:
            counts = self._counts.setdefault(key, [0] * (len(self.boundaries) + 1))
            idx = len(self.boundaries)
            for i, b in enumerate(self.boundaries):
                if value <= b:
                    idx = i
                    break
            counts[idx] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def _snapshot(self) -> dict:
        with self._lock:
            return {
                "kind": self.kind,
                "description": self.description,
                "boundaries": self.boundaries,
                "hist": [
                    [list(k), self._counts[k], self._sums.get(k, 0.0), self._totals.get(k, 0)]
                    for k in self._counts
                ],
            }


def register_collector(fn) -> None:
    """Register a zero-arg hook invoked before every flush/snapshot. Lets
    hot paths keep plain-int counters (no instrument lock per event) that a
    collector folds into Counters/Gauges at flush cadence."""
    with _REGISTRY_LOCK:
        if fn not in _COLLECTORS:
            _COLLECTORS.append(fn)


def set_fallback_flush_target(gcs_client, node_id: str, entity_id: str) -> None:
    """Flush destination for processes that never build a CoreWorker (a
    standalone raylet): snapshots land under ``metrics:<entity_id>`` exactly
    like worker snapshots."""
    global _FALLBACK_TARGET
    _FALLBACK_TARGET = (gcs_client, node_id, entity_id)


def _run_collectors():
    for fn in list(_COLLECTORS):
        try:
            fn()
        except Exception:
            pass


def _ensure_flusher():
    global _FLUSHER
    with _REGISTRY_LOCK:
        if _FLUSHER is not None:
            return
        _FLUSHER = threading.Thread(target=_flush_loop, name="metrics-flush", daemon=True)
        _FLUSHER.start()
    import atexit

    # A short-lived worker's final window must not vanish: the periodic
    # flusher only pushes every metrics_flush_interval_s, so a process that
    # exits mid-window would lose everything it recorded since the last tick.
    atexit.register(_flush_at_exit)


def _flush_at_exit():
    try:
        flush_metrics()
    except Exception:
        pass


def _flush_loop():
    from ray_tpu_torch._private.config import get_config

    first = True
    while True:
        # Re-read each tick: init_config() may replace the Config after the
        # first Metric (and thus this thread) was created. The FIRST flush
        # runs within ~1s of registration — a worker that lives less than a
        # full interval otherwise never exports anything.
        interval = get_config().metrics_flush_interval_s
        time.sleep(min(1.0, interval) if first else interval)
        first = False
        try:
            flush_metrics()
        except Exception:
            pass


def flush_metrics(core_worker=None):
    """Push this process's metric snapshots into the GCS KV (used by tests and
    the background flusher). Falls back to the target registered via
    set_fallback_flush_target when no CoreWorker exists; no-op when neither
    is available."""
    from ray_tpu_torch._private import worker_context

    cw = core_worker or worker_context.get_core_worker_if_initialized()
    if cw is not None:
        gcs, node_id, entity = cw.gcs, cw.node_id, cw.worker_id
    elif _FALLBACK_TARGET is not None:
        gcs, node_id, entity = _FALLBACK_TARGET
    else:
        return
    _run_collectors()
    with _REGISTRY_LOCK:
        snap = {name: m._snapshot() for name, m in _REGISTRY.items()}
    if not snap:
        return
    payload = json.dumps(
        {"ts": time.time(), "node_id": node_id, "metrics": snap}
    ).encode()
    gcs.call(
        "kv_put",
        {"key": f"metrics:{entity}", "value": payload, "overwrite": True},
    )


def _escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def prometheus_text(gcs_client, stale_after_s: float = 60.0) -> str:
    """Aggregate all processes' snapshots from the GCS KV into Prometheus text
    exposition format."""
    keys = gcs_client.call("kv_keys", {"prefix": "metrics:"}).get("keys", [])
    now = time.time()
    merged: dict[str, dict] = {}
    for key in keys:
        resp = gcs_client.call("kv_get", {"key": key})
        if not resp.get("found"):
            continue
        try:
            snap = json.loads(resp["value"])
        except Exception:
            continue
        if now - snap.get("ts", 0) > stale_after_s:
            continue
        wid = key.split(":", 1)[1][:8]
        for name, m in snap.get("metrics", {}).items():
            entry = merged.setdefault(name, {"kind": m["kind"], "description": m.get("description", ""), "series": []})
            base_tags = [("WorkerId", wid), ("NodeId", snap.get("node_id", "")[:8])]
            if m["kind"] == "histogram":
                for tags, counts, total_sum, total in m.get("hist", []):
                    entry["series"].append((base_tags + tags, {"counts": counts, "sum": total_sum, "count": total, "boundaries": m["boundaries"]}))
            else:
                for tags, value in m.get("values", []):
                    entry["series"].append((base_tags + tags, value))
    lines = []
    for name, entry in sorted(merged.items()):
        kind = entry["kind"]
        desc = entry["description"].replace("\\", "\\\\").replace("\n", "\\n")
        lines.append(f"# HELP {name} {desc}")
        lines.append(f"# TYPE {name} {kind}")
        for tags, value in entry["series"]:
            label = ",".join(f'{k}="{_escape(str(v))}"' for k, v in tags)
            if kind == "histogram":
                cumulative = 0
                for i, b in enumerate(value["boundaries"]):
                    cumulative += value["counts"][i]
                    le = f'le="{b}"'
                    lab = ",".join(x for x in (label, le) if x)
                    lines.append(f"{name}_bucket{{{lab}}} {cumulative}")
                lab = ",".join(x for x in (label, 'le="+Inf"') if x)
                lines.append(f"{name}_bucket{{{lab}}} {value['count']}")
                lines.append(f"{name}_sum{{{label}}} {value['sum']}")
                lines.append(f"{name}_count{{{label}}} {value['count']}")
            else:
                lines.append(f"{name}{{{label}}} {value}")
    lines.extend(_node_gauge_lines(gcs_client))
    return "\n".join(lines) + "\n"


def _node_gauge_lines(gcs_client) -> list[str]:
    """Synthesize ``ray_tpu_node_*`` gauges from the dashboard agent's node
    samples (GCS node table ``stats``) — host CPU/memory and per-worker RSS
    were previously reachable only via ``/api/cluster_status``."""
    try:
        nodes = gcs_client.call("get_nodes").get("nodes", {})
    except Exception:
        return []
    host_gauges = [
        ("ray_tpu_node_cpu_percent", "cpu_percent", "Host CPU utilization percent."),
        ("ray_tpu_node_mem_used_bytes", "mem_used", "Host memory used in bytes."),
        ("ray_tpu_node_mem_total_bytes", "mem_total", "Host memory total in bytes."),
        ("ray_tpu_node_disk_used_bytes", "disk_used", "Session-dir disk used in bytes."),
        ("ray_tpu_node_disk_total_bytes", "disk_total", "Session-dir disk total in bytes."),
    ]
    lines: list[str] = []
    for metric, key, help_text in host_gauges:
        samples = []
        for nid, node in nodes.items():
            stats = node.get("stats") or {}
            if node.get("state") == "ALIVE" and key in stats:
                samples.append((nid[:8], stats[key]))
        if samples:
            lines.append(f"# HELP {metric} {help_text}")
            lines.append(f"# TYPE {metric} gauge")
            for nid, value in samples:
                lines.append(f'{metric}{{NodeId="{_escape(nid)}"}} {value}')
    rss = []
    for nid, node in nodes.items():
        stats = node.get("stats") or {}
        if node.get("state") != "ALIVE":
            continue
        for wid, w in (stats.get("workers") or {}).items():
            if "rss" in w:
                rss.append((nid[:8], wid[:8], w.get("pid", 0), w["rss"]))
    if rss:
        lines.append("# HELP ray_tpu_node_worker_rss_bytes Per-worker resident set size in bytes.")
        lines.append("# TYPE ray_tpu_node_worker_rss_bytes gauge")
        for nid, wid, pid, value in rss:
            lines.append(
                f'ray_tpu_node_worker_rss_bytes{{NodeId="{_escape(nid)}",'
                f'WorkerId="{_escape(wid)}",pid="{pid}"}} {value}'
            )
    return lines
