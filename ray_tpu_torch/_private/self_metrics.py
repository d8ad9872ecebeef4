"""Runtime self-metrics — the ``ray_tpu_`` instrument registry.

The reference exports scheduler/store/RPC internals as first-class metrics
(src/ray/stats/metric_defs.cc) next to user-defined instruments; until this
module, our ``/metrics`` endpoint carried **only** user metrics. The
runtime components the port has (lease transport, dispatch path, object
store, RPC plane, transfer plane, actor lifecycle, GCS, Serve router and
LLM engine) feed the
instruments below through the existing ``util.metrics`` KV-flush -> ``/metrics`` path —
zero new dependencies, one namespace (``ray_tpu_*``), HELP/TYPE on every
family.

Instruments are created lazily on first use (``instruments()``); hot paths
that cannot afford an instrument lock per event (the RPC frame pump) keep
plain int counters and fold them in via a flush-time collector
(``util.metrics.register_collector``).
"""

from __future__ import annotations

import threading

# Serve latency buckets (the JAX package's dispatch-latency bounds): the
# router's assign->result and the LLM engine's TTFT / TPOT land in the
# millisecond-to-second decades.
_LATENCY_BOUNDS = [0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 1.0, 5.0]

_lock = threading.Lock()
_instruments: dict | None = None


def instruments() -> dict:
    """The process-wide ray_tpu_* instrument set (created on first call)."""
    global _instruments
    if _instruments is not None:
        return _instruments
    with _lock:
        if _instruments is not None:
            return _instruments
        from ray_tpu_torch.util import metrics as m

        inst = {
            # --- warm-lease transport (lease_manager.py) ---
            "lease_grants": m.Counter(
                "ray_tpu_lease_grants_total",
                "Worker leases granted to this owner (cold path: one raylet round trip).",
            ),
            "lease_reuses": m.Counter(
                "ray_tpu_lease_reuses_total",
                "Tasks shipped onto an already-warm lease (zero raylet RPCs).",
            ),
            "lease_tasks": m.Counter(
                "ray_tpu_lease_tasks_total",
                "Tasks shipped over the lease transport; hit ratio = reuses/tasks.",
            ),
            "lease_pool": m.Gauge(
                "ray_tpu_lease_pool_size",
                "Currently-held worker leases in this owner.",
            ),
            # --- object store arena (store/object_store.py) ---
            "store_bytes": m.Gauge(
                "ray_tpu_store_bytes_used", "Arena bytes currently allocated."
            ),
            "store_capacity": m.Gauge(
                "ray_tpu_store_capacity_bytes", "Arena capacity in bytes."
            ),
            "store_objects": m.Gauge(
                "ray_tpu_store_objects", "Objects resident in the node store."
            ),
            "store_seals": m.Counter(
                "ray_tpu_store_seals_total", "Objects sealed into the store."
            ),
            "store_spills": m.Counter(
                "ray_tpu_store_spills_total", "Objects spilled to external storage."
            ),
            "store_spilled_bytes": m.Counter(
                "ray_tpu_store_spilled_bytes_total", "Bytes spilled to external storage."
            ),
            "store_evictions": m.Counter(
                "ray_tpu_store_evictions_total",
                "Arena blocks evicted (freed after spill) under memory pressure.",
            ),
            # --- RPC plane (rpc.py WIRE counters via collector) ---
            "rpc_frames": m.Counter(
                "ray_tpu_rpc_frames_total",
                "Wire frames by direction.",
                tag_keys=("dir",),
            ),
            "rpc_bytes": m.Counter(
                "ray_tpu_rpc_bytes_total",
                "Wire bytes by direction.",
                tag_keys=("dir",),
            ),
            "rpc_connects": m.Counter(
                "ray_tpu_rpc_connects_total", "Client connections established."
            ),
            "rpc_resets": m.Counter(
                "ray_tpu_rpc_resets_total", "Client connections lost/reset."
            ),
            "rpc_hwm_stalls": m.Counter(
                "ray_tpu_rpc_write_hwm_stalls_total",
                "Writes that hit the socket write high-water mark (backpressure).",
            ),
            # --- transfer plane (push_manager.py / pull_manager.py) ---
            "transfer_bytes": m.Counter(
                "ray_tpu_transfer_bytes_total",
                "Object chunk payload bytes moved node-to-node, by direction.",
                tag_keys=("dir",),
            ),
            "transfer_chunks": m.Counter(
                "ray_tpu_transfer_chunks_total",
                "Object chunks moved node-to-node, by direction and wire "
                "framing (raw = zero-copy raw frames, msgpack = negotiated "
                "fallback).",
                tag_keys=("dir", "frame"),
            ),
            "transfer_pushes": m.Counter(
                "ray_tpu_transfer_pushes_total", "Outbound pushes committed."
            ),
            "transfer_pulls": m.Counter(
                "ray_tpu_transfer_pulls_total", "Pulls sealed into the local store."
            ),
            "transfer_relays": m.Counter(
                "ray_tpu_transfer_relays_total",
                "Cut-through broadcast relays completed (chunks forwarded "
                "downstream before the local copy sealed).",
            ),
            "transfer_pull_sources": m.Counter(
                "ray_tpu_transfer_pull_sources_total",
                "Source replicas that served chunks of a striped pull "
                "(per-pull average = this / pulls).",
            ),
            "transfer_admission_stalls": m.Counter(
                "ray_tpu_transfer_admission_stalls_total",
                "Pulls that queued on pull_admission_budget_bytes before "
                "allocating arena space.",
            ),
            "transfer_source_demotions": m.Counter(
                "ray_tpu_transfer_source_demotions_total",
                "Pull sources demoted to the back of the ranking after an "
                "error mid-transfer.",
            ),
            # --- Serve router (serve/_private/router.py) ---
            "serve_requests": m.Counter(
                "ray_tpu_serve_requests_total",
                "Requests routed to replicas.",
                tag_keys=("deployment",),
            ),
            "serve_queue_depth": m.Gauge(
                "ray_tpu_serve_router_queue_depth",
                "In-flight requests across this router's replicas.",
                tag_keys=("deployment",),
            ),
            "serve_migrations": m.Counter(
                "ray_tpu_serve_migrations_total",
                "Streaming requests migrated mid-stream to another replica "
                "after a replica death (proxy-side teacher-forced resume).",
                tag_keys=("deployment",),
            ),
            "serve_drains": m.Counter(
                "ray_tpu_serve_drains_total",
                "Replica drains completed before deliberate retirement "
                "(downscale / rolling update), by outcome.",
                tag_keys=("outcome",),
            ),
            "serve_latency": m.Histogram(
                "ray_tpu_serve_replica_latency_s",
                "Replica request latency observed at the handle (assign -> result).",
                boundaries=_LATENCY_BOUNDS,
                tag_keys=("deployment",),
            ),
            # --- continuous-batching LLM engine (serve/llm/engine.py) ---
            "serve_llm_running": m.Gauge(
                "ray_tpu_serve_llm_running_sequences",
                "Sequences occupying a decode slot in this process's engine.",
            ),
            "serve_llm_waiting": m.Gauge(
                "ray_tpu_serve_llm_waiting_sequences",
                "Prompts queued for a decode slot / KV blocks.",
            ),
            "serve_llm_kv_util": m.Gauge(
                "ray_tpu_serve_llm_kv_block_utilization",
                "Allocated fraction of the paged KV block pool (0..1; "
                "includes refs-0 prefix-cache blocks held for reuse).",
            ),
            "serve_llm_prefix_hits": m.Counter(
                "ray_tpu_serve_llm_prefix_hits_total",
                "Prompt blocks served from the prefix cache at admission "
                "(prefill skipped for those tokens).",
            ),
            "serve_llm_prefix_misses": m.Counter(
                "ray_tpu_serve_llm_prefix_misses_total",
                "Hashable prompt blocks that had to be prefilled.",
            ),
            "serve_llm_preemptions": m.Counter(
                "ray_tpu_serve_llm_preemptions_total",
                "Sequences preempted for KV blocks (recompute on readmission).",
            ),
            "serve_llm_evictions": m.Counter(
                "ray_tpu_serve_llm_prefix_evictions_total",
                "refs-0 prefix-cache blocks evicted under allocation pressure.",
            ),
            "serve_llm_handoffs": m.Counter(
                "ray_tpu_serve_llm_handoffs_total",
                "Completed prefill→decode KV handoffs (sealed payload "
                "imported on the decode side; descriptors only in-band, "
                "payloads on the direct-mailbox p2p plane).",
            ),
            "serve_llm_prefix_imports": m.Counter(
                "ray_tpu_serve_llm_prefix_imports_total",
                "Cluster-prefix-tier KV import attempts by outcome: hit "
                "(payload landed), miss (no registry row for any probed "
                "depth), error (row existed but the payload was gone or "
                "the fetch failed).",
                tag_keys=("outcome",),
            ),
            "serve_llm_ttft": m.Histogram(
                "ray_tpu_serve_llm_ttft_s",
                "Time to first token: submit -> first token emitted.",
                boundaries=_LATENCY_BOUNDS,
            ),
            "serve_llm_tpot": m.Histogram(
                "ray_tpu_serve_llm_time_per_output_token_s",
                "Per-request mean inter-token latency (first -> last token).",
                boundaries=_LATENCY_BOUNDS,
            ),
            # --- actor lifecycle (gcs.py) ---
            "actor_restarts": m.Counter(
                "ray_tpu_actor_restarts_total", "Actor restarts driven by the GCS."
            ),
            # --- GCS fan-in hardening (gcs.py) ---
            "gcs_events_dropped": m.Counter(
                "ray_tpu_gcs_events_dropped_total",
                "Task events dropped (oldest-first) by the GCS ingest ring "
                "under overload — observability degrades, liveness never "
                "does (paired with the gcs_overload flight event).",
            ),
            "locality_hits": m.Counter(
                "ray_tpu_sched_locality_hits_total",
                "Tasks placed on a node already holding their reference "
                "args (locality-aware scheduling fast path).",
            ),
        }
        m.register_collector(_collect_wire_stats)
        m.register_collector(_collect_transfer_stats)
        m.register_collector(_collect_lease_stats)
        m.register_collector(_collect_serve_llm_stats)
        _instruments = inst
    return _instruments


# Last-folded values per (source, attr): the plain-int stats objects are
# monotonic, Counters need deltas.
_folded: dict = {}


def _fold(source_key: str, stats_obj, pairs) -> None:
    """Fold monotonic plain-int attrs of a hot-path stats object into
    Counters. ``pairs`` = [(attr, counter, tags-or-None)]."""
    inst = _instruments
    if inst is None:
        return
    for attr, counter, tags in pairs:
        cur = getattr(stats_obj, attr)
        key = (source_key, attr)
        delta = cur - _folded.get(key, 0)
        if delta > 0:
            _folded[key] = cur
            counter.inc(delta, tags=tags)


def _collect_wire_stats():
    from ray_tpu_torch._private.rpc import WIRE

    inst = _instruments
    if inst is None:
        return
    _fold("wire", WIRE, [
        ("frames_out", inst["rpc_frames"], {"dir": "out"}),
        ("frames_in", inst["rpc_frames"], {"dir": "in"}),
        ("bytes_out", inst["rpc_bytes"], {"dir": "out"}),
        ("bytes_in", inst["rpc_bytes"], {"dir": "in"}),
        ("connects", inst["rpc_connects"], None),
        ("resets", inst["rpc_resets"], None),
        ("hwm_stalls", inst["rpc_hwm_stalls"], None),
    ])


def _collect_transfer_stats():
    from ray_tpu_torch._private.transfer_stats import TRANSFER

    inst = _instruments
    if inst is None:
        return
    _fold("transfer", TRANSFER, [
        ("bytes_out", inst["transfer_bytes"], {"dir": "out"}),
        ("bytes_in", inst["transfer_bytes"], {"dir": "in"}),
        ("chunks_raw_out", inst["transfer_chunks"], {"dir": "out", "frame": "raw"}),
        ("chunks_msgpack_out", inst["transfer_chunks"], {"dir": "out", "frame": "msgpack"}),
        ("chunks_raw_in", inst["transfer_chunks"], {"dir": "in", "frame": "raw"}),
        ("chunks_msgpack_in", inst["transfer_chunks"], {"dir": "in", "frame": "msgpack"}),
        ("pushes", inst["transfer_pushes"], None),
        ("pulls", inst["transfer_pulls"], None),
        ("relays", inst["transfer_relays"], None),
        ("pull_sources", inst["transfer_pull_sources"], None),
        ("admission_stalls", inst["transfer_admission_stalls"], None),
        ("source_demotions", inst["transfer_source_demotions"], None),
    ])


def _collect_lease_stats():
    from ray_tpu_torch._private.lease_manager import LEASE_STATS

    inst = _instruments
    if inst is None:
        return
    _fold("lease", LEASE_STATS, [
        ("grants", inst["lease_grants"], None),
        ("reuses", inst["lease_reuses"], None),
        ("tasks", inst["lease_tasks"], None),
    ])


def _collect_serve_llm_stats():
    import sys

    stats = sys.modules.get("ray_tpu_torch.serve.llm.stats")
    inst = _instruments
    if inst is None or stats is None:
        # No engine module in this process, so no engine ever lived here;
        # importing it would pull torch into every worker.
        return
    ENGINES, LLM = stats.ENGINES, stats.LLM
    _fold("serve_llm", LLM, [
        ("prefix_hit_blocks", inst["serve_llm_prefix_hits"], None),
        ("prefix_miss_blocks", inst["serve_llm_prefix_misses"], None),
        ("preemptions", inst["serve_llm_preemptions"], None),
        ("evicted_blocks", inst["serve_llm_evictions"], None),
        ("handoffs", inst["serve_llm_handoffs"], None),
        ("prefix_import_hits", inst["serve_llm_prefix_imports"], {"outcome": "hit"}),
        ("prefix_import_misses", inst["serve_llm_prefix_imports"], {"outcome": "miss"}),
        ("prefix_import_errors", inst["serve_llm_prefix_imports"], {"outcome": "error"}),
    ])
    engines = list(ENGINES)
    if not engines and not LLM.admitted:
        return  # no engine has ever lived in this process
    # Gauges are summed across LIVE engines at flush time (best-effort
    # plain-int reads, like LLMEngine.stats()): several engines fold into
    # one series, and once the last scheduler exits the sums — and the
    # exported gauges — honestly drop to zero instead of going stale.
    running = waiting = used = total = 0
    for eng in engines:
        running += sum(r is not None for r in eng._slots)
        waiting += len(eng._waiting)
        used += (eng.num_blocks - 1) - len(eng._free)
        total += eng.num_blocks - 1
    inst["serve_llm_running"].set(running)
    inst["serve_llm_waiting"].set(waiting)
    inst["serve_llm_kv_util"].set(used / total if total else 0.0)
