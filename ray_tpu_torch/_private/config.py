"""Config/flag registry.

Analog of the reference's ``RAY_CONFIG`` macro registry
(src/ray/common/ray_config_def.h:22, materialised in ray_config.h:60): a single
source of truth for runtime tunables, each overridable per-process via a
``RAY_TPU_TORCH_<NAME>`` environment variable and cluster-wide via the ``_system_config``
dict handed to ``ray_tpu_torch.init``.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from dataclasses import dataclass, field, fields
from typing import Any

_ENV_PREFIX = "RAY_TPU_TORCH_"


def runtime_root() -> str:
    """Root of everything the runtime writes on a host: ``ray_tpu_torch``
    under the temporary directory that TMPDIR names."""
    return os.path.join(tempfile.gettempdir(), "ray_tpu_torch")


def _coerce(value: str, typ: type) -> Any:
    if typ is bool:
        return value.lower() in ("1", "true", "yes", "on")
    if typ is int:
        return int(value)
    if typ is float:
        return float(value)
    if typ in (dict, list):
        return json.loads(value)
    return value


@dataclass
class Config:
    """All runtime tunables. Defaults match single-host development use."""

    # --- object store ---
    object_store_memory: int = 512 * 1024 * 1024  # arena capacity per node
    object_store_min_alloc: int = 64  # smallest arena block
    # objects <= this many bytes live in the owner's in-process store and are
    # shipped inline in RPCs (reference: 100KB in-process memory store cutoff).
    max_direct_call_object_size: int = 100 * 1024
    object_transfer_chunk_bytes: int = 4 * 1024 * 1024
    object_spill_dir: str = ""  # empty -> <session_dir>/spill
    object_spill_threshold: float = 0.8  # arena fullness ratio triggering spill
    # push-side transfer (reference: push_manager.h in-flight caps,
    # pull_manager.h admission control)
    push_pipeline_depth: int = 4        # concurrent chunk RPCs per push
    push_max_concurrent_per_dest: int = 2
    push_max_inbound: int = 8           # receiver-side concurrent push sessions
    push_admission_retries: int = 50    # sender retries while receiver is saturated
    # pull-side transfer (pull_manager.py; reference: pull_manager.h:52)
    pull_pipeline_depth: int = 4        # concurrent chunk RPCs per pull, per source
    pull_max_sources: int = 4           # replicas a single pull stripes across
    # Aggregate byte cap across concurrent inbound pulls on a node: past it,
    # new pulls queue (admission_stall flight event) instead of over-
    # committing the arena. A pull larger than the whole budget still admits
    # alone. 0 = unbounded.
    pull_admission_budget_bytes: int = 256 * 1024 * 1024
    # Raw-frame wire path for chunk transfer (rpc.py RAW_*): headers+payload
    # straight from/into the arena, no msgpack encode of multi-MiB bytes.
    # Negotiated per session; disabling forces the msgpack fallback
    # everywhere.
    transfer_raw_frames: bool = True

    # --- scheduling / raylet ---
    worker_lease_timeout_s: float = 30.0
    # Direct task transport (lease_manager.py): owners lease workers and ship
    # normal tasks straight to them, bypassing per-task raylet round trips
    # (reference: direct_task_transport.cc lease pipelining).
    direct_task_leases: bool = True
    lease_max_inflight: int = 32   # specs in flight per leased worker
    lease_max_per_shape: int = 8   # concurrent leases per (env, resources)
    lease_idle_release_s: float = 0.5  # linger before returning an idle lease
    worker_idle_timeout_s: float = 300.0  # idle workers kept warm for reuse
    # Lost-task sweep (core_worker._sweep_lost_tasks): raylet-path specs can
    # die WITH a spilled-to node; owners locate aged pending tasks across
    # alive raylets and resubmit ones held by nobody.
    lost_task_sweep_interval_s: float = 15.0
    lost_task_age_s: float = 30.0
    max_workers_per_node: int = 64
    worker_startup_timeout_s: float = 60.0
    scheduler_spread_threshold: float = 0.5  # hybrid policy pack->spread knob
    prestart_workers: int = 0
    # Fork-server worker spawn (zygote.py): turns per-worker interpreter boot
    # (~200ms of CPU) into a few-ms fork. Auto-disabled on nodes holding a
    # GPU resource (a CUDA context does not survive a fork).
    worker_zygote_enabled: bool = True

    # --- scheduling: data locality (reference: the Ray paper's
    # data-locality-aware placement claim; locality_aware_scheduling in
    # scheduling_policy.h) ---
    # Prefer nodes already holding a task's reference (plasma-sized) args —
    # inline args are below max_direct_call_object_size by construction, so
    # reference args ARE the large ones. Off = the measured no-locality
    # baseline arm.
    locality_aware_scheduling: bool = True
    # Raylet-side object-location cache for locality lookups (bounded, TTL):
    # one GCS round trip per arg per TTL window, not per task.
    locality_cache_ttl_s: float = 3.0
    # At most this many reference args consulted per task.
    locality_max_args: int = 8

    # --- health / failure detection ---
    heartbeat_interval_s: float = 0.5
    node_death_timeout_s: float = 5.0
    health_check_failure_threshold: int = 5
    # Versioned delta cluster-view sync on heartbeat replies: raylets send
    # their last seen view version and receive only changed rows + removal
    # tombstones (full O(N) view only on resync). Off = legacy full-view
    # replies — the measured "before" arm for the scale bench.
    heartbeat_delta_sync: bool = True
    # Jittered exponential backoff before a raylet re-registers in _rejoin:
    # a GCS restart or mass partition-heal otherwise makes every raylet
    # re-register in the same heartbeat interval (thundering herd).
    rejoin_backoff_base_s: float = 0.05
    rejoin_backoff_max_s: float = 2.0

    # --- GCS fan-in hardening ---
    # Per-node reverse index over object locations: node death touches only
    # that node's rows instead of scanning the whole directory. Off = legacy
    # full scan (bench baseline arm).
    gcs_location_index: bool = True

    # After a GCS restart, wait this long for in-flight actor creations on
    # surviving raylets to land before re-driving PENDING creations.
    gcs_actor_recovery_grace_s: float = 2.0

    # --- memory monitor (reference: memory_monitor.py:94 + raylet worker
    # killing policies worker_killing_policy*.h) ---
    memory_monitor_enabled: bool = True
    # Node memory fraction above which the raylet kills a task worker to
    # relieve pressure; the killed task retries elsewhere/later.
    memory_usage_threshold: float = 0.95
    memory_monitor_interval_s: float = 1.0

    # --- RPC ---
    rpc_connect_timeout_s: float = 10.0
    rpc_retries: int = 3
    # acall retry pacing: capped exponential backoff (base * 2^(attempt-1),
    # capped at max) with a [0.5, 1.0) jitter factor — a partitioned or
    # recovering peer is probed at a decaying, decorrelated rate instead of
    # the old fixed-pause hammering. retries=0 callers are unaffected.
    rpc_retry_backoff_base_ms: float = 100.0
    rpc_retry_backoff_max_ms: float = 2000.0
    # Bounded wait for the ack of a one-way completion report
    # (task_done/tasks_done send_nowait frames): a silently lost frame —
    # receiver dropped it — re-delivers through the acked
    # retrying path (owner dedupes by cid) instead of hanging the owner's
    # get() until the lost-task sweep (or forever, on the lease path).
    task_done_ack_timeout_s: float = 10.0

    # --- tasks / actors ---
    default_max_retries: int = 3
    default_actor_max_restarts: int = 0
    actor_call_queue_depth: int = 10_000
    # Calls to an actor still being created buffer this long (creation =
    # worker spawn + user __init__, slow under load) before giving up.
    actor_creation_timeout_s: float = 180.0

    # --- flight recorder (always-on observability; flight_recorder.py) ---
    # Ring capacity in events per process. The ring is mmap-backed under
    # <session_dir>/flight/ so a SIGKILLed process's final events survive.
    # Disable with RAY_TPU_TORCH_FLIGHT_RECORDER=0.
    flight_ring_slots: int = 4096

    # --- logging / events ---
    log_to_driver: bool = True
    event_stats: bool = True
    task_events_buffer_size: int = 10_000
    task_events_enabled: bool = True
    task_events_flush_interval_s: float = 1.0

    # --- metrics ---
    metrics_flush_interval_s: float = 5.0

    # --- compiled-graph channel plane (experimental/channel/) ---
    # Blocked channel readers are woken by the producer's doorbell frame;
    # this is the FALLBACK re-poll cap for a lost doorbell. Readers back off
    # exponentially from a few ms up to this cap while idle, and a doorbell
    # always wakes them at once. Env: RAY_TPU_TORCH_CHANNEL_POLL_INTERVAL_MS.
    channel_poll_interval_ms: int = 50

    # --- collectives ---
    collective_rendezvous_timeout_s: float = 60.0

    # --- device object plane (experimental/device_object/) ---
    # Per-process ceiling on device-resident object bytes; past it the
    # holder spills LRU tensors device->host into the shm arena (restored
    # on the next local resolve). 0 = no ceiling.
    # Env: RAY_TPU_TORCH_DEVOBJ_RESIDENT_LIMIT_BYTES.
    devobj_resident_limit_bytes: int = 0

    # --- misc ---
    # Sessions, the driver's logs and default results live under the
    # process's temporary directory (TMPDIR), never at a fixed path.
    session_dir_root: str = field(default_factory=runtime_root)

    def apply_overrides(self, system_config: dict | None = None) -> None:
        """Env vars take precedence over _system_config, which beats defaults."""
        if system_config:
            for key, value in system_config.items():
                if not hasattr(self, key):
                    raise ValueError(f"Unknown system config key: {key}")
                setattr(self, key, value)
        for f in fields(self):
            env = os.environ.get(_ENV_PREFIX + f.name.upper())
            if env is not None:
                setattr(self, f.name, _coerce(env, f.type if isinstance(f.type, type) else type(getattr(self, f.name))))

    def to_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}


_config_lock = threading.Lock()
_config: Config | None = None


def get_config() -> Config:
    global _config
    with _config_lock:
        if _config is None:
            _config = Config()
            _config.apply_overrides()
        return _config


def init_config(system_config: dict | None = None) -> Config:
    global _config
    with _config_lock:
        _config = Config()
        _config.apply_overrides(system_config)
        return _config
