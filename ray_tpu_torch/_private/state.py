"""GlobalState — cluster introspection backed by the GCS.

Analog of the reference's ``python/ray/_private/state.py``
(GlobalStateAccessor-backed): node/actor/placement-group/job tables, the
task-event log, and the Chrome-trace timeline dump
(reference: state.py:416 ``chrome_tracing_dump``, API ``timeline()``).
"""

from __future__ import annotations

import json

from ray_tpu_torch._private import worker_context
from ray_tpu_torch._private.rpc import RpcClient


class GlobalState:
    """Reads cluster state over GCS RPCs. Usable from a connected driver
    (default) or standalone against an explicit GCS address."""

    def __init__(self, gcs_address=None):
        if gcs_address is not None:
            if isinstance(gcs_address, str):
                host, port = gcs_address.rsplit(":", 1)
                gcs_address = (host, int(port))
            self._gcs = RpcClient(tuple(gcs_address), label="state-gcs")
            self._owns_client = True
        else:
            self._gcs = worker_context.get_core_worker().gcs
            self._owns_client = False

    # ---- tables ----

    def nodes(self) -> list[dict]:
        resp = self._gcs.call("get_nodes")
        return list(resp["nodes"].values())

    def actors(self) -> list[dict]:
        return self._gcs.call("list_actors").get("actors", [])

    def placement_groups(self) -> list[dict]:
        return self._gcs.call("list_placement_groups").get("placement_groups", [])

    def jobs(self) -> list[dict]:
        return self._gcs.call("list_jobs").get("jobs", [])

    def task_events(self, limit: int = 10_000) -> list[dict]:
        return self._gcs.call("get_task_events", {"limit": limit}).get("events", [])

    def node_state(self, node: dict) -> dict:
        """Live per-raylet state (resources, workers, store usage)."""
        client = RpcClient(tuple(node["address"]), label="state-raylet")
        try:
            return client.call("get_state")
        finally:
            client.close()

    def cluster_resources(self) -> dict:
        total: dict[str, float] = {}
        for node in self.nodes():
            if node.get("state") != "ALIVE":
                continue
            for k, v in (node.get("resources_total") or {}).items():
                total[k] = total.get(k, 0) + v
        return total

    def available_resources(self) -> dict:
        avail: dict[str, float] = {}
        for node in self.nodes():
            if node.get("state") != "ALIVE":
                continue
            for k, v in (node.get("resources_available") or {}).items():
                avail[k] = avail.get(k, 0) + v
        return avail

    # ---- flight recorder ----

    def flight_recorder_dump(self) -> list[dict]:
        """Cluster-wide flight-recorder collection: every alive raylet's
        ``debug_dump`` returns all rings on its node (scanned from the mmap
        files, so SIGKILLed processes' final events are included), merged
        into one stream ordered by stamp."""
        from ray_tpu_torch._private.flight_recorder import merge_events

        processes: list[dict] = []
        seen: set = set()
        for node in self.nodes():
            if node.get("state") != "ALIVE" or not node.get("address"):
                continue
            client = RpcClient(tuple(node["address"]), label="debug-raylet")
            try:
                resp = client.call("debug_dump", {}, timeout=10)
                for proc in resp.get("processes", []):
                    # Same-host clusters (cluster_utils.Cluster) share one
                    # session dir across raylets, so every raylet's scan
                    # returns every ring — dedupe by process identity or an
                    # N-raylet cluster reports each event N times.
                    key = (proc.get("pid"), proc.get("role"), proc.get("ident"))
                    if key in seen:
                        continue
                    seen.add(key)
                    proc["node_id"] = resp.get("node_id")
                    processes.append(proc)
            except Exception:
                continue
            finally:
                client.close()
        return merge_events(processes)

    # ---- timeline ----

    def chrome_tracing_dump(
        self,
        filename: str | None = None,
        flight_events: list[dict] | None = None,
    ) -> list[dict]:
        """Convert the GCS task-event log into Chrome trace-event JSON
        (open in chrome://tracing or Perfetto). ``flight_events`` (from
        flight_recorder_dump) render as instant events per process/role."""
        events = self.task_events()
        trace: list[dict] = []
        seen_procs: set[tuple] = set()
        for ev in events:
            pid = ev.get("node_id", "?")[:8]
            tid = ev.get("worker_id", "?")[:8]
            if (pid, tid) not in seen_procs:
                seen_procs.add((pid, tid))
                trace.append(
                    {
                        "name": "thread_name",
                        "ph": "M",
                        "pid": pid,
                        "tid": tid,
                        "args": {"name": f"worker:{tid}"},
                    }
                )
            state = ev.get("state")
            if state in ("FINISHED", "FAILED") and "start_ts" in ev:
                start = ev["start_ts"]
                end = ev.get("end_ts", ev["ts"])
                trace.append(
                    {
                        "name": ev.get("name", "task"),
                        "cat": "task",
                        "ph": "X",
                        "ts": start * 1e6,
                        "dur": max(end - start, 0) * 1e6,
                        "pid": pid,
                        "tid": tid,
                        "cname": "thread_state_runnable"
                        if state == "FINISHED"
                        else "terrible",
                        "args": {
                            "task_id": ev.get("task_id"),
                            "state": state,
                            "job_id": ev.get("job_id"),
                        },
                    }
                )
        if flight_events:
            for ev in flight_events:
                trace.append(
                    {
                        "name": ev.get("type", "event"),
                        "cat": "flight",
                        "ph": "i",
                        "s": "t",  # thread-scoped instant
                        "ts": ev["ts"] * 1e6,
                        "pid": f"flight:{ev.get('role', '?')}",
                        "tid": str(ev.get("pid", "?")),
                        "args": {"detail": ev.get("detail", ""), "seq": ev.get("seq")},
                    }
                )
        if filename:
            with open(filename, "w") as f:
                json.dump(trace, f)
        return trace

    def close(self):
        if self._owns_client:
            self._gcs.close()


def timeline(filename: str | None = None) -> list[dict]:
    """Dump a Chrome-trace timeline of executed tasks (reference:
    ``ray.timeline``, python/ray/_private/state.py:831)."""
    cw = worker_context.get_core_worker()
    cw.flush_task_events()
    return GlobalState().chrome_tracing_dump(filename)
