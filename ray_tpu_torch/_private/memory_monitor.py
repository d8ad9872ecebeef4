"""Node memory monitor → OOM worker killing.

Analog of the reference's memory monitor (_private/memory_monitor.py:94) and
the raylet's worker-killing policies
(worker_killing_policy_group_by_owner.h:85, retriable-FIFO policy): when node
memory passes the threshold, kill the most recently started retriable task's
worker first (its lost progress is the cheapest), falling back to the newest
busy worker. The kill surfaces as a worker death with an OOM cause, so the
owner raises OutOfMemoryError or retries per the task's policy.
"""

from __future__ import annotations

import logging
import time

logger = logging.getLogger(__name__)


def node_memory_fraction() -> float:
    """Used/total from /proc/meminfo (MemAvailable-based, like the reference's
    psutil fallback path)."""
    try:
        info = {}
        with open("/proc/meminfo") as f:
            for line in f:
                key, _, rest = line.partition(":")
                info[key] = int(rest.strip().split()[0])  # kB
        total = info.get("MemTotal", 0)
        avail = info.get("MemAvailable", info.get("MemFree", 0))
        if total <= 0:
            return 0.0
        return 1.0 - (avail / total)
    except Exception:
        return 0.0


class MemoryMonitor:
    def __init__(self, raylet):
        self.raylet = raylet
        self.cfg = raylet.cfg
        self._last_kill_ts = 0.0

    def tick(self):
        """Called from the raylet reap loop; returns the killed worker or None."""
        if not self.cfg.memory_monitor_enabled:
            return None
        frac = node_memory_fraction()
        if frac < self.cfg.memory_usage_threshold:
            return None
        # Cooldown: give the previous kill a chance to free memory.
        if time.monotonic() - self._last_kill_ts < 2.0:
            return None
        victim = self._pick_victim()
        if victim is None:
            return None
        self._last_kill_ts = time.monotonic()
        logger.warning(
            "node memory %.0f%% >= %.0f%%: killing worker %s (task %s) to relieve pressure",
            frac * 100,
            self.cfg.memory_usage_threshold * 100,
            victim.worker_id[:8],
            victim.current_task.name if victim.current_task else "?",
        )
        victim.oom_killed = True
        if victim.proc is not None:
            victim.proc.kill()
        return victim

    def _pick_victim(self):
        """Retriable tasks first, newest first (cheapest lost progress);
        then any busy worker, newest first. Actors are last resorts the
        reference also avoids — we skip them entirely."""
        busy = [
            w
            for w in self.raylet.workers.values()
            if w.state == "busy" and w.current_task is not None and w.proc is not None
        ]
        if not busy:
            return None
        retriable = [w for w in busy if w.current_task.max_retries > 0]
        pool = retriable or busy
        return max(pool, key=lambda w: w.dispatch_ts)
