"""Log pipeline: per-worker log files → GCS pubsub → driver stdout.

Analog of the reference's LogMonitor (python/ray/_private/log_monitor.py:102)
+ the driver-side print redirection (_private/worker.py print_logs): the
raylet tails every worker's stdout/stderr file and publishes new lines on the
``worker_logs`` channel; each driver subscribes and echoes lines belonging to
its job, prefixed ``({name} pid=..., node=...)`` like the reference.
"""

from __future__ import annotations

import asyncio
import glob
import logging
import os

logger = logging.getLogger(__name__)

MAX_LINES_PER_TICK = 200
MAX_LINE_LEN = 20_000


class LogMonitor:
    """Raylet-side tailer. Runs as an asyncio task on the raylet loop."""

    def __init__(self, raylet):
        self.raylet = raylet
        self.log_dir = os.path.join(raylet.session_dir, "logs")
        # path -> read offset
        self._offsets: dict[str, int] = {}

    @staticmethod
    def _read_chunk(path: str, offset: int, length: int):
        """Executor-side file read (None when the file vanished mid-tick)."""
        try:
            with open(path, "rb") as f:
                f.seek(offset)
                return f.read(length)
        except OSError:
            return None

    def _worker_for(self, path: str):
        """Map worker-<wid8>.out/.err to the raylet's worker handle."""
        base = os.path.basename(path)
        if not base.startswith("worker-"):
            return None
        wid8 = base[len("worker-") :].split(".")[0]
        for wid, w in self.raylet.workers.items():
            if wid.startswith(wid8):
                return w
        return None

    async def run(self):
        while True:
            try:
                await self._tick()
            except asyncio.CancelledError:
                return
            except Exception:
                logger.debug("log monitor tick failed", exc_info=True)
            await asyncio.sleep(0.3)

    async def _tick(self):
        for path in glob.glob(os.path.join(self.log_dir, "worker-*.out")) + glob.glob(
            os.path.join(self.log_dir, "worker-*.err")
        ):
            try:
                size = os.path.getsize(path)
            except OSError:
                continue
            # Attribution snapshot BEFORE reading: lines already in the file
            # were written under the job active up to now; a task dispatched
            # mid-tick must not claim them.
            worker = self._worker_for(path)
            offset = self._offsets.get(path, 0)
            if size <= offset:
                continue
            # Off-loop read: up to 1 MiB of file IO per path per tick would
            # otherwise stall every RPC on the raylet's loop (graftlint:
            # blocking/file-io-in-async).
            chunk = await asyncio.get_event_loop().run_in_executor(
                None, self._read_chunk, path, offset, min(size - offset, 1 << 20)
            )
            if chunk is None:
                continue
            # Only consume complete lines; partial tail re-read next tick.
            last_nl = chunk.rfind(b"\n")
            if last_nl < 0:
                if len(chunk) < MAX_LINE_LEN:
                    continue
                last_nl = len(chunk) - 1
            raw_lines = chunk[: last_nl + 1].splitlines(keepends=True)
            if len(raw_lines) > MAX_LINES_PER_TICK:
                # Publish a bounded batch and only advance the offset past
                # what was published — the rest is re-read next tick, never
                # silently dropped.
                raw_lines = raw_lines[:MAX_LINES_PER_TICK]
                consumed = sum(len(l) for l in raw_lines)
            else:
                consumed = last_nl + 1
            self._offsets[path] = offset + consumed
            lines = [l.decode(errors="replace").rstrip("\r\n")[:MAX_LINE_LEN] for l in raw_lines]
            if not lines:
                continue
            # Leased workers execute tasks the raylet never sees
            # individually, so attribution rides IN-BAND: the worker emits
            # "\x01attr:<job>:<task-name>" when its current task changes
            # (core_worker.execute_task) and the batch splits there.
            cur_name = getattr(worker, "last_task_name", None) if worker else None
            cur_job = getattr(worker, "last_job_id", None) if worker else None
            segments: list = []
            cur: list = []
            for line in lines:
                if line.startswith("\x01attr:"):
                    if cur:
                        segments.append((cur, cur_name, cur_job))
                        cur = []
                    parts = line[len("\x01attr:"):].split(":", 1)
                    if len(parts) == 2:
                        cur_job, cur_name = parts[0] or cur_job, parts[1]
                        if worker is not None:
                            worker.last_job_id = cur_job
                            worker.last_task_name = cur_name
                    continue
                cur.append(line)
            if cur:
                segments.append((cur, cur_name, cur_job))
            for seg_lines, name, job in segments:
                message = {
                    "lines": seg_lines,
                    "is_err": path.endswith(".err"),
                    "pid": worker.pid if worker else 0,
                    "node_id": self.raylet.node_id,
                    "job_id": job,
                    "name": name,
                }
                try:
                    await self.raylet.gcs.acall(
                        "publish", {"channel": "worker_logs", "message": message}
                    )
                except Exception:
                    pass


def print_worker_logs(message: dict, own_job_id: str):
    """Driver-side: echo a worker_logs message if it belongs to this job."""
    import sys

    job = message.get("job_id")
    if job is not None and job != own_job_id:
        return
    if job is None and not message.get("is_err"):
        # Unattributed stdout (e.g. prestarted worker chatter) would leak to
        # every driver; only unattributed STDERR (startup crashes) fans out.
        return
    name = message.get("name") or "worker"
    prefix = f"({name} pid={message.get('pid')}, node={str(message.get('node_id'))[:8]})"
    stream = sys.stderr if message.get("is_err") else sys.stdout
    for line in message.get("lines", []):
        print(f"{prefix} {line}", file=stream)
    try:
        stream.flush()
    except Exception:
        pass
