"""Receiver-side object pull manager.

Analog of the reference's PullManager
(src/ray/object_manager/pull_manager.h:52). A plain pull path fetches
chunks strictly serially from whichever location the GCS listed first and
retries the same ordering after a failure; this manager adds:

- **Pipelined chunk requests**: up to ``pull_pipeline_depth`` fetches in
  flight per source (the push plane's pacing, mirrored).
- **Striping**: when >1 replica exists, chunks round-robin across up to
  ``pull_max_sources`` sources, so a pull drains multiple NICs instead of
  one.
- **Ranked failover**: a source that errors is demoted (timestamped, sorted
  last on the next ranking) and the failed chunk immediately retries on the
  next healthy source — a SIGKILLed replica mid-pull costs one chunk
  timeout, not the pull.
- **Admission control**: concurrent pulls acquire from an aggregate byte
  budget (``pull_admission_budget_bytes``) before allocating arena space;
  past it they queue (``admission_stall`` flight event) instead of
  over-committing the arena. A pull larger than the whole budget still
  admits alone so it cannot deadlock.
- **Raw frames**: chunk requests carry ``raw=True``; a capable source
  answers with a raw frame whose payload the client-side sink scatters
  straight into the arena at ``offset+start`` — no msgpack decode, no
  intermediate ``bytes``. Sources that answer in msgpack (mixed-version)
  are handled transparently per response.
"""

from __future__ import annotations

import asyncio
import logging
import time

from ray_tpu_torch._private import flight_recorder
from ray_tpu_torch._private.concurrency import any_thread, loop_only
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.transfer_stats import TRANSFER

logger = logging.getLogger(__name__)

# Per-attempt ceiling on one chunk RPC: long enough for a multi-MiB chunk on
# a congested link, short enough that a hung source — or a silently lost
# chunk request/reply — costs one bounded stall before the chunk fails over
# to the next healthy replica (the 30s it used to be meant one lost frame
# ate most of a caller's pull budget before failover even started).
_CHUNK_TIMEOUT_S = 10.0

# A demotion stamp this old no longer counts against a source: one transient
# error during startup congestion must not derank (or, with more replicas
# than pull_max_sources, permanently EXCLUDE) a healthy replica forever, and
# pruning aged stamps keeps the penalty table from growing one entry per
# ever-demoted node over a long-lived raylet.
_PENALTY_DECAY_S = 60.0


class PullManager:
    def __init__(self, raylet):
        cfg = get_config()
        self.raylet = raylet
        self.chunk = cfg.object_transfer_chunk_bytes
        self.pipeline_depth = cfg.pull_pipeline_depth
        self.max_sources = max(1, cfg.pull_max_sources)
        self.budget = cfg.pull_admission_budget_bytes
        self.raw_enabled = cfg.transfer_raw_frames
        self._inflight: dict[str, asyncio.Future] = {}
        self._admitted = 0
        self._admit_event = asyncio.Event()
        # node_id -> monotonic stamp of the last transfer error: ranking
        # sorts ascending, so clean sources lead and the most recent
        # offender goes last (demoted, not retried first).
        self._penalty: dict[str, float] = {}

    @any_thread
    def inflight_ids(self) -> set[str]:
        return set(self._inflight)

    @any_thread
    def stats(self) -> dict:
        return {
            "active_pulls": len(self._inflight),
            "admitted_bytes": self._admitted,
            "demoted_sources": len(self._penalty),
        }

    @loop_only
    def _demote(self, node_id: str):
        self._penalty[node_id] = time.monotonic()
        TRANSFER.source_demotions += 1
        flight_recorder.record("pull_source_demoted", node_id[:12])

    def _rank(self, locs: list) -> list:
        cutoff = time.monotonic() - _PENALTY_DECAY_S
        for nid, ts in list(self._penalty.items()):
            if ts < cutoff:
                del self._penalty[nid]
        return sorted(locs, key=lambda l: self._penalty.get(l["node_id"], 0.0))

    # ---- admission (the pull_manager.h:52 byte budget) ----

    async def _admit(self, object_id: str, size: int, deadline: float) -> bool:
        """Acquire `size` bytes of the aggregate pull budget; returns whether
        a reservation was actually taken (budget disabled -> False)."""
        if self.budget <= 0:
            return False
        if self._admitted and self._admitted + size > self.budget:
            TRANSFER.admission_stalls += 1
            flight_recorder.record("admission_stall", f"{object_id[:12]}:{size}")
        while self._admitted and self._admitted + size > self.budget:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"pull of {object_id} timed out waiting for admission "
                    f"({self._admitted}/{self.budget} bytes committed)"
                )
            self._admit_event.clear()
            # Single-threaded loop: _admitted cannot change between the
            # while-check and this wait, so a release cannot be lost.
            try:
                await asyncio.wait_for(self._admit_event.wait(), remaining)
            except asyncio.TimeoutError:
                continue  # re-check -> raises above
        self._admitted += size
        return True

    @loop_only
    def _release_admission(self, size: int):
        self._admitted -= size
        self._admit_event.set()

    # ---- the pull itself ----

    async def pull(self, object_id: str, timeout: float | None) -> bool:
        """Fetch `object_id` into the local store; concurrent callers for the
        same object coalesce onto one pull."""
        fut = self._inflight.get(object_id)
        if fut is not None:
            await fut
            return True
        fut = asyncio.get_event_loop().create_future()
        self._inflight[object_id] = fut
        try:
            deadline = time.monotonic() + (timeout if timeout is not None else 3600.0)
            poll = 0.02
            while time.monotonic() < deadline:
                if self.raylet.store.contains(object_id):
                    # A local task (or inbound push) produced AND SEALED it
                    # while we were looking remotely; an unsealed rival
                    # session doesn't count — it may still be aborted.
                    fut.set_result(True)
                    return True
                resp = await self.raylet.gcs.acall(
                    "get_object_locations", {"object_id": object_id}
                )
                locs = [
                    l for l in resp["locations"] if l["node_id"] != self.raylet.node_id
                ]
                if not locs:
                    await asyncio.sleep(poll)
                    poll = min(poll * 1.5, 0.5)
                    continue
                if await self._attempt(object_id, locs, deadline):
                    fut.set_result(True)
                    return True
                await asyncio.sleep(0.05)
            raise TimeoutError(f"pull of {object_id} timed out")
        except BaseException as e:
            if not fut.done():
                fut.set_exception(e)
            raise
        finally:
            self._inflight.pop(object_id, None)
            if not fut.done():
                fut.set_result(False)

    async def _attempt(self, object_id: str, locs: list, deadline: float) -> bool:
        """One pull attempt over the current location set; False = retry
        after the outer loop refreshes locations."""
        ranked = self._rank(locs)[: self.max_sources]
        infos = await asyncio.gather(
            *(
                self.raylet._peer(loc["node_id"], loc["address"]).acall(
                    "fetch_object_info",
                    {"object_id": object_id},
                    timeout=10,
                    retries=0,
                )
                for loc in ranked
            ),
            return_exceptions=True,
        )
        sources, size = [], None
        for loc, info in zip(ranked, infos):
            if isinstance(info, Exception):
                self._demote(loc["node_id"])
            elif info.get("found"):
                sources.append(loc)
                size = info["size"]
        if not sources:
            return False
        admitted = await self._admit(object_id, size, deadline)
        try:
            offset = await self.raylet.store.create(object_id, size)
            if offset is None:
                # Rival creator appeared during create: sealed -> done;
                # unsealed -> let the outer loop wait for it to resolve.
                return self.raylet.store.contains(object_id)
            # Liveness token for this attempt's raw sinks: once the attempt
            # ends (seal OR abort) a straggling raw response must not write
            # through the captured offset — after an abort the block may
            # already belong to another object (defense in depth on top of
            # rpc.acall unregistering sinks on per-attempt timeout).
            live = {"ok": True}
            try:
                used = await self._fetch_striped(
                    object_id, offset, size, sources, live
                )
            except Exception as e:
                logger.debug("pull attempt for %s failed: %s", object_id[:8], e)
                live["ok"] = False
                self.raylet.store.abort(object_id)
                return False
            finally:
                live["ok"] = False
            self.raylet.store.seal(object_id)
            await self.raylet.gcs.acall(
                "add_object_location",
                {"object_id": object_id, "node_id": self.raylet.node_id},
            )
            TRANSFER.pulls += 1
            TRANSFER.pull_sources += len(used)
            flight_recorder.record(
                "transfer_pull", f"{object_id[:12]}:{size}:{len(used)}src"
            )
            return True
        finally:
            if admitted:
                self._release_admission(size)

    async def _fetch_striped(
        self, object_id: str, offset: int, size: int, sources: list, live: dict
    ) -> set:
        """Fetch all chunks, striped round-robin across `sources` with
        pipeline_depth requests in flight per source; failed sources demote
        and their chunks fail over to the remaining healthy ones. Returns
        the node ids that served at least one chunk."""
        healthy = list(sources)
        sems = {
            loc["node_id"]: asyncio.Semaphore(self.pipeline_depth) for loc in sources
        }
        used: set[str] = set()

        def next_source(idx: int, tried: set):
            if not healthy:
                return None
            shift = idx % len(healthy)
            for src in healthy[shift:] + healthy[:shift]:
                if src["node_id"] not in tried:
                    return src
            return None

        async def fetch(idx: int, start: int):
            length = min(self.chunk, size - start)
            tried: set[str] = set()
            while True:
                src = next_source(idx, tried)
                if src is None:
                    raise RuntimeError(
                        f"chunk {object_id[:8]}@{start}: all sources failed"
                    )
                nid = src["node_id"]
                peer = self.raylet._peer(nid, src["address"])
                try:
                    async with sems[nid]:
                        payload = {
                            "object_id": object_id,
                            "start": start,
                            "length": length,
                        }
                        sink = None
                        if self.raw_enabled:
                            payload["raw"] = True

                            def sink(frame, _start=start, _length=length):
                                # Scatter straight into the arena while the
                                # frame's buffer view is valid — the one and
                                # only copy on the receive side.
                                if not live["ok"]:
                                    # Attempt already sealed/aborted; the
                                    # captured offset may be reused memory.
                                    raise ValueError("stale chunk response")
                                if frame.start != _start or len(frame.payload) > _length:
                                    raise ValueError("raw chunk out of bounds")
                                self.raylet.arena.write(
                                    offset + _start, frame.payload
                                )
                                TRANSFER.chunks_raw_in += 1
                                return {"len": len(frame.payload), "raw": True}

                        resp = await peer.acall(
                            "fetch_object_chunk",
                            payload,
                            timeout=_CHUNK_TIMEOUT_S,
                            retries=0,
                            raw_sink=sink,
                        )
                        if resp.get("raw"):
                            got = resp["len"]
                        else:
                            data = resp["data"]  # msgpack fallback path
                            self.raylet.arena.write(offset + start, data)
                            TRANSFER.chunks_msgpack_in += 1
                            got = len(data)
                        if got != length:
                            raise RuntimeError(f"short chunk: {got} != {length}")
                        TRANSFER.bytes_in += length
                        used.add(nid)
                        # A served chunk is proof of health: clear any stale
                        # demotion so the next ranking treats it as clean.
                        self._penalty.pop(nid, None)
                        return
                except Exception as e:
                    tried.add(nid)
                    self._demote(nid)
                    if src in healthy:
                        healthy.remove(src)
                    logger.debug(
                        "chunk %s@%d from %s failed (%s); failing over",
                        object_id[:8], start, nid[:8], e,
                    )

        tasks = [
            asyncio.ensure_future(fetch(i, start))
            for i, start in enumerate(range(0, size, self.chunk))
        ]
        try:
            await asyncio.gather(*tasks)
        except BaseException:
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            raise
        return used
