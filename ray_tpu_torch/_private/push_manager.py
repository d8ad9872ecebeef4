"""Sender-side object push manager.

Analog of the reference's PushManager
(src/ray/object_manager/push_manager.h:29): owner/holder-initiated chunked
pushes with per-destination concurrency caps and pipelined chunk RPCs, plus
receiver-side admission control (the receiver can refuse a push session when
saturated — reference: pull_manager.h:52 admission control — and the sender
backs off and retries).

A pull-only transfer path (a node fetches chunks on demand) cannot
broadcast; pushes can: the holder streams an object out without the
receiver asking, and `rpc_broadcast_object` (raylet.py) fans out over a
binomial tree so a 1 GiB broadcast to N nodes costs the root O(log N) object
sends instead of N.

The hot path has two parts:

- **Raw frames**: when the receiver's `push_begin` reply advertises
  ``raw_ok``, chunks go out as raw frames (rpc.py RAW_CHUNK) — header +
  payload memoryview straight from the arena, no msgpack encode of the
  multi-MiB ``bytes`` and no ``bytes(...)`` copy. Receivers that don't
  advertise (mixed-version peers, ``transfer_raw_frames=False``) get the
  msgpack chunks they always did.

- **Cut-through relay**: `push_begin` carries the receiver's relay subtree,
  and `stream_from_session` forwards chunks downstream AS THEY ARRIVE
  (watermark-paced, starting after the first chunk) instead of after the
  local copy seals — broadcast latency drops from O(depth × size) to
  O(size + depth × chunk). The receiver's `push_commit` response folds in
  its subtree's outcome, so failures still propagate to the root.
"""

from __future__ import annotations

import asyncio
import logging
import time

from ray_tpu_torch._private import flight_recorder
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.rpc import RAW_CHUNK, ConnectionLost
from ray_tpu_torch._private.transfer_stats import TRANSFER

logger = logging.getLogger(__name__)


def subtree_node_ids(child: dict, subtree: list) -> list[str]:
    """Every node id a failed push to `child` takes down with it."""
    return [child["node_id"]] + [t["node_id"] for t in subtree or []]


class PushManager:
    def __init__(self, raylet):
        cfg = get_config()
        self.raylet = raylet
        self.chunk = cfg.object_transfer_chunk_bytes
        self.pipeline_depth = cfg.push_pipeline_depth
        self.max_per_dest = cfg.push_max_concurrent_per_dest
        self.admission_retries = cfg.push_admission_retries
        self.raw_enabled = cfg.transfer_raw_frames
        self._dest_sems: dict[str, asyncio.Semaphore] = {}
        self._active: dict[tuple, asyncio.Future] = {}

    def stats(self) -> dict:
        return {"active_pushes": len(self._active)}

    async def push(
        self,
        object_id: str,
        node_id: str,
        address,
        relay_targets: list | None = None,
        timeout: float | None = None,
    ) -> dict:
        """Push a sealed local object to one destination node; when
        ``relay_targets`` is given the destination cut-through-relays the
        object onward to that subtree. Returns ``{"ok": bool, "failed":
        [node_ids]}`` covering the destination AND its subtree.

        Plain (no-subtree) pushes of the same object to the same node
        deduplicate; relayed pushes never do — two broadcasts may hand the
        same child different subtrees and each must deliver."""
        child = {"node_id": node_id, "address": address}
        key = (object_id, node_id)
        if not relay_targets:
            fut = self._active.get(key)
            if fut is not None:
                return await fut
            fut = asyncio.get_event_loop().create_future()
            self._active[key] = fut
        else:
            fut = None
        result = {"ok": False, "failed": subtree_node_ids(child, relay_targets)}
        try:
            result = await self._push_once(
                object_id, node_id, address, relay_targets or [], timeout
            )
        except Exception as e:
            logger.debug("push %s -> %s failed: %s", object_id[:8], node_id[:8], e)
        finally:
            # Resolve in the finally so deduplicated waiters are released even
            # if this task is CANCELLED (CancelledError skips `except
            # Exception`; an unresolved future would hang them forever).
            if fut is not None:
                self._active.pop(key, None)
                if not fut.done():
                    fut.set_result(result)
        return result

    async def _begin_session(
        self, peer, object_id: str, size: int, relay_targets: list, timeout
    ) -> dict | None:
        """Receiver admission loop; returns the accepting begin reply, a
        reply with ``already``, or None (refused after all retries).

        The loop owns ALL retrying (per-call ``retries=0``): acall's internal
        retry would multiply the caller's timeout by rpc_retries+1 behind the
        deadline check's back. Transient transport failures retry here like a
        refusal, capped at the rpc-layer's own budget."""
        req = {"object_id": object_id, "size": size}
        if relay_targets:
            req["relay_targets"] = relay_targets
        if timeout is not None:
            req["timeout"] = timeout
        deadline = None if timeout is None else time.monotonic() + timeout
        transport_failures = 0
        for attempt in range(self.admission_retries):
            per_call = None
            if deadline is not None:
                per_call = max(0.5, deadline - time.monotonic())
            try:
                begin = await peer.acall(
                    "push_begin", req, timeout=per_call, retries=0
                )
            except (ConnectionLost, asyncio.TimeoutError):
                transport_failures += 1
                if transport_failures > 3:
                    raise
                begin = {"retry_after": 0.2}
            if begin.get("already") or begin.get("accepted"):
                return begin
            delay = begin.get("retry_after", 0.1) * (1 + attempt * 0.2)
            if deadline is not None and time.monotonic() + delay >= deadline:
                return None
            await asyncio.sleep(delay)
        return None

    async def _run_session(
        self,
        peer,
        object_id: str,
        offset: int,
        size: int,
        relay_targets: list,
        timeout,
        all_failed: list,
        available=None,
        relay_child: dict | None = None,
    ) -> dict:
        """One complete push-session protocol run against `peer`: admission
        begin (already -> delegate a broadcast of the subtree to the holder),
        raw negotiation, chunk stream, commit with subtree-outcome folding,
        abort on error. Shared by direct pushes (``available=None``, offset
        of a pinned sealed object) and cut-through relays
        (``available``=watermark over the inbound session,
        ``relay_child``=the child this relay feeds)."""
        begin = await self._begin_session(peer, object_id, size, relay_targets, timeout)
        if begin is None:
            return {"ok": False, "failed": all_failed}
        if begin.get("already"):
            if not relay_targets:
                return {"ok": True, "failed": []}
            # The peer already holds a sealed copy, so no push session (and
            # no cut-through relay) exists there: ask it to fan its copy out
            # to the subtree instead.
            resp = await peer.acall(
                "broadcast_object",
                {"object_id": object_id, "targets": relay_targets,
                 "timeout": timeout},
                timeout=timeout,
            )
            return {"ok": bool(resp.get("ok")),
                    "failed": list(resp.get("failed") or [])}
        raw = bool(begin.get("raw_ok")) and self.raw_enabled
        if relay_child is not None:
            # Recorded BEFORE the stream: the whole point is that forwarding
            # starts while the local copy is still arriving.
            flight_recorder.record(
                "transfer_relay", f"{object_id[:12]}:{relay_child['node_id'][:8]}"
            )
        try:
            # The chunk stream honors the session timeout too: a receiver
            # whose process wedges with the TCP connection still alive never
            # acks and never raises ConnectionLost — without this bound the
            # push (and the broadcast above it) would hang forever.
            stream = self._stream_chunks(
                peer, object_id, offset, size, raw, available=available
            )
            if timeout is not None:
                await asyncio.wait_for(stream, timeout)
            else:
                await stream
            # retries=1 (not the default 3): the receiver remembers the
            # commit outcome (raylet._commit_results), so ONE retry after a
            # timeout/connection blip recovers the true subtree verdict
            # without multiplying the caller's timeout budget further.
            resp = await peer.acall(
                "push_commit", {"object_id": object_id}, timeout=timeout, retries=1
            )
            ok = bool(resp.get("ok"))
            if ok:
                if relay_child is not None:
                    TRANSFER.relays += 1
                else:
                    TRANSFER.pushes += 1
                    flight_recorder.record(
                        "transfer_push",
                        f"{object_id[:12]}:{size}:{'raw' if raw else 'msgpack'}",
                    )
            # The peer sealed iff commit replied at all; a non-ok commit
            # names the subtree nodes its relays missed.
            return {"ok": ok,
                    "failed": list(resp.get("failed") or ([] if ok else all_failed))}
        except BaseException:
            try:
                await peer.acall("push_abort", {"object_id": object_id})
            except Exception:
                pass
            raise

    async def _push_once(
        self, object_id: str, node_id: str, address, relay_targets: list, timeout
    ) -> dict:
        child = {"node_id": node_id, "address": address}
        all_failed = subtree_node_ids(child, relay_targets)
        sem = self._dest_sems.setdefault(node_id, asyncio.Semaphore(self.max_per_dest))
        async with sem:
            peer = self.raylet._peer(node_id, address)
            offset, size = await self.raylet.store.get(object_id)  # pins the object
            try:
                return await self._run_session(
                    peer, object_id, offset, size, relay_targets, timeout, all_failed
                )
            finally:
                self.raylet.store.release(object_id)

    async def _stream_chunks(
        self, peer, object_id: str, offset: int, size: int, raw: bool,
        available=None,
    ):
        """Pipelined chunk stream: up to pipeline_depth chunk sends in flight
        (reference paces by chunks in flight too). ``available`` is an async
        callable(pos) -> contiguous-bytes-ready used by cut-through relays
        (None = the whole object is sealed and readable)."""
        inflight = asyncio.Semaphore(self.pipeline_depth)
        tasks: list[asyncio.Future] = []

        async def send(start: int, length: int):
            try:
                view = self.raylet.arena.read(offset + start, length)
                if raw:
                    fut = await peer.astart_raw(RAW_CHUNK, object_id, start, view)
                    TRANSFER.chunks_raw_out += 1
                else:
                    fut = await peer.astart_call(
                        "push_chunk",
                        {"object_id": object_id, "start": start,
                         "data": bytes(view)},
                    )
                    TRANSFER.chunks_msgpack_out += 1
                resp = await fut
                if not resp.get("ok"):
                    raise RuntimeError(
                        f"push_chunk {object_id[:8]}@{start} refused: "
                        f"{resp.get('error', 'session lost')}"
                    )
                TRANSFER.bytes_out += length
            finally:
                inflight.release()

        try:
            pos = 0
            while pos < size:
                if available is not None:
                    avail = await available(pos)
                else:
                    avail = size
                length = min(self.chunk, avail - pos)
                await inflight.acquire()
                # Fail the stream as soon as any in-flight chunk failed
                # rather than queuing the rest behind a dead session.
                for t in tasks:
                    if t.done() and t.exception() is not None:
                        inflight.release()
                        raise t.exception()
                tasks.append(asyncio.ensure_future(send(pos, length)))
                pos += length
            await asyncio.gather(*tasks)
        except BaseException:
            for t in tasks:
                t.cancel()
            # Reap cancellations so nothing leaks into the loop's exception
            # handler after we re-raise.
            await asyncio.gather(*tasks, return_exceptions=True)
            raise

    async def stream_from_session(
        self, sess: dict, object_id: str, child: dict, subtree: list, timeout
    ) -> dict:
        """Cut-through relay: forward an INBOUND push session's bytes to one
        child (with its own subtree) as they arrive, watermark-paced. Runs on
        the receiver; started by rpc_push_begin, awaited by rpc_push_commit.
        Returns {"ok", "failed"} like push()."""

        async def available(pos: int) -> int:
            while True:
                if sess.get("aborted"):
                    raise RuntimeError("inbound push session aborted")
                if sess["contig"] > pos:
                    return sess["contig"]
                ev = sess["event"]
                ev.clear()
                # Single-threaded loop: contig cannot advance between the
                # check above and this wait, so the set cannot be lost.
                await ev.wait()

        all_failed = subtree_node_ids(child, subtree)
        peer = self.raylet._peer(child["node_id"], child["address"])
        try:
            return await self._run_session(
                peer,
                object_id,
                sess["offset"],
                sess["size"],
                subtree,
                timeout,
                all_failed,
                available=available,
                relay_child=child,
            )
        except Exception as e:
            logger.debug(
                "relay %s -> %s failed: %s", object_id[:8], child["node_id"][:8], e
            )
            return {"ok": False, "failed": all_failed}
