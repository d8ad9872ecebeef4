"""KV-block transfer plane for disaggregated LLM serving.

The port's copy of ``ray_tpu/serve/llm/kv_transfer.py``. Two movements ride
through here, both as device objects whose ~300 B descriptor travels in-band
(an HTTP envelope or a GCS registry row) while the payload moves over the
direct-mailbox p2p plane — no raylet RPC, no store object:

- **prefill->decode handoff**: a prefill-pool engine finishes a prompt,
  seals the request's KV blocks (gathered on the device into one contiguous
  tensor) as a transient channel payload, and the descriptor rides the serve
  proxy to a decode-pool replica, which imports the blocks into its own pool
  and continues generation through the teacher-forced-resumption admission
  path.
- **cluster prefix tier**: an engine publishes a hot prompt prefix's KV once
  (a sealed copy, independent of the live pool, so eviction can never tear
  an in-flight import) plus one ``llmprefix/<chain-hash>`` GCS row per
  covered depth; any engine whose local prefix cache misses imports the
  payload from the holder instead of recomputing it.

The sealed copy costs one extra copy of the published blocks on the holder's
device: the price of torn-block-free imports. Rows are last-write-wins;
retraction is read-check-delete on the object id so a retract never deletes
a newer holder's row.

Across processes the holder serializes the CUDA tensor (one device-to-host
copy, ``_private/serialization.py``), the bytes cross the direct mailbox, and
the importer rebuilds the tensor on its card. In the same process the
importer gets the holder's tensor itself, moved to its own device.
"""

from __future__ import annotations

import json
import os

import torch

from ray_tpu_torch._private.concurrency import blocking

PREFIX_ROW = "llmprefix/"


def _core_worker():
    from ray_tpu_torch._private import worker_context

    return worker_context.get_core_worker_if_initialized()


@blocking
def seal_kv_payload(cache, bids, *, kv_pos: int, block_size: int, scope: str):
    """Gather KV blocks ``bids`` (logical order) out of the paged pool into
    one contiguous tensor ``[2, L, n_blocks, block_size, KV, Dh]`` on the
    pool's device, with one ``index_select`` per K and V along the block
    axis, and register it as a transient channel payload (pins=1, held by
    the caller). Returns the wire descriptor dict, or None when no core
    worker is attached (a bare engine: disaggregation is cluster-only).

    The gather is a COPY: the sealed payload is independent of the live
    pool, so pool eviction or reuse of ``bids`` after sealing cannot corrupt
    a later import.
    """
    cw = _core_worker()
    if cw is None:
        return None
    k, v = cache["k"], cache["v"]
    idx = torch.as_tensor(list(bids), dtype=torch.long, device=k.device)
    arr = torch.empty((2, k.shape[0], len(bids), *k.shape[2:]), dtype=k.dtype, device=k.device)
    torch.index_select(k, 1, idx, out=arr[0])
    torch.index_select(v, 1, idx, out=arr[1])
    meta = cw._device_manager().create_channel_payload(arr, pins=1, scope=scope)
    return {
        "oid": meta.object_id,
        "addr": list(meta.holder_addr),
        "nbytes": int(meta.nbytes),
        "kv_pos": int(kv_pos),
        "blocks": len(bids),
        "block_size": int(block_size),
    }


@blocking
def fetch_kv_payload(desc: dict, *, timeout: float = 20.0, release: bool = False, device=None):
    """Pull a sealed KV payload to this process as a tensor ``[2, L,
    n_blocks, block_size, KV, Dh]`` on ``device`` (the importing engine's;
    None keeps the device it arrives on).

    Same-process holders resolve through the manager directly; remote
    holders get ONE ``devobj_pull`` RPC carrying a direct-mailbox reply key —
    the payload streams straight into this process's p2p inbox, no store
    seal, no host arena. Raises ``DeviceObjectLostError`` when the holder no
    longer has the object (evicted, or the holder died) — the caller's typed
    miss — and ``TimeoutError`` when the payload never lands.

    ``release=True`` drops the holder-side pin after a successful fetch
    (one-shot handoff payloads); prefix-tier payloads are multi-consumer and
    stay pinned by the publishing engine.
    """
    from ray_tpu_torch._private import serialization
    from ray_tpu_torch.exceptions import DeviceObjectLostError

    cw = _core_worker()
    if cw is None:
        raise DeviceObjectLostError(desc["oid"], msg="no core worker attached")
    oid = desc["oid"]
    addr = tuple(desc["addr"])
    if addr == tuple(cw.address):
        arr = cw._device_manager().get_local(oid)
        if arr is None:
            raise DeviceObjectLostError(oid, msg="sealed KV payload already freed")
        # A prefix payload stays the holder's; the importer reads its own view.
        out = arr if device is None else arr.to(device)
        if release:
            cw._device_manager().release_pin(oid)
        return out
    from ray_tpu_torch.util.collective.p2p import direct_recv

    key = f"llmkv/{oid[:12]}/{os.urandom(6).hex()}"
    resp = cw._devobj_client(addr).call(
        "devobj_pull",
        {"object_id": oid, "direct_key": key, "direct_addr": list(cw.address)},
        timeout=timeout,
    )
    kind = resp.get("kind")
    if kind == "missing":
        raise DeviceObjectLostError(oid, msg="sealed KV payload already freed")
    if kind == "inline":
        out = serialization.loads(resp["data"])
    elif kind == "direct":
        data = direct_recv(cw, key, timeout=timeout)
        if data is None:
            raise TimeoutError(
                f"KV payload {oid[:12]} never landed in the direct mailbox ({timeout}s; holder {addr})"
            )
        out = serialization.loads(data)
    else:
        raise DeviceObjectLostError(oid, msg=f"holder answered devobj_pull with kind={kind!r}")
    if release:
        _release_payload(cw, addr, oid)
    return out if device is None else out.to(device)


def _release_payload(cw, addr, oid: str) -> None:
    """Drop one holder-side pin, best-effort (the holder's TTL reaper is the
    backstop for lost releases)."""

    async def _rel():
        try:
            await cw._devobj_client(tuple(addr)).acall("devobj_release", {"object_id": oid})
        except Exception:
            pass

    try:
        if tuple(addr) == tuple(cw.address):
            cw._device_manager().release_pin(oid)
        else:
            cw._io.spawn(_rel())
    except Exception:
        pass


# ---- cluster prefix registry (GCS rows, devobj/<oid> state-view pattern) ----


def publish_prefix_rows(cw, hashes, desc: dict, holder_id: str) -> list[str]:
    """Write one ``llmprefix/<chain-hash>`` row per covered depth: the row at
    depth k points importers at the sealed payload's FIRST k blocks.
    Fire-and-forget (the registry is a best-effort accelerator: a lost row
    means a recompute). Returns the row keys for later retraction."""
    keys = []
    for k, h in enumerate(hashes, start=1):
        key = PREFIX_ROW + h.hex()
        row = json.dumps(
            {
                "oid": desc["oid"],
                "addr": desc["addr"],
                "holder_id": holder_id,
                "use_blocks": k,
                "total_blocks": desc["blocks"],
                "block_size": desc["block_size"],
                "nbytes": desc["nbytes"],
            }
        ).encode()

        async def _put(key=key, row=row):
            try:
                await cw.gcs.acall("kv_put", {"key": key, "value": row})
            except Exception:
                pass

        cw._io.spawn(_put())
        keys.append(key)
    return keys


def retract_prefix_rows(cw, keys, oid: str) -> list:
    """Read-check-delete each row: only rows still pointing at ``oid`` are
    removed (last-write-wins rows may already belong to a newer holder).
    Returns the spawned deletes' futures: a process about to exit waits on
    them (a replica is killed right after its engine shuts down)."""

    async def _del(key):
        try:
            got = await cw.gcs.acall("kv_get", {"key": key})
            if not got.get("found"):
                return
            if json.loads(got["value"].decode()).get("oid") != oid:
                return
            await cw.gcs.acall("kv_del", {"key": key})
        except Exception:
            pass

    futures = []
    for key in keys:
        try:
            futures.append(cw._io.spawn(_del(key)))
        except Exception:
            pass
    return futures


@blocking
def lookup_prefix_row(cw, h: bytes, *, timeout: float = 2.0):
    """Resolve a chain hash to its holder row, or None."""
    try:
        got = cw.gcs.call("kv_get", {"key": PREFIX_ROW + h.hex()}, timeout=timeout)
    except Exception:
        return None
    if not got.get("found"):
        return None
    try:
        return json.loads(got["value"].decode())
    except Exception:
        return None
