"""Cluster-wide object distribution utilities.

`broadcast_object` proactively replicates a plasma object to every (or a
chosen set of) alive node(s) over the raylet push plane — the user-facing
entry to the PushManager/binomial-tree path (reference internals:
src/ray/object_manager/push_manager.h:29; the reference exposes no public
API for this, but its 1-GiB-broadcast envelope test exercises the same
machinery via task arguments).

The tree is CUT-THROUGH: the relay subtree rides inside each
`push_begin`, and every level starts forwarding chunks downstream as they
arrive rather than after its local copy seals, so end-to-end latency is
O(size + depth × chunk) instead of O(depth × size); chunks ride raw frames
(zero msgpack encode/copies) whenever both ends negotiated them.

Usage:
    ref = ray_tpu_torch.put(big_array)
    ray_tpu_torch.util.object_transfer.broadcast_object(ref)   # all alive nodes
"""

from __future__ import annotations


def broadcast_object(ref, node_ids: list[str] | None = None, timeout: float = 600.0) -> int:
    """Replicate `ref`'s value into the object store of every target node.

    Returns the number of nodes newly pushed to. Raises ValueError for
    objects that never reached plasma (<= max_direct_call_object_size values
    live in the owner's in-process store; broadcasting those is meaningless).
    """
    from ray_tpu_torch._private import worker_context

    cw = worker_context.get_core_worker()
    oid = ref.hex() if hasattr(ref, "hex") else str(ref)

    locs = cw.gcs.call("get_object_locations", {"object_id": oid})["locations"]
    have = {loc["node_id"] for loc in locs}
    if not have:
        raise ValueError(
            f"object {oid[:8]} has no plasma copy (small objects live in the "
            "owner's in-process store and are shipped inline; broadcast "
            "applies to ray_tpu_torch.put() objects above the direct-call cutoff)"
        )
    nodes = cw.gcs.call("get_nodes")["nodes"]
    targets = [
        {"node_id": nid, "address": info["address"]}
        for nid, info in nodes.items()
        if info.get("state") == "ALIVE"
        and nid not in have
        and (node_ids is None or nid in node_ids)
    ]
    if not targets:
        return 0
    resp = cw.raylet.call(
        "broadcast_object", {"object_id": oid, "targets": targets, "timeout": timeout},
        timeout=timeout,
    )
    if not resp.get("ok"):
        raise RuntimeError(f"broadcast of {oid[:8]} failed: {resp.get('failed')}")
    return len(targets)
