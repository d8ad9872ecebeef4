"""DeviceObjectMeta — the small descriptor that rides the normal store.

From ``ray_tpu/experimental/device_object/descriptor.py``; ``dtype`` is
torch's dtype name ("bfloat16") and ``sharding`` the tensor's device
("cuda:0").

A device object's ObjectRef resolves (via get / task-arg resolution) to one
of these instead of the payload; ``resolve.py`` then turns it back into the
live array out of band. The descriptor must stay cheap to pickle and must
import neither torch nor the core worker — it crosses process boundaries
inside ordinary object payloads.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

# Valid values for the ``tensor_transport=`` option. "collective" is the
# only transport today (group p2p with host-shm fallback); the name is the
# reference's, so code written against Ray's GPU-objects direction ports
# unchanged.
TENSOR_TRANSPORTS = ("collective",)


def validate_transport(transport) -> str:
    if transport not in TENSOR_TRANSPORTS:
        raise ValueError(
            f"tensor_transport must be one of {TENSOR_TRANSPORTS}, got {transport!r}"
        )
    return transport


@dataclass
class DeviceObjectMeta:
    """Everything a consumer needs to locate and reassemble the payload."""

    object_id: str  # hex — same id as the ObjectRef wrapping this descriptor
    shape: tuple
    dtype: str
    nbytes: int
    transport: str
    # Holder process: core-worker RPC address + a human-meaningful identity
    # (actor id for actors, worker/driver id otherwise) for error messages.
    holder_addr: tuple
    holder_id: str
    holder_kind: str = "driver"  # driver | worker | actor
    # The tensor's device ("cuda:0", "cpu"); a consumer's copy lands on the
    # same device index through serialization's tensor reducer.
    sharding: str = ""
    # [(group_name, rank, world_size)] of collective groups the holder had
    # initialized at create time; a consumer sharing one transfers over it.
    group_hints: list = field(default_factory=list)
    created_ts: float = field(default_factory=time.time)

    def holder_label(self) -> str:
        return f"{self.holder_kind} {self.holder_id[:16]} @ {self.holder_addr}"
