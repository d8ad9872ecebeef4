"""ray_tpu_torch.experimental.channel — shm channel plane for compiled graphs.

See README.md in this directory for the slot/doorbell protocol and its
failure semantics; ``ray_tpu_torch/dag/compiled.py`` is the main consumer.
"""

from ray_tpu_torch.experimental.channel.channel import (  # noqa: F401
    KIND_DEVICE,
    KIND_ERROR,
    KIND_VALUE,
    ChannelClosedError,
    ChannelError,
    ChannelReader,
    ChannelRegistry,
    ChannelTimeoutError,
    ChannelWriter,
    make_descriptor,
    pack_envelope,
    ring_bytes,
    unpack_envelope,
)

__all__ = [
    "ChannelError",
    "ChannelClosedError",
    "ChannelTimeoutError",
    "ChannelReader",
    "ChannelRegistry",
    "ChannelWriter",
    "KIND_DEVICE",
    "KIND_ERROR",
    "KIND_VALUE",
    "make_descriptor",
    "pack_envelope",
    "ring_bytes",
    "unpack_envelope",
]
