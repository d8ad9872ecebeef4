"""Plain-int counters for the node-to-node transfer plane.

Same discipline as ``rpc._WireStats``: every writer runs on the one IO loop
thread, so bare ``+=`` is race-free; the flush-time collector
(``self_metrics._collect_transfer_stats``) folds them into the
``ray_tpu_transfer_*`` instruments — an instrument lock per chunk would tax
the multi-MiB/s chunk stream exactly where it hurts.
"""

from __future__ import annotations


class _TransferStats:
    __slots__ = (
        "pushes",            # outbound pushes committed
        "pulls",             # pulls sealed locally
        "relays",            # cut-through relays completed (forward pre-seal)
        "bytes_out",         # chunk payload bytes sent (push + fetch responses)
        "bytes_in",          # chunk payload bytes received (pull + push sessions)
        "chunks_raw_out",    # chunks sent as raw frames
        "chunks_msgpack_out",  # chunks sent on the msgpack fallback
        "chunks_raw_in",     # chunks received as raw frames
        "chunks_msgpack_in",   # chunks received via msgpack
        "pull_sources",      # source replicas that served >=1 chunk of a pull
        "admission_stalls",  # pulls that queued on the byte budget
        "source_demotions",  # pull sources demoted after an error
    )

    def __init__(self):
        for name in self.__slots__:
            setattr(self, name, 0)


TRANSFER = _TransferStats()
