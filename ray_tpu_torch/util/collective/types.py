"""Collective types (analog of python/ray/util/collective/types.py; from
``ray_tpu/util/collective/types.py``)."""

from __future__ import annotations

import enum


class ReduceOp(enum.Enum):
    SUM = "sum"
    PRODUCT = "product"
    MIN = "min"
    MAX = "max"
    MEAN = "mean"


class Backend:
    CPU = "cpu"  # host ring over the GCS KV and the p2p plane (any tensor, numpy)
    NCCL = "nccl"  # a torch.distributed NCCL group on CUDA tensors (the JAX package's "tpu")
    GLOO = "gloo"  # the same torch.distributed group class on CPU tensors

    @staticmethod
    def validate(backend: str) -> str:
        if backend in ("tpu", "xla", "ici"):
            raise ValueError(
                f"collective backend {backend!r} is the JAX package's XLA world; use 'nccl' "
                "(or 'gloo' for CPU tensors, 'cpu' for the host ring)"
            )
        if backend in ("cpu", "object_store"):
            return Backend.CPU
        if backend in ("nccl", "gloo"):
            return backend
        raise ValueError(f"unknown collective backend {backend!r}; use 'nccl', 'gloo' or 'cpu'")
