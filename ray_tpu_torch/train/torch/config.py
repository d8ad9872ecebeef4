"""TorchConfig + _TorchBackend — device binding and torch.distributed
bootstrap over the gang.

Reference: python/ray/train/torch/config.py:155 (_TorchBackend.on_start calls
dist.init_process_group on every worker, :113, with worker-0 as master). It
replaces the JAX package's ``JaxBackend`` (collective group and mesh): every
worker first binds its device (``torch.cuda.set_device`` on a GPU gang), then
the gang forms a process group — NCCL on GPUs, gloo on CPUs; one worker forms
a group of one — and every worker builds the gang's mesh (one ``dp`` axis,
``session.get_mesh()``).
"""

from __future__ import annotations

from dataclasses import dataclass

import ray_tpu_torch
from ray_tpu_torch.train._internal.backend_executor import Backend


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _init_dist(rank: int, world_size: int, master_addr: str, master_port: int,
               backend: str, timeout_s: int):
    import datetime
    import os

    import torch.distributed as dist

    os.environ["MASTER_ADDR"] = master_addr
    os.environ["MASTER_PORT"] = str(master_port)
    os.environ["RANK"] = str(rank)
    os.environ["WORLD_SIZE"] = str(world_size)
    os.environ.setdefault("LOCAL_RANK", str(rank))
    if not dist.is_initialized():
        dist.init_process_group(
            backend=backend,
            rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s),
        )
    return dist.get_rank()


def _shutdown_dist():
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    return True


@dataclass
class TorchConfig:
    """Analog of train/torch/config.py TorchConfig."""

    backend: str | None = None  # None: nccl with use_gpu, gloo without
    init_timeout_s: int = 300

    def backend_cls(self) -> "_TorchBackend":
        return _TorchBackend(self)


class _TorchBackend(Backend):
    def __init__(self, config: TorchConfig | None = None):
        self.config = config or TorchConfig()

    def on_start(self, worker_group, scaling_config):
        self.device_names = ray_tpu_torch.get(
            [w.setup_device.remote() for w in worker_group.workers], timeout=300
        )
        backend = self.config.backend or ("nccl" if scaling_config.use_gpu else "gloo")
        # Worker 0 is the rendezvous master (same scheme as the collective
        # plane's coordinator; single-host address like tpu_group.py).
        master_port = ray_tpu_torch.get(
            worker_group.workers[0].execute.remote(_free_port), timeout=60
        )
        refs = [
            w.execute.remote(
                _init_dist, rank, worker_group.num_workers, "127.0.0.1",
                master_port, backend, self.config.init_timeout_s,
            )
            for rank, w in enumerate(worker_group.workers)
        ]
        ray_tpu_torch.get(refs, timeout=self.config.init_timeout_s + 60)
        ray_tpu_torch.get([w.build_mesh.remote() for w in worker_group.workers],
                          timeout=self.config.init_timeout_s + 60)

    def on_shutdown(self, worker_group):
        try:
            worker_group.execute(_shutdown_dist, timeout=30)
        except Exception:
            pass
