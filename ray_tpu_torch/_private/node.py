"""Node — session bootstrap and daemon lifecycle.

Analog of the reference's Node/process-tree launcher
(python/ray/_private/node.py:37, start_ray_processes node.py:1186,
services.py): creates the session directory and brings up the GCS and the
node's raylet.

Deviation from the reference (documented): daemons run in-process on the IO
event-loop thread rather than as separate OS processes — every interaction
still crosses a real socket, so the distributed protocol is identical and
multi-raylet "clusters" on one host (the reference's cluster_utils.Cluster
trick, python/ray/cluster_utils.py:99) work the same way; worker processes are
real subprocesses either way. `gcs.py`/`raylet.py` keep standalone `main()`s
for out-of-process deployment.

A node advertises its CUDA cards as the ``"GPU"`` resource. They are
counted through ``nvidia-smi`` — deliberately without importing torch or
initialising CUDA in the driver, whose raylet may still fork workers.
"""

from __future__ import annotations

import os
import subprocess
import time

from ray_tpu_torch._private.config import get_config, init_config
from ray_tpu_torch._private.gcs import GcsServer
from ray_tpu_torch._private.raylet import Raylet


def detect_gpus() -> int:
    """CUDA cards this node offers: ``RAY_TPU_TORCH_NUM_GPUS`` if set, else
    the cards ``nvidia-smi -L`` lists (0 where it is absent), no more than
    ``CUDA_VISIBLE_DEVICES`` names."""
    if os.environ.get("RAY_TPU_TORCH_NUM_GPUS"):
        return int(os.environ["RAY_TPU_TORCH_NUM_GPUS"])
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return 0
    n = sum(line.startswith("GPU ") for line in out.stdout.splitlines()) if out.returncode == 0 else 0
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        n = min(n, len([d for d in visible.split(",") if d.strip() and not d.strip().startswith("-")]))
    return n


class Node:
    def __init__(
        self,
        head: bool = True,
        gcs_address=None,
        num_cpus: int | None = None,
        num_gpus: int | None = None,
        resources: dict | None = None,
        object_store_memory: int | None = None,
        labels: dict | None = None,
        session_dir: str | None = None,
        _system_config: dict | None = None,
    ):
        cfg = init_config(_system_config) if head else get_config()
        ts = time.strftime("%Y%m%d-%H%M%S")
        import uuid as _uuid

        # uuid suffix: two inits in the same process+second (common in test
        # suites) must not share a session directory.
        self.session_dir = session_dir or os.path.join(
            cfg.session_dir_root, f"session_{ts}_{os.getpid()}_{_uuid.uuid4().hex[:6]}"
        )
        os.makedirs(os.path.join(self.session_dir, "logs"), exist_ok=True)

        self.gcs_server: GcsServer | None = None
        if head:
            self.gcs_server = GcsServer()
            self.gcs_address = self.gcs_server.address
        else:
            assert gcs_address is not None
            self.gcs_address = tuple(gcs_address)

        node_resources = dict(resources or {})
        node_resources.setdefault("CPU", num_cpus if num_cpus is not None else (os.cpu_count() or 1))
        gpus = num_gpus if num_gpus is not None else detect_gpus()
        if gpus:
            node_resources.setdefault("GPU", gpus)
        node_labels = dict(labels or {})

        self.raylet = Raylet(
            self.gcs_address,
            self.session_dir,
            resources=node_resources,
            labels=node_labels,
            object_store_memory=object_store_memory,
        )
        self.node_id = self.raylet.node_id

    def stop(self):
        self.raylet.stop()
        if self.gcs_server is not None:
            self.gcs_server.stop()
