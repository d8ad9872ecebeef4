"""MPMD pipeline parallelism over compiled graphs.

Counterpart of ``ray_tpu/parallel/mpmd_pipeline.py``. ``parallel/pipeline.py``
is the single-controller GPipe program: every rank of the ``pp`` axis runs
one schedule in lock step. This module is the MPMD counterpart (PAPERS.md,
"Scaling Deep Learning Training with MPMD Pipeline Parallelism"): each stage
is its OWN program — a ``@remote(tensor_transport="collective")`` actor
holding its stage's parameters on its own device and running its own stage
function — and the stages are stitched into a ``CompiledDAG`` (shm channel
rings + resident worker loops, zero raylet RPCs per iteration) whose
inter-stage edges carry device-object DESCRIPTORS
(experimental/channel/device_envelope.py) while the activations move out of
band over the ``util/collective`` p2p plane — no tensor crosses the host
object store between stages.

The schedule is streaming: the driver pumps microbatch ``m`` into stage 0
while stage ``k`` runs microbatch ``m-k``, so the steady-state bubble
fraction approaches ``(S-1)/(M+S-1)``; per-stage stall/busy counters
(``channel_loop_stats``) measure it.

The stage actors run on the card (``num_gpus=1/n_stages`` each) unless the
caller passes ``device="cpu"``; a cluster with no GPU refuses their
placement with the runtime's own error. Each stage function runs under
``torch.no_grad()`` (the pipeline is forward only, as in the JAX package).
Outputs are bit-equal to the in-process composition of the stage functions
on the same tensors: activations cross processes through
``_private/serialization``'s exact-bytes tensor reducer.
"""

from __future__ import annotations

import logging

import ray_tpu_torch
from ray_tpu_torch.dag import InputNode

logger = logging.getLogger(__name__)


def _tree_map(fn, tree):
    import torch.utils._pytree as pytree

    return pytree.tree_map(fn, tree)


@ray_tpu_torch.remote(tensor_transport="collective")
class PipelineStageActor:
    """One pipeline stage: owns its parameters (moved to its device once)
    and its stage function. ``run`` executes inside the resident channel
    loop — the tensor_transport opt-in makes its tensor result leave as a
    descriptor slot instead of ring bytes."""

    def __init__(self, stage_fn, params, stage_idx: int, n_stages: int,
                 mesh_axes: dict | None = None, device: str = "cuda"):
        import torch

        self.idx = stage_idx
        self.n_stages = n_stages
        self.device = torch.device(device)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device.index or 0)
        self.params = _tree_map(lambda p: p.to(self.device), params)
        self.mesh = None
        if mesh_axes:
            self.mesh = self._world1_mesh(mesh_axes)
        self._fn = stage_fn
        self._spans = None  # CUDA event pairs around each run, when timed

    def _world1_mesh(self, mesh_axes: dict):
        """A world-1 mesh over this stage's device (parallel/mesh.py), on a
        process group of its own when the process has none."""
        import torch.distributed as dist

        from ray_tpu_torch.parallel.mesh import MeshConfig, create_mesh

        if not dist.is_initialized():
            dist.init_process_group("nccl" if self.device.type == "cuda" else "gloo",
                                    store=dist.HashStore(), rank=0, world_size=1)
        return create_mesh(MeshConfig(**mesh_axes), device_type=self.device.type)

    def ready(self) -> int:
        return self.idx

    def warmup(self, x):
        """Run the stage once (kernel builds, allocator warm-up) before the
        clock starts."""
        import torch

        self.run(x)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return True

    def run(self, x):
        import torch

        with torch.no_grad():
            if self._spans is None:
                return self._fn(self.params, x.to(self.device))
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            y = self._fn(self.params, x.to(self.device))
            end.record()
            self._spans.append((start, end))
            return y

    def time_device(self, on: bool = True) -> None:
        """From now on (``on``), record a CUDA event before and after each
        ``run`` on a card, for ``device_spans``; off, record nothing."""
        self._spans = [] if on and self.device.type == "cuda" else None

    def device_spans(self) -> list:
        """Device ms of each ``run`` recorded since the last call, oldest
        first: from the stage's first device operation to its last, idle
        gaps between them included. Clears them."""
        import torch

        if not self._spans:
            return []
        spans, self._spans = self._spans, []
        torch.cuda.synchronize(self.device)
        return [a.elapsed_time(b) for a, b in spans]

    def time_alone(self, x, iters: int) -> dict:
        """The stage alone, ``iters`` runs of ``x`` after one untimed, each
        run finished before the next starts: host ms a run to issue it
        (``issue_ms``) and to finish it (``wall_ms``); on a card, device ms
        a run of its kernels and copies under torch.profiler
        (``kernel_ms``) and device operations a run (``ops``), both None
        where the profiler saw no device time."""
        import time

        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        cuda = self.device.type == "cuda"

        def finish():
            if cuda:
                torch.cuda.synchronize(self.device)

        self.run(x)
        finish()
        issue = wall = 0.0
        for _ in range(iters):
            t0 = time.perf_counter()
            self.run(x)
            t1 = time.perf_counter()
            finish()
            issue += t1 - t0
            wall += time.perf_counter() - t0
        out = {"issue_ms": issue * 1e3 / iters, "wall_ms": wall * 1e3 / iters, "kernel_ms": None, "ops": None}
        if cuda:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    self.run(x)
                finish()
            ev = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
            us = sum(e.self_device_time_total for e in ev)
            if us > 0:
                out.update(kernel_ms=us / 1e3 / iters, ops=sum(e.count for e in ev) / iters)
        return out

    def pid(self) -> int:
        import os

        return os.getpid()

    def devobj_stats(self) -> dict:
        from ray_tpu_torch.experimental.device_object import device_object_stats

        return device_object_stats()

    def launch_counts(self) -> dict:
        """The forward attention kernel's launches in this stage's process
        (ops/attention.py) — how a caller checks that the stage ran the
        kernel, not its plain version."""
        from ray_tpu_torch.ops import attention

        return attention.launch_counts()

    def reset_launch_counts(self) -> None:
        from ray_tpu_torch.ops import attention

        attention.reset_launch_counts()

    def init_collective(self, world_size, rank, backend, group_name):
        from ray_tpu_torch.util import collective as col

        col.init_collective_group(world_size, rank, backend=backend, group_name=group_name)


class MPMDPipeline:
    """N stage actors + one compiled DAG; ``apply`` streams microbatches.

    ``stage_fn(params_k, x_mb) -> y_mb`` with activations keeping one
    shape; ``stacked_params`` is a pytree of tensors with leading dim
    ``n_stages`` (the same contract as ``pipeline_apply``, so the two are
    comparable on identical params/inputs)."""

    def __init__(
        self,
        stage_fn,
        stacked_params,
        *,
        n_stages: int | None = None,
        num_microbatches: int | None = None,
        max_in_flight: int = 16,
        stage_mesh_axes: dict | None = None,
        warmup_x=None,
        device: str = "cuda",
    ):
        import torch.utils._pytree as pytree

        leaves = pytree.tree_leaves(stacked_params)
        if not leaves:
            raise ValueError("stacked_params has no leaves")
        inferred = int(leaves[0].shape[0])
        self.n_stages = n_stages or inferred
        if self.n_stages != inferred:
            raise ValueError(
                f"n_stages={self.n_stages} but stacked_params lead dim is {inferred}"
            )
        if device not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
        self.num_microbatches = num_microbatches or self.n_stages
        self._max_in_flight = max(2, int(max_in_flight))
        placement = {"num_gpus": 1.0 / self.n_stages} if device == "cuda" else {}
        # DAG class nodes (compiled graphs bind ClassNodes, not live
        # handles); resolve_actor_handle() gives the live gang for classic
        # calls (warmup, stats) — the same actors the compiled DAG uses,
        # via the shared per-DAG actor cache.
        self._stage_nodes = [
            PipelineStageActor.bind(
                stage_fn,
                _tree_map(lambda p, k=k: p[k], stacked_params),
                k,
                self.n_stages,
                stage_mesh_axes,
                device,
            ).options(**placement)
            for k in range(self.n_stages)
        ]
        self.stages = [n.resolve_actor_handle() for n in self._stage_nodes]
        ray_tpu_torch.get([s.ready.remote() for s in self.stages], timeout=300)
        if warmup_x is not None:
            ray_tpu_torch.get(
                [s.warmup.remote(warmup_x) for s in self.stages], timeout=300
            )
        with InputNode() as inp:
            d = inp
            for node in self._stage_nodes:
                d = node.run.bind(d)
        self.compiled = d.experimental_compile(
            max_buffered_results=self._max_in_flight
        )
        self._torn_down = False

    # -- execution ------------------------------------------------------

    def apply(self, x, num_microbatches: int | None = None):
        """Run the full batch through the pipeline; returns y with x's
        batch shape. Microbatches are pumped ``max_in_flight`` deep so the
        stages overlap; outputs gather in order."""
        import torch

        M = num_microbatches or self.num_microbatches
        B = x.shape[0]
        assert B % M == 0, f"batch {B} not divisible by microbatches {M}"
        mb = B // M
        x_mbs = x.reshape(M, mb, *x.shape[1:])
        window = self._max_in_flight - 1
        refs: list = []
        outs: list = []
        for m in range(M):
            refs.append(self.compiled.execute(x_mbs[m]))
            if len(refs) > window:
                outs.append(refs.pop(0).get())
        while refs:
            outs.append(refs.pop(0).get())
        return torch.cat(outs, dim=0)

    # -- measurement ----------------------------------------------------

    def reset_stage_stats(self):
        self._each_loop_stats(reset=True)

    def stage_stats(self) -> list:
        """Per-stage stall/busy/resolve split (ns), ordered by stage index —
        read from each resident loop. The basis of the measured bubble
        fraction."""
        rows = [r for stats in self._each_loop_stats() for r in stats]
        return sorted(rows, key=lambda r: int(r["label"].split(":", 1)[0]))

    def bubble_fraction(self) -> float:
        """stall / (stall + busy) summed over stages since the last reset —
        the measured counterpart of (S-1)/(M+S-1)."""
        rows = self.stage_stats()
        stall = sum(r["stall_ns"] for r in rows)
        busy = sum(r["busy_ns"] for r in rows)
        total = stall + busy
        return stall / total if total else 0.0

    def _each_loop_stats(self, reset: bool = False) -> list:
        from ray_tpu_torch._private import worker_context

        cw = worker_context.get_core_worker()
        out = []
        for addr in self.compiled._actor_addrs.values():
            resp = cw._owner_client(tuple(addr)).call(
                "channel_loop_stats",
                {"loop_id": self.compiled._dag_id, "reset": reset},
                timeout=10,
            )
            out.append(resp.get("stages") or [])
        return out

    def stage_devobj_stats(self) -> list:
        """Each stage process's device-object counters (the zero-host-copy
        evidence: transfers_host stays flat across a steady-state run)."""
        return ray_tpu_torch.get(
            [s.devobj_stats.remote() for s in self.stages], timeout=60
        )

    # -- lifecycle ------------------------------------------------------

    def teardown(self, kill_actors: bool = True):
        if self._torn_down:
            return
        self._torn_down = True
        self.compiled.teardown()
        if kill_actors:
            for s in self.stages:
                try:
                    ray_tpu_torch.kill(s)
                except Exception:
                    pass

    def __del__(self):
        try:
            if not self._torn_down:
                self.teardown(kill_actors=False)
        except Exception:
            pass


def mpmd_pipeline(stage_fn, stacked_params, **kwargs) -> MPMDPipeline:
    """Build an :class:`MPMDPipeline`; see the class docstring::

        pipe = mpmd_pipeline(stage_fn, ws, num_microbatches=8)
        y = pipe.apply(x)         # bit-equal to stage_fn composed in-process
        pipe.teardown()
    """
    return MPMDPipeline(stage_fn, stacked_params, **kwargs)
