"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper (H100).

A package of its own beside ``ray_tpu``: it imports ``torch`` and nothing of
JAX or of ``ray_tpu``. Its layout mirrors the JAX package's, so each module
has its counterpart there:

- ``ops/attention.py``: flash attention through hand-written CUDA kernels
  (``ops/csrc/*.cu``, built by ``ops/_build.py`` at the first CUDA call).
- ``ops/losses.py``: the chunked, fused LM-head cross-entropy.
- ``models/transformer.py``: the flagship decoder, its loss and train step.
- ``models/generate.py``: KV-cache inference (prefill, decode, paged decode,
  sampling, ``generate``, ``speculative_generate``).
- ``serve/llm``: the continuous-batching LLM engine on the paged cache.
- the runtime, copied from the JAX package: this module's public API
  (``init``, ``remote``, ``get``, ``put``, ``wait``, ``kill``, ...), the
  tasks, actors and objects of ``actor.py``, ``remote_function.py`` and
  ``object_ref.py``, and under ``_private/`` the GCS, the raylet with its
  scheduler core, lease, pull and push managers and worker fork-server, the
  core worker and worker entry, the shared-memory object store
  (``_private/store``, ``_native/*.cc``), the RPC layer and the thread
  affinity markers (``_private/concurrency.py``). Objects carry
  ``torch.Tensor`` values (``_private/serialization.py``).
- ``util/placement_group.py``, ``util/scheduling_strategies.py``,
  ``util/tracing.py``, ``util/metrics.py``.
- ``air``: ``ScalingConfig``/``RunConfig``, the train session, checkpoints
  and the actor and resource managers of ``air/execution``.
- ``train``: the data-parallel trainer, its backend executor and worker
  group, and ``train/torch``: ``TorchTrainer``, which stands in for the JAX
  package's ``JaxTrainer``.

The port's clusters never meet the JAX package's: every environment
variable it reads or sets carries the ``RAY_TPU_TORCH_`` prefix, its
sessions live under ``ray_tpu_torch`` in the temporary directory
(``tempfile.gettempdir()``, which TMPDIR sets), its workers start as
``ray_tpu_torch._private.worker_main``, its native libraries build into
``ray_tpu_torch/_native/build/``, and ``init(address=...)`` refuses a GCS
that is not the port's. A node advertises its CUDA cards as ``"GPU"``.
"""

from __future__ import annotations

import os
import tempfile
import threading

from ray_tpu_torch import exceptions  # noqa: F401
from ray_tpu_torch.actor import ActorClass, ActorHandle, method  # noqa: F401
from ray_tpu_torch.object_ref import ObjectRef, ObjectRefGenerator  # noqa: F401
from ray_tpu_torch.remote_function import RemoteFunction

__version__ = "0.1.0"

_init_lock = threading.Lock()
_global_node = None
# Set by the chained excepthook when an exception escapes the driver script;
# shutdown() (usually via atexit) then records the job as FAILED.
_uncaught_exception = False
_hooks_installed = False


def _install_driver_hooks():
    global _hooks_installed
    if _hooks_installed:
        return
    _hooks_installed = True
    import atexit
    import sys

    import threading as _threading

    prev_hook = sys.excepthook

    def _excepthook(tp, value, tb):
        global _uncaught_exception
        _uncaught_exception = True
        prev_hook(tp, value, tb)

    sys.excepthook = _excepthook

    prev_thread_hook = _threading.excepthook

    def _thread_excepthook(hook_args):
        global _uncaught_exception
        if hook_args.exc_type is not SystemExit:
            _uncaught_exception = True
        prev_thread_hook(hook_args)

    _threading.excepthook = _thread_excepthook
    # Known gap: `sys.exit(1)` raises SystemExit, which the interpreter
    # handles without calling sys.excepthook — such drivers are recorded
    # SUCCEEDED here; the job-submission layer (which sees the real exit
    # code) is authoritative for submitted jobs.
    atexit.register(shutdown)


def init(
    address=None,
    *,
    num_cpus: int | None = None,
    num_gpus: int | None = None,
    resources: dict | None = None,
    object_store_memory: int | None = None,
    namespace: str = "",
    labels: dict | None = None,
    runtime_env: dict | None = None,
    ignore_reinit_error: bool = False,
    _system_config: dict | None = None,
):
    """Start (or connect to) a cluster and attach this process as a driver."""
    global _global_node
    from ray_tpu_torch._private import worker_context
    from ray_tpu_torch._private.core_worker import DRIVER, CoreWorker
    from ray_tpu_torch._private.node import Node

    if address is None and os.environ.get("RAY_TPU_TORCH_ADDRESS"):
        # Set by operators — mirrors the reference's RAY_ADDRESS behavior.
        address = os.environ["RAY_TPU_TORCH_ADDRESS"]
    if isinstance(address, str) and address.startswith("ray_tpu_torch://"):
        raise NotImplementedError(
            "the thin client (ray_tpu_torch:// addresses) is not ported (ROADMAP A5, what remains)"
        )
    if address == "auto":
        address = os.environ.get("RAY_TPU_TORCH_ADDRESS")
        if address is None:
            raise ConnectionError('init(address="auto") found no running cluster (no RAY_TPU_TORCH_ADDRESS)')

    with _init_lock:
        if worker_context.get_core_worker_if_initialized() is not None:
            if ignore_reinit_error:
                return worker_context.get_core_worker()
            raise RuntimeError("ray_tpu_torch.init() called twice; pass ignore_reinit_error=True")

        if address is None:
            node = Node(
                head=True,
                num_cpus=num_cpus,
                num_gpus=num_gpus,
                resources=resources,
                object_store_memory=object_store_memory,
                labels=labels,
                _system_config=_system_config,
            )
            _global_node = node
            gcs_address = node.gcs_address
            raylet_address = node.raylet.address
            arena_name = node.raylet.arena_name
            node_id = node.raylet.node_id
            session_dir = node.session_dir
        else:
            # Connect to an existing cluster: find a raylet (prefer local host).
            from ray_tpu_torch._private.rpc import RpcClient

            gcs_address = tuple(address) if not isinstance(address, str) else _parse_addr(address)
            gcs = RpcClient(gcs_address, label="gcs")
            _check_port_gcs(gcs)
            nodes_resp = gcs.call("get_nodes")
            alive = [n for n in nodes_resp["nodes"].values() if n["state"] == "ALIVE"]
            if not alive:
                gcs.close()
                raise RuntimeError("no alive nodes in cluster")
            target = alive[0]
            raylet_address = tuple(target["address"])
            arena_name = target["arena_name"]
            node_id = target["node_id"]
            # A connecting driver keeps its own logs and flight ring apart
            # from the cluster's session and from other drivers.
            from ray_tpu_torch._private.config import runtime_root

            os.makedirs(runtime_root(), exist_ok=True)
            session_dir = tempfile.mkdtemp(prefix="driver_", dir=runtime_root())
            gcs.close()

        cw = CoreWorker(
            mode=DRIVER,
            gcs_address=gcs_address,
            raylet_address=raylet_address,
            arena_name=arena_name,
            node_id=node_id,
            session_dir=session_dir,
            namespace=namespace,
            job_runtime_env=runtime_env,
        )
        worker_context.set_core_worker(cw)
    from ray_tpu_torch.util import tracing as _tracing

    if _tracing.tracing_enabled():
        _tracing._publish_flag_if_connected()
    _install_driver_hooks()
    return cw


def _check_port_gcs(gcs) -> None:
    """Refuse a GCS that is not the port's: the JAX package's GCS speaks the
    same wire protocol but has no ``runtime_name`` method."""
    from ray_tpu_torch._private.rpc import RpcError

    try:
        name = gcs.call("runtime_name", timeout=10, retries=0).get("runtime")
    except RpcError:
        name = None
    if name != "ray_tpu_torch":
        gcs.close()
        raise ConnectionError(f"{gcs.address} is not a ray_tpu_torch GCS (another runtime listens there)")


def _parse_addr(address: str) -> tuple:
    host, port = address.rsplit(":", 1)
    return (host, int(port))


def shutdown():
    global _global_node
    from ray_tpu_torch._private import worker_context

    with _init_lock:
        cw = worker_context.get_core_worker_if_initialized()
        if cw is not None:
            cw.shutdown(job_state="FAILED" if _uncaught_exception else "SUCCEEDED")
            worker_context.set_core_worker(None)
        if _global_node is not None:
            _global_node.stop()
            _global_node = None


def is_initialized() -> bool:
    from ray_tpu_torch._private import worker_context

    return worker_context.get_core_worker_if_initialized() is not None


def remote(*args, **kwargs):
    """``@ray_tpu_torch.remote`` decorator for functions and classes."""

    def make(obj):
        if isinstance(obj, type):
            return ActorClass(obj, **kwargs)
        return RemoteFunction(obj, **kwargs)

    if len(args) == 1 and callable(args[0]) and not kwargs:
        return make(args[0])
    if args:
        raise TypeError("@remote takes keyword options only, e.g. @remote(num_cpus=2)")
    return make


def get(refs, *, timeout: float | None = None):
    from ray_tpu_torch._private import worker_context

    return worker_context.get_core_worker().get(refs, timeout=timeout)


def put(value, *, tensor_transport: str | None = None) -> ObjectRef:
    """Store ``value`` and return an ObjectRef.

    A ``torch.Tensor`` is stored as host bytes (a CUDA tensor through one
    copy to the host) and comes back on the same device index.
    ``tensor_transport="collective"`` keeps a plain tensor resident on this
    process's device instead (experimental/device_object/): only a small
    descriptor enters the store, and ``get`` resolves it out of band — the
    live tensor in this process, a copy on the consumer's device elsewhere.
    A DTensor raises ``TypeError`` (ROADMAP A9f).
    """
    from ray_tpu_torch._private import worker_context

    return worker_context.get_core_worker().put(value, tensor_transport=tensor_transport)


def wait(refs, *, num_returns: int = 1, timeout: float | None = None, fetch_local: bool = True):
    from ray_tpu_torch._private import worker_context

    return worker_context.get_core_worker().wait(
        refs, num_returns=num_returns, timeout=timeout, fetch_local=fetch_local
    )


def cancel(object_ref: ObjectRef, *, force: bool = False, recursive: bool = True):
    """Cancel the task producing ``object_ref`` (reference: ``ray.cancel``,
    python/ray/_private/worker.py:2773 / core_worker.cc CancelTask).

    Best-effort and asynchronous: pending tasks are dequeued (at the raylet,
    the owner's lease staging, or the actor's call queue), a running task is
    interrupted with :class:`~ray_tpu_torch.exceptions.TaskCancelledError` at its
    next Python bytecode boundary, and ``force=True`` kills the executing
    worker process outright. ``recursive=True`` also cancels the task's
    children. ``ray_tpu_torch.get`` on the task's returns raises
    ``TaskCancelledError`` once the cancel lands; a task that already
    finished is unaffected. ``force=True`` on an actor task raises
    ``ValueError`` (kill the actor instead), matching the reference.
    """
    from ray_tpu_torch._private import worker_context

    if not isinstance(object_ref, ObjectRef):
        raise TypeError(
            f"ray_tpu_torch.cancel() expects an ObjectRef, got {type(object_ref).__name__}"
        )
    worker_context.get_core_worker().cancel(object_ref, force=force, recursive=recursive)


def kill(actor: ActorHandle, *, no_restart: bool = True):
    from ray_tpu_torch._private import worker_context

    cw = worker_context.get_core_worker()
    # Bounded AND best-effort: a wedged GCS/worker must not block the
    # caller forever (a Tune controller hung here for 90 minutes when a
    # recycled worker port swallowed the GCS's kill_self relay), and kill
    # has never raised on slow delivery — swallow the timeout, the GCS
    # actor reaper finishes the job.
    import logging

    from ray_tpu_torch._private import rpc as _rpc

    try:
        # retries=0: acall retries TimeoutError internally, which would turn
        # this into a ~4x10s worst case; a single attempt keeps the total
        # bound at 10s, and a dropped kill is finished by the reaper anyway.
        cw.gcs.call(
            "kill_actor",
            {"actor_id": actor.actor_id, "no_restart": no_restart},
            timeout=10,
            retries=0,
        )
    except (TimeoutError, _rpc.ConnectionLost):
        logging.getLogger(__name__).warning(
            "kill(%s) did not confirm within the timeout; actor teardown "
            "continues asynchronously", actor.actor_id[:8],
        )
    if no_restart:
        cw.release_actor_args(actor.actor_id)


def get_actor(name: str, namespace: str = "") -> ActorHandle:
    from ray_tpu_torch._private import worker_context

    cw = worker_context.get_core_worker()
    resp = cw.gcs.call("get_actor", {"name": name, "namespace": namespace or cw.namespace})
    if not resp.get("found"):
        raise ValueError(f"no actor named {name!r}")
    return ActorHandle(resp["info"]["actor_id"], name=name)


def nodes() -> list:
    from ray_tpu_torch._private import worker_context

    cw = worker_context.get_core_worker()
    return list(cw.gcs.call("get_nodes")["nodes"].values())


def cluster_resources() -> dict:
    from ray_tpu_torch._private.state import GlobalState

    return GlobalState().cluster_resources()


def available_resources() -> dict:
    from ray_tpu_torch._private.state import GlobalState

    return GlobalState().available_resources()


def timeline(filename: str | None = None) -> list:
    """Chrome-trace timeline of executed tasks (reference: ``ray.timeline``,
    python/ray/_private/state.py:831); open the dump in chrome://tracing."""
    from ray_tpu_torch._private.state import timeline as _timeline

    return _timeline(filename)


def get_runtime_context():
    from ray_tpu_torch.runtime_context import get_runtime_context as _grc

    return _grc()


__all__ = [
    "ActorClass",
    "ActorHandle",
    "ObjectRef",
    "RemoteFunction",
    "available_resources",
    "cancel",
    "cluster_resources",
    "exceptions",
    "get",
    "get_actor",
    "get_runtime_context",
    "init",
    "is_initialized",
    "kill",
    "method",
    "nodes",
    "put",
    "remote",
    "shutdown",
    "timeline",
    "wait",
]
