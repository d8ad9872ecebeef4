"""ActorClass / ActorHandle / ActorMethod.

Analog of the reference's actor machinery (python/ray/actor.py:383 ActorClass,
:1024 ActorHandle, :98 ActorMethod): ``@ray_tpu_torch.remote`` on a class yields an
ActorClass; ``.remote()`` registers the actor with the GCS which gang-schedules
its creation; method calls go direct to the actor process (the raylet is not
involved after creation — reference: direct actor task transport).
"""

from __future__ import annotations

import functools

from ray_tpu_torch.remote_function import _build_resources, _scheduling_opts

_ACTOR_OPTION_KEYS = {
    "num_cpus",
    "num_gpus",
    "resources",
    "name",
    "namespace",
    "get_if_exists",
    "lifetime",
    "max_restarts",
    "max_task_retries",
    "max_concurrency",
    "scheduling_strategy",
    "placement_group",
    "placement_group_bundle_index",
    "runtime_env",
    # Device object plane: tensor returns stay resident on this actor's
    # device (experimental/device_object/).
    "tensor_transport",
}


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str, num_returns: int = 1):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns

    def remote(self, *args, **kwargs):
        return self._handle._invoke(self._method_name, args, kwargs, self._num_returns)

    def options(self, num_returns: int = 1):
        return ActorMethod(self._handle, self._method_name, num_returns)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor method '{self._method_name}' cannot be called directly; "
            f"use '.{self._method_name}.remote()'."
        )


class ActorHandle:
    def __init__(self, actor_id: str, max_task_retries: int = 0, name: str = "", method_num_returns: dict | None = None):
        self._actor_id = actor_id
        self._max_task_retries = max_task_retries
        self._name = name
        self._method_num_returns = method_num_returns or {}

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        return ActorMethod(self, item, self._method_num_returns.get(item, 1))

    def _invoke(self, method_name, args, kwargs, num_returns):
        from ray_tpu_torch._private import worker_context

        cw = worker_context.get_core_worker()
        refs = cw.submit_actor_task(
            self._actor_id,
            method_name,
            args,
            kwargs,
            num_returns=num_returns,
            max_task_retries=self._max_task_retries,
        )
        if num_returns == 1:
            return refs[0]
        return refs

    @property
    def actor_id(self) -> str:
        return self._actor_id

    def __reduce__(self):
        return (
            ActorHandle,
            (self._actor_id, self._max_task_retries, self._name, self._method_num_returns),
        )

    def __repr__(self):
        return f"ActorHandle({self._actor_id[:16]}, name={self._name!r})"


class ActorClass:
    def __init__(self, cls, **default_opts):
        self._cls = cls
        self._opts = default_opts
        functools.update_wrapper(self, cls, updated=[])

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class '{self._cls.__name__}' cannot be instantiated directly; "
            f"use '{self._cls.__name__}.remote()'."
        )

    def options(self, **opts):
        bad = set(opts) - _ACTOR_OPTION_KEYS
        if bad:
            raise ValueError(f"invalid actor .options() keys: {sorted(bad)}")
        return ActorClass(self._cls, **{**self._opts, **opts})

    def remote(self, *args, **kwargs) -> ActorHandle:
        from ray_tpu_torch._private import worker_context

        cw = worker_context.get_core_worker()
        opts = self._opts
        resources = _build_resources({**opts, "resources": opts.get("resources")})
        # Actors only reserve explicitly requested resources for their lifetime.
        if "num_cpus" not in opts and "CPU" in resources:
            resources.pop("CPU")
        info = cw.create_actor(
            self._cls,
            args,
            kwargs,
            resources=resources,
            name=opts.get("name"),
            namespace=opts.get("namespace"),
            get_if_exists=opts.get("get_if_exists", False),
            max_restarts=opts.get("max_restarts", 0),
            max_task_retries=opts.get("max_task_retries", 0),
            max_concurrency=opts.get("max_concurrency", 1),
            runtime_env=opts.get("runtime_env"),
            tensor_transport=opts.get("tensor_transport"),
            **_scheduling_opts(opts),
        )
        return ActorHandle(
            info["actor_id"],
            max_task_retries=info["max_task_retries"],
            name=info["name"],
            method_num_returns=self._method_num_returns(),
        )

    def bind(self, *args, **kwargs):
        """Build a lazy actor-construction DAG node (reference: ray.dag
        class_node); method ``.bind`` on the result builds method nodes."""
        from ray_tpu_torch.dag.dag_node import ClassNode

        return ClassNode(self, args, kwargs)

    def _method_num_returns(self) -> dict:
        out = {}
        for name in dir(self._cls):
            method = getattr(self._cls, name, None)
            n = getattr(method, "__ray_tpu_num_returns__", None)
            if n is not None:
                out[name] = n
        return out


def method(num_returns: int = 1):
    """Per-method options decorator (analog of ray.method)."""

    def decorator(fn):
        fn.__ray_tpu_num_returns__ = num_returns
        return fn

    return decorator
