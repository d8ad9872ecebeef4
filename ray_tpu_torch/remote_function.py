"""RemoteFunction — the @ray_tpu_torch.remote function wrapper.

Analog of the reference's RemoteFunction (python/ray/remote_function.py:39,
_remote at :245): holds the user function plus default options; ``.remote()``
submits through the core worker, ``.options()`` returns an overridden view.
"""

from __future__ import annotations

import functools

_OPTION_KEYS = {
    "num_returns",
    "num_cpus",
    "num_gpus",
    "resources",
    "max_retries",
    "retry_exceptions",
    "name",
    "scheduling_strategy",
    "placement_group",
    "placement_group_bundle_index",
    "runtime_env",
}


def _build_resources(opts: dict) -> dict:
    resources = dict(opts.get("resources") or {})
    if "num_cpus" in opts and opts["num_cpus"] is not None:
        resources["CPU"] = opts["num_cpus"]
    if "num_gpus" in opts and opts["num_gpus"] is not None:
        resources["GPU"] = opts["num_gpus"]
    resources.setdefault("CPU", 1)
    return {k: v for k, v in resources.items() if v}


def _scheduling_opts(opts: dict) -> dict:
    out = {}
    strategy = opts.get("scheduling_strategy")
    pg = opts.get("placement_group")
    if pg is not None:
        out["placement_group_id"] = pg.id.hex() if hasattr(pg, "id") else str(pg)
        out["placement_group_bundle_index"] = opts.get("placement_group_bundle_index", 0)
    elif strategy is not None:
        if isinstance(strategy, str):
            out["scheduling_strategy"] = strategy
        else:  # PlacementGroupSchedulingStrategy / NodeAffinitySchedulingStrategy
            out.update(strategy.to_options())
    return out


class RemoteFunction:
    def __init__(self, func, **default_opts):
        self._func = func
        self._opts = default_opts
        functools.update_wrapper(self, func)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function '{self._func.__name__}' cannot be called directly; "
            f"use '{self._func.__name__}.remote()'."
        )

    def options(self, **opts):
        bad = set(opts) - _OPTION_KEYS
        if bad:
            raise ValueError(f"invalid .options() keys: {sorted(bad)}")
        merged = {**self._opts, **opts}
        return RemoteFunction(self._func, **merged)

    def remote(self, *args, **kwargs):
        from ray_tpu_torch._private import worker_context

        cw = worker_context.get_core_worker()
        opts = self._opts
        refs = cw.submit_task(
            self._func,
            args=args,
            kwargs=kwargs,
            num_returns=opts.get("num_returns", 1),
            resources=_build_resources(opts),
            max_retries=opts.get("max_retries", 3),
            retry_exceptions=opts.get("retry_exceptions", False),
            name=opts.get("name"),
            runtime_env=opts.get("runtime_env"),
            **_scheduling_opts(opts),
        )
        if opts.get("num_returns", 1) == 1:
            return refs[0]
        return refs

    def bind(self, *args, **kwargs):
        """Build a lazy DAG node instead of executing (reference:
        python/ray/dag — f.bind(x))."""
        from ray_tpu_torch.dag.dag_node import FunctionNode

        return FunctionNode(self, args, kwargs)

    @property
    def underlying_function(self):
        return self._func
