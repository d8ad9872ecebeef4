"""DeploymentHandle — Python-side calls into a deployment.

Reference: python/ray/serve/handle.py (RayServeHandle / DeploymentHandle):
``handle.remote(*args)`` routes through the shared Router to a replica actor
and returns an ObjectRef; ``handle.method.remote(...)`` calls a specific
method of a class deployment.
"""

from __future__ import annotations

import threading

import ray_tpu_torch


class _MethodCaller:
    def __init__(self, handle: "DeploymentHandle", method_name: str):
        self._handle = handle
        self._method = method_name

    def remote(self, *args, **kwargs):
        return self._handle._invoke(self._method, args, kwargs)


class DeploymentHandle:
    def __init__(
        self,
        deployment_name: str,
        router,
        multiplexed_model_id: str = "",
        prefix_hint: str = "",
    ):
        self._deployment = deployment_name
        self._router = router
        self._multiplexed_model_id = multiplexed_model_id
        self._prefix_hint = prefix_hint

    def options(
        self,
        *,
        multiplexed_model_id: str | None = None,
        prefix_hint: str | None = None,
    ) -> "DeploymentHandle":
        """Per-call options (reference: handle.options(multiplexed_model_id=…)).
        ``prefix_hint`` routes to the replica holding a shared prompt's KV
        prefix-cache blocks (serve.llm.prefix_route_hint). Unspecified
        options keep the handle's current values (pass "" to clear one)."""
        return DeploymentHandle(
            self._deployment,
            self._router,
            multiplexed_model_id=(
                self._multiplexed_model_id
                if multiplexed_model_id is None
                else multiplexed_model_id
            ),
            prefix_hint=self._prefix_hint if prefix_hint is None else prefix_hint,
        )

    def remote(self, *args, **kwargs):
        return self._invoke("__call__", args, kwargs)

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        return _MethodCaller(self, item)

    def _invoke(self, method: str, args: tuple, kwargs: dict):
        import time

        model_id = self._multiplexed_model_id
        t0 = time.monotonic()
        # Assign -> dead-replica race: a replica can die after the router
        # hands it out but before it accepts (its table entry lingers until
        # the controller notices). ONE bounded reassign, driven by a cheap
        # GCS liveness probe after submission, keeps that window from
        # surfacing a raw ActorDiedError to the caller.
        exclude: list = []
        for attempt in range(2):
            replica = self._router.assign_replica(
                self._deployment,
                model_id=model_id,
                prefix_hint=self._prefix_hint,
                exclude=exclude,
            )
            try:
                actor = self._router.handle_for(replica)
                ref = actor.handle_request.remote(
                    method, args, kwargs, multiplexed_model_id=model_id
                )
            except Exception:
                self._router.release(replica, deployment=self._deployment)
                self._router.invalidate_handle(replica)
                if attempt == 0:
                    exclude.append(replica["actor_name"])
                    continue
                raise
            if attempt == 0 and not self._router.replica_alive(replica):
                # Submitted into a corpse: the ref is doomed (its error
                # resolves via refcounting; nobody waits on it). Reassign.
                self._router.release(replica, deployment=self._deployment)
                self._router.invalidate_handle(replica)
                exclude.append(replica["actor_name"])
                continue
            break
        # Release the slot once the result lands (fire-and-forget waiter);
        # the assign->result interval feeds ray_tpu_serve_replica_latency_s.
        router = self._router
        deployment = self._deployment

        def _release():
            try:
                ray_tpu_torch.wait([ref], num_returns=1, timeout=3600, fetch_local=False)
            finally:
                router.release(
                    replica, deployment=deployment, duration_s=time.monotonic() - t0
                )

        threading.Thread(target=_release, daemon=True).start()
        return ref
