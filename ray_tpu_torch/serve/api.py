"""Public Serve API.

Reference: python/ray/serve/api.py — serve.start :61, @serve.deployment :241,
serve.run :413; Deployment in serve/deployment.py.

Usage:
    @serve.deployment(num_replicas=2)
    class Model:
        def __call__(self, request): ...

    handle = serve.run(Model.bind(arg), route_prefix="/model")
    ray_tpu_torch.get(handle.remote(x))
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pickle
import time

import cloudpickle
from typing import Any, Callable, Optional

import ray_tpu_torch
from ray_tpu_torch.serve._private.common import (
    CONTROLLER_NAME,
    AutoscalingConfig,
    DeploymentConfig,
    DeploymentInfo,
    HandleMarker,
)
from ray_tpu_torch.serve.handle import DeploymentHandle

_started = False
_http_port: Optional[int] = None


class Application:
    """A bound deployment (reference: serve's built Application via .bind())."""

    def __init__(self, deployment: "Deployment", init_args: tuple, init_kwargs: dict):
        self.deployment = deployment
        self.init_args = init_args
        self.init_kwargs = init_kwargs
        # Sibling applications deployed (and torn down) WITH this one but
        # not referenced from its init args — e.g. the prefill pool paired
        # with a disaggregated LLM decode deployment, which the proxy finds
        # by naming convention rather than by handle. Each keeps its own
        # name and route prefix.
        self.extras: list = []


class Deployment:
    def __init__(self, cls_or_fn: Callable, name: str, config: DeploymentConfig, route_prefix: Optional[str]):
        self._cls_or_fn = cls_or_fn
        self.name = name
        self.config = config
        self.route_prefix = route_prefix

    def bind(self, *args, **kwargs) -> Application:
        return Application(self, args, kwargs)

    def options(self, *, num_replicas: Optional[int] = None, name: Optional[str] = None,
                max_concurrent_queries: Optional[int] = None, user_config: Any = None,
                ray_actor_options: Optional[dict] = None, autoscaling_config=None,
                route_prefix: Optional[str] = "__unset__", version: Optional[str] = None,
                drain_timeout_s: Optional[float] = None) -> "Deployment":
        import dataclasses

        cfg = dataclasses.replace(self.config)
        if num_replicas is not None:
            cfg.num_replicas = num_replicas
        if drain_timeout_s is not None:
            cfg.drain_timeout_s = drain_timeout_s
        if max_concurrent_queries is not None:
            cfg.max_concurrent_queries = max_concurrent_queries
        if user_config is not None:
            cfg.user_config = user_config
        if ray_actor_options is not None:
            cfg.ray_actor_options = ray_actor_options
        if autoscaling_config is not None:
            cfg.autoscaling = _coerce_autoscaling(autoscaling_config)
        if version is not None:
            cfg.version = version
        return Deployment(
            self._cls_or_fn,
            name or self.name,
            cfg,
            self.route_prefix if route_prefix == "__unset__" else route_prefix,
        )


def deployment(
    _cls=None,
    *,
    name: Optional[str] = None,
    num_replicas: int = 1,
    max_concurrent_queries: int = 100,
    user_config: Any = None,
    ray_actor_options: Optional[dict] = None,
    autoscaling_config=None,
    route_prefix: Optional[str] = None,
    version: Optional[str] = None,
    drain_timeout_s: float = 30.0,
):
    """``@serve.deployment`` decorator (reference: api.py:241)."""

    def wrap(cls_or_fn):
        cfg = DeploymentConfig(
            num_replicas=num_replicas,
            max_concurrent_queries=max_concurrent_queries,
            user_config=user_config,
            ray_actor_options=ray_actor_options or {},
            autoscaling=_coerce_autoscaling(autoscaling_config),
            version=version,
            drain_timeout_s=drain_timeout_s,
        )
        return Deployment(cls_or_fn, name or cls_or_fn.__name__, cfg, route_prefix)

    if _cls is not None:
        return wrap(_cls)
    return wrap


def _coerce_autoscaling(cfg) -> Optional[AutoscalingConfig]:
    if cfg is None:
        return None
    if isinstance(cfg, AutoscalingConfig):
        return cfg
    return AutoscalingConfig(**cfg)


def start(http_host: str = "127.0.0.1", http_port: int = 0, detached: bool = True):
    """Start the Serve control plane: controller actor + one HTTP proxy per
    node (reference: http_state.py proxy fleet). The controller's reconcile
    loop keeps a proxy on every ALIVE node and replaces unhealthy ones, so
    ingress survives losing the node a proxy lives on."""
    global _started, _http_port
    if _started:
        return
    from ray_tpu_torch.serve._private.controller import ServeController

    controller_cls = ray_tpu_torch.remote(num_cpus=0, name=CONTROLLER_NAME, max_concurrency=16)(ServeController)
    controller_cls.remote()
    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    addrs = ray_tpu_torch.get(controller.ensure_http.remote(http_host, http_port), timeout=120)
    deadline = time.time() + 60
    while not addrs and time.time() < deadline:
        time.sleep(0.5)
        addrs = ray_tpu_torch.get(controller.proxy_addresses.remote())
    if not addrs:
        raise RuntimeError("no serve proxy came up on any node")
    _http_port = next(iter(addrs.values()))[1]
    _started = True


def http_address() -> tuple:
    """Address of one live ingress proxy (prefer this node's)."""
    from ray_tpu_torch._private.worker_context import get_core_worker

    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    addrs = ray_tpu_torch.get(controller.proxy_addresses.remote())
    if not addrs:
        raise RuntimeError("no live serve proxies")
    local = addrs.get(get_core_worker().node_id)
    return tuple(local if local is not None else next(iter(addrs.values())))


def http_addresses() -> dict:
    """All live ingress proxies, node_id -> (host, port)."""
    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    return {k: tuple(v) for k, v in ray_tpu_torch.get(controller.proxy_addresses.remote()).items()}


def run(app: Application, *, name: str = "default", route_prefix: Optional[str] = "__from_deployment__", _blocking: bool = True) -> DeploymentHandle:
    """Deploy an application and return a handle (reference: api.py:413)."""
    from ray_tpu_torch.serve._private.router import Router

    if not _started:
        start()
    # Deployment composition: Applications bound as init args become child
    # deployments, replaced by HandleMarkers the replicas materialize into
    # DeploymentHandles (reference: deployment graphs / DeploymentNode args).
    infos: dict[str, DeploymentInfo] = {}
    root_name = _build_app_tree(app, name, infos, root_route_prefix=route_prefix)
    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    ray_tpu_torch.get(controller.deploy.remote([pickle.dumps(i) for i in infos.values()]))
    router = Router.shared(controller)
    if _blocking:
        # Worker spawn is ~seconds per replica on an idle box but degrades
        # under CPU contention; scale the readiness budget with the app's
        # STARTUP replica count — autoscaled deployments start at
        # min_replicas, not num_replicas — and apply it to BOTH waits
        # below (overridable: RAY_TPU_TORCH_SERVE_READY_TIMEOUT_S).
        def _startup_replicas(info) -> int:
            auto = getattr(info.config, "autoscaling", None)
            if auto is not None:
                return max(int(getattr(auto, "min_replicas", 1) or 1), 1)
            return max(int(getattr(info.config, "num_replicas", 1) or 1), 1)

        total_replicas = sum(_startup_replicas(i) for i in infos.values())
        try:
            timeout_s = float(os.environ["RAY_TPU_TORCH_SERVE_READY_TIMEOUT_S"])
        except (KeyError, ValueError):  # unset, "" or malformed -> computed default
            timeout_s = 60.0 + 30.0 * total_replicas
        for dep_name, info in infos.items():
            if not router.wait_for_deployment(dep_name, timeout_s=timeout_s):
                raise TimeoutError(f"deployment {dep_name} did not become ready")
            # Block until the full target replica count for this version is
            # RUNNING and stale-version replicas are retired (reference:
            # serve.run waits for the application to reach RUNNING state).
            deadline = time.time() + timeout_s
            while time.time() < deadline:
                st = ray_tpu_torch.get(controller.get_deployments.remote()).get(dep_name)
                if (
                    st is not None
                    and st["version"] == info.config.version
                    and st["num_replicas_current_version"] >= st["target"]
                    and st["num_replicas"] == st["num_replicas_current_version"]
                ):
                    break
                time.sleep(0.05)
            else:
                raise TimeoutError(
                    f"deployment {dep_name} did not reach target replica count"
                )
    return DeploymentHandle(root_name, router)


def _build_app_tree(
    app: Application,
    app_name: str,
    infos: dict,
    root_route_prefix="__from_deployment__",
) -> str:
    """Depth-first build of DeploymentInfos for an application graph.
    Children keep their own deployment names; only the root gets the
    requested route prefix."""
    dep = app.deployment
    existing = infos.get(dep.name)
    if existing is not None:
        # The same Application object bound in two places is a legitimate
        # diamond; two different bindings under one deployment name would
        # silently drop the second one's init args — refuse.
        if existing._source_app_id != id(app):
            raise ValueError(
                f"deployment name {dep.name!r} is bound more than once with "
                "different arguments; give each binding a distinct name via "
                ".options(name=...)"
            )
        return dep.name

    def subst(value):
        if isinstance(value, Application):
            return HandleMarker(_build_app_tree(value, app_name, infos))
        # Recurse into containers so e.g. Ingress.bind([A.bind(), B.bind()])
        # or {"a": A.bind()} also deploy their children.
        if isinstance(value, list):
            return [subst(v) for v in value]
        if isinstance(value, tuple):
            return tuple(subst(v) for v in value)
        if isinstance(value, dict):
            return {k: subst(v) for k, v in value.items()}
        return value

    init_args = tuple(subst(a) for a in app.init_args)
    init_kwargs = {k: subst(v) for k, v in app.init_kwargs.items()}
    prefix = (
        dep.route_prefix
        if root_route_prefix == "__from_deployment__"
        else root_route_prefix
    )
    import_spec = cloudpickle.dumps((dep._cls_or_fn, init_args, init_kwargs))
    cfg = dataclasses.replace(dep.config)
    if cfg.version is None:
        # Unversioned deployment: every change to code, init args, or
        # user_config is a new version → rolling update (reference:
        # serve/_private/version.py DeploymentVersion). JSON with sorted
        # keys gives an order-insensitive digest; cloudpickle covers
        # non-JSON user_configs (lambdas etc.).
        try:
            uc_bytes = json.dumps(cfg.user_config, sort_keys=True).encode()
        except (TypeError, ValueError):
            uc_bytes = cloudpickle.dumps(cfg.user_config)
        cfg.version = hashlib.md5(import_spec + uc_bytes).hexdigest()[:10]
    info = DeploymentInfo(
        name=dep.name,
        app_name=app_name,
        import_spec=import_spec,
        config=cfg,
        route_prefix=prefix,
    )
    info._source_app_id = id(app)
    infos[dep.name] = info
    for extra in getattr(app, "extras", ()):
        _build_app_tree(extra, app_name, infos)
    return dep.name


def get_deployment_handle(deployment_name: str) -> DeploymentHandle:
    from ray_tpu_torch.serve._private.router import Router

    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    return DeploymentHandle(deployment_name, Router.shared(controller))


def status() -> dict:
    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    return ray_tpu_torch.get(controller.get_deployments.remote())


def delete(deployment_name: str):
    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    ray_tpu_torch.get(controller.delete_deployments.remote([deployment_name]))


def shutdown(timeout_s: float = 30.0):
    """Tear down the Serve control plane. Every controller call is BOUNDED:
    a wedged controller (hung reconcile, dead event loop) used to park this
    call forever on an unbounded ``get``; now it is force-killed after
    ``timeout_s`` and the typed ``ActorUnavailableError`` names it."""
    global _started
    from ray_tpu_torch.exceptions import ActorUnavailableError
    from ray_tpu_torch.serve._private.router import Router

    # Another driver (e.g. the CLI) may shut down a running Serve instance:
    # resolve the controller once; absent controller + not started = no-op.
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except Exception:
        if not _started:
            return
        controller = None
    wedged = None
    try:
        if controller is None:
            raise RuntimeError("no controller")
        ray_tpu_torch.get(controller.shutdown_proxies.remote(), timeout=timeout_s)
        ray_tpu_torch.get(controller.graceful_shutdown.remote(), timeout=timeout_s)
        time.sleep(0.2)
        ray_tpu_torch.kill(controller)
    except TimeoutError as e:
        # The controller exists but cannot answer: force-kill it so its
        # replicas/proxies get reaped, then SURFACE the wedge (the old
        # swallow-everything path hid a stuck control plane entirely).
        wedged = ActorUnavailableError(
            f"serve controller {CONTROLLER_NAME!r} did not answer "
            f"graceful shutdown within {timeout_s}s ({type(e).__name__}); "
            "force-killed"
        )
        try:
            ray_tpu_torch.kill(controller)
        except Exception:
            pass
    except Exception:
        pass
    Router.reset()
    _started = False
    if wedged is not None:
        raise wedged


class StreamingResponse:
    """Wrap a generator/iterable to stream the HTTP response body chunk by
    chunk (reference: serve streaming responses). Yielded bytes/str pass
    through; other values are JSON-encoded one per line (SSE-style payloads
    are just str chunks like "data: ...\n\n").

        @serve.deployment
        class Tokens:
            def __call__(self, request):
                return StreamingResponse(self.generate(), content_type="text/plain")
    """

    def __init__(
        self,
        iterator,
        content_type: str = "application/octet-stream",
        status: int = 200,
        headers: Optional[dict] = None,
        on_disconnect: Optional[Callable[[], None]] = None,
        resume: Optional[dict] = None,
    ):
        self.iterator = iterator
        self.content_type = content_type
        self.status = status
        self.headers = headers or {}
        # Called EXACTLY ONCE if the stream is torn down before completion
        # (client disconnect via cancel_stream, or the idle reaper). Lets
        # producers holding real resources — e.g. the LLM engine's decode
        # slot + KV blocks — release them immediately instead of waiting
        # for their generator to observe GeneratorExit on its next yield.
        self.on_disconnect = on_disconnect
        # Mid-stream migration descriptor ({"kind": "sse_tokens", "body":
        # {...}}): if the replica dies mid-stream, the proxy resubmits
        # body (+ resume_tokens it parsed from the chunks it already
        # forwarded) to another replica instead of dropping the stream.
        # None (the default) = the stream is not migratable.
        self.resume = resume


def ingress(asgi_app):
    """Mount an ASGI-3 application as a deployment's HTTP entry.

    Reference: python/ray/serve/api.py:100 `serve.ingress(fastapi_app)` —
    there it mounts FastAPI; here any raw ASGI-3 callable (fastapi/starlette
    are not in the image, and the seam is the ASGI protocol itself, not a
    particular framework). Apply UNDER @serve.deployment:

        @serve.deployment(route_prefix="/svc")
        @serve.ingress(my_asgi_app)
        class Svc:
            pass

    HTTP requests routed to the deployment drive ``my_asgi_app`` with the
    matched route prefix as ASGI root_path (starlette mount semantics);
    handle calls still reach methods defined on the class.
    """

    def decorator(cls):
        from ray_tpu_torch.serve._private.asgi import run_asgi_request

        class ASGIWrapped(cls):
            def __call__(self, request):
                return run_asgi_request(asgi_app, request)

        ASGIWrapped.__name__ = cls.__name__
        ASGIWrapped.__qualname__ = getattr(cls, "__qualname__", cls.__name__)
        ASGIWrapped.__module__ = cls.__module__
        ASGIWrapped.__doc__ = cls.__doc__
        return ASGIWrapped

    return decorator
