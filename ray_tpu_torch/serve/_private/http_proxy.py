"""HTTP ingress proxy actor.

Reference: python/ray/serve/_private/http_proxy.py:320 HTTPProxy (ASGI app),
:553 HTTPProxyActor — one proxy actor per node, routing by longest prefix to
deployment replicas. The routing logic lives in `ProxyASGIApp`
(_private/asgi.py), a pure ASGI-3 application — exactly the reference's
shape — and this actor just binds it to a server. The server is
`ASGIServer`, HTTP/1.1 on the standard library's asyncio streams; swapping
servers touches only that class, never the app. Replica calls run in an
executor so the HTTP loop never blocks on the object store.
"""

from __future__ import annotations

import asyncio
import logging
import threading
from concurrent.futures import ThreadPoolExecutor

import ray_tpu_torch

logger = logging.getLogger(__name__)


class HTTPProxy:
    def __init__(self, controller_name: str, host: str = "127.0.0.1", port: int = 8000):
        from ray_tpu_torch.serve._private.router import Router

        controller = ray_tpu_torch.get_actor(controller_name)
        self._router = Router(controller)
        self._host = host
        self._port = port
        self._pool = ThreadPoolExecutor(max_workers=32, thread_name_prefix="proxy-call")
        self._ready = threading.Event()
        self._actual_port = None
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()
        self._ready.wait(timeout=30)

    def address(self) -> tuple:
        return (self._host, self._actual_port)

    def ready(self) -> bool:
        return self._ready.is_set()

    def _serve(self):
        from ray_tpu_torch.serve._private.asgi import ASGIServer, ProxyASGIApp

        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        app = ProxyASGIApp(self._router, self._pool)
        server = ASGIServer(app, self._host, self._port)
        loop.run_until_complete(server.start())
        self._actual_port = server.port
        self._ready.set()
        loop.run_forever()
