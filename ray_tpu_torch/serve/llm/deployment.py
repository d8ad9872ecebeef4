"""Serve-ready wrapper around ``LLMEngine``: streaming chat behind HTTP.

The port's copy of ``ray_tpu/serve/llm/deployment.py``. Deploy it like any
callable — the replica holds the engine (the weights and the paged KV pool,
on the card unless ``device="cpu"``), requests stream tokens over SSE through
the existing replica ``_StreamPump`` path, and a client disconnect frees the
request's decode slot and KV blocks immediately via
``StreamingResponse.on_disconnect``:

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.llm import LLMDeployment

    ray_tpu_torch.init(num_gpus=1)
    app = serve.deployment(ray_actor_options={"num_gpus": 0.5})(LLMDeployment).bind(
        model_config={"vocab_size": 32000, "d_model": 1024, "n_layers": 8,
                      "n_heads": 8, "n_kv_heads": 8, "d_ff": 2816,
                      "max_seq_len": 1024, "dtype": "bfloat16",
                      "param_dtype": "float32", "remat": False},
        engine_config={"num_slots": 8, "block_size": 16, "prefill_chunk": 128},
    )
    serve.run(app, route_prefix="/llm")

    curl -N http://host:port/llm -d '{"tokens": [1,2,3], "max_new_tokens": 16}'
    data: {"token": 42}
    ...
    data: [DONE]

Request body: ``{"tokens": [int], "max_new_tokens": int, "temperature":
float, "top_k": int, "seed": int, "stream": bool}`` — ``stream`` defaults
true (SSE); false buffers and returns ``{"tokens": [...]}``.

Disaggregated serving: give the engine ``role="prefill"`` and
requests terminate with a ``{"__llm_handoff__": ...}`` envelope — the
sealed-KV descriptor plus the first sampled token — instead of decoding.
The proxy forwards that descriptor to a decode-pool replica as
``kv_import=`` + ``resume_tokens=`` (+ ``echo_resume``, so the client
still sees the prefill-sampled token in its stream). Build the two-pool
app with :func:`disaggregated_llm_app`.
"""

from __future__ import annotations

import json

from ray_tpu_torch.serve._private.common import PREFILL_SUFFIX  # noqa: F401
from ray_tpu_torch.serve.llm.engine import LLMEngine, prefix_route_hint  # noqa: F401


class LLMDeployment:
    def __init__(
        self,
        model_config: dict,
        engine_config: dict | None = None,
        init_seed: int = 0,
        params=None,
        device: str = "cuda",
    ):
        """``model_config``: ``TransformerConfig``'s fields, the dtypes as
        names (``"bfloat16"``, ``"float32"``) so the config stays JSON.
        ``params``: the weights, else ``init_params(cfg, init_seed)`` on
        ``device`` (the card unless the caller asks for the CPU)."""
        import torch

        from ray_tpu_torch.models.transformer import TransformerConfig, init_params

        model_config = dict(model_config)
        for field in ("dtype", "param_dtype"):
            if isinstance(model_config.get(field), str):  # JSON-friendly configs
                model_config[field] = getattr(torch, model_config[field])
        self.cfg = TransformerConfig(**model_config)
        if params is None:
            params = init_params(self.cfg, init_seed, device=device)
        self.engine = LLMEngine(params, self.cfg, **(engine_config or {}))

    def __call__(self, request):
        from ray_tpu_torch.serve.api import StreamingResponse

        body = request.json() if hasattr(request, "json") else dict(request)
        req = self.engine.submit(
            body["tokens"],
            max_new_tokens=int(body.get("max_new_tokens", 32)),
            temperature=float(body.get("temperature", 0.0)),
            top_k=int(body.get("top_k", 0)),
            seed=int(body.get("seed", 0)),
            resume_tokens=body.get("resume_tokens"),
            kv_import=body.get("kv_import"),
        )
        # Resume tokens a migrated/handed-off request already owns but the
        # CLIENT has not seen yet (the handoff descriptor's first sampled
        # token): echo them ahead of the engine's stream so the client's
        # token sequence is complete. The engine itself never re-emits
        # resume tokens — echoing is presentation, owned here.
        echo = [int(t) for t in (body.get("resume_tokens") or ())] if body.get(
            "echo_resume"
        ) else []
        if self.engine.role == "prefill":
            return self._prefill_call(body, req)
        if not body.get("stream", True):
            try:
                toks = req.result(timeout=float(body.get("timeout", 120.0)))
                return {"tokens": echo + toks}
            except BaseException:
                # A timed-out (or otherwise failed) buffered request must not
                # keep generating into a queue nobody will read — free its
                # decode slot and KV blocks now, like the SSE path does.
                self.engine.cancel(req)
                raise
        engine = self.engine

        def sse():
            try:
                for tok in echo:
                    yield f"data: {json.dumps({'token': tok})}\n\n"
                for tok in req:
                    yield f"data: {json.dumps({'token': tok})}\n\n"
                yield "data: [DONE]\n\n"
            finally:
                # Belt: normal completion makes this a no-op; an aborted
                # generator (pump saw `cancelled` at a yield) frees the
                # request even if on_disconnect never fired.
                engine.cancel(req)

        return StreamingResponse(
            sse(),
            content_type="text/event-stream",
            # Suspenders: fires synchronously from cancel_stream / the idle
            # reaper, so the decode slot and KV blocks free immediately
            # even while the generator is parked waiting for a token.
            on_disconnect=lambda: engine.cancel(req),
            # Migration descriptor: if THIS replica dies mid-stream, the
            # proxy resubmits the original body to another replica with
            # resume_tokens= the tokens it already forwarded; "sse_tokens"
            # tells the proxy how to parse them back out of the SSE chunks
            # it relayed. The one-shot handoff fields must NOT ride along:
            # kv_import's payload is gone after the first import, and a
            # re-echo would duplicate tokens the client already has.
            # Counter-based sampling makes the continuation bit-identical,
            # so the client never notices.
            resume={
                "kind": "sse_tokens",
                "body": {
                    k: v
                    for k, v in body.items()
                    if k not in ("resume_tokens", "kv_import", "echo_resume")
                },
            },
        )

    def _prefill_call(self, body: dict, req) -> dict:
        """Prefill-role request: block until the engine finishes prefill and
        return the handoff envelope the proxy forwards to the decode pool.
        When the engine could not seal a payload (bare process) it decoded
        locally instead — return the plain buffered result so a mono-pool
        fallback still answers the client."""
        try:
            toks = req.result(timeout=float(body.get("timeout", 120.0)))
        except BaseException:
            self.engine.cancel(req)
            raise
        if req.handoff is None:
            return {"tokens": toks}
        desc = dict(req.handoff)
        tok0 = desc.pop("tok0")
        return {
            "__llm_handoff__": {
                "kv_import": desc,
                "resume_tokens": [tok0],
                "body": {
                    k: v
                    for k, v in body.items()
                    if k not in ("resume_tokens", "kv_import", "echo_resume")
                },
            }
        }

    def get_stats(self) -> dict:
        """Engine snapshot (handle-callable; used by tests and benches)."""
        return self.engine.stats()

    def check_health(self):
        self.engine.check_health()

    def drain(self):
        """Controller-initiated drain-before-retire: the engine refuses new
        admissions; in-flight decodes run to completion."""
        self.engine.drain()

    def prepare_for_shutdown(self):
        self.engine.shutdown()


def disaggregated_llm_app(
    model_config: dict,
    engine_config: dict | None = None,
    *,
    name: str = "llm",
    prefill_replicas: int = 1,
    decode_replicas: int = 1,
    cluster_prefix: bool = True,
    max_concurrent_queries: int = 100,
    init_seed: int = 0,
    route_prefix: str | None = "/llm",
    ray_actor_options: dict | None = None,
    device: str = "cuda",
    params=None,
):
    """Build the two-pool disaggregated serving application: a decode
    deployment that OWNS the route and a paired ``<name>--prefill``
    deployment the proxy discovers by naming convention. Pool sizes are
    static config (no cross-pool autoscaler). ``ray_actor_options`` apply to
    every replica of both pools (``{"num_gpus": 0.5}`` puts a prefill and a
    decode replica on one card); ``device`` is where each builds its
    weights, or ``params`` the weights both pools load. Returns the decode Application; ``serve.run(app)`` deploys both
    pools.
    """
    from ray_tpu_torch import serve

    engine_config = dict(engine_config or {})
    engine_config.pop("role", None)
    prefill_cfg = dict(
        engine_config, role="prefill", cluster_prefix=cluster_prefix
    )
    decode_cfg = dict(engine_config, role="decode", cluster_prefix=False)
    prefill = serve.deployment(
        num_replicas=int(prefill_replicas),
        name=f"{name}{PREFILL_SUFFIX}",
        max_concurrent_queries=max_concurrent_queries,
        route_prefix=None,
        ray_actor_options=ray_actor_options,
    )(LLMDeployment).bind(
        model_config=model_config,
        engine_config=prefill_cfg,
        init_seed=init_seed,
        device=device,
        params=params,
    )
    decode = serve.deployment(
        num_replicas=int(decode_replicas),
        name=name,
        max_concurrent_queries=max_concurrent_queries,
        route_prefix=route_prefix,
        ray_actor_options=ray_actor_options,
    )(LLMDeployment).bind(
        model_config=model_config,
        engine_config=decode_cfg,
        init_seed=init_seed,
        device=device,
        params=params,
    )
    # The decode app is the root; the prefill app rides as a sibling of
    # the same application tree (deployed together, torn down together).
    decode.extras.append(prefill)
    return decode
