"""Continuous-batching LLM serving: paged KV cache + slot-level scheduler +
prefix-cache reuse, with per-request token streams.

- ``LLMEngine`` — the batching brain: admission into decode slots, chunked
  prefill interleaved with decode, paged-block free list, prefix cache,
  preemption, per-request token streams.
- ``LLMRequest`` — one request's stream (iterate it, or ``result()``).
- ``block_hashes`` / ``prefix_route_hint`` — the chain hashes the prefix
  cache keys on, and the router affinity hint built from the first block.

Not ported yet: ``LLMDeployment`` (``deployment.py``, which needs the serve
controller and proxy) and ``kv_transfer.py`` (the object store).
"""

from ray_tpu_torch.serve.llm.engine import LLMEngine, LLMRequest, block_hashes, prefix_route_hint

__all__ = ["LLMEngine", "LLMRequest", "block_hashes", "prefix_route_hint"]
