"""Continuous-batching LLM serving: paged KV cache + slot-level scheduler +
prefix-cache reuse, streamed through the Serve replica path.

- ``LLMEngine`` — the batching brain: admission into decode slots, chunked
  prefill interleaved with decode, paged-block free list, prefix cache,
  preemption, per-request token streams; ``role="prefill"`` ends requests
  with a sealed-KV handoff, ``kv_import`` continues one, ``cluster_prefix``
  shares prompt prefixes across engines (``kv_transfer.py``).
- ``LLMRequest`` — one request's stream (iterate it, or ``result()``).
- ``LLMDeployment`` — serve-ready wrapper (SSE streaming over HTTP);
  ``disaggregated_llm_app`` builds the prefill/decode pair of pools.
- ``block_hashes`` / ``prefix_route_hint`` — the chain hashes the prefix
  cache keys on, and the router affinity hint built from the first block
  (send it as the ``serve_prefix_hash`` header or
  ``handle.options(prefix_hint=...)``).
"""

from ray_tpu_torch.serve.llm.deployment import PREFILL_SUFFIX, LLMDeployment, disaggregated_llm_app
from ray_tpu_torch.serve.llm.engine import LLMEngine, LLMRequest, block_hashes, prefix_route_hint

__all__ = [
    "LLMDeployment",
    "LLMEngine",
    "LLMRequest",
    "PREFILL_SUFFIX",
    "block_hashes",
    "disaggregated_llm_app",
    "prefix_route_hint",
]
