"""Model serving of the port.

So far the continuous-batching LLM engine (``serve.llm``): a slot scheduler
over the paged KV cache of ``models/generate.py``, driven in-process. The
serve controller, HTTP proxy, handles and deployments of ``ray_tpu/serve``
need the port's copy of the runtime and are not ported yet.
"""

from ray_tpu_torch.serve.llm import LLMEngine, LLMRequest, block_hashes, prefix_route_hint

__all__ = ["LLMEngine", "LLMRequest", "block_hashes", "prefix_route_hint"]
