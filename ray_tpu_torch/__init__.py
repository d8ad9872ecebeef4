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
- ``_private/concurrency.py``: the thread-affinity markers the engine uses.
"""
