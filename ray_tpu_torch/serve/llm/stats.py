"""The registry of live continuous-batching LLM engines.

From ``ray_tpu/serve/llm/stats.py``: ``ENGINES`` holds every engine whose
scheduler loop is still running, so a reader can sum their ``stats()`` into
one series. The JAX package's process-global counters (``LLM``) feed its
metrics exporter; the port has no exporter yet, and each engine's
``stats()`` carries its own counts.
"""

from __future__ import annotations

import weakref

# Engines register here at construction; the scheduler loop's exit (stop or
# crash) withdraws them. WeakSet so an abandoned engine can't pin itself.
ENGINES: "weakref.WeakSet" = weakref.WeakSet()
