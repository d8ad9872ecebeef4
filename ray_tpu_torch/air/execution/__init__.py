"""ray_tpu_torch.air.execution — the shared fault-tolerant execution substrate
beneath the libraries (reference: python/ray/air/execution/).

One audited set of actor restart/leak semantics instead of one per library:
Tune's trial loop, Train's BackendExecutor, and Serve's controller all
route actor lifecycle and resource acquisition through
:class:`ActorManager` + :class:`ResourceManager`.
"""

from ray_tpu_torch.air.execution.actor_manager import (  # noqa: F401
    ActorManager,
    TrackedActor,
    TrackedActorTask,
)
from ray_tpu_torch.air.execution.resources import (  # noqa: F401
    AcquiredResources,
    FixedResourceManager,
    PlacementGroupResourceManager,
    ResourceManager,
    ResourceRequest,
)

__all__ = [
    "ActorManager",
    "TrackedActor",
    "TrackedActorTask",
    "AcquiredResources",
    "FixedResourceManager",
    "PlacementGroupResourceManager",
    "ResourceManager",
    "ResourceRequest",
]
