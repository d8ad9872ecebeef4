"""ray_tpu_torch.serve — actor-based model serving with HTTP ingress.

The port's copy of ``ray_tpu/serve`` (itself the analog of Ray Serve,
python/ray/serve/): a singleton controller actor reconciles deployments into
replica actors; per-node HTTP proxy actors route by prefix; Python handles
route through a shared Router with queue-limit-aware round-robin;
queue-depth autoscaling. GPU replicas take a card or a fraction of one
(``ray_actor_options={"num_gpus": 0.5}``); ``serve.llm`` serves the
continuous-batching LLM engine over SSE, monolithic or as a disaggregated
prefill/decode pair that hands the KV blocks over on the device-object plane.

Not ported: ``serve/schema.py`` (the pydantic models of the ``serve deploy``
CLI), ``DAGDriver`` and ``http_adapters`` (ROADMAP A14).
"""

from ray_tpu_torch.serve._private.common import AutoscalingConfig, DeploymentConfig  # noqa: F401
from ray_tpu_torch.serve.api import (  # noqa: F401
    Application,
    Deployment,
    StreamingResponse,
    delete,
    deployment,
    get_deployment_handle,
    http_address,
    http_addresses,
    ingress,
    run,
    shutdown,
    start,
    status,
)
from ray_tpu_torch.serve.batching import batch  # noqa: F401
from ray_tpu_torch.serve.handle import DeploymentHandle  # noqa: F401
from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id, multiplexed  # noqa: F401

__all__ = [
    "Application",
    "AutoscalingConfig",
    "Deployment",
    "DeploymentConfig",
    "DeploymentHandle",
    "batch",
    "delete",
    "deployment",
    "get_deployment_handle",
    "get_multiplexed_model_id",
    "multiplexed",
    "http_address",
    "http_addresses",
    "ingress",
    "run",
    "shutdown",
    "start",
    "status",
    "StreamingResponse",
]
