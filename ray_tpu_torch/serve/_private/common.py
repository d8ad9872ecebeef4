"""Shared Serve types (reference: python/ray/serve/_private/common.py)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional


@dataclasses.dataclass
class DeploymentConfig:
    """Per-deployment config (reference: serve/config.py DeploymentConfig +
    autoscaling_policy.py AutoscalingConfig)."""

    num_replicas: int = 1
    max_concurrent_queries: int = 100
    user_config: Any = None
    ray_actor_options: dict = dataclasses.field(default_factory=dict)
    health_check_period_s: float = 10.0
    health_check_timeout_s: float = 30.0
    graceful_shutdown_timeout_s: float = 20.0
    # Drain-before-retire bound for DELIBERATE stops (downscale, rolling
    # update, deployment delete): the replica leaves the routing table,
    # refuses new requests, and gets up to this long for in-flight
    # requests/streams to finish before the process is retired. 0 disables
    # draining (immediate retire, the pre-drain behavior). Health-check
    # failures always retire immediately — a dead replica drains nothing.
    drain_timeout_s: float = 30.0
    autoscaling: Optional["AutoscalingConfig"] = None
    # None = autogenerate from code + init args + user_config at deploy time
    # (reference: unversioned deployments get a new version on every deploy,
    # serve/_private/version.py DeploymentVersion).
    version: Optional[str] = None


@dataclasses.dataclass
class AutoscalingConfig:
    """Queue-depth-driven autoscaling (reference:
    serve/_private/autoscaling_policy.py:9 calculate_desired_num_replicas)."""

    min_replicas: int = 1
    max_replicas: int = 4
    target_num_ongoing_requests_per_replica: float = 2.0
    upscale_delay_s: float = 3.0
    downscale_delay_s: float = 30.0


@dataclasses.dataclass
class ReplicaInfo:
    replica_id: str
    deployment_name: str
    actor_name: str
    max_concurrent_queries: int
    version: str


@dataclasses.dataclass
class DeploymentInfo:
    name: str
    app_name: str
    import_spec: bytes  # pickled (cls_or_fn, init_args, init_kwargs)
    config: DeploymentConfig
    route_prefix: Optional[str] = None


CONTROLLER_NAME = "SERVE_CONTROLLER"
PROXY_NAME = "SERVE_PROXY"

# HTTP header / handle option carrying the multiplexed model id
# (reference: serve/_private/constants.py SERVE_MULTIPLEXED_MODEL_ID).
MULTIPLEXED_MODEL_ID_HEADER = "serve_multiplexed_model_id"

# HTTP header / handle option carrying the prefix-cache routing hint
# (serve.llm.prefix_route_hint): requests sharing a system prompt carry the
# same value and the router pins them to the replica holding those KV
# blocks, falling back to least queue depth.
PREFIX_HINT_HEADER = "serve_prefix_hash"

# Naming convention pairing disaggregated LLM pools: the proxy
# discovers the prefill pool as f"{decode_deployment}{PREFILL_SUFFIX}" in
# its routing table. Lives here (not serve.llm.deployment, which re-exports
# it) so the proxy path never imports the model stack.
PREFILL_SUFFIX = "--prefill"


class HandleMarker:
    """Placeholder for a DeploymentHandle inside pickled init args —
    deployment composition (reference: deployment graphs / DeploymentNode
    bound as an argument). Replicas materialize it at construction."""

    def __init__(self, deployment_name: str):
        self.deployment_name = deployment_name

    def __repr__(self):
        return f"HandleMarker({self.deployment_name!r})"
