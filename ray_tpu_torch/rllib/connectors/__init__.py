"""Connectors — observation/action transformation pipelines.

Analog of the reference's rllib/connectors/{agent,action}/: small composable
transforms between the environment and the policy. Agent connectors shape
raw observations into what the module expects (normalization, clipping,
flattening); action connectors shape module outputs back for the env
(clipping/unsquashing). Stateful connectors (MeanStdFilter) carry running
statistics that sync across rollout workers with the weights — states ride
the same broadcast path, keeping everything mesh-friendly (pure arrays).
"""

from ray_tpu_torch.rllib.connectors.connector import (  # noqa: F401
    ActionConnector,
    ActionConnectorPipeline,
    AgentConnector,
    AgentConnectorPipeline,
    ClipActions,
    ClipObservations,
    ConnectorPipeline,
    ConvertToNumpy,
    FlattenObservations,
    FrameStack,
    MeanStdFilter,
    ObsPreprocessor,
    UnsquashActions,
    ViewRequirementConnector,
)
