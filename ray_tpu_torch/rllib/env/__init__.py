from ray_tpu_torch.rllib.env.cartpole import CartPoleEnv, make  # noqa: F401
from ray_tpu_torch.rllib.env.meta_env import PointGoalEnv, TaskSettableEnv  # noqa: F401
from ray_tpu_torch.rllib.env.multi_agent_env import MultiAgentEnv, make_multi_agent  # noqa: F401
from ray_tpu_torch.rllib.env.pendulum import PendulumEnv  # noqa: F401
from ray_tpu_torch.rllib.env.recsys import SlateRecEnv  # noqa: F401
from ray_tpu_torch.rllib.env.spaces import Box, Discrete  # noqa: F401
from ray_tpu_torch.rllib.env.vector_env import (  # noqa: F401
    EnvContext,
    MultiAgentVectorEnv,
    VectorEnv,
    make_vector_env,
)
from ray_tpu_torch.rllib.env.external_env import ExternalEnv, ExternalEnvRunner  # noqa: F401
from ray_tpu_torch.rllib.env.policy_server import PolicyClient, PolicyServerInput  # noqa: F401
