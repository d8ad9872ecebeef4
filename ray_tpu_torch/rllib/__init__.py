"""ray_tpu_torch.rllib — reinforcement learning on the port's runtime.

Analog of the reference's RLlib (rllib/): CPU rollout-worker actors step
vectorized envs (the port's own numpy CartPole-v1, or gymnasium's for any
other id); a torch Learner (in this process, or an actor gang with gradient
allreduce over the collective plane) runs SGD on the card; Algorithm extends
the Tune Trainable. The Decision Transformer's attention runs the port's
flash-attention kernels.

Ported so far (ROADMAP A13a-c, f and part of e): PPO, IMPALA, APPO and DT
with the layers under them. The JAX package's other algorithms, its
multi-agent, external-env and policy-server modules, and the Podracer device
weight sync (A13d) are not exported here until they are ported.
"""

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.appo import APPO, APPOConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.dt import DT, DTConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.impala import IMPALA, IMPALAConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig  # noqa: F401
from ray_tpu_torch.rllib.callbacks import DefaultCallbacks  # noqa: F401
from ray_tpu_torch.rllib.core.learner import Learner, LearnerGroup  # noqa: F401
from ray_tpu_torch.rllib.core.rl_module import RLModule, RLModuleSpec  # noqa: F401
from ray_tpu_torch.rllib.env.vector_env import (  # noqa: F401
    EnvContext,
    MultiAgentVectorEnv,
    VectorEnv,
    make_vector_env,
)
from ray_tpu_torch.rllib.policy.policy import Policy  # noqa: F401
from ray_tpu_torch.rllib.policy.sample_batch import MultiAgentBatch, SampleBatch, compute_gae  # noqa: F401
