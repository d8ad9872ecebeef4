"""ray_tpu_torch.rllib — reinforcement learning on the port's runtime.

Analog of the reference's RLlib (rllib/): CPU rollout-worker actors step
vectorized envs (the port's own numpy CartPole-v1, or gymnasium's for any
other id); a torch Learner (in this process, or an actor gang with gradient
allreduce over the collective plane) runs SGD on the card; Algorithm extends
the Tune Trainable. The Decision Transformer's attention runs the port's
flash-attention kernels.

Every algorithm directory of the JAX package's RLlib is ported (ROADMAP
A13a-f): PPO, IMPALA, APPO, DT, PG, A2C, A3C, DD-PPO, DQN, SimpleQ, Ape-X
DQN, R2D2, the continuous family (SAC, DDPG, TD3, CQL, CRR, Ape-X DDPG,
MADDPG), the model-based and meta-learning family (DreamerV3, MAML, MBMPO,
with the task-settable ``PointGoalEnv``), the lighter algorithms (MARWIL and
BC, QMIX, SlateQ with the slate env ``SlateRecEnv``, ES and ARS, and the
numpy bandits LinUCB and LinTS), and the MCTS family (AlphaZero on a
state-cloned env, LeelaChessZero on the board protocol of ``env/board_env.py``,
the AlphaStar league on the two-player envs of ``env/two_player.py``), with
the layers under them, the multi-agent env, the port's own Pendulum-v1, the
Podracer weight sync (``weight_sync="device_broadcast"``,
``grad_sync="device_allreduce"``), the external-env and policy-server modules
(``env/external_env.py``, ``env/policy_server.py``) and the ``rllib train``
CLI (``python -m ray_tpu_torch.rllib``).
"""

from ray_tpu_torch.rllib.algorithms.a2c import A2C, A2CConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.a3c import A3C, A3CConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.alpha_star import AlphaStar, AlphaStarConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.alpha_zero import AlphaZero, AlphaZeroConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.apex_ddpg import ApexDDPG, ApexDDPGConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.apex_dqn import ApexDQN, ApexDQNConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.appo import APPO, APPOConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.ars import ARS, ARSConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.bandits import BanditConfig, BanditLinTS, BanditLinUCB  # noqa: F401
from ray_tpu_torch.rllib.algorithms.cql import CQL, CQLConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.crr import CRR, CRRConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.ddpg import DDPG, TD3, DDPGConfig, TD3Config  # noqa: F401
from ray_tpu_torch.rllib.algorithms.ddppo import DDPPO, DDPPOConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.dqn import DQN, DQNConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.dreamerv3 import DreamerV3, DreamerV3Config  # noqa: F401
from ray_tpu_torch.rllib.algorithms.dt import DT, DTConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.es import ES, ESConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.impala import IMPALA, IMPALAConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.leela_chess_zero import LeelaChessZero, LeelaChessZeroConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.maddpg import MADDPG, MADDPGConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.maml import MAML, MAMLConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.marwil import BC, MARWIL, BCConfig, MARWILConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.mbmpo import MBMPO, MBMPOConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.pg import PG, PGConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.qmix import QMIX, QMIXConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.r2d2 import R2D2, R2D2Config  # noqa: F401
from ray_tpu_torch.rllib.algorithms.sac import SAC, SACConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.simple_q import SimpleQ, SimpleQConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.slateq import SlateQ, SlateQConfig  # noqa: F401
from ray_tpu_torch.rllib.callbacks import DefaultCallbacks  # noqa: F401
from ray_tpu_torch.rllib.core.learner import Learner, LearnerGroup  # noqa: F401
from ray_tpu_torch.rllib.core.rl_module import RLModule, RLModuleSpec  # noqa: F401
from ray_tpu_torch.rllib.env.external_env import ExternalEnv, ExternalEnvRunner  # noqa: F401
from ray_tpu_torch.rllib.env.multi_agent_env import MultiAgentEnv, make_multi_agent  # noqa: F401
from ray_tpu_torch.rllib.env.vector_env import (  # noqa: F401
    EnvContext,
    MultiAgentVectorEnv,
    VectorEnv,
    make_vector_env,
)
from ray_tpu_torch.rllib.policy.policy import Policy  # noqa: F401
from ray_tpu_torch.rllib.policy.sample_batch import MultiAgentBatch, SampleBatch, compute_gae  # noqa: F401
