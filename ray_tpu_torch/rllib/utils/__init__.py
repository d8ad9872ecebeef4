from ray_tpu_torch.rllib.utils.replay_buffers import PrioritizedReplayBuffer, ReplayBuffer  # noqa: F401
from ray_tpu_torch.rllib.utils.vtrace import vtrace  # noqa: F401
