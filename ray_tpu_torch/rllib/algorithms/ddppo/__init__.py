from ray_tpu_torch.rllib.algorithms.ddppo.ddppo import DDPPO, DDPPOConfig  # noqa: F401
