from ray_tpu_torch.rllib.algorithms.ppo.ppo import PPO, PPOConfig, ppo_loss  # noqa: F401
