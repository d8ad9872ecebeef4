from ray_tpu_torch.rllib.algorithms.dqn.dqn import DQN, DQNConfig, dqn_loss, q_forward  # noqa: F401
