from ray_tpu_torch.rllib.algorithms.maml.maml import MAML, MAMLConfig  # noqa: F401
