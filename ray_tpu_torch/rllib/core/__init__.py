from ray_tpu_torch.rllib.core.learner import Learner, LearnerGroup  # noqa: F401
from ray_tpu_torch.rllib.core.rl_module import RLModule, RLModuleSpec, rl_module_params_from_jax  # noqa: F401
