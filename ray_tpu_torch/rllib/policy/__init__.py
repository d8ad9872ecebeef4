from ray_tpu_torch.rllib.policy.policy import Policy  # noqa: F401
from ray_tpu_torch.rllib.policy.sample_batch import MultiAgentBatch, SampleBatch, compute_gae  # noqa: F401
