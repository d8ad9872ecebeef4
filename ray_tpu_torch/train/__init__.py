"""ray_tpu_torch.train — distributed training (reference: python/ray/train).

``train/torch`` holds the trainer (``TorchTrainer``). The JAX package's
predictors, sklearn/rl trainers and ``train/jax/checkpointing.py`` are not
ported (ROADMAP A5, what remains).
"""

from ray_tpu_torch.train.base_trainer import BaseTrainer, Result  # noqa: F401
from ray_tpu_torch.train.data_parallel_trainer import DataParallelTrainer  # noqa: F401
