"""ray_tpu_torch.train — distributed training (reference: python/ray/train).

``train/torch`` holds the trainer (``TorchTrainer``); ``predictor.py`` the
predictors (``TorchPredictor`` in place of the JAX package's
``JaxPredictor``, and ``BatchPredictor``). The JAX package's sklearn/rl
trainers and ``train/jax/checkpointing.py`` are not ported (ROADMAP A5, what
remains).
"""

from ray_tpu_torch.train.base_trainer import BaseTrainer, Result  # noqa: F401
from ray_tpu_torch.train.data_parallel_trainer import DataParallelTrainer  # noqa: F401
from ray_tpu_torch.train.predictor import BatchPredictor, Predictor, TorchPredictor  # noqa: F401
