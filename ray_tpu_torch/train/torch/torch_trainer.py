"""TorchTrainer — data-parallel torch training on the actor gang.

Reference: python/ray/train/torch/torch_trainer.py (TorchTrainer is
DataParallelTrainer + _TorchBackend); in this package it also takes the
place of the JAX package's ``JaxTrainer``. The train loop runs per worker on
its bound device (``session.get_device()``: a CUDA card by default), with a
torch.distributed group already formed when the gang has more than one
worker; `prepare_model` / `prepare_data_loader` / `prepare_batch`
(train_loop_utils) move models and batches to the device and wrap DDP and
DistributedSampler.
"""

from __future__ import annotations

from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.data_parallel_trainer import DataParallelTrainer
from ray_tpu_torch.train.torch.config import TorchConfig


class TorchTrainer(DataParallelTrainer):
    def __init__(
        self,
        train_loop_per_worker,
        *,
        train_loop_config: dict | None = None,
        torch_config: TorchConfig | None = None,
        scaling_config: ScalingConfig | None = None,
        run_config: RunConfig | None = None,
        datasets: dict | None = None,
        resume_from_checkpoint=None,
    ):
        torch_config = torch_config or TorchConfig()
        super().__init__(
            train_loop_per_worker,
            train_loop_config=train_loop_config,
            backend=torch_config.backend_cls(),
            scaling_config=scaling_config,
            run_config=run_config,
            datasets=datasets,
            resume_from_checkpoint=resume_from_checkpoint,
        )
