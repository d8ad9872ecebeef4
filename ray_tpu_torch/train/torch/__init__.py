"""ray_tpu_torch.train.torch — the port's trainer.

``TorchTrainer`` stands in for the JAX package's ``JaxTrainer``
(``ray_tpu/train/jax``, the accelerator path: a worker actor per device,
the train loop on the card) and for its ``TorchTrainer``
(``ray_tpu/train/torch``, gloo process groups over CPU workers). With
``ScalingConfig(use_gpu=True)``, the default, each worker is bound to a CUDA
card and a gang of several forms an NCCL process group; with
``use_gpu=False`` the workers train on the CPU over gloo.
"""

from ray_tpu_torch.train.torch.config import TorchConfig  # noqa: F401
from ray_tpu_torch.train.torch.torch_trainer import TorchTrainer  # noqa: F401
from ray_tpu_torch.train.torch.train_loop_utils import (  # noqa: F401
    get_device,
    prepare_batch,
    prepare_data_loader,
    prepare_model,
    report,
)
