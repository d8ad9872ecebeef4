"""Models of the port: the flagship decoder-only transformer (dense path) and
its KV-cache inference (``models.generate``)."""

from ray_tpu_torch.models.transformer import (  # noqa: F401
    TransformerConfig,
    adamw,
    forward,
    forward_hidden,
    init_params,
    loss_fn,
    make_train_step,
    num_params,
    param_leaves,
    params_from_jax,
)
