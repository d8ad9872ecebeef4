"""Models of the port: the flagship decoder-only transformer (dense or
mixture-of-experts) and its KV-cache inference (``models.generate``), plus
the MLP, ResNet and ViT of the JAX package's zoo.

The JAX package's ``models`` exports a function ``generate`` over its
submodule's name; here ``models.generate`` stays the submodule, which callers
import as such (the function is ``models.generate.generate``)."""

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
from ray_tpu_torch.models.generate import (  # noqa: F401
    decode_chunk,
    decode_step,
    init_cache,
    prefill,
    prefill_chunked,
    speculative_generate,
)
from ray_tpu_torch.models.mlp import init_mlp, mlp_forward, mlp_loss, mlp_params_from_jax  # noqa: F401
from ray_tpu_torch.models.resnet import (  # noqa: F401
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet101,
    resnet_params_from_jax,
)
from ray_tpu_torch.models.vit import ViT, ViT_B16, ViT_Tiny, vit_params_from_jax  # noqa: F401
