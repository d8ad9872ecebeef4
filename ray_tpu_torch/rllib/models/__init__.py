"""Model catalog (analog of reference rllib/models/catalog.py ModelCatalog).

The reference's catalog maps (obs space, action space, model config) onto a
framework network (FCNet / VisionNet / ...). Here the same decision produces
an RLModuleSpec — the module family of core/rl_module.py: flat
observations get the FCNet-style MLP torso, 3D image observations get the
VisionNet-style conv stack (default filters by input size, overridable via
``model_config["conv_filters"]``).
"""

from __future__ import annotations

from ray_tpu_torch.rllib.core.rl_module import (  # noqa: F401
    RLModuleSpec,
    default_conv_filters,
)

MODEL_DEFAULTS: dict = {
    "fcnet_hiddens": (64, 64),
    "fcnet_activation": "tanh",
    "conv_filters": None,
}


class ModelCatalog:
    @staticmethod
    def get_model_spec(observation_space, action_space, model_config: dict | None = None) -> RLModuleSpec:
        cfg = {**MODEL_DEFAULTS, **(model_config or {})}
        spec = RLModuleSpec.from_spaces(
            observation_space,
            action_space,
            hiddens=tuple(cfg["fcnet_hiddens"]),
            conv_filters=cfg["conv_filters"],
        )
        if cfg["fcnet_activation"] != spec.activation:
            import dataclasses

            spec = dataclasses.replace(spec, activation=cfg["fcnet_activation"])
        return spec
