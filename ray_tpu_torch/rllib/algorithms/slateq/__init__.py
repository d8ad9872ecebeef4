from ray_tpu_torch.rllib.algorithms.slateq.slateq import SlateQ, SlateQConfig

__all__ = ["SlateQ", "SlateQConfig"]
