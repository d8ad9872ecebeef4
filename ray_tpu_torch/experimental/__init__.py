"""ray_tpu_torch.experimental — pre-stable subsystems (compiled-graph channels)."""
