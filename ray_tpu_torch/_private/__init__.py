"""The port's own copies of ``ray_tpu/_private`` modules (no JAX in them)."""
