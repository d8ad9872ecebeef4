"""The port's own copies of ``ray_tpu._private`` helpers (no JAX in them)."""
