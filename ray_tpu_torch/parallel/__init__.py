"""Parallelism for the port. Only mixture-of-experts (``moe``) is here yet:
it runs on one card. Meshes, ring and Ulysses attention and pipelines wait
for process groups (ROADMAP A9b-e)."""
