"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``): the
harness, its traffic, its yardstick and its plain references. Imports
nothing of the JAX package."""
