"""Plain PyTorch references of the port's problems: each derives its
operators from a benchmark configuration file alone and imports nothing of
``mioc_tpu_torch``, ``mioc_tpu`` or JAX."""
