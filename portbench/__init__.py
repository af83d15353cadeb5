"""The benchmark of ``mioc_tpu_torch``, the PyTorch/CUDA port (``run.py``)."""
