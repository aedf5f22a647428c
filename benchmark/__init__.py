"""The benchmark of the PyTorch/CUDA port (``hudiff_tpu_torch``): see run.py."""
