"""PyTorch/CUDA port of hudiff_tpu for NVIDIA Hopper (H100).

A second package beside the JAX reference, with the same layout (ops/,
models/, sampling/, numbering/, training/). It imports torch and numpy and
nothing of JAX or of hudiff_tpu. Hand-written CUDA kernels live in csrc/
and are built with nvcc on first use (ops/_build.py).
"""
