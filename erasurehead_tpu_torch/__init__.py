"""PyTorch/CUDA port of erasurehead_tpu: coded gradient descent on one NVIDIA GPU.

Module paths mirror the JAX package's (``erasurehead_tpu``), which stays the
reference; this package never imports it or JAX.
"""
