"""TubeR in PyTorch and CUDA for NVIDIA Hopper (H100).

The port of ``tubelet_transformer_tpu`` (JAX on a TPU), which stays the
reference it is tested against. The layout mirrors that package module for
module; public functions keep its channels-last (B, T, H, W, C) layout.
Hand-written CUDA kernels live under ``csrc/`` and build at first use into
``build/kernels/`` at the repository root (``ops/cuda/build.py``).

Nothing here imports JAX: the only modules shared with the JAX package are
its jax-free ``config``, ``data.transforms`` and ``train.torch_convert``.
"""
