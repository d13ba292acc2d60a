"""TubeR in PyTorch and CUDA for NVIDIA Hopper (H100).

The port of ``tubelet_transformer_tpu`` (JAX on a TPU), which stays the
reference it is tested against. The layout mirrors that package module for
module; public functions keep its channels-last (B, T, H, W, C) layout.
Hand-written CUDA kernels live under ``csrc/`` and build at first use into
``build/kernels/`` at the repository root (``ops/cuda/build.py``).

Nothing here imports JAX or the JAX package. What the port needs of the
JAX package's jax-free modules it keeps as its own copies, under the same
module names: ``config``, ``utils`` (meters, log dirs), ``data.{transforms,
loader,synthetic,ava,native,packed}``, ``eval.{labelmap,map_eval,ava_eval}``
and the export half of ``train/torch_convert.py`` in ``convert``.
"""
