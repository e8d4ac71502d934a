"""PyTorch + CUDA (Hopper) port of Act3D + ChainedDiffuser: serving and training.

A second package beside the JAX reference ``act3d_tpu``.  It imports
``torch`` only — never ``jax``, ``flax`` or anything of ``act3d_tpu`` —
and keeps the JAX package's public layouts (batch-major (B, L, E) tokens,
camera-major row-major token order, ghost points as (B, N, 3), attention
row stats as (B, L, 2H)) so the two can be compared like with like.

Layout mirrors the JAX package: ``ops/``, ``kernels/`` (hand-written CUDA
kernels from ``csrc/`` with their plain PyTorch versions), ``nn/``,
``models/``, ``eval/`` (the Actioner, the RLBench loop and its sim-free
backend, the eval CLI, the real-robot loop), ``train/`` (the training
steps and the two training CLIs), ``data/`` (packaged episodes, the host
data path and the device feeder), ``core/`` (the CLIs' config) and
``convert.py`` (flax params or reference ``.pth`` state dicts ->
state_dict).

Entry points (the model constructors, :class:`eval.actioner.Actioner`, the
training CLIs and the eval CLI) default to the card and raise when no card
is present; pass ``device="cpu"`` (``--device cpu``) to run the plain
versions on the CPU.
On the card they run matmuls and cuDNN convolutions in full float32, never
TF32 (:func:`device.pin_float32`, applied by :func:`resolve_device`).
"""

from .device import float32_precision, pin_float32, resolve_device

__all__ = ["float32_precision", "pin_float32", "resolve_device"]
