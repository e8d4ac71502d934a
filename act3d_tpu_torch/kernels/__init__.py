"""Hand-written CUDA kernels of the port (attention forward and backward,
the row-gather adjoint), each with its plain PyTorch version beside it.
The CUDA sources live in ``../csrc`` and are built by ``_build`` at first
use, never at import."""
