"""Hand-written CUDA kernels of the serving path, each with its plain
PyTorch version beside it.  The CUDA sources live in ``../csrc`` and are
built by ``_build`` at first use, never at import."""
