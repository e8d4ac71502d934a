"""Hand-written CUDA kernels of the port (the fused attention forward and
backward, the single-head-layout attention core, the row-gather adjoint's
three entries), each with its plain PyTorch version beside it.  The CUDA
sources live in ``../csrc`` and are built by ``_build`` at first use, never
at import."""
