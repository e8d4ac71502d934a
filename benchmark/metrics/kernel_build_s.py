"""Host seconds the process waited on nvcc for the port's CUDA sources
(s): ``act3d_tpu_torch/kernels/_build.py``'s ``NVCC_SECONDS``, read after
the run.  Only a checkout's first run builds, in its warm-up; every later
run finds the libraries built and reads 0.  None where the program keeps
no such count."""

import importlib


def read(run):
    return getattr(importlib.import_module("act3d_tpu_torch.kernels._build"), "NVCC_SECONDS",
                   None)
