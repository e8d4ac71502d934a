"""Host seconds the process spent loading the port's CUDA libraries,
nvcc left out (s): ``act3d_tpu_torch/kernels/_build.py``'s
``LOAD_SECONDS``, read after the run.  The loader runs once per source,
at its first use in the warm-up, so the count is the set-up's: hashing
the sources and ``ctypes`` loads, on every run.  None where the program
keeps no such count."""

import importlib


def read(run):
    return getattr(importlib.import_module("act3d_tpu_torch.kernels._build"), "LOAD_SECONDS",
                   None)
