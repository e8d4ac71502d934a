"""Training steps whose forward and backward replayed a CUDA graph (%): the
port's counts in ``act3d_tpu_torch/train/engine.py::Trainer``
(``replayed_steps`` over ``replayed_steps + eager_steps``), over every
step of the process, read after the run: the warm-up Trainer's and the
window's.  A step that captured its graph counts as replayed.  The check
runs the reference alone.  None where the program keeps no such counts or
ran no step."""

import importlib


def read(run):
    trainer = importlib.import_module("act3d_tpu_torch.train.engine").Trainer
    replayed = getattr(trainer, "replayed_steps", None)
    eager = getattr(trainer, "eager_steps", None)
    if replayed is None or eager is None or replayed + eager == 0:
        return None
    return 100.0 * replayed / (replayed + eager)
