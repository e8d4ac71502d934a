"""Denoising steps replayed from a CUDA graph (%): the port's counts in
``act3d_tpu_torch/models/diffusion_planner.py::compute_trajectory``
(``replayed_steps`` over ``replayed_steps + eager_steps``), over every
step of the process, read after the run.  The serving path runs the first
step of its first keystep eagerly and replays the rest; the check runs the
reference alone.  None where the program keeps no such counts or ran no
step."""

import importlib


def read(run):
    sampler = importlib.import_module("act3d_tpu_torch.models.diffusion_planner")
    replayed = getattr(sampler.compute_trajectory, "replayed_steps", None)
    eager = getattr(sampler.compute_trajectory, "eager_steps", None)
    if replayed is None or eager is None or replayed + eager == 0:
        return None
    return 100.0 * replayed / (replayed + eager)
