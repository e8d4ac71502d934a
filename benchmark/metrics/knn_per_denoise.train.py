"""Trajectory-nearest selections per denoiser evaluation (selections): the
port's ``ops/geometry.py::find_traj_nn.calls`` over
``models/diffusion_head.py::DiffusionHead.evaluations``, read after the run
(the check runs the reference alone).  The 3-scale x 2-round head selects
at scales 1 and 2 of each round: 4.  None where the program keeps no such
counts or its head made no selection."""

import importlib


def read(run):
    calls = getattr(importlib.import_module("act3d_tpu_torch.ops.geometry").find_traj_nn,
                    "calls", None)
    evaluations = getattr(importlib.import_module("act3d_tpu_torch.models.diffusion_head")
                          .DiffusionHead, "evaluations", None)
    if not calls or not evaluations:
        return None
    return calls / evaluations
