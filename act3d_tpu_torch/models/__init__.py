"""Act3D keypose predictor and the ChainedDiffuser trajectory sampler."""

from .act3d import Act3D
from .diffusion_head import DiffusionHead
from .diffusion_planner import DiffusionPlanner, compute_trajectory

__all__ = ["Act3D", "DiffusionHead", "DiffusionPlanner", "compute_trajectory"]
