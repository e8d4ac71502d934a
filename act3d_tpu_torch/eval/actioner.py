"""Actioner: chained keypose -> trajectory inference for closed-loop eval.

Counterpart of ``act3d_tpu/eval/actioner.py``.  Per keystep, Act3D
predicts the next keypose, which becomes the goal of the 100-step
trajectory sampler (the "chained" behaviour of ChainedDiffuser).  The
predicted keypose stays on the device between the two models; the
observation arrives as numpy and the action leaves as numpy, one readback
per keystep.

The JAX ``fused_dispatch`` option (both models as one jitted program) has
no meaning without ``jit`` and is dropped: PyTorch enqueues the two
models back to back on one stream.  On a CUDA device that stream is
``device.py::graph_stream``, and the sampler replays its denoising steps
from CUDA graphs captured on it (``models/sampler_graph.py``).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from ..device import graph_stream, on_stream, resolve_device
from ..models import Act3D, DiffusionPlanner, compute_trajectory
from ..models.sampler_graph import SamplerGraphs
from ..utils.spans import span

__all__ = ["Actioner"]


class Actioner:
    keysteps = 0  # keysteps predicted by every Actioner of this process

    def __init__(
        self,
        keypose_model: Optional[Act3D] = None,
        traj_model: Optional[DiffusionPlanner] = None,
        instructions: Optional[Dict] = None,
        action_dim: int = 7,
        predict_keypose: bool = True,
        predict_trajectory: bool = True,
        seed: int = 0,
        device="cuda",
    ):
        self.device = resolve_device(device)
        if predict_keypose and keypose_model is None:
            raise ValueError("predict_keypose needs a keypose_model")
        if predict_trajectory and traj_model is None:
            raise ValueError("predict_trajectory needs a traj_model")
        self.keypose_model = keypose_model.to(self.device).eval() if keypose_model else None
        self.traj_model = traj_model.to(self.device).eval() if traj_model else None
        self._instructions = instructions
        self._action_dim = action_dim
        self._predict_keypose = predict_keypose
        self._predict_trajectory = predict_trajectory
        self._rng = np.random.default_rng(seed)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._instr = None
        self._task_str = None
        # host seconds of each model in the last predict(timed=True)
        self.last_phase_seconds: Optional[Dict[str, float]] = None
        self._stream = graph_stream(self.device)
        self._graphs = SamplerGraphs()

    def load_episode(self, task_str: str, variation: int):
        self._task_str = task_str
        options = list(self._instructions[task_str][variation])
        choice = options[self._rng.integers(len(options))]
        self._instr = torch.as_tensor(
            np.asarray(choice, np.float32)[None], device=self.device
        )  # (1, 53, 512)

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def _mark(self, timed: bool) -> float:
        if timed and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    @torch.inference_mode()
    def predict(
        self,
        rgbs: np.ndarray,  # (1, ncam, 3, H, W) in [-1, 1] (sim convention)
        pcds: np.ndarray,  # (1, ncam, 3, H, W)
        gripper: np.ndarray,  # (1, 8)
        gt_action: Optional[np.ndarray] = None,
        trajectory_mask: Optional[np.ndarray] = None,
        *,
        timed: bool = False,
        ghost_points_override=None,
        noise=None,
    ) -> Dict[str, Optional[np.ndarray]]:
        """One keystep.  ``timed`` synchronises the device around each
        model and records their host-clock seconds in
        ``last_phase_seconds``.  ``ghost_points_override`` (per-level
        (1, N, 3) tensors) and ``noise`` (see ``compute_trajectory``)
        replace the draws from the Actioner's generator, so a comparison
        can feed two implementations the same numbers.  The keystep runs
        in span "keystep", its models in "keystep.act3d" and
        "keystep.sampler" (``utils/spans.py``)."""
        if self._instr is None:
            raise ValueError("call load_episode first")
        Actioner.keysteps += 1
        with on_stream(self._stream), span("keystep"):
            rgbs = self._tensor(rgbs) / 2 + 0.5  # to [0, 1]
            pcds = self._tensor(pcds)
            gripper = self._tensor(gripper)
            output: Dict[str, Optional[np.ndarray]] = {}
            clock = [self._mark(timed)]

            with span("keystep.act3d"):
                if self._predict_keypose:
                    pred = self.keypose_model(
                        rgbs, pcds, self._instr, gripper, generator=self._generator,
                        ghost_points_override=ghost_points_override,
                    )
                    action = torch.cat([pred["position"], pred["rotation"], pred["gripper"]],
                                       dim=1)
                    output["coarse_position"] = pred["position_pyramid"][0].reshape(-1, 3)[-1]
                    output["fine_position"] = pred["position"].reshape(-1, 3)[-1]
                else:
                    action = self._tensor(gt_action)[:, -1]
            clock.append(self._mark(timed))

            traj = None
            if self._predict_trajectory:
                with span("keystep.sampler"):
                    traj = compute_trajectory(
                        self.traj_model,
                        torch.as_tensor(np.asarray(trajectory_mask, bool), device=self.device),
                        rgbs, pcds, self._instr,
                        gripper[:, : self._action_dim], action[:, : self._action_dim],
                        generator=self._generator, noise=noise, graphs=self._graphs,
                    )
            clock.append(self._mark(timed))
            if timed:
                self.last_phase_seconds = {"act3d": clock[1] - clock[0],
                                           "sampler": clock[2] - clock[1]}
            output["action"] = action
            output["trajectory"] = traj
            return {k: None if v is None else v.cpu().numpy() for k, v in output.items()}
