"""Instruction loading, workspace bounds and vendored assets.

A copy of the parts of ``act3d_tpu/utils/registry.py`` the training CLIs
need (reference utils/utils_without_rlbench.py:54-97).  Workspace-bound
JSONs ({task: [[min_xyz], [max_xyz]]}) are data files vendored under the
repository's ``assets/``; a bare file name resolves there.
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch.nn as nn

__all__ = ["asset_path", "count_parameters", "get_gripper_loc_bounds", "load_instructions"]

ASSETS_DIR = Path(__file__).resolve().parents[2] / "assets"


def load_instructions(instructions: Optional[Path], tasks: Optional[Sequence[str]] = None,
                      variations: Optional[Sequence[int]] = None):
    """Filtered unpickle of instructions.pkl: task -> var -> (n, 53, 512)
    numpy (torch tensors in legacy pickles are converted)."""
    if instructions is None:
        return None
    with open(instructions, "rb") as fid:
        data = pickle.load(fid)
    if tasks is not None:
        data = {t: v for t, v in data.items() if t in tasks}
    if variations is not None:
        data = {t: {var: ins for var, ins in v.items() if var in variations}
                for t, v in data.items()}

    def to_np(x):
        if type(x).__module__.startswith("torch"):
            return x.detach().cpu().numpy()
        return np.asarray(x)

    return {t: {var: to_np(ins) for var, ins in v.items()} for t, v in data.items()}


def asset_path(name: str) -> Path:
    """A vendored run artifact by bare name: ``assets/``, ``assets/tasks/``
    or ``assets/data_preprocessing/``."""
    for candidate in (ASSETS_DIR / name, ASSETS_DIR / "tasks" / name,
                      ASSETS_DIR / "data_preprocessing" / name):
        if candidate.exists():
            return candidate
    raise FileNotFoundError(f"no vendored asset named {name!r} under {ASSETS_DIR}")


def _resolve(path) -> Path:
    """A real path, or a vendored asset found by name."""
    p = Path(path)
    if p.exists():
        return p
    if len(p.parts) == 1:
        return asset_path(p.name)
    return p


def get_gripper_loc_bounds(path: str, buffer: float = 0.0,
                           task: Optional[str] = None) -> np.ndarray:
    """(2, 3) [min, max] workspace bounds for one task or the union of all
    (reference utils_without_rlbench.py:54-68)."""
    with open(_resolve(path)) as f:
        bounds = json.load(f)
    if task is not None and task in bounds:
        lo = np.array(bounds[task][0]) - buffer
        hi = np.array(bounds[task][1]) + buffer
    else:
        lo = np.min(np.stack([b[0] for b in bounds.values()]), axis=0) - buffer
        hi = np.max(np.stack([b[1] for b in bounds.values()]), axis=0) + buffer
    print("Gripper workspace size:", hi - lo)
    return np.stack([lo, hi])


def count_parameters(module: nn.Module) -> int:
    """Number of parameter elements of a module."""
    return sum(p.numel() for p in module.parameters())
