"""Episode container I/O, a copy of ``act3d_tpu/data/episode.py``.

The on-disk episode format is the reference packager's
(reference: data_preprocessing/data_gen.py:44-136, read back by
datasets/utils.py:16-37 and indexed by datasets/dataset_engine.py:139-149):

  episode = [
      frame_ids,        # list[int]
      obs_tensors,      # list of (n_cam, 2, 3, H, W); [:,0]=RGB in [-1,1], [:,1]=XYZ
      action_tensors,   # list of (1, 8) keypose actions
      camera_dicts,     # list of {camera_name: ...}
      gripper_tensors,  # list of (1, 8) current gripper poses
      trajectories,     # list of (N_i, 8) dense inter-keyframe trajectories
      camera_params,    # OPTIONAL 7th slot: list of {camera_name:
                        # {"intrinsics": (3,3), "extrinsics": (4,4)}};
                        # reference readers index 0-5 and ignore it
  ]

``.dat`` files are blosc1 containers of a pickle (decoded by the native C++
codec, ``data/native``); ``.npy``/``.pkl`` are also accepted.  Loaded
tensors are converted to numpy.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Any, List, Optional

import numpy as np

from . import native

__all__ = ["load_episode", "save_episode", "to_numpy_tree"]


def to_numpy_tree(obj: Any) -> Any:
    """Recursively convert torch tensors / array-likes to numpy."""
    if isinstance(obj, np.ndarray):
        return obj
    if type(obj).__module__.startswith("torch"):
        return obj.detach().cpu().numpy()
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_numpy_tree(x) for x in obj)
    if isinstance(obj, dict):
        return {k: to_numpy_tree(v) for k, v in obj.items()}
    return obj


def load_episode(path) -> Optional[List]:
    """Load one packaged episode (.dat / .npy / .pkl) as numpy arrays."""
    path = Path(path)
    try:
        if path.suffix == ".dat":
            content = pickle.loads(native.decompress(path.read_bytes()))
        elif path.suffix == ".npy":
            content = np.load(path, allow_pickle=True)
        elif path.suffix == ".pkl":
            with open(path, "rb") as f:
                content = pickle.load(f)
        else:
            raise ValueError(f"unknown episode format {path.suffix}")
    except (pickle.UnpicklingError, ValueError) as e:
        print(f"Can't load {path}: {e}")
        return None
    return to_numpy_tree(list(content))


def save_episode(path, episode: List, typesize: int = 8) -> None:
    """Write an episode as a blosc1 .dat container (readable by this loader,
    JAX's and python-blosc).  Compressed with blosclz when the system
    libblosc is present."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    blob = pickle.dumps(to_numpy_tree(episode))
    path.write_bytes(native.compress(blob, typesize=typesize))
