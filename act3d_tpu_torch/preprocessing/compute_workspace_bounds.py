"""Compute per-task gripper workspace bounds from a packaged dataset.

Counterpart of ``act3d_tpu/preprocessing/compute_workspace_bounds.py``
(reference data_preprocessing/compute_workspace_bounds.py:44-95): scans
keypose actions and dense trajectories and writes
{task: [[min_xyz], [max_xyz]]} JSON, read by
``utils.registry.get_gripper_loc_bounds``.

Run (numpy over the episodes, on the host):
  python -m act3d_tpu_torch.preprocessing.compute_workspace_bounds \\
      --dataset /path/packaged --tasks pick_and_lift close_door \\
      --out_file bounds.json
"""

from __future__ import annotations

import argparse
import json
import pprint
from pathlib import Path

import numpy as np

from ..data.episode import load_episode


def compute_bounds(
    dataset_root,
    tasks,
    variations=(0,),
    instructions=None,  # kept for the CLI's flags; bounds need no language
    max_episodes_per_task=100,
):
    """Scan packaged episodes' keypose actions and dense trajectories
    (slots 2 and 5 of the episode schema) directly, with no image assembly."""
    bounds = {}
    for task in tasks:
        locs = []
        for var in variations:
            d = Path(dataset_root) / f"{task}+{var}"
            if not d.is_dir():
                continue
            eps = sorted(
                list(d.glob("ep*.dat")) + list(d.glob("ep*.npy")) + list(d.glob("ep*.pkl"))
            )[:max_episodes_per_task]
            for ep_path in eps:
                ep = load_episode(ep_path)
                if ep is None:
                    continue
                for a in ep[2]:
                    locs.append(np.asarray(a)[..., :3].reshape(-1, 3))
                for t in ep[5]:
                    locs.append(np.asarray(t)[..., :3].reshape(-1, 3))
        if locs:
            all_locs = np.concatenate(locs, axis=0)
            bounds[task] = [all_locs.min(axis=0).tolist(), all_locs.max(axis=0).tolist()]
    return bounds


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", required=True)
    p.add_argument("--tasks", nargs="+", required=True)
    p.add_argument("--variations", nargs="*", type=int, default=[0])
    p.add_argument("--instructions", default=None)
    p.add_argument("--max_episodes_per_task", type=int, default=100)
    p.add_argument("--out_file", required=True)
    args = p.parse_args(argv)

    bounds = compute_bounds(
        args.dataset, args.tasks, tuple(args.variations), args.instructions,
        max_episodes_per_task=args.max_episodes_per_task,
    )
    pprint.pprint(bounds)
    with open(args.out_file, "w") as f:
        json.dump(bounds, f, indent=4)


if __name__ == "__main__":
    main()
