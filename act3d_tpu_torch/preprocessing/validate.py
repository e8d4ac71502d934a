"""Validate generated episode data.

Counterpart of ``act3d_tpu/preprocessing/validate.py`` (reference
data_preprocessing/validate_data_generation.py): counts packaged episodes
per task variation and, with ``--deep``, checks every ``.dat`` episode
against the episode schema.

Run (numpy over the episodes, on the host):
  python -m act3d_tpu_torch.preprocessing.validate --dataset /path/packaged \\
      --tasks pick_and_lift --deep
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..data.episode import load_episode


def count_episodes(dataset: Path, tasks, variations):
    """{"task+var": number of ep*.dat and ep*.npy episodes, or "MISSING"}
    (``.pkl`` episodes are not counted, as in JAX)."""
    report = {}
    for task in tasks:
        for var in variations:
            d = Path(dataset) / f"{task}+{var}"
            if not d.is_dir():
                report[f"{task}+{var}"] = "MISSING"
                continue
            eps = sorted(d.glob("ep*.dat")) + sorted(d.glob("ep*.npy"))
            report[f"{task}+{var}"] = len(eps)
    return report


def check_episode_schema(path: Path) -> bool:
    """Deep-check one episode against the 6-slot schema (reference
    datasets/dataset_engine.py:139-149); a 7th camera-params slot (the
    depth wire's, preprocessing/data_gen.py) is accepted and length-checked
    when present."""
    ep = load_episode(path)
    if ep is None or len(ep) not in (6, 7):
        return False
    frame_ids, obs, actions, cam_dicts, grippers, trajs = ep[:6]
    if len(ep) == 7 and len(ep[6]) != len(frame_ids):
        return False
    n = len(frame_ids)
    ok = (
        len(obs) == n
        and len(actions) == n
        and len(grippers) == n
        and len(trajs) == n
        and all(a.shape[-1] == 8 for a in actions)
        and all(t.ndim == 2 and t.shape[-1] == 8 for t in trajs)
        and all(o.shape[1] == 2 and o.shape[2] == 3 for o in obs)
    )
    return bool(ok)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", required=True)
    p.add_argument("--tasks", nargs="+", required=True)
    p.add_argument("--variations", nargs="*", type=int, default=[0])
    p.add_argument("--deep", action="store_true", help="schema-check every episode")
    args = p.parse_args(argv)

    report = count_episodes(args.dataset, args.tasks, args.variations)
    for key, val in sorted(report.items()):
        print(f"{key}: {val}")

    if args.deep:
        bad = []
        for task in args.tasks:
            for var in args.variations:
                for ep in sorted((Path(args.dataset) / f"{task}+{var}").glob("ep*.dat")):
                    if not check_episode_schema(ep):
                        bad.append(str(ep))
        print(f"schema check: {len(bad)} bad episodes")
        for b in bad:
            print("  BAD:", b)


if __name__ == "__main__":
    main()
