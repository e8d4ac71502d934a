"""Where the time of one serving keystep of the PyTorch port goes, on the card.

Builds the Actioner of chip_smoke.py (reference widths, seeded random
weights), serves one warm-up keystep, then one keystep under
torch.profiler and prints:
  * the keystep's host-clock time split into Act3D and sampler;
  * device busy time (the union of kernel intervals) against the
    keystep's wall time, i.e. the device's idle share;
  * kernel time by name (top 15) and the kernel launch count;
  * the fused_mha_fwd kernel's share of device time.
The Chrome trace goes to <out>/keystep_trace.json.gz (default out dir:
profiles/, listed in .gitignore).

Run from the repository root on the card:
    python3 scripts/profile_torch_keystep.py [--out DIR]
"""

from __future__ import annotations

import argparse
import gzip
import json
import shutil
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


def _union_us(intervals):
    total, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=str(REPO / "profiles"),
                        help="directory for the Chrome trace")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_keystep: no CUDA device", file=sys.stderr)
        return 1
    card = cs.nvidia_smi()
    print(card, flush=True)
    rng = np.random.default_rng(cs.SEED)
    bank = rng.normal(size=(cs.N_INSTR, 512)).astype(np.float32)
    actioner = cs.build_actioner(cs.ACT3D_CFG, cs.PLANNER_CFG, "cuda",
                                 {"synthetic": {0: [bank]}})
    actioner.load_episode("synthetic", 0)
    mask = np.zeros((1, cs.TRAJ_LEN), bool)
    obs = [cs.synthetic_observation(rng, 256, cs.NCAM) for _ in range(3)]
    for o in obs[:2]:
        actioner.predict(*o, trajectory_mask=mask, timed=True)
        print("warm-up keystep", {k: round(v * 1e3, 1)
                                  for k, v in actioner.last_phase_seconds.items()}, "ms")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        actioner.predict(*obs[2], trajectory_mask=mask, timed=True)
        wall_us = (time.perf_counter() - t0) * 1e6
    phases = actioner.last_phase_seconds

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = defaultdict(lambda: [0, 0.0])
    intervals = []
    for e in kernels:
        start = e.time_range.start
        end = e.time_range.end
        intervals.append((start, end))
        by_name[e.name][0] += 1
        by_name[e.name][1] += end - start
    busy_us = _union_us(intervals)
    n_launch = sum(c for c, _ in by_name.values())
    mha = sum(t for name, (c, t) in by_name.items() if "fused_mha_fwd" in name)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    summary = {
        "card": card,
        "keystep_ms": wall_us / 1e3,
        "act3d_ms": phases["act3d"] * 1e3,
        "sampler_ms": phases["sampler"] * 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / wall_us,
        "device_kernel_events": n_launch,
        "fused_mha_fwd_ms": mha / 1e3,
        "fused_mha_fwd_share_of_busy": mha / busy_us if busy_us else None,
        "top_kernels": [{"name": n[:90], "count": c, "ms": t / 1e3} for n, (c, t) in top],
    }
    for row in summary["top_kernels"]:
        print(f"{row['ms']:9.3f} ms {row['count']:6d}x  {row['name']}")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    trace = out / "keystep_trace.json"
    prof.export_chrome_trace(str(trace))
    with open(trace, "rb") as src, gzip.open(f"{trace}.gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    trace.unlink()
    print(json.dumps({k: v for k, v in summary.items() if k != "top_kernels"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
