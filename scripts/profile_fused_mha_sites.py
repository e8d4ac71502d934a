"""Device time of each kernel a fused-MHA forward call launches, by name.

Run from the repository root on a machine with one NVIDIA H100:

    python3 scripts/profile_fused_mha_sites.py

At the serving sites that split S (the sampler cross site and the L = 1
query site) and at the keypose training sites, 50 calls of
``fused_mha_forward`` are traced with ``torch.profiler``; the main kernel
and the chunk-combine kernel are listed apart, with the launch plan.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from act3d_tpu_torch.kernels import attention as A  # noqa: E402

# (B, L, S, E, H) of chip_smoke.py's sites
SITES = {"planner.cross": (1, 50, 3074, 120, 8), "planner.self": (1, 50, 50, 120, 8),
         "act3d.query": (1, 1, 3126, 60, 4), "keypose.query": (16, 1, 3126, 60, 4),
         "keypose.ghost_point": (16, 333, 3126, 60, 4)}
CALLS = 50


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_fused_mha_sites: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for site, (b, l, s, e, h) in SITES.items():
        q = torch.randn(b, l, e, generator=gen, device=dev) * (e // h) ** -0.5
        k, v = (torch.randn(b, s, e, generator=gen, device=dev) for _ in range(2))
        for _ in range(5):
            A.fused_mha_forward(q, k, v, h)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                A.fused_mha_forward(q, k, v, h)
            torch.cuda.synchronize()
        print(site, A.fwd_plan(b, l, s, h, e // h), flush=True)
        for ev in prof.key_averages():
            if ev.device_time_total > 0:
                print(f"   {ev.key[:80]:80s} calls {ev.count} mean "
                      f"{ev.device_time_total / ev.count:.2f} us", flush=True)
    print(torch.cuda.get_device_name(0), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
