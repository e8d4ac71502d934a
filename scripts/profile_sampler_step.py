"""Device time of one denoising step of the serving sampler, and of the part
of it that does not change from step to step.

At the serving widths (``chip_smoke.PLANNER_CFG``: embedding 120, 6 query
and 2 vision-language layers, 3 cameras at 256^2, trajectory length 50,
batch 1) with seeded weights and a seeded observation, times on the card
(``chip_smoke.device_ms``: calls captured in a CUDA graph, replayed between
CUDA events):
  * ``step_ms``: ``reverse_step`` at t > 0 (the denoiser, the held entries
    and both DDPM updates), as the serving path replays it;
  * ``invariant_ms``: what each block of the step recomputes from the
    observation alone: ``rotary_pe_3d`` of the context points and
    ``vl_attention_{i}`` of the visual tokens over the instruction (exact
    to hoist out of the loop at scale 0, where the context is ``encode``'s);
and prints one JSON line with both, their ratio and the card's name.

Run from the repository root on the card:
    python3 scripts/profile_sampler_step.py [--iters N]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from act3d_tpu_torch.device import resolve_device  # noqa: E402
from act3d_tpu_torch.models import DiffusionPlanner  # noqa: E402
from act3d_tpu_torch.models.diffusion_planner import reverse_step  # noqa: E402
from act3d_tpu_torch.ops.rotary import rotary_pe_3d  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=50)
    args = p.parse_args(argv)
    dev = resolve_device("cuda")
    cfg = chip_smoke.PLANNER_CFG
    torch.manual_seed(chip_smoke.SEED)
    model = DiffusionPlanner(**cfg, device="cpu").to(dev).eval()
    head = model.prediction_head
    rng = np.random.default_rng(chip_smoke.SEED)
    rgb, pcd, gripper = (torch.as_tensor(x, device=dev) for x in
                         chip_smoke.synthetic_observation(rng, 256, chip_smoke.NCAM))
    instr = torch.as_tensor(rng.normal(size=(1, chip_smoke.N_INSTR, 512)).astype(np.float32),
                            device=dev)
    b, length, d = 1, chip_smoke.TRAJ_LEN, model.internal_dim
    side = torch.cuda.Stream()
    with torch.no_grad():
        context, curr, goal = model.encode(rgb / 2 + 0.5, pcd, instr, gripper[:, :7],
                                           gripper[:, :7])
        trajectory = torch.randn(b, length, d, device=dev)
        mask = torch.zeros(b, length, dtype=torch.bool, device=dev)
        cond_mask = torch.zeros(b, length, d, dtype=torch.bool, device=dev)
        eps = torch.randn(b, length, d, device=dev)
        index = torch.tensor([1], device=dev)
        n_blocks = head.attn_rounds * head.feat_scales_to_use

        def step():
            reverse_step(model, trajectory, mask, index, context, trajectory, cond_mask, eps)

        def invariant():
            for i in range(n_blocks):
                scale = i % head.feat_scales_to_use
                rotary_pe_3d(context["pcd_pyramid"][scale], head.embedding_dim)
                if head.use_instruction:
                    getattr(head, f"vl_attention_{i}")(context["rgb_feats_pyramid"][scale],
                                                       context["instr_feats"])

        step_ms = chip_smoke.device_ms(step, args.iters, side)
        invariant_ms = chip_smoke.device_ms(invariant, args.iters, side)
    print(json.dumps({"step_ms": step_ms, "invariant_ms": invariant_ms,
                      "invariant_share": invariant_ms / step_ms, "blocks": n_blocks,
                      "card": torch.cuda.get_device_name()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
