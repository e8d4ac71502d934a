"""Closed-loop chained evaluation CLI.

Counterpart of ``act3d_tpu/eval/main.py``, the equivalent of the
reference's online_evaluation/eval1.py: load an Act3D keypose checkpoint
and a DiffusionPlanner trajectory checkpoint, evaluate the chained policy
on stored RLBench demos task by task, and dump the success rates to JSON
(``task -> {variation: rate, "mean": rate}``).

Checkpoints load from the port Trainer's ``.pt`` files (``best.pt`` /
``last.pt``), from the JAX Trainer's ``.msgpack`` files (``best.msgpack`` /
``last.msgpack``, read by ``core/msgpack.py`` and mapped by the flax
bridge) or from reference ``.pth`` torch checkpoints (through
:mod:`act3d_tpu_torch.convert`, stripping DDP prefixes as eval1.py:137-153
does).  The flags are JAX's, plus ``--device`` (the card by default; the
CPU only when asked).

Run:
  python -m act3d_tpu_torch.eval.main \\
      --data_dir /path/raw_demos --tasks pick_and_lift \\
      --instructions instructions.pkl \\
      --keypose_ckpt act3d_best.pth --traj_ckpt traj_best.pth \\
      --gripper_loc_bounds bounds.json --output eval_results.json
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..convert import (act3d_from_flax, act3d_from_reference, diffusion_planner_from_flax,
                       diffusion_planner_from_reference)
from ..core.msgpack import load_msgpack
from ..device import resolve_device
from ..models import Act3D, DiffusionPlanner
from ..utils.registry import get_gripper_loc_bounds, load_instructions
from .actioner import Actioner
from .rlbench_env import RLBenchEnv

__all__ = ["build_models", "load_params", "main"]


def load_params(path, model: torch.nn.Module, convert_fn, flax_fn=act3d_from_flax
                ) -> torch.nn.Module:
    """Load a checkpoint into ``model`` (``strict=True``): a port ``.pt``
    (the Trainer's ``payload["model"]``), a JAX ``.msgpack`` (its
    ``payload["params"]``, mapped by ``flax_fn``) or a reference ``.pth``
    (``{"weight": state_dict}``, mapped by ``convert_fn``)."""
    path = Path(path)
    if path.suffix == ".pth":
        state = torch.load(path, map_location="cpu", weights_only=True)
        state = convert_fn(state.get("weight", state))
    elif path.suffix == ".pt":
        state = torch.load(path, map_location="cpu", weights_only=True)["model"]
    elif path.suffix == ".msgpack":
        state = flax_fn(load_msgpack(path)["params"])
    else:
        raise ValueError(f"{path}: expected a .pt (port), .msgpack (JAX) or .pth (reference) "
                         "checkpoint")
    model.load_state_dict(state, strict=True)
    return model


def build_models(args, bounds):
    """Act3D and DiffusionPlanner at the CLI's widths, on ``args.device``,
    with their checkpoints loaded."""
    image_size = tuple(int(x) for x in args.image_size.split(","))
    bounds = tuple(map(tuple, np.asarray(bounds, np.float64).tolist()))
    keypose_model = Act3D(
        image_size=image_size,
        embedding_dim=args.keypose_embedding_dim,
        num_ghost_points=args.num_ghost_points,
        num_ghost_points_val=args.num_ghost_points_val,
        num_sampling_level=args.num_sampling_level,
        num_ghost_point_cross_attn_layers=args.num_ghost_point_cross_attn_layers,
        num_query_cross_attn_layers=args.keypose_query_cross_attn_layers,
        num_vis_ins_attn_layers=args.num_vis_ins_attn_layers,
        gripper_loc_bounds=bounds,
        use_instruction=bool(args.use_instruction),
        device=args.device,
    )
    traj_model = DiffusionPlanner(
        image_size=image_size,
        embedding_dim=args.traj_embedding_dim,
        output_dim=7,
        num_query_cross_attn_layers=args.num_query_cross_attn_layers,
        num_vis_ins_attn_layers=args.num_vis_ins_attn_layers,
        use_instruction=bool(args.use_instruction),
        use_goal=True,
        use_goal_at_test=False,  # chained: the goal comes from Act3D
        rotation_parametrization="6D",
        diffusion_timesteps=args.diffusion_timesteps,
        gripper_loc_bounds=bounds,
        device=args.device,
    )
    load_params(args.keypose_ckpt, keypose_model, lambda sd: act3d_from_reference(
        sd,
        num_sampling_level=args.num_sampling_level,
        use_instruction=bool(args.use_instruction),
        num_ghost_point_cross_attn_layers=args.num_ghost_point_cross_attn_layers,
        num_query_cross_attn_layers=args.keypose_query_cross_attn_layers,
        num_vis_ins_attn_layers=args.num_vis_ins_attn_layers,
    ), act3d_from_flax)
    load_params(args.traj_ckpt, traj_model, lambda sd: diffusion_planner_from_reference(
        sd,
        use_instruction=bool(args.use_instruction),
        use_goal=True,
        num_query_cross_attn_layers=args.num_query_cross_attn_layers,
        num_vis_ins_attn_layers=args.num_vis_ins_attn_layers,
    ), diffusion_planner_from_flax)
    return keypose_model, traj_model


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_dir", required=True)
    p.add_argument("--tasks", nargs="+", required=True)
    p.add_argument("--variations", nargs="*", type=int, default=[-1])
    p.add_argument("--instructions", required=True)
    p.add_argument("--keypose_ckpt", required=True)
    p.add_argument("--traj_ckpt", required=True)
    p.add_argument("--gripper_loc_bounds", default=None)
    p.add_argument("--image_size", default="256,256")
    p.add_argument(
        "--cameras", nargs="*",
        default=["left_shoulder", "right_shoulder", "wrist"],
    )
    p.add_argument("--keypose_embedding_dim", type=int, default=60)
    p.add_argument("--traj_embedding_dim", type=int, default=120)
    p.add_argument("--num_ghost_points", type=int, default=1000)
    p.add_argument("--num_ghost_points_val", type=int, default=10000)
    p.add_argument("--num_sampling_level", type=int, default=3)
    p.add_argument("--num_ghost_point_cross_attn_layers", type=int, default=2)
    p.add_argument("--keypose_query_cross_attn_layers", type=int, default=2)
    p.add_argument("--num_vis_ins_attn_layers", type=int, default=2)
    p.add_argument("--num_query_cross_attn_layers", type=int, default=6)
    p.add_argument("--diffusion_timesteps", type=int, default=100)
    p.add_argument("--interpolation_length", type=int, default=50)
    p.add_argument("--num_demos", type=int, default=100)
    p.add_argument("--max_tries", type=int, default=2)
    p.add_argument("--max_steps", type=int, default=25)
    p.add_argument("--headless", type=int, default=1)
    p.add_argument("--record_videos", type=int, default=0,
                   help="1: write rollout mp4s (needs OpenCV and PyRep)")
    p.add_argument("--num_videos", type=int, default=10)
    p.add_argument("--log_dir", default="eval_logs")
    p.add_argument("--output", default="eval_results.json")
    # reference eval1.py parity flags (Arguments, eval1.py:23-70)
    p.add_argument("--seed", type=int, default=2)
    p.add_argument("--offline", type=int, default=0,
                   help="1: follow ground-truth keyposes (eval1.py:49)")
    p.add_argument("--verbose", type=int, default=0)
    p.add_argument("--collision_checking", type=int, default=0)
    p.add_argument("--dense_interpolation", type=int, default=1)
    p.add_argument("--predict_keypose", type=int, default=1)
    p.add_argument("--predict_traj", type=int, default=1)
    p.add_argument("--use_instruction", type=int, default=1)
    p.add_argument("--action_dim", type=int, default=7)
    p.add_argument("--fused_dispatch", type=int, default=1,
                   help="accepted so the JAX CLI's command lines run unchanged; both "
                        "values run the same computation here (the two models are "
                        "enqueued back to back on one stream, one readback per keystep)")
    p.add_argument("--fake_sim", type=int, default=0,
                   help="1: run against the sim-free dry-run backend "
                        "(eval/fake_sim.py) instead of CoppeliaSim — "
                        "exercises the full CLI without the simulator")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; without a card, cuda raises")
    args = p.parse_args(argv)
    resolve_device(args.device)

    if args.gripper_loc_bounds:
        bounds = get_gripper_loc_bounds(
            args.gripper_loc_bounds,
            task=args.tasks[0] if len(args.tasks) == 1 else None,
            buffer=0.04,
        )
    else:
        bounds = np.array([[-2.0, -2.0, -2.0], [2.0, 2.0, 2.0]])

    keypose_model, traj_model = build_models(args, bounds)
    instructions = load_instructions(args.instructions, tasks=args.tasks)

    actioner = Actioner(
        keypose_model=keypose_model,
        traj_model=traj_model,
        instructions=instructions,
        action_dim=args.action_dim,
        predict_keypose=bool(args.predict_keypose),
        predict_trajectory=bool(args.predict_traj),
        seed=args.seed,
        device=args.device,
    )
    image_size = tuple(int(x) for x in args.image_size.split(","))
    fake_env = None
    if args.fake_sim:
        from .fake_sim import FakeSimEnv

        fake_env = FakeSimEnv(
            image_size=image_size, cameras=tuple(args.cameras),
            seed=args.seed,
        )
    env = RLBenchEnv(
        data_path=args.data_dir,
        image_size=image_size,
        apply_cameras=tuple(args.cameras),
        headless=bool(args.headless),
        collision_checking=bool(args.collision_checking),
        env=fake_env,
    )

    results = {}
    for task in args.tasks:
        rates = env.evaluate_task_on_multiple_variations(
            task,
            max_steps=args.max_steps,
            num_variations=args.variations[0],
            num_demos=args.num_demos,
            actioner=actioner,
            max_tries=args.max_tries,
            offline=bool(args.offline),
            dense_interpolation=bool(args.dense_interpolation),
            interpolation_length=args.interpolation_length,
            verbose=bool(args.verbose),
            record_videos=bool(args.record_videos),
            num_videos=args.num_videos,
            log_dir=args.log_dir,
        )
        results[task] = rates
        print(task, rates)
        with open(args.output, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
