"""Typed CLI configuration (argparse over dataclasses).

A copy of ``act3d_tpu/core/config.py`` with the same flags and defaults
(the reference's tap.Tap schemas, main_keypose.py:22-95 and
main_trajectory.py:25-79), plus ``device`` ("cuda" unless the caller asks
for "cpu").  A flag whose value asks for what the port does not have yet
raises ``NotImplementedError`` naming the ROADMAP item, when the config is
built:

  ==============================================  ===========================
  flag value                                      ROADMAP Queue A item
  ==============================================  ===========================
  ``--backbone`` other than ``clip``              TorchResNet50
  ``--rotation_parametrization`` (keypose) other  Act3D options
  than ``quat_from_query``, ``--weight_tying 0``
  / ``--gp_emb_tying 0``, ``--approx_topk 1``
  ``--rotation_parametrization`` (trajectory)     ChainedDiffuser options
  other than ``6D``, ``--feat_scales_to_use`` /
  ``--attn_rounds`` other than 1
  ==============================================  ===========================

Two TPU knobs change how JAX computes and not what: ``fast_prng`` (the
TPU's rbg PRNG) and ``flat_optimizer`` (flattened AdamW groups); they are
accepted and ignored.  ``num_devices`` -1 means the launched world size
(``torchrun --nproc_per_node``), 1 without a launcher; ``fsdp`` F > 1
shards over a ``(num_devices / F, F)`` mesh (``parallel/mesh.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
from typing import Optional, Tuple

__all__ = ["CommonConfig", "KeyposeConfig", "TrajectoryConfig", "parse_config"]


@dataclasses.dataclass
class CommonConfig:
    cameras: Tuple[str, ...] = ("wrist", "left_shoulder", "right_shoulder")
    image_size: str = "256,256"
    max_episodes_per_task: int = 100
    instructions: Optional[str] = "instructions.pkl"
    seed: int = 0
    tasks: Tuple[str, ...] = ()
    variations: Tuple[int, ...] = (0,)
    checkpoint: Optional[str] = None
    accumulate_grad_batches: int = 1
    val_freq: int = 500
    gripper_loc_bounds: Optional[str] = None
    eval_only: int = 0

    dataset: str = ""
    valset: str = ""

    base_log_dir: str = "train_logs"
    exp_log_dir: str = "exp"
    run_log_dir: str = "run"

    num_workers: int = 1
    batch_size: int = 16
    batch_size_val: int = 4
    cache_size: int = 100
    cache_size_val: int = 100
    lr: float = 1e-4
    train_iters: int = 200_000
    max_episode_length: int = 5

    image_rescale: str = "0.75,1.25"
    point_cloud_rotate_yaw_range: float = 0.0

    backbone: str = "clip"
    use_instruction: int = 0

    # Metric key (after aggregation) that drives the "best" checkpoint:
    # "default" is mean/pos_l2_final for keypose (the reference keys on an
    # action_mse its keypose criterion never emits, main_keypose.py:281,
    # so its best degenerates to last; "" reproduces that) and
    # traj_action_mse for trajectory (main_trajectory.py:274).
    best_checkpoint_metric: str = "default"

    # Host path and deployment flags of the JAX package.  num_devices / fsdp
    # build the mesh (parallel/mesh.py); mixed_precision 1 trains in bf16
    # with float32 master weights (train/flagship.py).
    num_devices: int = -1  # -1: the launched world size (1 without torchrun)
    fsdp: int = 1
    compact_transfer: int = 0  # u8 rgb / u16 pcd on the wire (data/compact.py)
    wire: str = "pcd"  # "depth": depth + camera model (data/depthwire.py)
    instr_mode: str = "features"  # "ids": a row of the instruction bank
    device_augment: int = 0  # Resize / Rotate on the card (data/device_augment.py)
    # resume from <log_dir>/last.pt when it exists and no --checkpoint was
    # given (preemption-safe relaunch with the same command line)
    auto_resume: int = 1
    use_tensorboard: int = 0
    fast_prng: int = 1  # accepted and ignored
    mixed_precision: int = 0
    flat_optimizer: int = 1  # accepted and ignored

    # the port's own: where the CLI runs ("cuda" or "cpu")
    device: str = "cuda"

    def __post_init__(self):
        _reject_unported(self)

    @property
    def image_size_tuple(self) -> Tuple[int, int]:
        return tuple(int(x) for x in self.image_size.split(","))  # type: ignore

    @property
    def image_rescale_tuple(self) -> Tuple[float, float]:
        return tuple(float(x) for x in self.image_rescale.split(","))  # type: ignore

    @property
    def log_dir(self) -> Path:
        return Path(self.base_log_dir) / self.exp_log_dir / self.run_log_dir

    def save(self, path: Path):
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(dataclasses.asdict(self), indent=2, default=str))


@dataclasses.dataclass
class KeyposeConfig(CommonConfig):
    """Act3D training flags (reference main_keypose.py:22-95)."""

    position_prediction_only: int = 0
    position_loss: str = "ce"
    ground_truth_gaussian_spread: float = 0.01
    compute_loss_at_all_layers: int = 0
    position_loss_coeff: float = 1.0
    position_offset_loss_coeff: float = 10000.0
    rotation_loss_coeff: float = 10.0
    symmetric_rotation_loss: int = 0
    gripper_loss_coeff: float = 1.0
    label_smoothing: float = 0.0
    regress_position_offset: int = 0

    num_sampling_level: int = 3
    fine_sampling_ball_diameter: float = 0.16
    weight_tying: int = 1
    gp_emb_tying: int = 1
    num_ghost_points: int = 1000
    num_ghost_points_val: int = 10000
    use_ground_truth_position_for_sampling_train: int = 1
    use_ground_truth_position_for_sampling_val: int = 0

    embedding_dim: int = 60
    num_ghost_point_cross_attn_layers: int = 2
    num_query_cross_attn_layers: int = 2
    num_vis_ins_attn_layers: int = 2
    rotation_parametrization: str = "quat_from_query"
    approx_topk: int = 0  # JAX's lax.approx_max_k fine-context selection


@dataclasses.dataclass
class TrajectoryConfig(CommonConfig):
    """DiffusionPlanner training flags (reference main_trajectory.py:25-79)."""

    dense_interpolation: int = 0
    interpolation_length: int = 100

    action_dim: int = 7
    embedding_dim: int = 120
    num_query_cross_attn_layers: int = 6
    num_vis_ins_attn_layers: int = 2
    use_goal: int = 0
    use_goal_at_test: int = 1
    feat_scales_to_use: int = 1
    attn_rounds: int = 1
    weight_tying: int = 0  # unread by the trajectory model, as in JAX
    rotation_parametrization: str = "6D"
    diffusion_timesteps: int = 100


def _reject_unported(cfg: CommonConfig) -> None:
    """Raise NotImplementedError for a flag value the port lacks, naming the
    ROADMAP Queue A item that ports it by its title."""
    rules = [
        (cfg.backbone != "clip", f"--backbone {cfg.backbone}",
         'ROADMAP Queue A, item "TorchResNet50"'),
        (cfg.device not in ("cuda", "cpu"), f"--device {cfg.device}", "cuda or cpu only"),
    ]
    if isinstance(cfg, KeyposeConfig):
        act3d = 'ROADMAP Queue A, item "Act3D options"'
        rules += [
            (cfg.rotation_parametrization != "quat_from_query",
             f"--rotation_parametrization {cfg.rotation_parametrization}",
             f"{act3d} (rotation parametrizations)"),
            (not cfg.weight_tying or not cfg.gp_emb_tying, "--weight_tying 0 / --gp_emb_tying 0",
             f"{act3d} (untied levels)"),
            (cfg.approx_topk, "--approx_topk", f"{act3d} (approximate top-k)"),
        ]
    if isinstance(cfg, TrajectoryConfig):
        planner = 'ROADMAP Queue A, item "ChainedDiffuser options"'
        rules += [
            (cfg.rotation_parametrization != "6D",
             f"--rotation_parametrization {cfg.rotation_parametrization}",
             f"{planner} (6D only)"),
            (cfg.feat_scales_to_use != 1 or cfg.attn_rounds != 1,
             "--feat_scales_to_use / --attn_rounds != 1",
             f"{planner} (multi-scale DiffusionHead)"),
        ]
    for bad, flag, item in rules:
        if bad:
            raise NotImplementedError(f"{flag} is not ported yet: {item}")


def parse_config(cls, argv=None):
    """Build an argparse parser from the dataclass fields and parse."""
    parser = argparse.ArgumentParser()
    for f in dataclasses.fields(cls):
        name = f"--{f.name}"
        default = f.default
        if f.type in ("Tuple[str, ...]", "Tuple[int, ...]") or isinstance(default, tuple):
            elem = int if default and isinstance(default[0], int) else str
            parser.add_argument(name, nargs="*", type=elem, default=list(default))
        elif f.type == "Optional[str]" or default is None:
            parser.add_argument(name, type=str, default=default)
        else:
            parser.add_argument(name, type=type(default), default=default)
    kwargs = vars(parser.parse_args(argv))
    for k, v in kwargs.items():
        if isinstance(getattr(cls, k, None), tuple) and isinstance(v, list):
            kwargs[k] = tuple(v)
    return cls(**kwargs)
