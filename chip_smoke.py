"""On-card smoke test of the PyTorch/CUDA port (act3d_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero):
  1. device: torch/CUDA versions, the card's name and power limit; the
     port's float32 policy (act3d_tpu_torch.device.pin_float32, applied by
     resolve_device as at every entry point: matmuls and cuDNN
     convolutions in float32, no TF32), read back through the same
     fp32_precision API.
  2. build: nvcc builds every CUDA source of the port for sm_90a (one nvcc
     per source, all started together); prints each kernel's ptxas report
     (registers, spills).
  3. kernel: the fused-MHA forward kernel against its plain PyTorch
     version at every attention shape of the serving keystep (plus a
     padded-key mask and a fully masked row), atol 2e-5 / rtol 1e-4 on
     out and stats, a repeated call bit-identical; device times (calls
     replayed from a CUDA graph) of the kernel, the plain version and
     torch's scaled_dot_product_attention (timing yardstick only), the
     kernel's time per eager call from Python, the float32 bound (67
     TFLOP/s) and the tensor-core bound (3xTF32 at 165 TFLOP/s, the
     exponentials at the card's max SM clock, the bytes), and the launch
     plan's device kernels per call and workspace bytes.
  4. small keystep: the chained Actioner at a small size on the card
     against the same weights and injected samples on the CPU.
  5. serve: the Actioner at the reference widths (Act3D emb 60 / 3
     levels / 10000 ghost points; DiffusionPlanner emb 120 / 6 layers /
     100 steps; 3 cameras at 256^2; trajectory length 50), seeded random
     weights, 3 keysteps; checks shapes, finiteness, unit quaternions and
     that every attention site launched the forward kernel (1918 per
     keystep) and none the backward or the gather adjoint.
  6. training kernels: the fused-MHA forward with dropout (rate 0.1) and
     the fused-MHA backward against their plain versions at every
     attention shape of the ChainedDiffuser training step (B=16, E=120,
     H=8), plus a padded-key mask, a fully masked row and rate 0, and at
     the three attention shapes of the Act3D keypose training step (B=16,
     E=60, H=4, rate 0); repeated calls bit-identical; the keep fraction
     of the hash mask; device times of both kernels, their plain versions
     and SDPA (forward, and backward through autograd as forward +
     backward minus forward, at dropout_p=0: timing yardstick only) beside
     both bounds; then the device kernels per wrapper call and the
     workspace bytes at every site and per unit of the main path.
  7. gather kernels: the sorted and unsorted row-scatter kernels (the
     fine-context gather's adjoint) against their plain version at the
     Act3D fine-level shape (B=16, K=3072, C=60, P=49152) for three index
     layouts (sorted top-k nearest of an anchor in a synthetic cloud,
     uniform, K-edge-hugging) and at C=3; the match must be exact; device
     times of both kernels, the plain version and a zero-filled
     ``scatter_`` (timing yardstick only).
  8. small training step: loss and every trainable gradient on the card
     against the CPU (same weights, injected noise and timesteps, dropout
     off); a dropout-on step run twice gives identical gradients.
  9. small keypose step: the same for a small Act3D (128^2, 1 camera, emb
     24, 2 levels, injected ghost points, gt sampling on), then the card
     step twice with bit-identical gradients.
 10. train: the flagship ChainedDiffuser (emb 120, 8 heads, 6 query
     layers, dropout 0.1, 3 cameras at 256^2, trajectory length 50) takes
     5 Trainer steps at batch 16 on a seeded synthetic batch; checks finite
     losses, changed trainable params, a bit-identical backbone and 19
     forward + 19 backward kernel launches per step; prints step times and
     peak memory.
 11. train_act3d: the flagship Act3D keypose model (emb 60, 4 heads, 1000
     training ghost points over 3 levels, weights tied, instructions, 3
     cameras at 256^2, gt-biased fine sampling, position CE + rotation x10
     + gripper) takes 5 Trainer steps at batch 16; checks finite losses,
     changed params, a bit-identical backbone and 18 fused_mha_fwd + 18
     fused_mha_bwd + 2 scatter_rows_sorted launches per step; prints step
     times and peak memory; then one Trainer.evaluate on a batch of 4
     (10000 ghost points).
 12. attention_core: the single-head-layout core (no model path, as in
     JAX), the fused forward kernel at H = 1 without stats, against its
     plain version at every attention site of both training steps
     flattened to (B*H, L, 15), plus a padded mask and a fully masked row,
     atol 2e-5 / rtol 1e-4, a repeated call bit-identical; its gradient
     through AttentionCore on the card against the CPU; device times
     beside both bounds (float32 and tensor-core), the plain version and
     SDPA (timing yardstick only), and the launch plan's device kernels
     per call and workspace bytes.
 13. scatter_rows_chunked: the chunked row-scatter entry (no model path)
     bit-exact against its plain version at the Act3D fine-level shape for
     three layouts and at K = 3000, P = 49000 (padding), at JAX's defaults
     (p_tile 256, 4 chunks), at 17 chunks and at p_tile 1, 100 and 57344;
     device times of its grid (the sorted entry's, as the C side reports
     it, whatever p_tile and n_chunks are) beside scatter_rows_sorted, the
     plain version and scatter_.
 14. cli_keypose: a fixture tree (pick_and_lift, 3 cameras at 256^2, 5-frame
     episodes, instructions) in a temporary directory, then
     act3d_tpu_torch.train.main_keypose.main with scripts/train_act3d.sh's
     flags, --train_iters 6 --val_freq 3: finite losses, best.pt / last.pt,
     18 + 18 + 2 launches in every training step, finite evaluations; a
     second call with --train_iters 7 resumes at step 6.  Prints each
     step's time and its wait in next(feeder), and the peak memory.
 15. cli_trajectory: the same for main_trajectory.main with
     scripts/train_trajectory.sh's flags (batch 22, emb 120, 6 layers, 6D,
     100 steps, dense interpolation to 50, goal, instructions),
     --train_iters 4 --val_freq 4: 19 + 19 launches per training step, one
     evaluation with the 100-step sampler at batch 4; resumes at step 4.
 15b. the model options of both CLIs (after 15), at the scripts' flags plus
     JAX's option flags: kernels_options (after 6: #1d / #2 at the sites
     the 3-scale x 2-round head adds, B=16, E=120, H=8: the scale-1 and
     scale-2 cross sites L=50 over S=3202 / 802, with and without a padded
     mask, and vl_attention at L=3200 / 800 over 53; phase 6's tolerances,
     device times beside both bounds and SDPA); cli_trajectory_options
     (--feat_scales_to_use 3 --attn_rounds 2 --backbone resnet, 3 steps
     and one evaluation with the 100-step sampler, then a resume: 114 + 114
     launches a step, none of the row scatters); cli_trajectory_quat (the
     same with --rotation_parametrization quat, 2 steps); cli_keypose_options
     (--weight_tying 0 --gp_emb_tying 0 --rotation_parametrization
     6D_from_top_ghost --approx_topk 1, 4 steps and one evaluation: 18 + 18
     + 2 launches a step, a zero gradient on the six rotation rows of
     gripper_state_fc2 in every backward (6D has no rotation loss, as in
     JAX), and the card's approximate fine-context selection equal to the
     exact set but for points at the k-th distance, with both selections'
     device times).
 16. cli_eval: an Act3D and a DiffusionPlanner at act3d_tpu/eval/main.py's
     default widths (the serve phase's), seeded weights saved by
     Trainer.save_checkpoint as best.pt and, by flax_params + msgpack_bytes
     (the flax bridge inverted, flax's msgpack layout), as the JAX
     Trainer's best.msgpack; then act3d_tpu_torch.eval.main.main over the
     sim-free backend (--fake_sim 1 --tasks pick_and_lift --num_demos 1
     --max_steps 3 --record_videos 0, every other flag its default): 1918
     fused_mha_fwd launches and no other kernel in each keystep, the
     success-rate JSON in JAX's layout; the same over the .msgpack files,
     every keystep's output bit for bit the .pt run's; then --offline 1
     --predict_traj 0 (18 launches a keystep, Act3D alone) must score on
     every demo.  Prints each keystep's host-clock latency (Act3D /
     sampler) and the phase's peak memory.
 17. host_path: over the CLIs' fixture tree, at the keypose CLI's shapes
     (batch 16, 3 cameras at 256^2): expand_batch's uint8 / uint16
     conversions on the card against the CPU (exact), the u16 wires and the
     depth wire's reconstruct_pcds against the host XYZ batch of the same
     draws (within WIRE_TOL = 5e-4 m), gather_hw and device_augment's
     resize against the host Resize of the same draws (exact).  Then where
     the host batch's time goes: median host-clock ms of sample_batch at
     both CLIs' flags (batch 16 / 22) with the host Resize on and off, wire
     pcd and depth, dense interpolation on and off, compact_batch, the
     pinned copy and the H2D copy of each batch, sample_batch in a thread
     while the main thread dispatches CUDA ops (the GIL), the
     multi-process sampler's batches with W workers, and what a worker's
     imports cost.
 18. cli_keypose_host_path: phase 14 with --num_workers W --device_augment 1
     --compact_transfer 1 --instr_mode ids, W = half the machine's cores
     (printed), 24 steps with one evaluation at the end (so that the feeder
     wait of steps 12- is the steady state's), then a resume: the same
     checks and launches per step.
 19. cli_trajectory_host_path: phase 15 with --wire depth --instr_mode ids
     --num_workers W, 24 steps likewise; then the feeder wait per step and
     the peak memory of each CLI with (steps 12-) and without (the steps
     before the first evaluation) the host-path flags.
bf16 mixed precision (--mixed_precision 1) adds, in this order among the
phases above:
 13b. kernels_bf16: the bf16 entry of every kernel at every shape of both
     bf16 training steps (the fused-MHA forward and backward at the sites
     of 6 and 11, the core at the sites of 12, the three row scatters at
     the Act3D fine level) against its bf16 plain version and the float32
     plain version on the same bf16-rounded inputs: the kernel's error
     against float32 at most twice the plain bf16 version's plus one bf16
     ulp of the output's scale (kernels.bf16_errors; the gradients with a
     floor of float32 noise), stats at atol 2e-5 / rtol 1e-4, repeats
     bit-identical, the row scatters bit-exact, the dropout zero pattern the
     float32 kernel's for one seed; device times of each kernel, its plain
     bf16 version and SDPA / scatter_ in bf16 beside the bf16 bound (989
     TFLOP/s dense bf16, 3.35 TB/s).
  9b. small bf16 steps: one step of a small ChainedDiffuser and Act3D in
     bf16 on the card against the CPU: losses within 2e-2, the whole
     gradient within cosine 0.99 / relative L2 5e-2, gradients float32.
 11b. train_bf16 / train_act3d_bf16: phases 10 and 11 with
     compute_dtype=torch.bfloat16: 19 + 19 and 18 + 18 + 2 launches of the
     bf16 entries per step and none of the float32 ones (Act3D's evaluation
     runs the float32 forward, as JAX evaluates uncast), params, AdamW
     moments and gradients float32 (as in phases 10 and 11, which check the
     same), step times and peak memory.
 Phases 18 and 19 train with --mixed_precision 1 (their launches per step
 are the bf16 entries').
Data parallelism (--num_devices / --fsdp) adds:
 13c. kernels_dropout_offset (after 13b): the fused-MHA forward and
     backward, float32 and bf16, at every ChainedDiffuser dropout site on
     rows 8-15 of a batch of 16 with dropout_b0 = 8, against the plain
     versions of the whole batch, rows 8-15 (phase 6's and 13b's bounds);
     the drop pattern (v the identity of each head) equal to rows 8-15 of
     the full-batch mask, every drop counted.
  9c. dp_equal (after 9b): small models (phases 8 and 9's widths, a global
     batch of 4, the planner's rows padded unevenly) at world 1 in this
     process against two ranks spawned on the card over gloo with CUDA
     tensors: DDP (dp2) for the planner and Act3D, FSDP2 on a (1, 2) mesh
     (dp1 x fsdp2) for the planner; and against DDP and FSDP2 at world 1
     over NCCL.  3 steps: losses within rtol 2e-4, gradients by JAX's
     per-leaf scaled rule (atol 5e-4), each rank's launches those of world
     1, each fsdp2 rank's trainable and moment bytes below 0.6 of world 1's.
 20. cli_dp (after 19): both CLIs at their scripts' flags under python -m
     torch.distributed.run --standalone (ranks run chip_smoke.py
     --cli_child SPEC): one rank over NCCL with --num_devices 1 (keypose 3
     steps, trajectory 4, the steps before the first evaluation), float32,
     and the trajectory CLI with --mixed_precision 1; step losses within
     rtol 2e-4 of the non-launched runs (phases 14 and 15, and a
     non-launched bf16 run here).  Then the trajectory CLI on two ranks
     sharing the card over gloo (--num_devices 2 --fsdp 2: FSDP2), its
     global losses against phase 15's and each rank's trainable and moment
     bytes; eval.main over its best.pt and the launched keypose run's, two
     keysteps.  Also: the host batch of the trajectory CLI at world 1 and
     per rank of 2 (replayed draws), an elementwise dropout draw at world 1
     and 2.
Then the samplers' fork server and resource tracker are stopped (they
would outlive the script by seconds), and the script fails if any process
it started is left.
Every main-path phase (serve, train, train_act3d, the eight CLIs, dp_equal
and cli_dp) runs with all launch counts set to 0 just before it and read
just after; the launches of dp_equal's and cli_dp's child processes,
counted by each child's wrappers, are added to their phase.
The second-to-last line is a JSON object of kernel numbers (six kernels
and their six bf16 entries);
the last is {"ok": true, "device": {...}}.  Without a card it exits
non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import pickle
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from act3d_tpu_torch.data.augment import Resize
from act3d_tpu_torch.data.compact import compact_batch, expand_batch
from act3d_tpu_torch.data.dataset import RLBenchDataset
from act3d_tpu_torch.data.depthwire import gather_hw, reconstruct_pcds
from act3d_tpu_torch.data.device_augment import resize_with_params
from act3d_tpu_torch.data.feeder import DeviceFeeder, to_tensors
from act3d_tpu_torch.data.fixtures import CAMERAS, make_dataset_tree, make_instructions
from act3d_tpu_torch.data.pipeline import (
    MultiProcessSampler,
    rlbench_dataset_factory,
    stop_helper_processes,
)
from act3d_tpu_torch.device import float32_precision, resolve_device
from act3d_tpu_torch.eval import main as eval_main
from act3d_tpu_torch.eval.actioner import Actioner
from act3d_tpu_torch.kernels import BWD_FLOOR, _build, bf16_errors
from act3d_tpu_torch.kernels import gather as gather_kernels
from act3d_tpu_torch.kernels.attention import (
    attention_core,
    attention_core_forward,
    attention_core_reference,
    bwd_plan,
    dropout_keep,
    fused_mha_backward,
    fused_mha_backward_reference,
    fused_mha_forward,
    fused_mha_forward_reference,
    fwd_plan,
)
from act3d_tpu_torch.kernels.gather import (
    scatter_rows,
    scatter_rows_chunked,
    scatter_rows_reference,
    scatter_rows_sorted,
)
from act3d_tpu_torch.models import Act3D, DiffusionPlanner
from act3d_tpu_torch.nn.dropout import Generators
from act3d_tpu_torch.ops.geometry import topk_nearest_context
from act3d_tpu_torch.train import main_keypose, main_trajectory
from act3d_tpu_torch.train.engine import Trainer
from act3d_tpu_torch.train.flagship import (
    diffusion_loss,
    diffusion_loss_fn,
    keypose_loss_fn,
    keypose_metrics_fn,
    keypose_pred,
    make_diffusion_model,
    make_keypose_model,
)
from act3d_tpu_torch.train.losses import KeyposeLossAndMetrics
from act3d_tpu_torch.utils.registry import get_gripper_loc_bounds
from act3d_tpu_torch.utils.testing import synthetic_keypose_batch, synthetic_trajectory_batch

ATOL, RTOL = 2e-5, 1e-4
# backward kernel vs its plain version: float32 sums over up to 3072 rows
# (dk, dv) or 3074 keys (dq) taken in another order than the plain
# version's matmuls; the expected error is ~1e-5 at these magnitudes
BWD_ATOL, BWD_RTOL = 1e-4, 1e-3
PEAK_F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
# float32 accuracy on the TF32 tensor cores (495 TFLOP/s): three TF32
# products per product (3xTF32, csrc/mma_tf32.cuh)
PEAK_TC_F32_FLOPS = 495e12 / 3
EXP_PER_CLOCK = 132 * 16  # exponentials per clock: 132 SMs x 16 special-function lanes
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 on the tensor cores
BOUNDS = ((-0.3, -0.5, 0.75), (0.7, 0.5, 1.5))
SEED = 0

# Reference widths (act3d_tpu/eval/main.py defaults).
ACT3D_CFG = dict(image_size=(256, 256), embedding_dim=60, num_attn_heads=4,
                 num_ghost_point_cross_attn_layers=2, num_query_cross_attn_layers=2,
                 num_vis_ins_attn_layers=2, num_ghost_points_val=10000,
                 num_sampling_level=3, use_instruction=True, gripper_loc_bounds=BOUNDS)
PLANNER_CFG = dict(image_size=(256, 256), embedding_dim=120, output_dim=7,
                   num_query_cross_attn_layers=6, num_vis_ins_attn_layers=2,
                   use_instruction=True, use_goal=True, use_goal_at_test=False,
                   diffusion_timesteps=100, gripper_loc_bounds=BOUNDS)
NCAM, TRAJ_LEN, N_INSTR = 3, 50, 53
N_KEYSTEPS = 3
# ChainedDiffuser training (act3d_tpu/train/flagship.py make_diffusion_model
# with the trainer defaults of act3d_tpu/core/config.py: batch 16, lr 1e-4,
# weight decay 5e-4; dropout 0.1; 3 cameras at 256^2, trajectory length 50)
TRAIN_B, TRAIN_STEPS, DROPOUT = 16, 5, 0.1
SMALL_KEYS = ("trajectory", "trajectory_mask", "rgbs", "pcds", "instr", "curr_gripper",
              "action")
# Act3D keypose training (act3d_tpu/train/flagship.py make_keypose_model with
# the trainer defaults of scripts/train_act3d.sh / core/config.py
# KeyposeConfig: batch 16, lr 1e-4, weight decay 5e-4, 1000 training and
# 10000 eval ghost points over 3 levels, gt-biased fine sampling)
KEYPOSE_LEVELS, KEYPOSE_EVAL_B = 3, 4
KEYPOSE_KEYS = ("rgbs", "pcds", "instr", "curr_gripper")
# Act3D fine-level gather adjoint: B = 16, K = 32*32*3 context tokens out of
# P = 128*128*3 points (levels 1 and 2 read the 128^2 res1 map), C = 60
GATHER_B, GATHER_K, GATHER_P, GATHER_C = TRAIN_B, 32 * 32 * NCAM, 128 * 128 * NCAM, 60
CHUNKED_DEFAULTS = (256, 4)  # JAX's p_tile and n_chunks
# Every kernel of the port, by the name the kernel line gives it: the
# wrapper and its launch counter (float32 entries count in ``launches``,
# the bf16 entries of --mixed_precision 1 in ``launches_bf16``).
_WRAPPERS = {"fused_mha_fwd": fused_mha_forward, "fused_mha_bwd": fused_mha_backward,
             "scatter_rows_sorted": scatter_rows_sorted, "scatter_rows": scatter_rows,
             "scatter_rows_chunked": scatter_rows_chunked, "attention_core": attention_core}
KERNELS = {**{name: (fn, "launches") for name, fn in _WRAPPERS.items()},
           **{f"{name}_bf16": (fn, "launches_bf16") for name, fn in _WRAPPERS.items()}}


def launch_counts() -> tuple:
    """Every kernel's launch count, in KERNELS order."""
    return tuple(getattr(fn, attr) for fn, attr in KERNELS.values())


def per_unit_launches(**counts) -> tuple:
    """Launches per step or keystep in KERNELS order: the named ones, 0
    for the others."""
    assert set(counts) <= set(KERNELS), counts
    return tuple(counts.get(name, 0) for name in KERNELS)


def nonzero(launches) -> dict:
    """The kernels a tuple in KERNELS order launched, with their counts."""
    return {name: n for name, n in zip(KERNELS, launches) if n}
# The training CLIs at their reference scripts' flags (scripts/train_act3d.sh,
# scripts/train_trajectory.sh) over a fixture tree of CLI_EPISODES episodes.
REPO = Path(__file__).resolve().parent
CLI_BOUNDS = REPO / "assets" / "tasks" / "74_hiveformer_tasks_location_bounds.json"
CLI_EPISODES = 4
KEYPOSE_CLI_FLAGS = [
    "--batch_size", "16", "--batch_size_val", "4", "--lr", "1e-4", "--embedding_dim", "60",
    "--num_ghost_points", "1000", "--num_ghost_points_val", "10000",
    "--num_sampling_level", "3", "--weight_tying", "1", "--gp_emb_tying", "1",
    "--use_instruction", "1", "--cache_size", "100", "--image_rescale", "0.75,1.25",
    "--exp_log_dir", "exp",
]
TRAJECTORY_CLI_FLAGS = [
    "--batch_size", "22", "--batch_size_val", "4", "--lr", "1e-4", "--embedding_dim", "120",
    "--num_query_cross_attn_layers", "6", "--rotation_parametrization", "6D",
    "--diffusion_timesteps", "100", "--dense_interpolation", "1",
    "--interpolation_length", "50", "--use_goal", "1", "--use_goal_at_test", "0",
    "--use_instruction", "1", "--cache_size", "600", "--image_rescale", "0.75,1.25",
    "--exp_log_dir", "exp",
]

# The training host path: the same CLIs with JAX's host-path flags, the
# workers from host_workers(); median host-clock times over HOST_REPEATS
# calls; WIRE_TOL = the u16 depth step times |K^-1 u| (tests/test_depthwire.py).
def keypose_host_path_flags(workers):
    return ["--num_workers", str(workers), "--device_augment", "1", "--compact_transfer", "1",
            "--instr_mode", "ids"]


def trajectory_host_path_flags(workers):
    return ["--wire", "depth", "--instr_mode", "ids", "--num_workers", str(workers)]


# --mixed_precision 1, on the host-path CLI phases; the phases that train in bf16
BF16_CLI_FLAGS = ["--mixed_precision", "1"]
BF16_PHASES = ("train_bf16", "train_act3d_bf16", "cli_keypose_host_path",
               "cli_trajectory_host_path")
HOST_REPEATS = 5
WIRE_TOL = 5e-4
# steps of the host-path CLI phases, one evaluation at the end: the second
# half runs after the workers' prefilled slots are used up
HOST_PATH_CLI_ITERS = 24

# The eval CLI over the sim-free backend; every other flag is its default
# (act3d_tpu/eval/main.py's widths, as ACT3D_CFG / PLANNER_CFG).  With
# --num_demos 1 the loop runs num_demos // 1 variation + 1 = 2 demos of one
# keystep each (the fake demo's one keypose).
EVAL_CLI_FLAGS = ["--fake_sim", "1", "--tasks", "pick_and_lift", "--num_demos", "1",
                  "--max_steps", "3", "--record_videos", "0"]
EVAL_CLI_DEMOS = 2


def planner_sites_per_denoise() -> int:
    """Attention cores of one DiffusionHead.denoise: vl_attention +
    traj_lang_attention + (cross + self) per layer of the traj
    (query_layers - 2), pos (2) and rot (2) stacks."""
    p = PLANNER_CFG
    return (p["num_vis_ins_attn_layers"] + 1
            + 2 * (p["num_query_cross_attn_layers"] - 2) + 2 * 2 + 2 * 2)


def act3d_sites_per_forward() -> int:
    """Attention cores of one Act3D forward: vis_ins, ghost_point and query
    stacks at every level."""
    a = ACT3D_CFG
    return a["num_sampling_level"] * (
        a["num_vis_ins_attn_layers"] + a["num_ghost_point_cross_attn_layers"]
        + a["num_query_cross_attn_layers"])


def expected_launches_per_keystep() -> int:
    return (act3d_sites_per_forward()
            + PLANNER_CFG["diffusion_timesteps"] * planner_sites_per_denoise())


# (site, L, S, E, H, mask kind, launches per keystep); B = 1.  Context
# lengths: 3126 = 32*32*3 visual + 1 gripper + 53 instruction tokens;
# 3333 = 10000 // 3 ghost points; 3074 = 3072 visual + current + goal.
SHAPES = [
    ("act3d.vis_ins", 3073, 53, 60, 4, None, 6),
    ("act3d.ghost_point", 3333, 3126, 60, 4, None, 6),
    ("act3d.query", 1, 3126, 60, 4, None, 6),
    ("planner.vl", 3072, 53, 120, 8, None, 200),
    ("planner.traj_lang", 50, 53, 120, 8, None, 100),
    ("planner.cross", 50, 3074, 120, 8, None, 800),
    ("planner.self", 50, 50, 120, 8, "valid", 800),
    ("check.self_padded", 50, 50, 120, 8, "padded", 0),
    ("check.fully_masked_row", 50, 50, 120, 8, "full", 0),
]

# (site, L, S, mask kind, dropout rate, launches per training step); B = 16,
# E = 120, H = 8: the attention cores of one denoise pass
# (act3d_tpu/models/diffusion_head.py:309-359), each launched once forward
# and once backward per step.
TRAIN_SHAPES = [
    ("train.vl", 3072, 53, None, DROPOUT, 2),
    ("train.traj_lang", 50, 53, None, DROPOUT, 1),
    ("train.cross", 50, 3074, None, DROPOUT, 8),
    ("train.self", 50, 50, "valid", DROPOUT, 8),
    ("check.train_self_padded", 50, 50, "padded", DROPOUT, 0),
    ("check.train_fully_masked_row", 50, 50, "full", DROPOUT, 0),
    ("check.train_cross_rate0", 50, 3074, None, 0.0, 0),
]
# The Act3D keypose training step's attention cores, B = 16, E = 60, H = 4,
# no dropout (JAX builds the Act3D layers at rate 0): per level and layer,
# vis_ins (3072 visual + 1 gripper rows over 53 instruction tokens), ghost
# (1000 // 3 ghost points over 3073 + 53 context tokens) and query (1 row).
KEYPOSE_SHAPES = [
    ("keypose.vis_ins", 3073, 53, None, 0.0, 6),
    ("keypose.ghost_point", 333, 3126, None, 0.0, 6),
    ("keypose.query", 1, 3126, None, 0.0, 6),
]

# The model options of both CLIs (JAX's option flags on top of the scripts'
# flags): the ChainedDiffuser head over 3 feature scales x 2 attention
# rounds (6 blocks of 19 attention sites) on the ResNet-50 trunk, then
# quaternion rotations; Act3D with untied levels, the rotation read from the
# top ghost point as ortho-6D, and approximate top-k.
OPTION_SCALES, OPTION_ROUNDS = 3, 2
OPTION_BLOCKS = OPTION_SCALES * OPTION_ROUNDS
TRAJECTORY_OPTION_FLAGS = ["--feat_scales_to_use", str(OPTION_SCALES), "--attn_rounds",
                           str(OPTION_ROUNDS), "--backbone", "resnet"]
TRAJECTORY_QUAT_FLAGS = TRAJECTORY_OPTION_FLAGS + ["--rotation_parametrization", "quat"]
KEYPOSE_OPTION_FLAGS = ["--weight_tying", "0", "--gp_emb_tying", "0",
                        "--rotation_parametrization", "6D_from_top_ghost", "--approx_topk", "1"]
# (site, L, S, mask kind, dropout rate, launches per step of the 6-block
# head); B = 16, E = 120, H = 8.  Blocks at scales 1 and 2 attend to the
# 64 * 50 and 16 * 50 trajectory-nearest points of the 128^2 res1 level
# (find_traj_nn), plus the current and goal gripper tokens; their
# vl_attention runs from those points to the 53 instruction tokens.  Their
# traj_lang (50 x 53) and self (50 x 50) sites are TRAIN_SHAPES' shapes.
OPTION_SHAPES = [
    ("options.vl_scale1", 64 * TRAJ_LEN, 53, None, DROPOUT, 2 * OPTION_ROUNDS),
    ("options.vl_scale2", 16 * TRAJ_LEN, 53, None, DROPOUT, 2 * OPTION_ROUNDS),
    ("options.cross_scale1", TRAJ_LEN, 64 * TRAJ_LEN + 2, None, DROPOUT, 8 * OPTION_ROUNDS),
    ("options.cross_scale2", TRAJ_LEN, 16 * TRAJ_LEN + 2, None, DROPOUT, 8 * OPTION_ROUNDS),
    ("check.options_cross_scale1_padded", TRAJ_LEN, 64 * TRAJ_LEN + 2, "padded", DROPOUT, 0),
    ("check.options_cross_scale2_padded", TRAJ_LEN, 16 * TRAJ_LEN + 2, "padded", DROPOUT, 0),
]
# launches per step of TRAIN_SHAPES' sites in the 6-block head, per launch
# of the one-block step: vl and cross at scale 0 only, traj_lang and self in
# every block
OPTION_SCALE0_BLOCKS = {"train.vl": OPTION_ROUNDS, "train.cross": OPTION_ROUNDS,
                        "train.traj_lang": OPTION_BLOCKS, "train.self": OPTION_BLOCKS}


def options_step_pairs(train_rows, option_rows):
    """(shape row, launches per step) of the 6-block head's training step:
    TRAIN_SHAPES' sites at their counts in the 6 blocks, and the scale-1 /
    scale-2 sites of OPTION_SHAPES."""
    pairs = [(r, r["per_step"] * OPTION_SCALE0_BLOCKS[r["site"]]) for r in train_rows
             if r["site"] in OPTION_SCALE0_BLOCKS]
    pairs += [(r, r["per_step"]) for r in option_rows if r["per_step"]]
    assert sum(n for _, n in pairs) == OPTION_BLOCKS * 19, pairs
    return pairs


def nvidia_smi(query="name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def sm_clock_mhz() -> float:
    """The card's maximum SM clock, as nvidia-smi reads it (MHz)."""
    return float(nvidia_smi("clocks.max.sm").split()[0])


def _event_ms(run, calls: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def eager_ms(fn, iters: int) -> float:
    """Time per call of back-to-back calls from Python: host dispatch
    included, as the eager sampler loop pays it."""
    for _ in range(3):
        fn()

    def run():
        for _ in range(iters):
            fn()
    return _event_ms(run, iters)


def device_ms(fn, iters: int, side: torch.cuda.Stream, replays: int = 3) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    replayed between CUDA events, so no host dispatch is in the number.
    ``side`` is the warm-up stream; one stream serves every measurement,
    since each new stream keeps a cuBLAS workspace of its own."""
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()

    def run():
        for _ in range(replays):
            graph.replay()
    ms = _event_ms(run, replays * iters)
    del graph
    return ms


def make_mask(kind, s, dev):
    if kind is None:
        return None
    mask = torch.zeros(2 if kind == "full" else 1, s, dtype=torch.bool, device=dev)
    if kind == "padded":
        mask[:, s - 10:] = True
    if kind == "full":
        mask[1] = True  # batch row 1 has every key masked
    return mask


def fwd_work(l, s, e, h, b, masked):
    """FLOPs (q k^T and p v) and bytes (q, k, v, the mask read; out, stats
    written) of one forward call."""
    flops = 4.0 * b * l * s * e
    nbytes = 4.0 * (2 * b * l * e + 2 * b * s * e + 2 * b * l * h) + (b * s if masked else 0)
    return flops, nbytes


def bwd_work(l, s, e, h, b, masked):
    """Five (L, S, d) products per head; the wrapper reads q, out, dO, k,
    v, stats (and the mask) and writes dq, dk, dv, each byte once."""
    flops = 10.0 * b * l * s * e
    nbytes = 4.0 * (4 * b * l * e + 4 * b * s * e + 2 * b * l * h) + (b * s if masked else 0)
    return flops, nbytes


def bound(l, s, e, h, b, masked):
    """The float32 bound: FLOPs at 67 TFLOP/s outside the tensor cores,
    bytes at 3.35 TB/s."""
    flops, nbytes = fwd_work(l, s, e, h, b, masked)
    return flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


def bound_bwd(l, s, e, h, b, masked):
    flops, nbytes = bwd_work(l, s, e, h, b, masked)
    return flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


def tc_bound(flops, exps, nbytes, sm_mhz):
    """The fused-MHA kernels' tensor-core bound: the largest of the FLOPs at
    165 TFLOP/s (3xTF32), the exponentials on the special-function units at
    the card's SM clock, and the bytes at 3.35 TB/s."""
    times = {"operations": flops / PEAK_TC_F32_FLOPS * 1e3,
             "exponentials": exps / (EXP_PER_CLOCK * sm_mhz * 1e6) * 1e3,
             "bytes": nbytes / PEAK_BYTES * 1e3}
    by = max(times, key=times.get)
    return dict(tc_bound_ms=times[by], tc_bound_by=by)


def fwd_tc_bound(l, s, e, h, b, masked, sm_mhz):
    flops, nbytes = fwd_work(l, s, e, h, b, masked)
    return tc_bound(flops, b * l * s * h, nbytes, sm_mhz)


def bwd_tc_bound(l, s, e, h, b, masked, sm_mhz):
    flops, nbytes = bwd_work(l, s, e, h, b, masked)
    return tc_bound(flops, b * l * s * h, nbytes, sm_mhz)


def plan_row(plan):
    """The launch plan of one call: device kernels and workspace bytes."""
    return dict(kernels_per_call=plan.kernels, workspace_bytes=4 * plan.workspace_floats,
                plan=plan._asdict())


def core_work(l, s, d, bh, masked):
    """attention_core reads q, k, v (and the (BH, S) bool mask) and writes
    out, each byte once; it keeps no softmax stats."""
    flops = 4.0 * bh * l * s * d
    nbytes = 4.0 * (2 * bh * l * d + 2 * bh * s * d) + (bh * s if masked else 0)
    return flops, nbytes


def bound_core(l, s, d, bh, masked):
    flops, nbytes = core_work(l, s, d, bh, masked)
    return flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


def core_tc_bound(l, s, d, bh, masked, sm_mhz):
    flops, nbytes = core_work(l, s, d, bh, masked)
    return tc_bound(flops, bh * l * s, nbytes, sm_mhz)


def _bound_row(t_ops, t_bytes):
    return dict(bound_ms=max(t_ops, t_bytes), ops_ms=t_ops, bytes_ms=t_bytes,
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def _max_errs(pairs):
    abs_err = rel_err = 0.0
    for got, want in pairs:
        diff = (got - want).abs()
        abs_err = max(abs_err, diff.max().item())
        rel_err = max(rel_err, (diff / want.abs().clamp_min(1e-30)).max().item())
    return abs_err, rel_err


def phase_kernels(dev, card, sm_mhz):
    gen = torch.Generator(device=dev).manual_seed(SEED)
    side = torch.cuda.Stream()
    rows = []
    for site, l, s, e, h, kind, per_keystep in SHAPES:
        mask = make_mask(kind, s, dev)
        b = 1 if mask is None else mask.shape[0]
        q = torch.randn(b, l, e, generator=gen, device=dev) * (e // h) ** -0.5
        k = torch.randn(b, s, e, generator=gen, device=dev)
        v = torch.randn(b, s, e, generator=gen, device=dev)
        out, stats = fused_mha_forward(q, k, v, h, mask, return_stats=True)
        torch.cuda.synchronize()
        ref_out, ref_stats = fused_mha_forward_reference(q, k, v, h, mask)
        err = max((out - ref_out).abs().max().item(), (stats - ref_stats).abs().max().item())
        rel = max(((out - ref_out).abs() / ref_out.abs().clamp_min(1e-30)).max().item(),
                  ((stats - ref_stats).abs() / ref_stats.abs().clamp_min(1e-30)).max().item())
        torch.testing.assert_close(out, ref_out, atol=ATOL, rtol=RTOL)
        torch.testing.assert_close(stats, ref_stats, atol=ATOL, rtol=RTOL)
        again = fused_mha_forward(q, k, v, h, mask, return_stats=True)
        assert torch.equal(out, again[0]) and torch.equal(stats, again[1]), site
        if kind == "full":
            uniform = v[1].mean(dim=0).expand(l, e)
            torch.testing.assert_close(out[1], uniform, atol=ATOL, rtol=RTOL)

        iters = 20 if l * s > 1e6 else 200
        def kernel():
            return fused_mha_forward(q, k, v, h, mask)

        ms = device_ms(kernel, iters, side)
        kernel_eager_ms = eager_ms(kernel, iters)
        plain_ms = device_ms(lambda: fused_mha_forward_reference(q, k, v, h, mask), iters,
                             side)
        d = e // h
        qh, kh, vh = (x.reshape(b, -1, h, d).transpose(1, 2).contiguous() for x in (q, k, v))
        attn_mask = None if mask is None else ~mask[:, None, None, :]
        library_ms = device_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=attn_mask, scale=1.0), iters, side)
        t_ops, t_bytes = bound(l, s, e, h, b, mask is not None)
        row = dict(site=site, B=b, L=l, S=s, E=e, H=h, mask=kind, per_keystep=per_keystep,
                   max_abs_err=err, max_rel_err=rel, ms=ms, eager_ms=kernel_eager_ms,
                   plain_ms=plain_ms, library_ms=library_ms, bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   ops_ms=t_ops, bytes_ms=t_bytes,
                   **fwd_tc_bound(l, s, e, h, b, mask is not None, sm_mhz),
                   **plan_row(fwd_plan(b, l, s, h, d)))
        rows.append(row)
        print(f"kernel {site:24s} B={b} L={l} S={s} E={e} H={h} mask={kind}: "
              f"max_abs {err:.3e} max_rel {rel:.3e}, repeat bit-identical | kernel {ms:.4f} ms "
              f"(eager call {kernel_eager_ms:.4f} ms), plain {plain_ms:.4f} ms, sdpa "
              f"{library_ms:.4f} ms, f32 bound {row['bound_ms']:.5f} ms ({row['bound_by']}), "
              f"tensor-core bound {row['tc_bound_ms']:.5f} ms ({row['tc_bound_by']}) | "
              f"{row['kernels_per_call']} device kernel(s), workspace "
              f"{row['workspace_bytes']} bytes | {card}", flush=True)
    return rows


def synthetic_observation(rng, image, ncam):
    lo, hi = np.asarray(BOUNDS, np.float32)
    rgb = rng.uniform(-1.0, 1.0, (1, ncam, 3, image, image)).astype(np.float32)
    pcd = rng.uniform(lo, hi, (1, ncam, image, image, 3)).astype(np.float32)
    pcd = np.ascontiguousarray(pcd.transpose(0, 1, 4, 2, 3))
    quat = rng.normal(size=4)
    gripper = np.concatenate([rng.uniform(lo, hi), quat / np.linalg.norm(quat), [1.0]])
    return rgb, pcd, gripper[None].astype(np.float32)


def build_actioner(act3d_cfg, planner_cfg, dev, instructions):
    torch.manual_seed(SEED)
    act3d = Act3D(**act3d_cfg, device="cpu")
    planner = DiffusionPlanner(**planner_cfg, device="cpu")
    return Actioner(act3d, planner, instructions=instructions, seed=SEED, device=dev)


def phase_small_keystep(dev):
    """Same weights and injected samples on the card and on the CPU."""
    small_a = dict(ACT3D_CFG, image_size=(64, 64), embedding_dim=24,
                   num_ghost_points_val=60, num_sampling_level=2)
    small_p = dict(PLANNER_CFG, image_size=(64, 64), embedding_dim=24,
                   num_query_cross_attn_layers=3, diffusion_timesteps=5)
    rng = np.random.default_rng(SEED)
    instructions = {"synthetic": {0: [rng.normal(size=(N_INSTR, 512)).astype(np.float32)]}}
    rgb, pcd, gripper = synthetic_observation(rng, 64, 2)
    lo, hi = np.asarray(BOUNDS, np.float32)
    ghosts = [rng.uniform(lo, hi, (1, 30, 3)).astype(np.float32) for _ in range(2)]
    noise = (rng.normal(size=(1, 8, 9)).astype(np.float32),
             rng.normal(size=(5, 1, 8, 9)).astype(np.float32))
    mask = np.zeros((1, 8), bool)
    outs = []
    for device in ("cpu", dev):
        actioner = build_actioner(small_a, small_p, device, instructions)
        actioner.load_episode("synthetic", 0)
        outs.append(actioner.predict(
            rgb, pcd, gripper, trajectory_mask=mask,
            ghost_points_override=[torch.as_tensor(g, device=device) for g in ghosts],
            noise=tuple(torch.as_tensor(n, device=device) for n in noise),
        ))
    for key in ("action", "trajectory"):
        err = np.abs(outs[0][key] - outs[1][key]).max()
        print(f"small keystep {key}: card vs CPU max_abs {err:.3e}", flush=True)
        np.testing.assert_allclose(outs[1][key], outs[0][key], atol=2e-3, rtol=1e-3)


def train_mask(kind, b, s, dev):
    if kind is None:
        return None
    mask = torch.zeros(b, s, dtype=torch.bool, device=dev)
    if kind == "padded":
        mask[:, s - 10:] = True
    if kind == "full":
        mask[1] = True  # batch row 1 has every key masked
    return mask


def phase_train_kernels(dev, card, shapes, e, h, seed_base, sm_mhz):
    """Both kernels at one training step's shapes (B = 16, width e, h
    heads), with the step's dropout, against their plain versions; device
    times beside the bound, plain and SDPA."""
    gen = torch.Generator(device=dev).manual_seed(seed_base)
    side = torch.cuda.Stream()
    b = TRAIN_B
    d = e // h
    fwd_rows, bwd_rows = [], []
    for i, (site, l, s, kind, rate, per_step) in enumerate(shapes):
        mask = train_mask(kind, b, s, dev)
        seed = seed_base * 1000 + i if rate else None
        q = torch.randn(b, l, e, generator=gen, device=dev) * d ** -0.5
        k, v, g = (torch.randn(b, n, e, generator=gen, device=dev) for n in (s, s, l))
        out, stats = fused_mha_forward(q, k, v, h, mask, True, rate, seed)
        grads = fused_mha_backward(q, k, v, out, stats, g, h, mask, rate, seed)
        torch.cuda.synchronize()
        ref_out, ref_stats = fused_mha_forward_reference(q, k, v, h, mask, rate, seed)
        ref_grads = fused_mha_backward_reference(q, k, v, out, stats, g, h, mask, rate, seed)
        fwd_err = _max_errs([(out, ref_out), (stats, ref_stats)])
        bwd_err = _max_errs(zip(grads, ref_grads))
        keep = (dropout_keep(seed, b, h, l, s, rate, dev).float().mean().item()
                if rate else 1.0)
        print(f"train kernel {site:28s} B={b} L={l} S={s} rate={rate} mask={kind}: fwd "
              f"max_abs {fwd_err[0]:.3e} max_rel {fwd_err[1]:.3e} | bwd max_abs "
              f"{bwd_err[0]:.3e} max_rel {bwd_err[1]:.3e} | keep {keep:.5f}", flush=True)
        torch.testing.assert_close(out, ref_out, atol=ATOL, rtol=RTOL)
        torch.testing.assert_close(stats, ref_stats, atol=ATOL, rtol=RTOL)
        for got, want in zip(grads, ref_grads):
            torch.testing.assert_close(got, want, atol=BWD_ATOL, rtol=BWD_RTOL)
        again = fused_mha_forward(q, k, v, h, mask, True, rate, seed)
        grads_again = fused_mha_backward(q, k, v, out, stats, g, h, mask, rate, seed)
        assert all(torch.equal(a, b) for a, b in zip((out, stats, *grads),
                                                     (*again, *grads_again))), site
        assert abs(keep - (1.0 - rate)) < 0.005, keep
        if kind == "full" and not rate:
            torch.testing.assert_close(out[1], v[1].mean(dim=0).expand(l, e), atol=ATOL,
                                       rtol=RTOL)

        iters = 20 if b * l * s > 1e6 else 100
        fwd_ms = device_ms(lambda: fused_mha_forward(q, k, v, h, mask, False, rate, seed),
                           iters, side)
        fwd_plain = device_ms(lambda: fused_mha_forward_reference(q, k, v, h, mask, rate, seed),
                              iters, side)
        bwd_ms = device_ms(lambda: fused_mha_backward(q, k, v, out, stats, g, h, mask, rate,
                                                      seed), iters, side)
        bwd_plain = device_ms(lambda: fused_mha_backward_reference(
            q, k, v, out, stats, g, h, mask, rate, seed), iters, side)
        qh, kh, vh, gh = (x.reshape(b, -1, h, d).transpose(1, 2).contiguous()
                          for x in (q, k, v, g))
        qh, kh, vh = (x.requires_grad_() for x in (qh, kh, vh))
        attn_mask = None if mask is None else ~mask[:, None, None, :]

        def sdpa():
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=attn_mask, scale=1.0)

        with torch.no_grad():
            lib_fwd = device_ms(sdpa, iters, side)
        # autograd's backward is captured together with its forward (CUDA
        # graphs take whole-network captures), so SDPA's backward is the
        # forward + backward replay minus the forward's
        lib_fwd_bwd = device_ms(lambda: torch.autograd.grad(sdpa(), (qh, kh, vh), gh),
                                iters, side)
        lib_bwd = lib_fwd_bwd - lib_fwd
        common = dict(site=site, B=b, L=l, S=s, E=e, H=h, mask=kind, rate=rate,
                      per_step=per_step)
        fwd_rows.append(dict(common, max_abs_err=fwd_err[0], max_rel_err=fwd_err[1],
                             keep_fraction=keep, ms=fwd_ms, plain_ms=fwd_plain,
                             library_ms=lib_fwd, **_bound_row(*bound(l, s, e, h, b, kind)),
                             **fwd_tc_bound(l, s, e, h, b, kind, sm_mhz),
                             **plan_row(fwd_plan(b, l, s, h, d))))
        bwd_rows.append(dict(common, max_abs_err=bwd_err[0], max_rel_err=bwd_err[1],
                             ms=bwd_ms, plain_ms=bwd_plain, library_ms=lib_bwd,
                             library_fwd_bwd_ms=lib_fwd_bwd,
                             **_bound_row(*bound_bwd(l, s, e, h, b, kind)),
                             **bwd_tc_bound(l, s, e, h, b, kind, sm_mhz),
                             **plan_row(bwd_plan(b, l, s, h, d))))
        fr, br = fwd_rows[-1], bwd_rows[-1]
        print(f"train kernel {site:28s} fwd {fwd_ms:.4f} ms (plain {fwd_plain:.4f}, sdpa "
              f"{lib_fwd:.4f}, f32 bound {fr['bound_ms']:.5f} {fr['bound_by']}, tensor-core "
              f"bound {fr['tc_bound_ms']:.5f} {fr['tc_bound_by']}; {fr['kernels_per_call']} "
              f"device kernel(s), workspace {fr['workspace_bytes']} bytes) | bwd {bwd_ms:.4f} "
              f"ms (plain {bwd_plain:.4f}, sdpa {lib_bwd:.4f}, f32 bound {br['bound_ms']:.5f} "
              f"{br['bound_by']}, tensor-core bound {br['tc_bound_ms']:.5f} "
              f"{br['tc_bound_by']}; {br['kernels_per_call']} device kernel(s), workspace "
              f"{br['workspace_bytes']} bytes) | {card}", flush=True)
    return fwd_rows, bwd_rows


def gather_indices(layout, gen, dev, b, k, p):
    """(B, K) int64 unique ascending indices into P rows."""
    if layout == "topk_nearest":  # what Act3D's fine levels sort and gather
        lo, hi = torch.tensor(BOUNDS, device=dev)
        cloud = lo + torch.rand(b, p, 3, generator=gen, device=dev) * (hi - lo)
        anchor = lo + torch.rand(b, 3, generator=gen, device=dev) * (hi - lo)
        idx = topk_nearest_context(anchor, cloud, k)
    elif layout == "uniform":
        idx = torch.stack([torch.randperm(p, generator=gen, device=dev)[:k] for _ in range(b)])
    elif layout == "edges":  # the first and last possible positions
        idx = torch.cat([torch.arange(k // 2, device=dev),
                         p - k + k // 2 + torch.arange(k - k // 2, device=dev)]).expand(b, k)
    else:
        raise ValueError(layout)
    return torch.sort(idx, dim=-1).values.contiguous()


def bound_gather(b, k, p, c):
    """Bytes the adjoint must move: the (B, P, C) output written once, g and
    the int64 indices read once; no arithmetic."""
    nbytes = 4.0 * b * p * c + 4.0 * b * k * c + 8.0 * b * k
    return 0.0, nbytes / PEAK_BYTES * 1e3


def phase_gather_kernels(dev, card):
    """Both row-scatter kernels against their plain version (exact match)
    at the Act3D fine-level shape for three index layouts and at C = 3;
    device times of the kernels, the plain version and a zero-filled
    scatter_ at the real layout."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    side = torch.cuda.Stream()
    b, k, p = GATHER_B, GATHER_K, GATHER_P
    rows = {"scatter_rows_sorted": [], "scatter_rows": []}
    for layout, c in (("topk_nearest", GATHER_C), ("uniform", GATHER_C), ("edges", GATHER_C),
                      ("topk_nearest", 3)):
        idx = gather_indices(layout, gen, dev, b, k, p)
        g = torch.randn(b, k, c, generator=gen, device=dev)
        perm = torch.randperm(k, generator=gen, device=dev)
        g_any, idx_any = g[:, perm].contiguous(), idx[:, perm].contiguous()
        want = scatter_rows_reference(g, idx, p)
        got_sorted = scatter_rows_sorted(g, idx, p)
        got_any = scatter_rows(g_any, idx_any, p)
        torch.cuda.synchronize()
        for name, got in (("scatter_rows_sorted", got_sorted), ("scatter_rows", got_any)):
            err = (got - want).abs().max().item()
            print(f"gather kernel {name:20s} {layout:12s} B={b} K={k} P={p} C={c}: "
                  f"exact {torch.equal(got, want)} (max_abs {err:.1e})", flush=True)
            assert torch.equal(got, want), (name, layout, c)
        if layout != "topk_nearest" or c != GATHER_C:
            continue
        # the Act3D layout: time both kernels beside the plain version and
        # the library scatter (timing yardstick only, never called by the port)
        plain_ms = device_ms(lambda: scatter_rows_reference(g, idx, p), 20, side)
        library_ms = device_ms(lambda: g.new_zeros(b, p, c).scatter_(
            1, idx[..., None].expand(-1, -1, c), g), 20, side)
        bounds = _bound_row(*bound_gather(b, k, p, c))
        for name, fn in (("scatter_rows_sorted", lambda: scatter_rows_sorted(g, idx, p)),
                         ("scatter_rows", lambda: scatter_rows(g_any, idx_any, p))):
            ms = device_ms(fn, 20, side)
            rows[name].append(dict(site=f"act3d.fine_gather.{layout}", B=b, K=k, P=p, C=c,
                                   per_step=2 if name == "scatter_rows_sorted" else 0,
                                   max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                                   library_ms=library_ms, **bounds))
            print(f"gather kernel {name:20s} {layout:12s} {ms:.4f} ms per call (plain "
                  f"{plain_ms:.4f}, scatter_ {library_ms:.4f}, bound {bounds['bound_ms']:.5f} "
                  f"bytes) | {card}", flush=True)
    return rows


def attention_core_sites():
    """(site, BH, L, S, mask kind, launches per training step) of the
    single-head-layout core: every attention site of the two training steps
    flattened to (B*H, L, d = 15), plus the padded and fully masked checks.
    The kernel has no model path (as in JAX); the per-step counts are those
    of the fused kernel it would stand in for."""
    sites = [(f"core.{site.split('.', 1)[1]}", TRAIN_B * ACT3D_CFG["num_attn_heads"], l, s,
              kind, per_step) for site, l, s, kind, _, per_step in KEYPOSE_SHAPES]
    sites += [(f"core.{site.split('.', 1)[1]}", TRAIN_B * 8, l, s, kind, per_step)
              for site, l, s, kind, rate, per_step in TRAIN_SHAPES if rate or kind]
    return sites


def phase_attention_core(dev, card, sm_mhz):
    """attention_core (the fused forward kernel at H = 1, no stats) against
    attention_core_reference at every flattened training site (atol 2e-5 /
    rtol 1e-4, a repeat bit-identical), its gradient through AttentionCore
    on the card against the CPU at a small size, and device times beside
    both bounds (bound_core, core_tc_bound), the plain version and SDPA
    (timing yardstick only), with the launch plan (fwd_plan at one head)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    side = torch.cuda.Stream()
    d = ACT3D_CFG["embedding_dim"] // ACT3D_CFG["num_attn_heads"]
    rows = []
    for site, bh, l, s, kind, per_step in attention_core_sites():
        b_mask = train_mask(kind, TRAIN_B, s, dev)
        heads = bh // TRAIN_B
        mask = None if b_mask is None else b_mask.repeat_interleave(heads, dim=0).contiguous()
        q = torch.randn(bh, l, d, generator=gen, device=dev) * d ** -0.5
        k, v = (torch.randn(bh, s, d, generator=gen, device=dev) for _ in range(2))
        before = attention_core.launches, fused_mha_forward.launches
        out = attention_core_forward(q, k, v, mask)
        torch.cuda.synchronize()
        assert (attention_core.launches, fused_mha_forward.launches) == (
            before[0] + 1, before[1]), site
        ref = attention_core_reference(q, k, v, mask)
        err = _max_errs([(out, ref)])
        torch.testing.assert_close(out, ref, atol=ATOL, rtol=RTOL)
        assert torch.equal(out, attention_core_forward(q, k, v, mask)), site
        if kind == "full":  # rows 1*heads .. 2*heads-1 of batch row 1: uniform weights
            torch.testing.assert_close(out[heads], v[heads].mean(dim=0).expand(l, d),
                                       atol=ATOL, rtol=RTOL)
        iters = 20 if bh * l * s > 1e6 else 100
        ms = device_ms(lambda: attention_core_forward(q, k, v, mask), iters, side)
        plain_ms = device_ms(lambda: attention_core_reference(q, k, v, mask), iters, side)
        attn_mask = None if mask is None else ~mask[:, None, None, :]
        library_ms = device_ms(lambda: F.scaled_dot_product_attention(
            q[:, None], k[:, None], v[:, None], attn_mask=attn_mask, scale=1.0), iters, side)
        row = dict(site=site, BH=bh, L=l, S=s, D=d, mask=kind, per_step=per_step,
                   max_abs_err=err[0], max_rel_err=err[1], ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, **_bound_row(*bound_core(l, s, d, bh, kind)),
                   **core_tc_bound(l, s, d, bh, kind, sm_mhz),
                   **plan_row(fwd_plan(bh, l, s, 1, d)))
        rows.append(row)
        print(f"attention_core {site:24s} BH={bh} L={l} S={s} D={d} mask={kind}: max_abs "
              f"{err[0]:.3e} max_rel {err[1]:.3e}, repeat bit-identical | kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, f32 bound "
              f"{row['bound_ms']:.5f} ms ({row['bound_by']}), tensor-core bound "
              f"{row['tc_bound_ms']:.5f} ms ({row['tc_bound_by']}) | "
              f"{row['kernels_per_call']} device kernel(s), workspace "
              f"{row['workspace_bytes']} bytes | {card}", flush=True)
    live = [r for r in rows if r["per_step"]]
    print(f"attention_core per step pair: {sum(r['per_step'] for r in live)} wrapper calls, "
          f"{sum(r['per_step'] * r['kernels_per_call'] for r in live)} device kernels; "
          f"{sum(r['per_step'] * r['ms'] for r in live):.4f} ms, tensor-core bound "
          f"{sum(r['per_step'] * r['tc_bound_ms'] for r in live):.4f} ms, f32 bound "
          f"{sum(r['per_step'] * r['bound_ms'] for r in live):.4f} ms; largest workspace "
          f"{max(r['workspace_bytes'] for r in live)} bytes | {card}", flush=True)

    # gradient through AttentionCore on the card against the CPU
    small = [torch.randn(3, n, d, generator=gen, device=dev) * scale
             for n, scale in ((24, 0.3), (40, 0.3), (40, 1.0))]
    mask = torch.zeros(3, 40, dtype=torch.bool, device=dev)
    mask[0, -7:] = True
    mask[1] = True
    g = torch.randn(3, 24, d, generator=gen, device=dev)
    grads = []
    for device in (dev, "cpu"):
        leaves = [x.detach().to(device).requires_grad_() for x in small]
        attention_core(*leaves, mask.to(device)).backward(g.to(device))
        grads.append([x.grad.cpu() for x in leaves])
    err = _max_errs(zip(*grads))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=BWD_ATOL, rtol=BWD_RTOL)
    print(f"attention_core gradient (BH=3, L=24, S=40, a padded and a fully masked row): "
          f"card vs CPU max_abs {err[0]:.3e} max_rel {err[1]:.3e}", flush=True)
    return rows


def phase_chunked(dev, card):
    """scatter_rows_chunked against its plain version, bit for bit, at the
    Act3D fine-level shape for three index layouts and at a K that is not a
    multiple of 128 with a P that needs padding, at several p_tile and
    n_chunks; device times at JAX's defaults and at a chunk count that gave
    two blocks per SM on JAX's grid, beside scatter_rows_sorted, the plain
    version and a zero-filled scatter_."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    side = torch.cuda.Stream()
    b, k, p, c = GATHER_B, GATHER_K, GATHER_P, GATHER_C
    filled = -(-2 * 132 // b)  # chunks per batch row for >= 2 blocks per SM on JAX's grid
    cases = [("topk_nearest", k, p), ("uniform", k, p), ("edges", k, p),
             ("uniform", 3000, 49000)]
    tilings = [CHUNKED_DEFAULTS, (CHUNKED_DEFAULTS[0], filled)]
    row = None
    for layout, kk, pp in cases:
        idx = gather_indices(layout, gen, dev, b, kk, pp)
        g = torch.randn(b, kk, c, generator=gen, device=dev)
        want = scatter_rows_reference(g, idx, pp)
        extra = [(1, 3), (100, 5), (57344, 1)] if layout == "topk_nearest" else []
        for p_tile, n_chunks in tilings + extra:
            got = scatter_rows_chunked(g, idx, pp, p_tile, n_chunks)
            torch.cuda.synchronize()
            exact = torch.equal(got, want)
            print(f"chunked kernel {layout:12s} B={b} K={kk} P={pp} C={c} p_tile={p_tile} "
                  f"n_chunks={n_chunks}: exact {exact}", flush=True)
            assert exact, (layout, kk, pp, p_tile, n_chunks)
        got = scatter_rows_chunked(g, idx, pp, *CHUNKED_DEFAULTS)
        assert torch.equal(got, want) and torch.equal(
            got, scatter_rows_chunked(g, idx, pp, *CHUNKED_DEFAULTS)), layout
        if layout != "topk_nearest":
            continue
        ms = device_ms(lambda: scatter_rows_chunked(g, idx, p, *CHUNKED_DEFAULTS), 20, side)
        filled_ms = device_ms(lambda: scatter_rows_chunked(g, idx, p, CHUNKED_DEFAULTS[0],
                                                           filled), 20, side)
        sorted_ms = device_ms(lambda: scatter_rows_sorted(g, idx, p), 20, side)
        plain_ms = device_ms(lambda: scatter_rows_reference(g, idx, p), 20, side)
        library_ms = device_ms(lambda: g.new_zeros(b, p, c).scatter_(
            1, idx[..., None].expand(-1, -1, c), g), 20, side)
        grid = gather_kernels.launch_shape(b, p)
        blocks = grid["x"] * grid["y"]
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        row = dict(site=f"act3d.fine_gather.{layout}", B=b, K=k, P=p, C=c,
                   p_tile=CHUNKED_DEFAULTS[0], n_chunks=CHUNKED_DEFAULTS[1], max_abs_err=0.0,
                   ms=ms, n_chunks_filled=filled, ms_filled=filled_ms,
                   scatter_rows_sorted_ms=sorted_ms, plain_ms=plain_ms, library_ms=library_ms,
                   grid=dict(grid, blocks=blocks, blocks_per_sm=blocks / sms),
                   **_bound_row(*bound_gather(b, k, p, c)))
        print(f"chunked kernel {layout:12s} {ms:.4f} ms at n_chunks={CHUNKED_DEFAULTS[1]}, "
              f"{filled_ms:.4f} ms at n_chunks={filled} (grid {grid['x']} x {grid['y']} = "
              f"{blocks} blocks of {grid['threads']} threads, {grid['rows_per_block']} rows "
              f"each, either way); scatter_rows_sorted {sorted_ms:.4f}, plain {plain_ms:.4f}, "
              f"scatter_ {library_ms:.4f}, bound {row['bound_ms']:.5f} ms (bytes) | {card}",
              flush=True)
    return row


def phase_small_train(dev):
    """Loss and gradients of a small model on the card against the CPU
    (same weights, injected noise and timesteps, dropout off), then a
    dropout-on step run twice on the card."""
    cfg = dict(image_size=(64, 64), embedding_dim=24, num_query_cross_attn_layers=3)
    batch = synthetic_trajectory_batch(2, 2, (64, 64), 8, seed=SEED)
    batch["trajectory_mask"][1, -3:] = True
    rng = np.random.default_rng(SEED)
    noise = torch.from_numpy(rng.normal(size=(2, 8, 9)).astype(np.float32))
    timesteps = torch.tensor([3, 71])
    torch.manual_seed(SEED)
    cpu_model = make_diffusion_model(**cfg, device="cpu")
    card_model = make_diffusion_model(**cfg, device=dev)
    card_model.load_state_dict(cpu_model.state_dict())

    def run(model, device, **kw):
        model.zero_grad(set_to_none=True)
        loss = model(*(batch[k].to(device) for k in SMALL_KEYS), **kw)
        loss.backward()
        return loss.item(), {n: p.grad.detach().cpu() for n, p in model.named_parameters()
                             if p.grad is not None and "backbone" not in n}

    (cpu_loss, cpu_grads), (card_loss, card_grads) = (
        run(m.eval(), device, noise=noise.to(device), timesteps=timesteps.to(device))
        for m, device in ((cpu_model, "cpu"), (card_model, dev)))
    assert cpu_grads.keys() == card_grads.keys() and len(cpu_grads) > 100
    err = _max_errs((card_grads[n], cpu_grads[n]) for n in cpu_grads)
    print(f"small train step: loss card {card_loss:.6f} cpu {cpu_loss:.6f}; "
          f"{len(cpu_grads)} gradients, card vs CPU max_abs {err[0]:.3e} max_rel "
          f"{err[1]:.3e}", flush=True)
    assert abs(card_loss - cpu_loss) <= 1e-4 * abs(cpu_loss), (card_loss, cpu_loss)
    # float32 sums in another order through the whole model (the
    # full-model bound of tests/README.md)
    for n in cpu_grads:
        torch.testing.assert_close(card_grads[n], cpu_grads[n], atol=1e-4, rtol=1e-3, msg=n)

    torch.backends.cudnn.deterministic = True  # conv weight gradients
    runs = [run(card_model.train(), dev, generator=Generators.from_seed(7, dev))
            for _ in range(2)]
    torch.backends.cudnn.deterministic = False
    assert runs[0][0] == runs[1][0], (runs[0][0], runs[1][0])
    for n, grad in runs[0][1].items():
        assert torch.equal(grad, runs[1][1][n]), n
    print(f"small train step, dropout on (seed 7), twice: loss {runs[0][0]:.6f}, "
          f"{len(runs[0][1])} gradients bit-identical", flush=True)


def phase_small_keypose(dev):
    """Loss and gradients of a small Act3D on the card against the CPU:
    same weights, injected ghost points spread over the workspace (so every
    level's argmax has a wide margin), gt sampling on; then the card step
    twice, with bit-identical gradients."""
    cfg = dict(image_size=(128, 128), embedding_dim=24, num_ghost_points=40,
               num_sampling_level=2)
    batch = synthetic_keypose_batch(2, 1, (128, 128), seed=SEED)
    rng = np.random.default_rng(SEED)
    lo, hi = np.asarray(BOUNDS, np.float32)
    ghosts = [torch.from_numpy(rng.uniform(lo, hi, (2, 20, 3)).astype(np.float32))
              for _ in range(2)]
    criterion = KeyposeLossAndMetrics()
    torch.manual_seed(SEED)
    cpu_model = make_keypose_model(**cfg, device="cpu")
    card_model = make_keypose_model(**cfg, device=dev)
    card_model.load_state_dict(cpu_model.state_dict())

    def run(model, device):
        model.zero_grad(set_to_none=True)
        pred = model(*(batch[k].to(device) for k in KEYPOSE_KEYS),
                     gt_action=batch["action"].to(device),
                     ghost_points_override=[g.to(device) for g in ghosts])
        loss = sum(criterion.compute_loss(pred, batch["action"].to(device)).values())
        loss.backward()
        return pred, loss.item(), {n: p.grad.detach().cpu() for n, p in model.named_parameters()
                                   if p.grad is not None and "backbone" not in n}

    cpu_pred, cpu_loss, cpu_grads = run(cpu_model.train(), "cpu")
    for masks in cpu_pred["ghost_pcd_masks_pyramid"]:
        top2 = torch.topk(masks[-1].detach(), 2, dim=-1).values
        assert (top2[:, 0] - top2[:, 1]).min() > 1e-3, top2
    before = scatter_rows_sorted.launches
    card_pred, card_loss, card_grads = run(card_model.train(), dev)
    assert scatter_rows_sorted.launches == before + 1, scatter_rows_sorted.launches
    for got, want in zip(card_pred["position_pyramid"], cpu_pred["position_pyramid"]):
        assert torch.equal(got.cpu(), want), (got, want)  # no argmax flip
    assert cpu_grads.keys() == card_grads.keys() and len(cpu_grads) > 50
    err = _max_errs((card_grads[n], cpu_grads[n]) for n in cpu_grads)
    print(f"small keypose step: loss card {card_loss:.6f} cpu {cpu_loss:.6f}; "
          f"{len(cpu_grads)} gradients, card vs CPU max_abs {err[0]:.3e} max_rel "
          f"{err[1]:.3e}", flush=True)
    assert abs(card_loss - cpu_loss) <= 1e-4 * abs(cpu_loss), (card_loss, cpu_loss)
    for n in cpu_grads:
        torch.testing.assert_close(card_grads[n], cpu_grads[n], atol=1e-4, rtol=1e-3, msg=n)

    torch.backends.cudnn.deterministic = True  # conv weight gradients
    runs = [run(card_model, dev)[1:] for _ in range(2)]
    torch.backends.cudnn.deterministic = False
    assert runs[0][0] == runs[1][0], (runs[0][0], runs[1][0])
    for n, grad in runs[0][1].items():
        assert torch.equal(grad, runs[1][1][n]), n
    print(f"small keypose step on the card, twice: loss {runs[0][0]:.6f}, "
          f"{len(runs[0][1])} gradients bit-identical", flush=True)


def bf16_bound(flops, nbytes):
    """The bf16 bound: operations at the dense bf16 tensor-core peak, bytes
    at 3.35 TB/s."""
    return _bound_row(flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3)


def bf16_mha_work(l, s, e, h, b, masked, backward):
    """FLOPs and bytes of one bf16 forward or backward call: the (B, L, E)
    and (B, S, E) tensors in 2 bytes, the stats in 4; each read or written
    once (forward: q, k, v, out, stats; backward: q, out, dO, k, v, stats
    read, dq, dk, dv written)."""
    flops = (10.0 if backward else 4.0) * b * l * s * e
    per = 4 if backward else 2
    nbytes = (2.0 * (per * b * l * e + per * b * s * e) + 4.0 * 2 * b * l * h
              + (b * s if masked else 0))
    return flops, nbytes


def _bf16_row(errs, **extra):
    """A bf16 kernel row: the error of the kernel against its bf16 plain
    version (max_abs_err) and of both against the float32 plain version."""
    return dict(max_abs_err=errs["max_abs_err"], kernel_vs_f32=errs["kernel_vs_f32"],
                plain_vs_f32=errs["plain_vs_f32"], err_bound=errs["bound"], **extra)


def phase_kernels_bf16(dev, card):
    """The bf16 entries of every kernel at every shape the bf16 training
    steps launch, against their bf16 plain versions (which round where the
    TPU kernels round) and the float32 plain version on the same
    bf16-rounded inputs: each result within bf16_errors' bound (the
    gradients' with the float32-noise floor), the stats at atol 2e-5 / rtol
    1e-4, repeats bit-identical, the row scatters bit-exact; the dropout
    zero pattern equal to the float32 kernel's for one seed; device times
    of each kernel, its bf16 plain version and one PyTorch call in bf16
    (SDPA, scatter_) beside the bf16 bound."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    side = torch.cuda.Stream()
    bf = torch.bfloat16
    rows = {f"{name}_bf16": [] for name in _WRAPPERS}
    sites = ([(site, l, s_, kind, rate, n, PLANNER_CFG["embedding_dim"], 8)
              for site, l, s_, kind, rate, n in TRAIN_SHAPES]
             + [(site, l, s_, kind, rate, n, ACT3D_CFG["embedding_dim"],
                 ACT3D_CFG["num_attn_heads"]) for site, l, s_, kind, rate, n in KEYPOSE_SHAPES])
    b = TRAIN_B
    for i, (site, l, s, kind, rate, per_step, e, h) in enumerate(sites):
        d = e // h
        mask = train_mask(kind, b, s, dev)
        seed = 7000 + i if rate else None
        q = (torch.randn(b, l, e, generator=gen, device=dev) * d ** -0.5).to(bf)
        k, v, g = (torch.randn(b, n, e, generator=gen, device=dev).to(bf) for n in (s, s, l))
        f32 = [x.float() for x in (q, k, v, g)]
        out, stats = fused_mha_forward(q, k, v, h, mask, True, rate, seed)
        grads = fused_mha_backward(q, k, v, out, stats, g, h, mask, rate, seed)
        again = (*fused_mha_forward(q, k, v, h, mask, True, rate, seed),
                 *fused_mha_backward(q, k, v, out, stats, g, h, mask, rate, seed))
        torch.cuda.synchronize()
        assert all(torch.equal(a, c) for a, c in zip((out, stats, *grads), again)), site
        plain_out, plain_stats = fused_mha_forward_reference(q, k, v, h, mask, rate, seed)
        ref_out, _ = fused_mha_forward_reference(*f32[:3], h, mask, rate, seed)
        fwd = bf16_errors(out, plain_out, ref_out)
        torch.testing.assert_close(stats, plain_stats, atol=ATOL, rtol=RTOL)
        plain_g = fused_mha_backward_reference(q, k, v, out, stats, g, h, mask, rate, seed)
        ref_g = fused_mha_backward_reference(*f32[:3], out.float(), stats, f32[3], h, mask,
                                             rate, seed)
        bwd = [bf16_errors(*t, BWD_FLOOR) for t in zip(grads, plain_g, ref_g)]
        print(f"kernels_bf16 {site:28s} B={b} L={l} S={s} E={e} H={h} rate={rate} "
              f"mask={kind}: fwd vs plain bf16 {fwd['max_abs_err']:.3e}, vs float32 kernel "
              f"{fwd['kernel_vs_f32']:.3e} plain {fwd['plain_vs_f32']:.3e} (bound "
              f"{fwd['bound']:.3e}) | bwd dq/dk/dv vs plain bf16 "
              + "/".join(f"{x['max_abs_err']:.3e}" for x in bwd) + ", vs float32 kernel "
              + "/".join(f"{x['kernel_vs_f32']:.3e}" for x in bwd) + " plain "
              + "/".join(f"{x['plain_vs_f32']:.3e}" for x in bwd) + " (bound "
              + "/".join(f"{x['bound']:.3e}" for x in bwd) + "); repeats bit-identical",
              flush=True)
        assert fwd["ok"] and all(x["ok"] for x in bwd), (site, fwd, bwd)

        iters = 20 if b * l * s > 1e6 else 100
        fwd_ms = device_ms(lambda: fused_mha_forward(q, k, v, h, mask, False, rate, seed),
                           iters, side)
        bwd_ms = device_ms(lambda: fused_mha_backward(q, k, v, out, stats, g, h, mask, rate,
                                                      seed), iters, side)
        fwd_plain = device_ms(lambda: fused_mha_forward_reference(q, k, v, h, mask, rate, seed),
                              iters, side)
        bwd_plain = device_ms(lambda: fused_mha_backward_reference(
            q, k, v, out, stats, g, h, mask, rate, seed), iters, side)
        qh, kh, vh, gh = (x.reshape(b, -1, h, d).transpose(1, 2).contiguous()
                          for x in (q, k, v, g))
        qh, kh, vh = (x.requires_grad_() for x in (qh, kh, vh))
        attn_mask = None if mask is None else ~mask[:, None, None, :]

        def sdpa():
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=attn_mask, scale=1.0)

        with torch.no_grad():
            lib_fwd = device_ms(sdpa, iters, side)
        lib_bwd = device_ms(lambda: torch.autograd.grad(sdpa(), (qh, kh, vh), gh), iters,
                            side) - lib_fwd
        common = dict(site=site, B=b, L=l, S=s, E=e, H=h, mask=kind, rate=rate,
                      per_step=per_step)
        rows["fused_mha_fwd_bf16"].append(_bf16_row(
            fwd, **common, ms=fwd_ms, plain_ms=fwd_plain, library_ms=lib_fwd,
            **bf16_bound(*bf16_mha_work(l, s, e, h, b, kind, False)),
            **plan_row(fwd_plan(b, l, s, h, d))))
        worst = max(bwd, key=lambda x: x["kernel_vs_f32"] - x["bound"])
        rows["fused_mha_bwd_bf16"].append(_bf16_row(
            worst, **common, ms=bwd_ms, plain_ms=bwd_plain, library_ms=lib_bwd,
            **bf16_bound(*bf16_mha_work(l, s, e, h, b, kind, True)),
            **plan_row(bwd_plan(b, l, s, h, d))))
        fr, br = rows["fused_mha_fwd_bf16"][-1], rows["fused_mha_bwd_bf16"][-1]
        print(f"kernels_bf16 {site:28s} fwd {fwd_ms:.4f} ms (plain bf16 {fwd_plain:.4f}, sdpa "
              f"bf16 {lib_fwd:.4f}, bf16 bound {fr['bound_ms']:.5f} {fr['bound_by']}) | bwd "
              f"{bwd_ms:.4f} ms (plain bf16 {bwd_plain:.4f}, sdpa bf16 {lib_bwd:.4f}, bf16 "
              f"bound {br['bound_ms']:.5f} {br['bound_by']}) | {card}", flush=True)

    # the dropout zero pattern: with v the identity of each head (S <= d),
    # out is the kept weights, zero where dropped
    h, d, l, s, rate = 8, PLANNER_CFG["embedding_dim"] // 8, TRAJ_LEN, 15, DROPOUT
    q = torch.randn(TRAIN_B, l, h * d, generator=gen, device=dev) * d ** -0.5
    k = torch.randn(TRAIN_B, s, h * d, generator=gen, device=dev)
    v = torch.eye(s, d, device=dev).repeat(TRAIN_B, 1, h)
    zeros = [(fused_mha_forward(q.to(dt), k.to(dt), v.to(dt), h, None, dropout_rate=rate,
                                dropout_seed=99).reshape(TRAIN_B, l, h, d)[..., :s]
              .transpose(1, 2) == 0) for dt in (torch.float32, bf)]
    keep = dropout_keep(99, TRAIN_B, h, l, s, rate, dev)
    assert torch.equal(zeros[1], zeros[0]) and torch.equal(zeros[0], ~keep)
    print(f"kernels_bf16 dropout pattern (B={TRAIN_B}, L={l}, S={s}, H={h}, rate {rate}, seed "
          f"99): the bf16 kernel drops the float32 kernel's {int(zeros[0].sum())} weights "
          f"exactly", flush=True)

    # the single-head-layout core (no model path) at every flattened site
    for site, bh, l, s, kind, per_step in attention_core_sites():
        b_mask = train_mask(kind, TRAIN_B, s, dev)
        mask = (None if b_mask is None
                else b_mask.repeat_interleave(bh // TRAIN_B, dim=0).contiguous())
        q = (torch.randn(bh, l, 15, generator=gen, device=dev) * 15 ** -0.5).to(bf)
        k, v = (torch.randn(bh, s, 15, generator=gen, device=dev).to(bf) for _ in range(2))
        out = attention_core_forward(q, k, v, mask)
        assert torch.equal(out, attention_core_forward(q, k, v, mask)), site
        errs = bf16_errors(out, attention_core_reference(q, k, v, mask),
                           attention_core_reference(q.float(), k.float(), v.float(), mask))
        assert errs["ok"], (site, errs)
        iters = 20 if bh * l * s > 1e6 else 100
        attn_mask = None if mask is None else ~mask[:, None, None, :]
        nbytes = 2.0 * (2 * bh * l * 15 + 2 * bh * s * 15) + (bh * s if mask is not None else 0)
        rows["attention_core_bf16"].append(_bf16_row(
            errs, site=site, BH=bh, L=l, S=s, D=15, mask=kind, per_step=per_step,
            ms=device_ms(lambda: attention_core_forward(q, k, v, mask), iters, side),
            plain_ms=device_ms(lambda: attention_core_reference(q, k, v, mask), iters, side),
            library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                q[:, None], k[:, None], v[:, None], attn_mask=attn_mask, scale=1.0),
                iters, side),
            **bf16_bound(4.0 * bh * l * s * 15, nbytes)))
        r = rows["attention_core_bf16"][-1]
        print(f"kernels_bf16 attention_core {site:20s} BH={bh} L={l} S={s}: vs plain bf16 "
              f"{r['max_abs_err']:.3e}, vs float32 kernel {r['kernel_vs_f32']:.3e} plain "
              f"{r['plain_vs_f32']:.3e} (bound {r['err_bound']:.3e}) | {r['ms']:.4f} ms (plain "
              f"bf16 {r['plain_ms']:.4f}, sdpa bf16 {r['library_ms']:.4f}, bf16 bound "
              f"{r['bound_ms']:.5f} {r['bound_by']}) | {card}", flush=True)

    # the row scatters at the Act3D fine level, bit-exact
    b, kk, p, c = GATHER_B, GATHER_K, GATHER_P, GATHER_C
    idx = gather_indices("topk_nearest", gen, dev, b, kk, p)
    g = torch.randn(b, kk, c, generator=gen, device=dev).to(bf)
    perm = torch.randperm(kk, generator=gen, device=dev)
    g_any, idx_any = g[:, perm].contiguous(), idx[:, perm].contiguous()
    want = scatter_rows_reference(g, idx, p)
    plain_ms = device_ms(lambda: scatter_rows_reference(g, idx, p), 20, side)
    library_ms = device_ms(lambda: g.new_zeros(b, p, c).scatter_(
        1, idx[..., None].expand(-1, -1, c), g), 20, side)
    bound = bf16_bound(0.0, 2.0 * b * p * c + 2.0 * b * kk * c + 8.0 * b * kk)
    for name, fn, per_step in (
            ("scatter_rows_sorted_bf16", lambda: scatter_rows_sorted(g, idx, p), 2),
            ("scatter_rows_bf16", lambda: scatter_rows(g_any, idx_any, p), 0),
            ("scatter_rows_chunked_bf16",
             lambda: scatter_rows_chunked(g, idx, p, *CHUNKED_DEFAULTS), 0)):
        got = fn()
        torch.cuda.synchronize()
        assert got.dtype == bf and torch.equal(got, want), name
        ms = device_ms(fn, 20, side)
        rows[name].append(dict(site="act3d.fine_gather.topk_nearest", B=b, K=kk, P=p, C=c,
                               per_step=per_step, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                               library_ms=library_ms,
                               access_bytes=gather_kernels.access_bytes(g), **bound))
        print(f"kernels_bf16 {name:26s} B={b} K={kk} P={p} C={c}: bit-exact, {ms:.4f} ms "
              f"({gather_kernels.access_bytes(g)}-byte accesses; plain bf16 {plain_ms:.4f}, "
              f"scatter_ bf16 {library_ms:.4f}, bf16 bound {bound['bound_ms']:.5f} bytes) | "
              f"{card}", flush=True)
    return rows


def phase_small_bf16(dev):
    """One small bf16 step of each model on the card against the same step
    on the CPU (plain versions; the same weights, injected draws, dropout
    off): the losses within 2e-2 relative and the whole trained gradient
    within cosine 0.99 / relative L2 5e-2, the bounds of
    tests/test_torch_bf16.py against JAX; every gradient float32."""
    criterion = KeyposeLossAndMetrics()
    rng = np.random.default_rng(SEED)
    lo, hi = np.asarray(BOUNDS, np.float32)
    traj = synthetic_trajectory_batch(2, 2, (64, 64), 8, seed=SEED)
    traj["trajectory_mask"][1, -3:] = True
    noise = torch.from_numpy(rng.normal(size=(2, 8, 9)).astype(np.float32))
    kp = synthetic_keypose_batch(2, 1, (128, 128), seed=SEED)
    ghosts = [torch.from_numpy(rng.uniform(lo, hi, (2, 20, 3)).astype(np.float32))
              for _ in range(2)]

    def diffusion(model, device):
        batch = {k: v.to(device) for k, v in traj.items()}
        return diffusion_loss(model.eval(), batch, None, torch.bfloat16,
                              noise=noise.to(device), timesteps=torch.tensor([3, 71]).to(device))

    def keypose(model, device):
        batch = {k: v.to(device) for k, v in kp.items()}
        pred = keypose_pred(model.train(), batch, None, True, torch.bfloat16,
                            ghost_points_override=[x.to(device) for x in ghosts])
        return sum(criterion.compute_loss(pred, batch["action"]).values())

    for name, make, cfg, run in (
            ("diffusion", make_diffusion_model,
             dict(image_size=(64, 64), embedding_dim=24, num_query_cross_attn_layers=3),
             diffusion),
            ("keypose", make_keypose_model,
             dict(image_size=(128, 128), embedding_dim=24, num_ghost_points=40,
                  num_sampling_level=2), keypose)):
        torch.manual_seed(SEED)
        cpu_model = make(**cfg, device="cpu")
        card_model = make(**cfg, device=dev)
        card_model.load_state_dict(cpu_model.state_dict())
        out = []
        for model, device in ((cpu_model, "cpu"), (card_model, dev)):
            loss = run(model, device)
            loss.backward()
            grads = {n: p.grad.detach().cpu().double() for n, p in model.named_parameters()
                     if p.grad is not None and "backbone" not in n}
            assert loss.dtype == torch.float32 and all(
                p.grad.dtype == torch.float32 for p in model.parameters() if p.grad is not None)
            out.append((loss.item(), grads))
        (cpu_loss, cpu_grads), (card_loss, card_grads) = out
        assert cpu_grads.keys() == card_grads.keys() and len(cpu_grads) > 50
        gc_, gg = (torch.cat([g[n].flatten() for n in cpu_grads]) for g in (cpu_grads, card_grads))
        cos = F.cosine_similarity(gg, gc_, dim=0).item()
        rel = ((gg - gc_).norm() / gc_.norm()).item()
        print(f"small bf16 {name} step: loss card {card_loss:.6f} cpu {cpu_loss:.6f}; "
              f"{len(cpu_grads)} gradients, card vs CPU cosine {cos:.5f}, relative L2 "
              f"{rel:.3e}", flush=True)
        assert abs(card_loss - cpu_loss) <= 2e-2 * abs(cpu_loss), (card_loss, cpu_loss)
        assert cos >= 0.99 and rel <= 5e-2, (cos, rel)


def check_master_state(model, optimizer, loss_fn, batch, generators) -> int:
    """Mixed precision keeps its master state in float32: the parameters,
    AdamW's moments, and the gradients of one more backward (taken here,
    not stepped).  Returns the number of gradients checked."""
    assert all(p.dtype == torch.float32 for p in model.parameters())
    state = optimizer.state_dict()["state"]
    assert state and all(v.dtype == torch.float32 for st in state.values()
                         for v in st.values() if torch.is_tensor(v) and v.is_floating_point())
    model.train()
    loss, _ = loss_fn(batch, generators)
    assert loss.dtype == torch.float32, loss.dtype
    loss.backward()
    grads = [p.grad for p in model.parameters() if p.requires_grad and p.grad is not None]
    assert len(grads) > 50 and all(g.dtype == torch.float32 for g in grads)
    model.zero_grad(set_to_none=True)
    return len(grads)


def _counter(compute_dtype) -> str:
    """The launch counter of the kernel entries a step in compute_dtype uses."""
    return "launches" if compute_dtype is None else "launches_bf16"


def check_trained(model, before):
    """The backbone bit-identical; every other tensor changed but the
    biases of FPN levels the model does not read (zero gradient, no decay).
    Returns the number changed."""
    changed, unchanged = 0, []
    for n, p in model.named_parameters():
        if "backbone" in n:
            assert torch.equal(p, before[n]), n
        elif torch.equal(p, before[n]):
            unchanged.append(n)
        else:
            changed += 1
    assert changed and all("feature_pyramid" in n and n.endswith("bias")
                           for n in unchanged), unchanged
    return changed


def phase_train(dev, card, compute_dtype=None):
    """Trainer steps of the flagship ChainedDiffuser at batch 16, in float32
    or, with compute_dtype bf16, as --mixed_precision 1 trains (the bf16
    kernel entries, float32 master state)."""
    tag = "train" if compute_dtype is None else "train_bf16"
    attr = _counter(compute_dtype)
    torch.manual_seed(SEED)
    model = make_diffusion_model(device=dev)
    batch = synthetic_trajectory_batch(TRAIN_B, NCAM, (256, 256), TRAJ_LEN, seed=SEED,
                                       device=dev)
    loss_fn = diffusion_loss_fn(model, compute_dtype)
    trainer = Trainer(loss_fn, model, lr=1e-4, weight_decay=5e-4, seed=SEED)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    per_step = planner_sites_per_denoise()
    assert per_step == sum(r[-1] for r in TRAIN_SHAPES) == 19, per_step
    counters = (fused_mha_forward, fused_mha_backward)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    steps = []
    for i in range(TRAIN_STEPS):
        start = [getattr(fn, attr) for fn in counters]
        t0 = time.perf_counter()
        loss = trainer.step(batch)["loss"].item()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = tuple(getattr(fn, attr) - n for fn, n in zip(counters, start))
        assert np.isfinite(loss), loss
        assert launched == (per_step, per_step), launched
        steps.append(dict(step=i, seconds=seconds, loss=loss, fwd_launches=launched[0],
                          bwd_launches=launched[1]))
        print(f"{tag} step {i}: {seconds * 1e3:.1f} ms, loss {loss:.4f}, {launched[0]} "
              f"fused_mha_fwd + {launched[1]} fused_mha_bwd launches ({attr}) | {card}",
              flush=True)
    launches = tuple(getattr(fn, attr) for fn in counters)
    peak = torch.cuda.max_memory_allocated()
    changed = check_trained(model, before)
    grads = check_master_state(model, trainer.optimizer, loss_fn, batch, trainer.generators)
    assert all(fn.launches == fn.launches_bf16 == 0
               for fn in (scatter_rows_sorted, scatter_rows))
    warm = [s["seconds"] for s in steps[1:]]
    print(f"{tag}: warm step {np.mean(warm) * 1e3:.1f} ms (mean of steps 1-{TRAIN_STEPS - 1}; "
          f"min {min(warm) * 1e3:.1f}, max {max(warm) * 1e3:.1f}); peak memory "
          f"{peak / 2**20:.1f} MiB, resident before the first step {resident / 2**20:.1f} MiB; "
          f"{changed} trainable tensors changed, backbone unchanged; params, AdamW moments "
          f"and {grads} gradients float32 | {card}", flush=True)
    return launches, steps, dict(peak_memory_bytes=peak, resident_memory_bytes=resident)


def phase_train_act3d(dev, card, compute_dtype=None):
    """Trainer steps of the flagship Act3D keypose model at batch 16 (in
    float32, or in bf16 as phase_train), then one evaluation at 10000
    ghost points, in float32 either way."""
    tag = "train_act3d" if compute_dtype is None else "train_act3d_bf16"
    attr = _counter(compute_dtype)
    torch.manual_seed(SEED)
    model = make_keypose_model(device=dev)
    batch = synthetic_keypose_batch(TRAIN_B, NCAM, (256, 256), seed=SEED, device=dev)
    criterion = KeyposeLossAndMetrics()
    loss_fn = keypose_loss_fn(model, criterion, compute_dtype)
    trainer = Trainer(loss_fn, model, metrics_fn=keypose_metrics_fn(model, criterion),
                      lr=1e-4, weight_decay=5e-4, seed=SEED)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    per_step = KEYPOSE_LEVELS * (ACT3D_CFG["num_vis_ins_attn_layers"]
                                 + ACT3D_CFG["num_ghost_point_cross_attn_layers"]
                                 + ACT3D_CFG["num_query_cross_attn_layers"])
    assert per_step == sum(r[-1] for r in KEYPOSE_SHAPES) == 18, per_step
    gathers = KEYPOSE_LEVELS - 1  # one sorted fine-context adjoint per fine level
    counters = (fused_mha_forward, fused_mha_backward, scatter_rows_sorted, scatter_rows)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    steps = []
    for i in range(TRAIN_STEPS):
        start = [getattr(fn, attr) for fn in counters]
        t0 = time.perf_counter()
        out = trainer.step(batch)
        loss = out["loss"].item()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = tuple(getattr(fn, attr) - n for fn, n in zip(counters, start))
        assert np.isfinite(loss), loss
        assert launched == (per_step, per_step, gathers, 0), launched
        steps.append(dict(step=i, seconds=seconds, loss=loss, fwd_launches=launched[0],
                          bwd_launches=launched[1], gather_launches=launched[2]))
        parts = ", ".join(f"{k} {v.item():.4f}" for k, v in out.items() if k != "loss")
        print(f"{tag} step {i}: {seconds * 1e3:.1f} ms, loss {loss:.4f} ({parts}); "
              f"{launched[0]} fused_mha_fwd + {launched[1]} fused_mha_bwd + {launched[2]} "
              f"scatter_rows_sorted launches ({attr}) | {card}", flush=True)
    launches = tuple(getattr(fn, attr) for fn in counters)
    peak = torch.cuda.max_memory_allocated()
    changed = check_trained(model, before)
    grads = check_master_state(model, trainer.optimizer, loss_fn, batch, trainer.generators)
    warm = [st["seconds"] for st in steps[1:]]
    print(f"{tag}: warm step {np.mean(warm) * 1e3:.1f} ms (mean of steps "
          f"1-{TRAIN_STEPS - 1}; min {min(warm) * 1e3:.1f}, max {max(warm) * 1e3:.1f}); "
          f"peak memory {peak / 2**20:.1f} MiB, resident before the first step "
          f"{resident / 2**20:.1f} MiB; {changed} trainable tensors changed, backbone "
          f"unchanged; params, AdamW moments and {grads} gradients float32 | {card}",
          flush=True)

    # evaluation stays float32 (the float32 entries), as JAX's metrics_fn
    eval_batch = {k: v[:KEYPOSE_EVAL_B] for k, v in batch.items()}
    start = [fn.launches for fn in counters] + [fn.launches_bf16 for fn in counters]
    t0 = time.perf_counter()
    metrics = trainer.evaluate([eval_batch])
    seconds = time.perf_counter() - t0
    launched = tuple(n - m for n, m in zip(
        [fn.launches for fn in counters] + [fn.launches_bf16 for fn in counters], start))
    assert launched == (per_step, 0, 0, 0, 0, 0, 0, 0), launched
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    print(f"{tag} evaluate: batch {KEYPOSE_EVAL_B}, "
          f"{ACT3D_CFG['num_ghost_points_val']} ghost points, float32, {seconds * 1e3:.1f} ms; "
          + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items()), flush=True)
    return launches, steps, dict(peak_memory_bytes=peak, resident_memory_bytes=resident,
                                 eval_seconds=seconds, eval_metrics=metrics)


@contextlib.contextmanager
def recorded_steps():
    """Records, for every Trainer.step run inside the block, the step's
    number, its loss, its time to a synchronized end, the time the
    DeviceFeeder.__next__ before it took, and the launches of each kernel
    (in KERNELS order) that the step made.  The loss read and the
    synchronize are this measurement's own: the CLIs' loop syncs only at
    each evaluation."""
    records, waits = [], []
    step, feeder_next = Trainer.step, DeviceFeeder.__next__

    def timed_next(self):
        t0 = time.perf_counter()
        batch = feeder_next(self)
        waits.append(time.perf_counter() - t0)
        return batch

    def recorded(self, batch):
        start = launch_counts()
        number = self.step_count
        t0 = time.perf_counter()
        out = step(self, batch)
        loss = out["loss"].item()
        torch.cuda.synchronize()
        records.append(dict(
            step=number, loss=loss, step_s=time.perf_counter() - t0,
            data_wait_s=waits[-1] if waits else 0.0,
            launches=tuple(a - b for a, b in zip(launch_counts(), start))))
        return out

    Trainer.step, DeviceFeeder.__next__ = recorded, timed_next
    try:
        yield records
    finally:
        Trainer.step, DeviceFeeder.__next__ = step, feeder_next


def write_fixture_tree(root, n_episodes):
    """pick_and_lift episodes of 5 frames, 3 cameras at 256^2, and their
    instructions, written by the port's fixture writer."""
    make_dataset_tree(root / "data", tasks=("pick_and_lift",),
                      episodes_per_variation=n_episodes, n_frames=5, n_cam=NCAM,
                      image_size=256, seed=SEED)
    ipath = root / "instructions.pkl"
    ipath.write_bytes(pickle.dumps(make_instructions(("pick_and_lift",), seed=SEED)))
    return root / "data", ipath


def phase_cli(dev, card, name, main_fn, flags, iters, val_freq, per_step, metric):
    """One training CLI at its reference script's flags over a fixture
    tree: ``iters`` steps with an evaluation every ``val_freq``; checks
    finite losses, best.pt / last.pt, the kernel launches of every training
    step and a finite ``metric`` in every evaluation; then the same command
    line with one more step resumes from last.pt."""
    with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{name}_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        tree, ipath = write_fixture_tree(tmp, CLI_EPISODES)
        write_s = time.perf_counter() - t0
        argv = ["--dataset", str(tree), "--valset", str(tree), "--instructions", str(ipath),
                "--gripper_loc_bounds", str(CLI_BOUNDS), "--tasks", "pick_and_lift",
                "--base_log_dir", str(tmp / "logs"), "--run_log_dir", "smoke", *flags,
                "--val_freq", str(val_freq)]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with recorded_steps() as steps:
            evals = main_fn(argv + ["--train_iters", str(iters)])["evals"]
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        for st in steps:
            print(f"{name} step {st['step']}: {st['step_s'] * 1e3:.1f} ms, waited "
                  f"{st['data_wait_s'] * 1e3:.1f} ms in next(feeder), loss {st['loss']:.4f}; "
                  f"launches {nonzero(st['launches'])} | {card}", flush=True)
        assert [st["step"] for st in steps] == list(range(iters)), steps
        assert all(np.isfinite(st["loss"]) for st in steps), steps
        assert [st["launches"] for st in steps] == [per_step] * iters, steps
        assert len(evals) == iters // val_freq and all(
            np.isfinite(ev["loss"]) and np.isfinite(ev["val"][metric]) for ev in evals), evals
        log_dir = tmp / "logs" / "exp" / "smoke"
        assert (log_dir / "best.pt").exists() and (log_dir / "last.pt").exists()
        with recorded_steps() as again:
            main_fn(argv + ["--train_iters", str(iters + 1)])
        assert [st["step"] for st in again] == [iters], again
        assert again[0]["launches"] == per_step and np.isfinite(again[0]["loss"]), again
    warm = [st["step_s"] for st in steps[1:]]
    waits = [st["data_wait_s"] for st in steps]
    # before the first evaluation the feeder has no pause to fill its queue
    # in; from step iters // 2 the sampler's prefilled slots are used up
    steady = dict(before_eval=float(np.mean(waits[1:val_freq])) * 1e3,
                  second_half=float(np.mean(waits[iters // 2:])) * 1e3)
    print(f"{name}: warm step {np.mean(warm) * 1e3:.1f} ms (mean of steps 1-{iters - 1}; "
          f"min {min(warm) * 1e3:.1f}, max {max(warm) * 1e3:.1f}); feeder wait per step "
          f"mean {np.mean(waits) * 1e3:.1f} ms (steps 1-: {np.mean(waits[1:]) * 1e3:.1f} ms; "
          f"steps 1-{val_freq - 1}: {steady['before_eval']:.1f} ms; steps {iters // 2}-: "
          f"{steady['second_half']:.1f} ms), "
          f"max {max(waits) * 1e3:.1f} ms; peak memory {peak / 2**20:.1f} MiB; evaluations "
          + ", ".join(f"{ev['seconds']:.2f} s ({metric} {ev['val'][metric]:.4f})"
                      for ev in evals)
          + f"; resumed at step {iters}; whole run {seconds:.1f} s, fixture tree "
          f"{write_s:.1f} s | {card}", flush=True)
    return dict(steps=steps, evals=[dict(step=ev["step"], seconds=ev["seconds"],
                                         metric=ev["val"][metric]) for ev in evals],
                warm_step_ms=np.mean(warm) * 1e3, data_wait_ms=np.mean(waits) * 1e3,
                data_wait_steady_ms=steady,
                peak_memory_bytes=peak, seconds=seconds, launches_per_step=per_step)


@contextlib.contextmanager
def keypose_option_probes():
    """Records, inside the block, the largest |gradient| of the six rotation
    rows of Act3D's gripper_state_fc2 (weight and bias) in every backward
    of a Trainer.step (device tensors, read after the phase), and the first
    fine-context selection made with gradients on (a training step's):
    its anchor, cloud, k, the indices it returned and its approx flag."""
    from act3d_tpu_torch.models import act3d as act3d_module

    probes = dict(rotation_grads=[], selection=None)
    step, select = Trainer.step, act3d_module.topk_nearest_context
    hooked = set()

    def recorded(self, batch):
        fc2 = self.model.gripper_state_fc2
        if id(fc2) not in hooked:
            hooked.add(id(fc2))
            for param in (fc2.weight, fc2.bias):
                param.register_hook(
                    lambda g: probes["rotation_grads"].append(g[:6].abs().max().detach()))
        return step(self, batch)

    def selecting(anchor, cloud, k, approx=False):
        idx = select(anchor, cloud, k, approx=approx)
        if probes["selection"] is None and torch.is_grad_enabled():
            probes["selection"] = (anchor.detach().clone(), cloud.detach().clone(), k,
                                   idx.clone(), approx)
        return idx

    Trainer.step, act3d_module.topk_nearest_context = recorded, selecting
    try:
        yield probes
    finally:
        Trainer.step, act3d_module.topk_nearest_context = step, select


def check_approx_selection(selection, card):
    """The card's approximate top-k (torch.topk, sorted=False) against the
    exact selection of the same call's anchor and cloud: the same number of
    unique indices, and every index in one set but not the other lies at
    exactly the k-th distance (ties at the boundary).  Device times of both
    selections at this shape."""
    anchor, cloud, k, idx, approx = selection
    assert approx, "the CLI did not select with approx_topk"
    exact = topk_nearest_context(anchor, cloud, k)
    d2 = torch.sum((anchor[:, None, :] - cloud) ** 2, dim=-1)
    kth = d2.gather(1, exact[:, -1:])
    picked = torch.zeros_like(d2, dtype=torch.bool).scatter_(1, idx, True)
    wanted = torch.zeros_like(d2, dtype=torch.bool).scatter_(1, exact, True)
    differ = picked ^ wanted
    assert (picked.sum(1) == k).all(), "approx indices are not unique"
    assert (d2[differ] == kth.expand_as(d2)[differ]).all(), "approx left out a nearer point"
    side = torch.cuda.Stream()
    approx_ms = device_ms(lambda: topk_nearest_context(anchor, cloud, k, approx=True), 20, side)
    exact_ms = device_ms(lambda: topk_nearest_context(anchor, cloud, k), 20, side)
    ties = int((d2 == kth).sum())
    swapped = int(differ.sum()) // 2
    print(f"cli_keypose_options approx top-k: B={d2.shape[0]} P={d2.shape[1]} k={k}; "
          f"{swapped} index(es) swapped against the exact set, all at the k-th distance "
          f"({ties} point(s) there); selection {approx_ms:.4f} ms approx vs {exact_ms:.4f} ms "
          f"exact (stable sort) | {card}", flush=True)
    return dict(B=d2.shape[0], P=d2.shape[1], k=k, swapped=swapped, ties_at_kth=ties,
                approx_ms=approx_ms, exact_ms=exact_ms)


_PROJ = ("q_proj", "k_proj", "v_proj", "out_proj")


def flax_params(state_dict) -> dict:
    """The flax ``params`` tree of a port state dict, the inverse of
    act3d_tpu_torch/convert.py's flax bridge: Dense (out, in) -> kernel
    (in, out), Conv OIHW -> HWIO, ``{q,k,v,out}_proj`` -> ``{q,k,v,out}_kernel``
    / ``_bias``, LayerNorm / frozen BN ``weight`` -> ``scale``,
    ``running_mean`` / ``running_var`` -> ``mean`` / ``var``."""
    tree = {}
    for key, value in state_dict.items():
        *path, leaf = key.split(".")
        a = value.detach().cpu().float().numpy()
        if path and path[-1] in _PROJ:
            proj = path.pop()[:-len("_proj")]
            leaf = f"{proj}_kernel" if leaf == "weight" else f"{proj}_bias"
            a = a.T if a.ndim == 2 else a
        elif leaf == "weight":
            leaf = "kernel" if a.ndim in (2, 4) else "scale"
            a = a.T if a.ndim == 2 else a.transpose(2, 3, 1, 0) if a.ndim == 4 else a
        elif leaf in ("running_mean", "running_var"):
            leaf = leaf[len("running_"):]
        node = tree
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = np.ascontiguousarray(a)
    return tree


def _msgpack_len(n: int, fix: int, fix_max: int, wide: tuple) -> bytes:
    """A msgpack length header: the fix form below ``fix_max``, else the
    first of ``wide`` ((type byte, width), ...) that holds ``n``."""
    if n < fix_max:
        return bytes([fix | n])
    for code, width in wide:
        if n < 1 << (8 * width):
            return bytes([code]) + n.to_bytes(width, "big")
    raise ValueError(n)


def msgpack_bytes(obj) -> bytes:
    """flax's msgpack_serialize encoding of a tree of dicts (str keys),
    lists, str, bytes, ints and numpy arrays; an array is flax's extension
    type 1: msgpack (shape, dtype name, C-order bytes)."""
    if isinstance(obj, dict):
        return _msgpack_len(len(obj), 0x80, 16, ((0xDE, 2), (0xDF, 4))) + b"".join(
            msgpack_bytes(k) + msgpack_bytes(v) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return _msgpack_len(len(obj), 0x90, 16, ((0xDC, 2), (0xDD, 4))) + b"".join(
            msgpack_bytes(v) for v in obj)
    if isinstance(obj, str):
        data = obj.encode()
        return _msgpack_len(len(data), 0xA0, 32, ((0xD9, 1), (0xDA, 2), (0xDB, 4))) + data
    if isinstance(obj, bytes):
        return _msgpack_len(len(obj), 0, 0, ((0xC4, 1), (0xC5, 2), (0xC6, 4))) + obj
    if isinstance(obj, (int, np.integer)):
        return bytes([obj]) if 0 <= obj < 128 else b"\xd3" + int(obj).to_bytes(8, "big",
                                                                                  signed=True)
    if isinstance(obj, np.ndarray):
        data = msgpack_bytes([list(obj.shape), obj.dtype.name,
                              np.ascontiguousarray(obj).tobytes()])
        return _msgpack_len(len(data), 0, 0, ((0xC7, 1), (0xC8, 2), (0xC9, 4))) + b"\x01" + data
    raise TypeError(type(obj))


class _Records(list):
    def __init__(self):
        super().__init__()
        self.outputs = []


@contextlib.contextmanager
def recorded_keysteps():
    """Records, for every Actioner.predict run inside the block, its
    host-clock seconds, the Act3D and sampler seconds (predict's own
    ``timed`` marks, which synchronize the device) and the launches of each
    kernel (in KERNELS order) that the keystep made; its output goes to the
    list ``records.outputs``."""
    records, predict = _Records(), Actioner.predict
    outputs = records.outputs

    def recorded(self, *args, **kwargs):
        start = launch_counts()
        t0 = time.perf_counter()
        out = predict(self, *args, timed=True, **kwargs)
        records.append(dict(
            seconds=time.perf_counter() - t0, act3d_s=self.last_phase_seconds["act3d"],
            sampler_s=self.last_phase_seconds["sampler"],
            launches=tuple(a - b for a, b in zip(launch_counts(), start))))
        outputs.append(out)
        return out

    Actioner.predict = recorded
    try:
        yield records
    finally:
        Actioner.predict = predict


def phase_cli_eval(card):
    """The eval CLI as a user runs it after training: both models at
    act3d_tpu/eval/main.py's default widths with seeded weights, saved by
    Trainer.save_checkpoint as best.pt, then eval_main.main over the
    sim-free backend on the card.  Checks every keystep's launches, the
    JSON's layout (task -> {variation, "mean"}) and, following the demos'
    keyposes without the sampler, a score on every demo: the fake task
    rewards the demo's final keypose.  The loop's rate is JAX's compensated
    success count (demos scored x num_demos / (num_demos - missing)), so a
    full score with 2 demos run reads 2.0."""
    expected = expected_launches_per_keystep()
    # launches per keystep: fused_mha_fwd alone
    full = per_unit_launches(fused_mha_fwd=expected)
    act3d_only = per_unit_launches(fused_mha_fwd=act3d_sites_per_forward())
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_eval_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        ipath = tmp / "instructions.pkl"
        ipath.write_bytes(pickle.dumps(make_instructions(("pick_and_lift",), seed=SEED)))
        torch.manual_seed(SEED)
        for name, model in (("act3d", Act3D(**ACT3D_CFG, device="cpu")),
                            ("planner", DiffusionPlanner(**PLANNER_CFG, device="cpu"))):
            Trainer(None, model).save_checkpoint(tmp / name)
            # the same weights in the JAX Trainer's .msgpack layout
            (tmp / name / "best.msgpack").write_bytes(msgpack_bytes(
                {"params": flax_params(model.state_dict()), "step": 0}))
        save_s = time.perf_counter() - t0

        def run(output, *extra, suffix=".pt"):
            argv = ["--data_dir", str(tmp), "--instructions", str(ipath),
                    "--keypose_ckpt", str(tmp / "act3d" / f"best{suffix}"),
                    "--traj_ckpt", str(tmp / "planner" / f"best{suffix}"),
                    "--output", str(tmp / output), "--log_dir", str(tmp / "logs"),
                    *EVAL_CLI_FLAGS, *extra]
            t0 = time.perf_counter()
            with recorded_keysteps() as keysteps:
                results = eval_main.main(argv)
            seconds = time.perf_counter() - t0
            written = json.loads((tmp / output).read_text())
            assert written == {t: {str(k): v for k, v in r.items()}
                               for t, r in results.items()}, (written, results)
            assert list(written) == ["pick_and_lift"], written
            assert sorted(written["pick_and_lift"]) == ["0", "mean"], written
            assert all(0.0 <= r <= EVAL_CLI_DEMOS for r in written["pick_and_lift"].values())
            assert len(keysteps) == EVAL_CLI_DEMOS, keysteps
            return written["pick_and_lift"], keysteps, seconds

        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        rates, keysteps, seconds = run("eval_results.json")
        peak = torch.cuda.max_memory_allocated()
        for i, k in enumerate(keysteps):
            print(f"cli_eval keystep {i}: {k['seconds'] * 1e3:.1f} ms (act3d "
                  f"{k['act3d_s'] * 1e3:.1f} ms, sampler {k['sampler_s'] * 1e3:.1f} ms); "
                  f"launches {nonzero(k['launches'])} | {card}", flush=True)
        assert all(k["launches"] == full for k in keysteps), keysteps
        # the same weights from the .msgpack files: every keystep's output
        # bit for bit the .pt run's (the eval CLI seeds its draws alike)
        msgpack_rates, msgpack_keysteps, msgpack_s = run("eval_msgpack.json", suffix=".msgpack")
        assert msgpack_rates == rates, (msgpack_rates, rates)
        assert all(k["launches"] == full for k in msgpack_keysteps), msgpack_keysteps
        for a, b in zip(keysteps.outputs, msgpack_keysteps.outputs):
            assert a.keys() == b.keys() and all(
                (a[k] is None and b[k] is None) or np.array_equal(a[k], b[k]) for k in a), (a, b)
        print(f"cli_eval from best.msgpack (the JAX Trainer's layout): {len(msgpack_keysteps)} "
              f"keysteps bit-identical to best.pt's, rates {msgpack_rates}, whole run "
              f"{msgpack_s:.1f} s | {card}", flush=True)
        offline_rates, offline_keysteps, offline_s = run(
            "eval_offline.json", "--offline", "1", "--predict_traj", "0")
        for i, k in enumerate(offline_keysteps):
            print(f"cli_eval offline keystep {i}: {k['seconds'] * 1e3:.1f} ms (act3d "
                  f"{k['act3d_s'] * 1e3:.1f} ms); launches "
                  f"{nonzero(k['launches'])} | {card}", flush=True)
        assert all(k["launches"] == act3d_only for k in offline_keysteps), offline_keysteps
        assert offline_rates["mean"] == EVAL_CLI_DEMOS, offline_rates
    print(f"cli_eval: rates {rates} (chained, seeded random weights), offline {offline_rates}; "
          f"peak memory {peak / 2**20:.1f} MiB (allocated before the CLI started "
          f"{resident / 2**20:.1f} MiB); whole run {seconds:.1f} s, offline run "
          f"{offline_s:.1f} s, checkpoints written in {save_s:.1f} s | {card}", flush=True)
    return dict(rates=rates, offline_rates=offline_rates, keysteps=list(keysteps),
                offline_keysteps=list(offline_keysteps), peak_memory_bytes=peak,
                resident_memory_bytes=resident, seconds=seconds,
                offline_seconds=offline_s, launches_per_keystep=expected,
                msgpack_keysteps=list(msgpack_keysteps), msgpack_seconds=msgpack_s)


class _ScriptedRng:
    """np.random.Generator stand-in that hands out scripted draws, to run the
    host Resize at chosen (scale, i, j)."""

    def __init__(self, uniforms, integers):
        self._uniforms, self._integers = list(uniforms), list(integers)

    def uniform(self, *args):
        return self._uniforms.pop(0)

    def integers(self, *args):
        return self._integers.pop(0)


def child_processes() -> list:
    """(pid, command line) of every process whose parent is this one."""
    me, found = str(os.getpid()), []
    for entry in Path("/proc").iterdir():
        if not entry.name.isdigit():
            continue
        try:  # the command may hold ")": the fields after its last one
            ppid = (entry / "stat").read_text().rsplit(")", 1)[1].split()[1]
            if ppid == me:
                cmd = (entry / "cmdline").read_bytes().replace(b"\0", b" ").decode()
                found.append((int(entry.name), cmd[:160]))
        except OSError:  # exited while read
            continue
    return found


def host_workers() -> int:
    """Worker processes of the host-path CLI phases: half the machine's
    cores (at least 2), leaving the rest to the training loop's main and
    feeder threads."""
    return max(2, (os.cpu_count() or 4) // 2)


def cli_dataset_args(tree, ipath, model, **over):
    """The RLBenchDataset arguments of a training CLI's training set at its
    reference script's flags (scripts/train_act3d.sh: batch 16, no
    trajectory; scripts/train_trajectory.sh: batch 22, dense interpolation
    to 50, action_dim 7), seeded SEED."""
    args = dict(root=tree, instructions=pickle.loads(ipath.read_bytes()),
                taskvar=[("pick_and_lift", 0)], cameras=CAMERAS, cache_size=100,
                training=True, image_rescale=(0.75, 1.25),
                gripper_loc_bounds=get_gripper_loc_bounds(str(CLI_BOUNDS), buffer=0.04,
                                                          task="pick_and_lift"),
                seed=SEED)
    if model == "trajectory":
        args.update(return_low_lvl_trajectory=True, dense_interpolation=True,
                    interpolation_length=50, action_dim=7)
    else:
        args.update(action_dim=8)
    args.update(over)
    return args


def _median_ms(fn, repeats):
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def _nbytes(batch):
    return sum(v.nbytes for v in batch.values() if isinstance(v, np.ndarray))


def _pinned(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
            for k, v in batch.items() if isinstance(v, np.ndarray)}


def _h2d(pinned, dev):
    out = {k: v.to(dev, non_blocking=True) for k, v in pinned.items()}
    torch.cuda.synchronize()
    return out


def _max_err(got, want) -> float:
    return float((got.detach().cpu().to(torch.float64) - torch.as_tensor(want).to(torch.float64))
                 .abs().max())


def _proc_memory_kib(pid) -> dict:
    """A process's resident memory (VmRSS) and its anonymous part (RssAnon:
    what a forked worker does not share with the fork server), KiB, from
    /proc/<pid>/status; None where the kernel does not report a field."""
    fields = {}
    try:
        lines = Path(f"/proc/{pid}/status").read_text().splitlines()
    except FileNotFoundError:  # a sandboxed kernel without it
        lines = []
    for line in lines:
        name, _, value = line.partition(":")
        if name in ("VmRSS", "RssAnon"):
            fields[name] = int(value.split()[0])
    return {k: fields.get(k) for k in ("VmRSS", "RssAnon")}


def _mean_mib(memory, key):
    values = [m[key] for m in memory if m[key] is not None]
    return f"{np.mean(values) / 1024:.0f} MiB" if values else "not reported"


def host_path_checks(dev, card, tree, ipath):
    """The host path's device-side code on the card at the keypose CLI's
    shapes (batch 16, 3 cameras at 256^2), against the CPU and against the
    host batch of the same draws."""
    b = 16
    rotate = dict(point_cloud_rotate_yaw_range=15.0)  # exercise the extrinsic fold
    host = RLBenchDataset(**cli_dataset_args(tree, ipath, "keypose", **rotate)).sample_batch(b)
    wire = RLBenchDataset(**cli_dataset_args(tree, ipath, "keypose", wire="depth",
                                             **rotate)).sample_batch(b)
    assert "depth" in wire and "aug_rows" in wire, sorted(wire)
    for k in ("action", "curr_gripper"):  # the same draws
        assert np.array_equal(wire[k], host[k]), k
    errs = {}
    # expand_batch's conversions (uint8, uint16) on the card against the CPU
    for name, batch in (("xyz", compact_batch(host)), ("depth", compact_batch(wire))):
        tensors = {k: v for k, v in batch.items() if k != "task"}
        cpu, gpu = expand_batch(to_tensors(tensors, "cpu")), expand_batch(to_tensors(tensors, dev))
        for k in ("rgbs", "pcds"):
            assert gpu[k].dtype == torch.float32 and gpu[k].device.type == dev.type, k
            errs[f"expand_{name}_{k}_card_vs_cpu"] = _max_err(gpu[k], cpu[k])
        errs[f"expand_{name}_pcds_vs_host"] = _max_err(gpu["pcds"], host["pcds"])
    # the depth wire's gathers and reconstruction at float32 depth
    rows, cols = (torch.from_numpy(wire[k]).to(dev) for k in ("aug_rows", "aug_cols"))
    errs["gather_hw_rgbs_vs_host"] = _max_err(
        gather_hw(torch.from_numpy(wire["rgbs"]).to(dev), rows, cols), host["rgbs"])
    errs["reconstruct_pcds_vs_host"] = _max_err(
        reconstruct_pcds(*(torch.from_numpy(wire[k]).to(dev)
                           for k in ("depth", "cam_intr", "cam_c2w")), rows=rows, cols=cols),
        host["pcds"])
    # device_augment's resize at the host Resize's draws, one per sample
    plain = RLBenchDataset(**cli_dataset_args(tree, ipath, "keypose",
                                              augment_host=False)).sample_batch(b)
    rng = np.random.default_rng(SEED)
    scales = rng.uniform(0.75, 1.25, b)
    size = plain["rgbs"].shape[-1]
    crops = [[int(rng.integers(0, max(int(size * s) - size, 0) + 1)) for _ in range(2)]
             for s in scales]
    want = {k: np.stack([Resize((s, s), _ScriptedRng([s], c))(**{k: plain[k][i]})[k]
                         for i, (s, c) in enumerate(zip(scales, crops))])
            for k in ("rgbs", "pcds")}
    got = resize_with_params({k: torch.from_numpy(plain[k]).to(dev) for k in want},
                             torch.from_numpy(scales).to(dev),
                             torch.tensor([c[0] for c in crops], device=dev),
                             torch.tensor([c[1] for c in crops], device=dev))
    for k in want:
        errs[f"device_resize_{k}_vs_host"] = _max_err(got[k], want[k])
    torch.cuda.synchronize()
    print("host_path checks at batch 16, 3 cameras at 256^2: " + ", ".join(
        f"{k} {v:.3g}" for k, v in errs.items()) + f" | {card}", flush=True)
    for k, v in errs.items():
        if k.endswith("_card_vs_cpu"):
            # conversions exact; the reconstruction's sums within float32 rounding
            assert v <= (1e-5 if k == "expand_depth_pcds_card_vs_cpu" else 0.0), (k, v)
        elif k.startswith(("gather_hw", "device_resize")):
            assert v == 0.0, (k, v)
        else:  # the u16 wires and the depth wire's reconstruction
            assert v <= WIRE_TOL, (k, v)
    return errs


def host_split(dev, card, tree, ipath):
    """Where a host batch's time goes on this machine: median host-clock
    ms of sample_batch at the keypose (16) and trajectory (22) CLIs' flags
    with the host Resize on and off, wire pcd and depth, and (trajectory)
    dense interpolation on and off; the compact encode; the pinned copy and
    the host -> device copy of each batch; sample_batch in a thread while
    the main thread dispatches small CUDA ops (the GIL), and the
    multi-process sampler's batches per second with host_workers()."""
    rows = []
    configs = [("keypose", 16, {}), ("keypose", 16, dict(augment_host=False)),
               ("keypose", 16, dict(wire="depth")),
               ("keypose", 16, dict(wire="depth", instr_mode="ids")),
               ("trajectory", 22, {}), ("trajectory", 22, dict(augment_host=False)),
               ("trajectory", 22, dict(dense_interpolation=False)),
               ("trajectory", 22, dict(wire="depth", instr_mode="ids"))]
    for model, b, over in configs:
        ds = RLBenchDataset(**cli_dataset_args(tree, ipath, model, **over))
        batch = ds.sample_batch(b)  # loads the episodes into the cache
        sample_ms = _median_ms(lambda: ds.sample_batch(b), HOST_REPEATS)
        compact = compact_batch(batch)
        compact_ms = _median_ms(lambda: compact_batch(batch), HOST_REPEATS)
        shipped = compact if over.get("wire") == "depth" else batch
        pin_ms = _median_ms(lambda: _pinned(shipped), HOST_REPEATS)
        pinned = _pinned(shipped)
        h2d_ms = _median_ms(lambda: _h2d(pinned, dev), HOST_REPEATS)
        row = dict(model=model, batch=b, **{k: str(v) for k, v in over.items()},
                   sample_batch_ms=sample_ms, compact_ms=compact_ms,
                   f32_bytes=_nbytes(batch), compact_bytes=_nbytes(compact),
                   shipped_bytes=_nbytes(shipped), pin_ms=pin_ms, h2d_ms=h2d_ms)
        rows.append(row)
        print(f"host_path split {model} b{b} {over or 'defaults'}: sample_batch "
              f"{sample_ms:.1f} ms, compact_batch {compact_ms:.1f} ms, bytes f32 "
              f"{row['f32_bytes'] / 1e6:.2f} MB / compact {row['compact_bytes'] / 1e6:.2f} MB; "
              f"shipped {row['shipped_bytes'] / 1e6:.2f} MB: pin {pin_ms:.1f} ms, H2D "
              f"{h2d_ms:.2f} ms (medians of {HOST_REPEATS}) | {card}", flush=True)

    ds = RLBenchDataset(**cli_dataset_args(tree, ipath, "keypose"))
    ds.sample_batch(16)
    times, done = [], threading.Event()

    def draw():
        for _ in range(HOST_REPEATS):
            t0 = time.perf_counter()
            ds.sample_batch(16)
            times.append(time.perf_counter() - t0)
        done.set()

    thread = threading.Thread(target=draw)
    x = torch.zeros(1024, device=dev)
    dispatched = 0
    thread.start()
    while not done.is_set():  # host dispatch, as a training step's
        x.add_(1.0)
        dispatched += 1
    thread.join()
    torch.cuda.synchronize()
    gil = dict(sample_batch_ms_in_thread=float(np.median(times)) * 1e3,
               main_thread_dispatches=dispatched)
    print(f"host_path GIL: keypose sample_batch in a thread while the main thread dispatched "
          f"{dispatched} small CUDA ops: {gil['sample_batch_ms_in_thread']:.1f} ms (alone "
          f"{rows[0]['sample_batch_ms']:.1f} ms) | {card}", flush=True)

    workers = host_workers()
    samplers = []
    # the host-path CLI phases' datasets: keypose with the Resize on the card,
    # trajectory on the depth wire, both with instruction ids; the workers
    # compact-encode
    for model, b, over in (("keypose", 16, dict(augment_host=False, instr_mode="ids")),
                           ("trajectory", 22, dict(wire="depth", instr_mode="ids"))):
        t0 = time.perf_counter()
        with MultiProcessSampler(rlbench_dataset_factory(
                cli_dataset_args(tree, ipath, model, **over), SEED, compact=True), batch_size=b,
                num_workers=workers) as sampler:
            for _ in range(workers):
                next(sampler)
            first_s = time.perf_counter() - t0
            n = 3 * workers
            t0 = time.perf_counter()
            for _ in range(n):
                next(sampler)
            per_batch_ms = (time.perf_counter() - t0) / n * 1e3
            memory = [_proc_memory_kib(p.pid) for p in sampler._procs]
        samplers.append(dict(model=model, batch=b, workers=workers, first_batches_s=first_s,
                             steady_ms_per_batch=per_batch_ms, worker_memory_kib=memory))
        print(f"host_path sampler {model} b{b} {over}: {workers} workers, first {workers} "
              f"batches after {first_s:.1f} s, then {per_batch_ms:.1f} ms per batch over {n}; "
              f"per worker resident {_mean_mib(memory, 'VmRSS')}, anonymous "
              f"{_mean_mib(memory, 'RssAnon')} | {card}", flush=True)
    probe = subprocess.run(
        [sys.executable, "-c", "import resource, time; t = time.perf_counter(); "
         "import act3d_tpu_torch.data.dataset; print(time.perf_counter() - t, "
         "resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)"],
        cwd=REPO, capture_output=True, text=True, check=True).stdout.split()
    worker_import = dict(import_s=float(probe[0]), max_rss_kib=int(probe[1]))
    print(f"host_path worker start: importing act3d_tpu_torch.data.dataset (torch with it) "
          f"takes {worker_import['import_s']:.2f} s and {worker_import['max_rss_kib'] / 1024:.0f} "
          f"MiB resident in a fresh process | {card}", flush=True)
    return dict(split=rows, gil=gil, samplers=samplers, worker_import=worker_import)


def phase_host_path(dev, card):
    """The host path on this machine: checks (host_path_checks), then the
    time split (host_split), over a fixture tree of the CLIs'."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_host_path_") as tmp:
        tree, ipath = write_fixture_tree(Path(tmp), CLI_EPISODES)
        errs = host_path_checks(dev, card, tree, ipath)
        split = host_split(dev, card, tree, ipath)
    return dict(checks=errs, **split)


def print_plans(serve_rows, train_fwd, train_bwd, kp_fwd, kp_bwd):
    """The device kernels each fused-MHA wrapper call runs (one, or two with
    the forward's split combine or the backward's slab sums) and its
    workspace, per site and per unit of the main path."""
    units = (("fused_mha_fwd", "serving keystep", serve_rows, "per_keystep"),
             ("fused_mha_fwd", "ChainedDiffuser step", train_fwd, "per_step"),
             ("fused_mha_bwd", "ChainedDiffuser step", train_bwd, "per_step"),
             ("fused_mha_fwd", "Act3D step", kp_fwd, "per_step"),
             ("fused_mha_bwd", "Act3D step", kp_bwd, "per_step"))
    for name, unit, unit_rows, per in units:
        live = [r for r in unit_rows if r[per]]
        for r in live:
            print(f"{name} device kernels per call at {r['site']}: {r['kernels_per_call']}, "
                  f"workspace {r['workspace_bytes']} bytes", flush=True)
        print(f"{name} per {unit}: {sum(r[per] for r in live)} wrapper calls, "
              f"{sum(r[per] * r['kernels_per_call'] for r in live)} device kernels; largest "
              f"workspace {max(r['workspace_bytes'] for r in live)} bytes", flush=True)


def phase_serve(dev, card):
    rng = np.random.default_rng(SEED)
    bank = rng.normal(size=(N_INSTR, 512)).astype(np.float32)
    actioner = build_actioner(ACT3D_CFG, PLANNER_CFG, dev, {"synthetic": {0: [bank]}})
    actioner.load_episode("synthetic", 0)
    mask = np.zeros((1, TRAJ_LEN), bool)
    expected = expected_launches_per_keystep()
    assert expected == sum(r[-1] for r in SHAPES) == 1918, expected
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    weights = sum(t.numel() * t.element_size()
                  for model in (actioner.keypose_model, actioner.traj_model)
                  for t in [*model.parameters(), *model.buffers()])
    latencies = []
    for step in range(N_KEYSTEPS):
        before = fused_mha_forward.launches
        rgb, pcd, gripper = synthetic_observation(rng, 256, NCAM)
        t0 = time.perf_counter()
        out = actioner.predict(rgb, pcd, gripper, trajectory_mask=mask, timed=True)
        latency = time.perf_counter() - t0
        launched = fused_mha_forward.launches - before
        action, traj = out["action"], out["trajectory"]
        assert action.shape == (1, 8), action.shape
        assert traj.shape == (1, TRAJ_LEN, 7), traj.shape
        assert np.isfinite(action).all() and np.isfinite(traj).all()
        assert np.abs(np.linalg.norm(action[:, 3:7], axis=-1) - 1).max() < 1e-4
        assert np.abs(np.linalg.norm(traj[..., 3:7], axis=-1) - 1).max() < 1e-4
        assert launched == expected, (launched, expected)
        phases = actioner.last_phase_seconds
        latencies.append(dict(keystep=step, seconds=latency, act3d_s=phases["act3d"],
                              sampler_s=phases["sampler"], launches=launched))
        print(f"serve keystep {step}: {latency * 1e3:.1f} ms (act3d "
              f"{phases['act3d'] * 1e3:.1f} ms, sampler {phases['sampler'] * 1e3:.1f} ms), "
              f"{launched} fused_mha_fwd launches | {card}", flush=True)
    assert fused_mha_backward.launches == 0, fused_mha_backward.launches
    assert scatter_rows_sorted.launches == scatter_rows.launches == 0
    peak = torch.cuda.max_memory_allocated()
    print(f"serve peak memory: {peak / 2**20:.1f} MiB; resident before the first keystep "
          f"{resident / 2**20:.1f} MiB, of which weights and buffers "
          f"{weights / 2**20:.1f} MiB | {card}", flush=True)
    return fused_mha_forward.launches, latencies, dict(
        peak_memory_bytes=peak, resident_memory_bytes=resident, weight_bytes=weights)


# ------------------------------------------------------------ data parallel
# The dropout offset of the fused-MHA kernels: the ChainedDiffuser's
# dropout sites, the global batch of TRAIN_B rows split over two ranks;
# rank 1's rows start at b0 = TRAIN_B // 2.
DP_WORLD = 2
DP_B0 = TRAIN_B // DP_WORLD
# dp_equal: the small models of phase_small_train / phase_small_keypose
# (dropout 0.1 in the planner), a global batch of 4, 3 steps; JAX's
# tests/test_sharding.py bounds
DP_STEPS, DP_BATCH, DP_RTOL, DP_GRAD_ATOL = 3, 4, 2e-4, 5e-4
DP_SMALL = {"diffusion": dict(image_size=(64, 64), embedding_dim=24,
                              num_query_cross_attn_layers=3),
            "keypose": dict(image_size=(128, 128), embedding_dim=24, num_ghost_points=40,
                            num_sampling_level=2)}
# cli_dp: steps before each CLI's first evaluation (the batches drawn
# after it depend on the order of the feeder's and the evaluation's draws)
CLI_DP_KEYPOSE_ITERS, CLI_DP_TRAJECTORY_ITERS = 3, 4


def phase_kernels_dropout_offset(dev, card):
    """#1d and #2 with a batch offset: at every ChainedDiffuser dropout site,
    rank 1's rows (b0 = 8 of a global batch of 16) through the float32 and
    bf16 kernels against the plain versions of the whole batch, rows 8-15:
    outputs and gradients within the bounds of phase_train_kernels /
    phase_kernels_bf16; then the drop pattern itself (v the identity of
    each head, so out is the kept weights) equal to rows 8-15 of the plain
    full-batch mask, every drop counted."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    e, h, bf = PLANNER_CFG["embedding_dim"], 8, torch.bfloat16
    d = e // h
    b, b0 = TRAIN_B, DP_B0
    rows = slice(b0, b)
    t0 = time.perf_counter()
    for i, (site, l, s, kind, rate, _) in enumerate(TRAIN_SHAPES):
        if not rate:
            continue
        seed = 9000 + i
        mask = train_mask(kind, b, s, dev)
        part_mask = None if mask is None else mask[rows].contiguous()
        q = torch.randn(b, l, e, generator=gen, device=dev) * d ** -0.5
        k, v, g = (torch.randn(b, n, e, generator=gen, device=dev) for n in (s, s, l))
        # float32: the kernel on rows b0.. against the plain full batch
        ref_out, ref_stats = fused_mha_forward_reference(q, k, v, h, mask, rate, seed)
        ref_grads = fused_mha_backward_reference(q, k, v, ref_out, ref_stats, g, h, mask,
                                                 rate, seed)
        part = [x[rows].contiguous() for x in (q, k, v, g)]
        out, stats = fused_mha_forward(*part[:3], h, part_mask, True, rate, seed,
                                       dropout_b0=b0)
        grads = fused_mha_backward(*part[:3], out, stats, part[3], h, part_mask, rate, seed,
                                   dropout_b0=b0)
        torch.testing.assert_close(out, ref_out[rows], atol=ATOL, rtol=RTOL)
        torch.testing.assert_close(stats, ref_stats[rows], atol=ATOL, rtol=RTOL)
        for got, want in zip(grads, ref_grads):
            torch.testing.assert_close(got, want[rows], atol=BWD_ATOL, rtol=BWD_RTOL)
        f32_err = _max_errs([(out, ref_out[rows])] + list(zip(grads, (w[rows] for w in
                                                                      ref_grads))))
        # bf16: the kernel on rows b0.. against its plain version there (b0)
        # and the float32 plain version of the whole batch, rows b0..
        pb = [x.to(bf) for x in part]
        out_b, stats_b = fused_mha_forward(*pb[:3], h, part_mask, True, rate, seed,
                                           dropout_b0=b0)
        grads_b = fused_mha_backward(*pb[:3], out_b, stats_b, pb[3], h, part_mask, rate, seed,
                                     dropout_b0=b0)
        plain_b, _ = fused_mha_forward_reference(*pb[:3], h, part_mask, rate, seed,
                                                 dropout_b0=b0)
        full32 = [x.to(bf).float() for x in (q, k, v, g)]
        ref_b, _ = fused_mha_forward_reference(*full32[:3], h, mask, rate, seed)
        fwd = bf16_errors(out_b, plain_b, ref_b[rows])
        plain_gb = fused_mha_backward_reference(*pb[:3], out_b, stats_b, pb[3], h, part_mask,
                                                rate, seed, dropout_b0=b0)
        ref_gb = fused_mha_backward_reference(
            *full32[:3], torch.cat([ref_b[:b0], out_b.float()]),
            torch.cat([ref_stats[:b0], stats_b]), full32[3], h, mask, rate, seed)
        bwd = [bf16_errors(got, plain, want[rows], BWD_FLOOR)
               for got, plain, want in zip(grads_b, plain_gb, ref_gb)]
        assert fwd["ok"] and all(x["ok"] for x in bwd), (site, fwd, bwd)
        print(f"kernels_dropout_offset {site:16s} B={b - b0} of {b} (b0 {b0}) L={l} S={s} "
              f"rate={rate} mask={kind}: float32 fwd/bwd vs plain full batch max_abs "
              f"{f32_err[0]:.3e} | bf16 fwd {fwd['kernel_vs_f32']:.3e} (bound "
              f"{fwd['bound']:.3e}), bwd "
              + "/".join(f"{x['kernel_vs_f32']:.3e}" for x in bwd) + " (bounds "
              + "/".join(f"{x['bound']:.3e}" for x in bwd) + ")", flush=True)

    # the drop pattern: with v the identity of each head (S <= d), out is
    # the kept weights, zero where dropped
    l, s, rate = TRAJ_LEN, 15, DROPOUT
    q = torch.randn(b, l, h * d, generator=gen, device=dev) * d ** -0.5
    k = torch.randn(b, s, h * d, generator=gen, device=dev)
    v = torch.eye(s, d, device=dev).repeat(b - b0, 1, h)
    full_keep = dropout_keep(99, b, h, l, s, rate, dev)
    for dt in (torch.float32, bf):
        out = fused_mha_forward(q[rows].contiguous().to(dt), k[rows].contiguous().to(dt),
                                v.to(dt), h, None, dropout_rate=rate, dropout_seed=99,
                                dropout_b0=b0)
        zeros = out.reshape(b - b0, l, h, d)[..., :s].transpose(1, 2) == 0
        assert torch.equal(zeros, ~full_keep[rows]), dt
        assert not torch.equal(~full_keep[:b0], ~full_keep[rows])  # rank 0 drops others
        print(f"kernels_dropout_offset pattern ({dt}, B={b - b0} at b0 {b0}, L={l}, S={s}, "
              f"H={h}, rate {rate}, seed 99): the kernel drops {int(zeros.sum())} of the "
              f"{int((~full_keep[rows]).sum())} weights rows {b0}-{b - 1} of the full-batch "
              f"mask drop, exactly", flush=True)
    seconds = time.perf_counter() - t0
    print(f"kernels_dropout_offset: {seconds:.1f} s | {card}", flush=True)
    return seconds


def _dp_batch(kind):
    if kind == "diffusion":
        batch = synthetic_trajectory_batch(DP_BATCH, 2, (64, 64), 8, seed=SEED + 3)
        batch["trajectory_mask"][0, -5:] = True  # rank 0 holds fewer valid points
        batch["trajectory_mask"][1, -2:] = True
        return batch
    return synthetic_keypose_batch(DP_BATCH, 1, (128, 128), seed=SEED + 3)


def _dp_loss_fn(kind, model, compute_dtype=None):
    if kind == "diffusion":
        return diffusion_loss_fn(model, compute_dtype)
    return keypose_loss_fn(model, KeyposeLossAndMetrics(), compute_dtype)


def dp_run(rank, world, kind, mesh_shape, dev):
    """One rank's gradients of the first backward (full tensors) and the
    losses (the ranks' mean) of DP_STEPS Trainer steps of a small model
    on its rows of the global batch, and the kernel launches it made.
    ``mesh_shape``: None (no mesh), (n,) the ("dp",) mesh (DDP) or (n, f)
    the ("dp", "fsdp") mesh (FSDP2)."""
    from torch.distributed.device_mesh import init_device_mesh

    from act3d_tpu_torch.parallel.collectives import mean_over_ranks
    from act3d_tpu_torch.parallel.mesh import _full, batch_rows

    mesh = None if mesh_shape is None else init_device_mesh(
        "cuda", mesh_shape, mesh_dim_names=("dp", "fsdp")[:len(mesh_shape)])
    torch.manual_seed(SEED)
    make = make_diffusion_model if kind == "diffusion" else make_keypose_model
    model = make(**DP_SMALL[kind], device=dev)
    trainer = Trainer(_dp_loss_fn(kind, model), model, lr=1e-3, seed=SEED + 5, mesh=mesh)
    local = {k: v.to(dev) for k, v in batch_rows(rank, world, _dp_batch(kind)).items()}
    start = launch_counts()
    trainer.runner.train()
    loss, _ = trainer.runner(trainer._loss_fn, local, trainer.generators)
    loss.backward()
    grads = {n: _full(p.grad).float().cpu().numpy() for n, p in model.named_parameters()
             if p.grad is not None}
    trainer.optimizer.zero_grad(set_to_none=True)
    losses = [mean_over_ranks(loss.item())]
    for _ in range(DP_STEPS):
        losses.append(mean_over_ranks(trainer.step(local)["loss"].item()))
    torch.cuda.synchronize()
    launched = tuple(a - b for a, b in zip(launch_counts(), start))
    return dict(grads=grads, losses=losses, launches=launched, **state_bytes(trainer),
                param_types=sorted({type(p).__name__ for p in model.parameters()}),
                backend=(torch.distributed.get_backend() if torch.distributed.is_initialized()
                         else None))


def state_bytes(trainer):
    """This rank's bytes of trainable parameters and AdamW moments (the
    local shards under FSDP2)."""
    def local(t):
        return t.to_local() if hasattr(t, "to_local") else t

    params = sum(local(p).numel() * local(p).element_size()
                 for p in trainer.model.parameters() if p.requires_grad)
    moments = sum(local(v).numel() * local(v).element_size()
                  for state in trainer.optimizer.state.values()
                  for k, v in state.items() if k in ("exp_avg", "exp_avg_sq"))
    return dict(param_bytes=params, moment_bytes=moments)


def _dp_entry(rank, world, backend, store_path, runs, queue):
    """A spawned rank: the port's CUDA device of this rank, one process
    group over ``backend``, the ``runs`` of dp_run in turn."""
    import traceback

    try:
        dev = resolve_device("cuda:0")
        torch.cuda.set_device(dev)
        _build.build()  # already built by the parent: loads the libraries
        torch.distributed.init_process_group(
            backend, store=torch.distributed.FileStore(store_path, world), rank=rank,
            world_size=world)
        try:
            queue.put((rank, [dp_run(rank, world, kind, shape, dev) for kind, shape in runs],
                       None))
        finally:
            torch.distributed.destroy_process_group()
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))


def _next_result(queue, procs, timeout):
    """The next rank's (rank, result, error) from ``queue``, waiting at most
    ``timeout`` seconds; a rank that died without putting one fails at
    once instead of at the timeout."""
    import queue as queue_module

    deadline = time.monotonic() + timeout
    while True:
        try:
            return queue.get(timeout=2)
        except queue_module.Empty:
            dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
            if dead or time.monotonic() > deadline:
                raise RuntimeError(f"ranks died (exit codes {dead}) or timed out") from None


def spawn_ranks(world, backend, runs, tmp):
    """``runs`` (kind, mesh shape) of dp_run on ``world`` spawned ranks sharing
    the card over ``backend``; every process joined before it returns."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    store = str(Path(tmp) / f"store-{backend}-{world}-{time.monotonic_ns()}")
    procs = [ctx.Process(target=_dp_entry, args=(r, world, backend, store, runs, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    out = []
    try:
        while len(out) < world:
            out.append(_next_result(queue, procs, 600))
            assert out[-1][2] is None, f"rank {out[-1][0]} failed:\n{out[-1][2]}"
    finally:
        for p in procs:
            p.join(timeout=60 if len(out) == world else 1)
            if p.is_alive():
                p.kill()
                p.join()
    return [r for _, r, _ in sorted(out, key=lambda t: t[0])]


def _assert_grads_close(g1, gn):
    """JAX's tests/test_sharding.py rule: per-leaf scaled, leaves below 1e-6
    of the largest gradient (the noise floor) skipped."""
    assert sorted(g1) == sorted(gn), (sorted(g1), sorted(gn))
    gmax = max(np.abs(a).max() for a in g1.values())
    checked, worst = 0, 0.0
    for name in g1:
        scale = max(np.abs(g1[name]).max(), np.abs(gn[name]).max())
        if scale < 1e-6 * gmax:
            continue
        checked += 1
        worst = max(worst, float(np.abs(g1[name] - gn[name]).max() / scale))
        np.testing.assert_allclose(g1[name] / scale, gn[name] / scale, atol=DP_GRAD_ATOL,
                                   rtol=0, err_msg=name)
    assert checked > 10, checked
    return checked, worst


def phase_dp_equal(dev, card):
    """One global batch at world 1 (no process group, this process) against
    world 2: two ranks spawned on the one card over gloo with CUDA tensors,
    DDP on the ("dp",) mesh (dp2) for the ChainedDiffuser (dropout 0.1, the
    ranks' padding uneven) and Act3D, and FSDP2 on the (1, 2) ("dp",
    "fsdp") mesh (dp1 x fsdp2) for the ChainedDiffuser; and DDP and FSDP2
    at world 1 over NCCL.  Losses within rtol 2e-4 and gradients by JAX's
    scaled rule; each rank's launch counts show the kernels ran; each
    rank's trainable and moment bytes (half under fsdp2)."""
    t0 = time.perf_counter()
    ref = {kind: dp_run(0, 1, kind, None, dev) for kind in DP_SMALL}
    gloo_runs = [(kind, (DP_WORLD,)) for kind in DP_SMALL] + [("diffusion", (1, DP_WORLD))]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        dp2 = spawn_ranks(DP_WORLD, "gloo", gloo_runs, tmp)
        (nccl,) = spawn_ranks(1, "nccl", [("diffusion", (1,)), ("diffusion", (1, 1))], tmp)
    checks = [(f"{kind} {'dp1 x fsdp2' if len(shape) == 2 else 'dp2'} (gloo) rank {rank}", kind,
               runs[i], "gloo", "DTensor" if len(shape) == 2 else "Parameter")
              for rank, runs in enumerate(dp2) for i, (kind, shape) in enumerate(gloo_runs)]
    checks += [("diffusion DDP world 1 (nccl)", "diffusion", nccl[0], "nccl", "Parameter"),
               ("diffusion FSDP2 (1, 1) (nccl)", "diffusion", nccl[1], "nccl", "DTensor")]
    results = {}
    for tag, kind, run, backend, ptype in checks:
        np.testing.assert_allclose(ref[kind]["losses"], run["losses"], rtol=DP_RTOL)
        checked, worst = _assert_grads_close(ref[kind]["grads"], run["grads"])
        assert run["launches"] == ref[kind]["launches"], (tag, nonzero(run["launches"]))
        assert run["launches"][0] and run["launches"][1], nonzero(run["launches"])
        assert run["backend"] == backend and ptype in run["param_types"], (tag, run["backend"],
                                                                          run["param_types"])
        print(f"dp_equal {tag}: losses {run['losses']} vs world 1 {ref[kind]['losses']}; "
              f"{checked} gradients within {worst:.2e} of the largest (scaled); launches "
              f"{nonzero(run['launches'])}; trainable params {run['param_bytes']} bytes, "
              f"moments {run['moment_bytes']} (world 1: {ref[kind]['param_bytes']}, "
              f"{ref[kind]['moment_bytes']}) | {card}", flush=True)
        if "fsdp2" in tag:  # each rank holds its half (dim 0 cut in two)
            assert run["param_bytes"] < 0.6 * ref[kind]["param_bytes"], run
            assert run["moment_bytes"] == 2 * run["param_bytes"], run
        results[tag] = dict(losses=run["losses"], param_bytes=run["param_bytes"],
                            moment_bytes=run["moment_bytes"])
    results["world1"] = {kind: r["losses"] for kind, r in ref.items()}
    results["seconds"] = time.perf_counter() - t0
    print(f"dp_equal: {results['seconds']:.1f} s | {card}", flush=True)
    launched = [run["launches"] for runs in dp2 + [nccl] for run in runs]
    return results, tuple(map(sum, zip(*launched)))


def cli_child(spec_path):
    """The body of one rank of a launched CLI (``torchrun ... chip_smoke.py
    --cli_child SPEC``): ``main(argv)`` with every step recorded; writes
    this rank's steps, backend, world and parameter types to SPEC's
    ``out`` directory."""
    spec = json.loads(Path(spec_path).read_text())
    main_fn = {"keypose": main_keypose, "trajectory": main_trajectory}[spec["name"]].main
    seen, init, trainers = {}, Trainer.__init__, []

    def recorded_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        trainers.append(self)
        seen.update(world=self.world, rank=self.rank,
                    backend=(torch.distributed.get_backend()
                             if torch.distributed.is_initialized() else None),
                    param_types=sorted({type(p).__name__ for p in self.model.parameters()}))

    Trainer.__init__ = recorded_init
    torch.cuda.reset_peak_memory_stats()
    try:
        with recorded_steps() as steps:
            main_fn(spec["argv"])
    finally:
        Trainer.__init__ = init
    out = Path(spec["out"]) / f"rank{seen['rank']}.json"
    out.write_text(json.dumps(dict(seen, steps=steps, **state_bytes(trainers[-1]),
                                   peak_memory_bytes=torch.cuda.max_memory_allocated())))
    return 0


def torchrun(nproc, name, argv, tmp):
    """One launched CLI run, ``python -m torch.distributed.run --standalone
    --nproc_per_node nproc``: each rank's record (cli_child) and the wall
    time."""
    run_dir = Path(tempfile.mkdtemp(prefix=f"{name}-{nproc}-", dir=tmp))
    spec = run_dir / "spec.json"
    spec.write_text(json.dumps(dict(name=name, argv=argv, out=str(run_dir))))
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                    "--nproc_per_node", str(nproc), str(REPO / "chip_smoke.py"), "--cli_child",
                    str(spec)], check=True, timeout=900, cwd=REPO)
    seconds = time.perf_counter() - t0
    return [json.loads((run_dir / f"rank{r}.json").read_text()) for r in range(nproc)], seconds


def _step_losses(ranks):
    """The global batch's loss of each step: the ranks' mean."""
    return [float(np.mean([r["steps"][i]["loss"] for r in ranks]))
            for i in range(len(ranks[0]["steps"]))]


def _host_cost(argv, card):
    """Host seconds of one training batch of the trajectory CLI's dataset
    (median of HOST_REPEATS after a warm call) at world 1 and for each rank
    of world 2, which replays the other rank's draws."""
    from act3d_tpu_torch.core.config import TrajectoryConfig, parse_config
    from act3d_tpu_torch.train.cli import (dataset_args, load_cli_instructions,
                                           train_dataset_args, workspace_bounds)

    cfg = parse_config(TrajectoryConfig, argv)
    out = {}
    for rank, world in ((0, 1), (0, DP_WORLD), (1, DP_WORLD)):
        common = dataset_args(cfg, load_cli_instructions(cfg), workspace_bounds(cfg), rank,
                              world, return_low_lvl_trajectory=True,
                              dense_interpolation=bool(cfg.dense_interpolation),
                              interpolation_length=cfg.interpolation_length,
                              action_dim=cfg.action_dim)
        ds = RLBenchDataset(**train_dataset_args(cfg, common))
        ds.sample_batch(cfg.batch_size)
        times = []
        for _ in range(HOST_REPEATS):
            t0 = time.perf_counter()
            ds.sample_batch(cfg.batch_size)
            times.append(time.perf_counter() - t0)
        out[f"rank{rank}_of_{world}"] = float(np.median(times)) * 1e3
    print(f"cli_dp host batch (trajectory CLI, global batch {cfg.batch_size}): "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in out.items())
          + " (median host-clock ms; world 2 decodes half the rows and replays the "
          f"other half's draws) | {card}", flush=True)
    return out


def _draw_cost(dev, card):
    """CUDA-event ms per call (50 calls back to back, dispatch included: a
    generator's offset cannot advance inside device_ms's graph capture) of
    the planner's largest elementwise dropout, a rank's 11 rows of the
    global batch 22 at 3072 x 120: at world 1 (11 rows drawn) and as rank 1
    of 2 (22 rows drawn, 11 kept)."""
    from act3d_tpu_torch.nn.dropout import dropout

    x = torch.randn(11, 3072, PLANNER_CFG["embedding_dim"], device=dev)
    out = {}
    for world in (1, DP_WORLD):
        gens = Generators.from_seed(SEED, dev, world - 1, world)

        def calls():
            for _ in range(50):
                dropout(x, DROPOUT, gens)

        calls()
        out[f"world{world}"] = _event_ms(calls, 50)
    print(f"cli_dp dropout draw (11 x 3072 x 120 rows of a rank, event-timed): world 1 "
          f"{out['world1']:.4f} ms, rank 1 of 2 {out['world2']:.4f} ms | {card}", flush=True)
    return out


def phase_cli_dp(dev, card, cli_kp, cli_traj):
    """Both training CLIs at their scripts' full widths, launched by
    torch.distributed.run: one rank over NCCL with --num_devices 1 (a DDP
    world of 1), float32, and the trajectory CLI also with
    --mixed_precision 1; their step losses before the first evaluation
    equal the non-launched runs' (cli_keypose / cli_trajectory, and a
    non-launched bf16 run here) within rtol 2e-4.  Then the trajectory CLI
    on two ranks sharing the card over gloo (--num_devices 2 --fsdp 2:
    FSDP2 on a (1, 2) mesh), its global losses against the one-process
    run's, each rank's trainable and moment bytes; its best.pt and the
    launched keypose run's are read by act3d_tpu_torch.eval.main for one
    keystep per demo.  Every spawned process is joined (subprocess.run)
    and its process group destroyed by the CLI."""
    t0 = time.perf_counter()
    per_step_kp = per_unit_launches(fused_mha_fwd=18, fused_mha_bwd=18,
                                    scatter_rows_sorted=KEYPOSE_LEVELS - 1)
    per_step_traj = per_unit_launches(fused_mha_fwd=19, fused_mha_bwd=19)
    per_step_bf16 = per_unit_launches(fused_mha_fwd_bf16=19, fused_mha_bwd_bf16=19)
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_dp_") as tmp:
        tmp = Path(tmp)
        tree, ipath = write_fixture_tree(tmp, CLI_EPISODES)

        def argv(name, flags, iters, run, *extra):
            return ["--dataset", str(tree), "--valset", str(tree), "--instructions",
                    str(ipath), "--gripper_loc_bounds", str(CLI_BOUNDS), "--tasks",
                    "pick_and_lift", "--base_log_dir", str(tmp / "logs"), "--run_log_dir", run,
                    *flags, "--val_freq", str(iters), "--train_iters", str(iters), *extra]

        kp_argv = argv("keypose", KEYPOSE_CLI_FLAGS, CLI_DP_KEYPOSE_ITERS, "kp1",
                       "--num_devices", "1")
        traj_argv = argv("trajectory", TRAJECTORY_CLI_FLAGS, CLI_DP_TRAJECTORY_ITERS, "traj1",
                         "--num_devices", "1")
        bf16_argv = argv("trajectory", TRAJECTORY_CLI_FLAGS, CLI_DP_TRAJECTORY_ITERS,
                         "traj1_bf16", "--num_devices", "1", *BF16_CLI_FLAGS)
        with recorded_steps() as bf16_ref:
            main_trajectory.main(argv("trajectory", TRAJECTORY_CLI_FLAGS,
                                      CLI_DP_TRAJECTORY_ITERS, "ref_bf16", *BF16_CLI_FLAGS))
        runs = [("keypose nccl world 1", "keypose", 1, kp_argv,
                 [s["loss"] for s in cli_kp["steps"][:CLI_DP_KEYPOSE_ITERS]], per_step_kp,
                 "nccl"),
                ("trajectory nccl world 1", "trajectory", 1, traj_argv,
                 [s["loss"] for s in cli_traj["steps"][:CLI_DP_TRAJECTORY_ITERS]],
                 per_step_traj, "nccl"),
                ("trajectory nccl world 1 bf16", "trajectory", 1, bf16_argv,
                 [s["loss"] for s in bf16_ref], per_step_bf16, "nccl"),
                ("trajectory gloo dp1 x fsdp2", "trajectory", DP_WORLD,
                 argv("trajectory", TRAJECTORY_CLI_FLAGS, CLI_DP_TRAJECTORY_ITERS, "traj2",
                      "--num_devices", str(DP_WORLD), "--fsdp", str(DP_WORLD)),
                 [s["loss"] for s in cli_traj["steps"][:CLI_DP_TRAJECTORY_ITERS]],
                 per_step_traj, "gloo")]
        launches = per_unit_launches()
        for tag, name, nproc, run_argv, want, per_step, backend in runs:
            ranks, seconds = torchrun(nproc, name, run_argv, tmp)
            got = _step_losses(ranks)
            warm = [float(np.mean([r["steps"][i]["step_s"] for r in ranks])) * 1e3
                    for i in range(1, len(got))]
            for r in ranks:
                assert r["world"] == nproc and r["backend"] == backend, r
                assert [tuple(s["launches"]) for s in r["steps"]] == [per_step] * len(got), (
                    r["steps"])
                launches = tuple(a + sum(s["launches"][i] for s in r["steps"])
                                 for i, a in enumerate(launches))
            peak = max(r["peak_memory_bytes"] for r in ranks)
            state = [(r["param_bytes"], r["moment_bytes"]) for r in ranks]
            print(f"cli_dp {tag}: step losses {got} vs non-launched {want}; warm step "
                  f"{np.mean(warm):.1f} ms (steps 1-{len(got) - 1}, mean over ranks); peak "
                  f"{peak / 2**20:.1f} MiB per rank (largest); trainable params and AdamW "
                  f"moments per rank (bytes) {state}; parameters "
                  f"{sorted({t for r in ranks for t in r['param_types']})}; launches per step "
                  f"{nonzero(per_step)} on each rank; whole launch {seconds:.1f} s | {card}",
                  flush=True)
            np.testing.assert_allclose(got, want, rtol=DP_RTOL, err_msg=tag)
            if "fsdp2" in tag:
                assert all("DTensor" in r["param_types"] for r in ranks), ranks
            out[tag] = dict(losses=got, reference=want, warm_step_ms=float(np.mean(warm)),
                            peak_memory_bytes=peak, state_bytes=state, seconds=seconds,
                            world=nproc, backend=backend)

        logs = tmp / "logs" / "exp"
        eval_argv = ["--data_dir", str(tmp), "--instructions", str(ipath),
                     "--keypose_ckpt", str(logs / "kp1" / "best.pt"),
                     "--traj_ckpt", str(logs / "traj2" / "best.pt"),
                     "--output", str(tmp / "eval.json"), "--log_dir", str(tmp / "eval_logs"),
                     *EVAL_CLI_FLAGS]
        with recorded_keysteps() as keysteps:
            results = eval_main.main(eval_argv)
        expected = per_unit_launches(fused_mha_fwd=expected_launches_per_keystep())
        assert len(keysteps) == EVAL_CLI_DEMOS and all(
            k["launches"] == expected for k in keysteps), keysteps
        launches = tuple(a + sum(k["launches"][i] for k in keysteps)
                         for i, a in enumerate(launches))
        print(f"cli_dp eval over the fsdp2 trajectory best.pt and the launched keypose "
              f"best.pt: {results} ({len(keysteps)} keysteps) | {card}", flush=True)
        out["host_ms"] = _host_cost(argv("trajectory", TRAJECTORY_CLI_FLAGS, 1, "host"), card)
    out["draw_ms"] = _draw_cost(dev, card)
    out["seconds"] = time.perf_counter() - t0
    print(f"cli_dp: {out['seconds']:.1f} s | {card}", flush=True)
    return out, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = resolve_device("cuda")  # the port's float32 policy, as every entry point sets it
    card = nvidia_smi()
    sm_mhz = sm_clock_mhz()
    print(f"device: torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    print(card, flush=True)
    print(f"max SM clock (nvidia-smi clocks.max.sm): {sm_mhz:.0f} MHz", flush=True)
    precision = float32_precision()
    print(f"tf32: matmul {precision['matmul']} cudnn conv {precision['conv']} (fp32_precision "
          f"as the port set it; ieee = float32, no TF32)", flush=True)
    assert precision == {"matmul": "ieee", "conv": "ieee"}, precision

    t0 = time.perf_counter()
    paths = _build.build()
    print(f"build: {len(paths)} CUDA source(s) in {time.perf_counter() - t0:.1f} s", flush=True)
    for src, path in paths.items():
        log = path.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "Compiling entry" in line:
                    line = line.split("'")[1] if "'" in line else line
                if "registers" in line or "spill" in line or line.startswith("_Z"):
                    print(f"ptxas {src}: {line.strip()}", flush=True)

    main_path = {}  # the launches of every kernel in each main-path phase

    def drive(phase, fn, *args):
        """Run one main-path phase with every launch count set to 0 just
        before it, and read the counts just after (and print its time)."""
        for wrapper, attr in KERNELS.values():
            setattr(wrapper, attr, 0)
        t0 = time.perf_counter()
        out = fn(*args)
        main_path[phase] = dict(zip(KERNELS, launch_counts()))
        print(f"phase {phase}: {time.perf_counter() - t0:.1f} s", flush=True)
        return out

    def add_launches(phase, launched):
        """Launches a phase's child processes counted in their wrappers."""
        for name, n in zip(KERNELS, launched):
            main_path[phase][name] += n

    rows = phase_kernels(dev, card, sm_mhz)
    phase_small_keystep(dev)
    serve_launches, latencies, memory = drive("serve", phase_serve, dev, card)
    train_fwd_rows, train_bwd_rows = phase_train_kernels(
        dev, card, TRAIN_SHAPES, PLANNER_CFG["embedding_dim"], 8, SEED + 1, sm_mhz)
    kp_fwd_rows, kp_bwd_rows = phase_train_kernels(
        dev, card, KEYPOSE_SHAPES, ACT3D_CFG["embedding_dim"], ACT3D_CFG["num_attn_heads"],
        SEED + 2, sm_mhz)
    opt_fwd_rows, opt_bwd_rows = phase_train_kernels(
        dev, card, OPTION_SHAPES, PLANNER_CFG["embedding_dim"], 8, SEED + 5, sm_mhz)
    print_plans(rows, train_fwd_rows, train_bwd_rows, kp_fwd_rows, kp_bwd_rows)
    gather_rows = phase_gather_kernels(dev, card)
    core_rows = phase_attention_core(dev, card, sm_mhz)
    chunked_row = phase_chunked(dev, card)
    bf16_rows = phase_kernels_bf16(dev, card)
    offset_s = phase_kernels_dropout_offset(dev, card)
    phase_small_train(dev)
    phase_small_keypose(dev)
    phase_small_bf16(dev)
    dp_equal, dp_launches = drive("dp_equal", phase_dp_equal, dev, card)
    add_launches("dp_equal", dp_launches)
    (train_fwd, train_bwd), train_steps, train_memory = drive("train", phase_train, dev, card)
    kp_launches, kp_steps, kp_memory = drive("train_act3d", phase_train_act3d, dev, card)
    bf16_train = drive("train_bf16", phase_train, dev, card, torch.bfloat16)
    bf16_act3d = drive("train_act3d_bf16", phase_train_act3d, dev, card, torch.bfloat16)
    per_step_kp = per_unit_launches(fused_mha_fwd=18, fused_mha_bwd=18,
                                    scatter_rows_sorted=KEYPOSE_LEVELS - 1)
    per_step_traj = per_unit_launches(fused_mha_fwd=19, fused_mha_bwd=19)
    cli_kp = drive("cli_keypose", phase_cli, dev, card, "cli_keypose", main_keypose.main,
                   KEYPOSE_CLI_FLAGS, 6, 3, per_step_kp, "mean/pos_l2_final")
    cli_traj = drive("cli_trajectory", phase_cli, dev, card, "cli_trajectory",
                     main_trajectory.main, TRAJECTORY_CLI_FLAGS, 4, 4, per_step_traj,
                     "traj_action_mse")
    per_step_options = per_unit_launches(fused_mha_fwd=19 * OPTION_BLOCKS,
                                         fused_mha_bwd=19 * OPTION_BLOCKS)
    cli_traj_opt = drive("cli_trajectory_options", phase_cli, dev, card,
                         "cli_trajectory_options", main_trajectory.main,
                         TRAJECTORY_CLI_FLAGS + TRAJECTORY_OPTION_FLAGS, 3, 3, per_step_options,
                         "traj_action_mse")
    cli_traj_quat = drive("cli_trajectory_quat", phase_cli, dev, card, "cli_trajectory_quat",
                          main_trajectory.main, TRAJECTORY_CLI_FLAGS + TRAJECTORY_QUAT_FLAGS,
                          2, 2, per_step_options, "traj_action_mse")
    with keypose_option_probes() as probes:
        cli_kp_opt = drive("cli_keypose_options", phase_cli, dev, card, "cli_keypose_options",
                           main_keypose.main, KEYPOSE_CLI_FLAGS + KEYPOSE_OPTION_FLAGS, 4, 4,
                           per_step_kp, "mean/pos_l2_final")
    rotation_grad = max(float(g) for g in probes["rotation_grads"])
    print(f"cli_keypose_options: 6D_from_top_ghost computes no rotation loss (as JAX): the "
          f"six rotation rows of gripper_state_fc2 got gradient max |g| {rotation_grad} in "
          f"{len(probes['rotation_grads']) // 2} backward(s)", flush=True)
    assert rotation_grad == 0.0 and len(probes["rotation_grads"]) >= 2 * 5, probes
    cli_kp_opt["approx_topk"] = check_approx_selection(probes["selection"], card)
    cli_eval = drive("cli_eval", phase_cli_eval, card)
    host = phase_host_path(dev, card)
    workers = host_workers()
    print(f"host-path CLI phases: {workers} workers (os.cpu_count() {os.cpu_count()})",
          flush=True)
    # the host-path CLI phases also train as --mixed_precision 1 does: bf16
    # entries in every step (the evaluations stay float32)
    per_step_kp_bf16 = per_unit_launches(fused_mha_fwd_bf16=18, fused_mha_bwd_bf16=18,
                                         scatter_rows_sorted_bf16=KEYPOSE_LEVELS - 1)
    per_step_traj_bf16 = per_unit_launches(fused_mha_fwd_bf16=19, fused_mha_bwd_bf16=19)
    cli_kp_hp = drive("cli_keypose_host_path", phase_cli, dev, card, "cli_keypose_host_path",
                      main_keypose.main, KEYPOSE_CLI_FLAGS + keypose_host_path_flags(workers)
                      + BF16_CLI_FLAGS, HOST_PATH_CLI_ITERS, HOST_PATH_CLI_ITERS,
                      per_step_kp_bf16, "mean/pos_l2_final")
    cli_traj_hp = drive("cli_trajectory_host_path", phase_cli, dev, card,
                        "cli_trajectory_host_path", main_trajectory.main,
                        TRAJECTORY_CLI_FLAGS + trajectory_host_path_flags(workers)
                        + BF16_CLI_FLAGS, HOST_PATH_CLI_ITERS, HOST_PATH_CLI_ITERS,
                        per_step_traj_bf16, "traj_action_mse")
    for single, multi in ((cli_kp, cli_kp_hp), (cli_traj, cli_traj_hp)):
        print(f"feeder wait per step: one feeder thread "
              f"{single['data_wait_steady_ms']['before_eval']:.1f} ms (steps before the first "
              f"evaluation), warm step {single['warm_step_ms']:.1f} ms, peak "
              f"{single['peak_memory_bytes'] / 2**20:.1f} MiB; {workers} workers + host-path "
              f"flags {multi['data_wait_steady_ms']['second_half']:.1f} ms (steps "
              f"{HOST_PATH_CLI_ITERS // 2}-), warm step {multi['warm_step_ms']:.1f} ms, peak "
              f"{multi['peak_memory_bytes'] / 2**20:.1f} MiB | {card}", flush=True)
    cli_dp, cli_dp_launches = drive("cli_dp", phase_cli_dp, dev, card, cli_kp, cli_traj)
    add_launches("cli_dp", cli_dp_launches)
    # the samplers' fork server (which holds torch) and resource tracker
    # would outlive this process by seconds: stop them, and leave nothing
    stop_helper_processes()
    left = child_processes()
    print(f"child processes left after the last phase: {left or 'none'}", flush=True)
    assert not left, left
    for phase, counts in main_path.items():
        print(f"main path {phase}: launches {counts}", flush=True)
        assert all(counts[f"{name}{tag}"] == 0 for name in ("attention_core",
                   "scatter_rows_chunked") for tag in ("", "_bf16")), counts
        # a bf16 phase trains on the bf16 entries alone (its evaluations run the
        # float32 forward); a float32 phase launches no bf16 entry
        if phase in BF16_PHASES:
            assert counts["fused_mha_bwd"] == counts["scatter_rows_sorted"] == 0, counts
            assert counts["fused_mha_fwd_bf16"] and counts["fused_mha_bwd_bf16"], counts
        elif phase == "cli_dp":  # float32 runs and one --mixed_precision 1 run
            assert all(counts[n] for n in ("fused_mha_fwd", "fused_mha_bwd",
                                           "scatter_rows_sorted", "fused_mha_fwd_bf16",
                                           "fused_mha_bwd_bf16")), counts
        else:
            assert not any(n for name, n in counts.items() if name.endswith("_bf16")), counts
    launches = {name: sum(c[name] for c in main_path.values()) for name in KERNELS}

    def per_unit(shape_rows, key):
        """Σ over one keystep's (or training step's) launches of the
        per-call numbers at each shape."""
        return sum(r[key[0]] * r[key[1]] for r in shape_rows if r[key[1]])

    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "ops_ms", "bytes_ms")
    mha_keys = keys + ("tc_bound_ms",)
    serve = {k: per_unit(rows, (k, "per_keystep")) for k in mha_keys + ("eager_ms",)}
    train = {k: per_unit(train_fwd_rows, (k, "per_step")) for k in mha_keys}
    bwd = {k: per_unit(train_bwd_rows, (k, "per_step")) for k in mha_keys}
    kp_fwd = {k: per_unit(kp_fwd_rows, (k, "per_step")) for k in mha_keys}
    kp_bwd = {k: per_unit(kp_bwd_rows, (k, "per_step")) for k in mha_keys}

    def total(*units):
        out = {k: sum(u[k] for u in units) for k in units[0] if all(k in u for u in units)}
        out["bound_by"] = "operations" if out["ops_ms"] >= out["bytes_ms"] else "bytes"
        return out

    fwd_total, bwd_total = total(serve, train, kp_fwd), total(bwd, kp_bwd)
    options = {name: {k: sum(r[k] * n for r, n in options_step_pairs(t_rows, o_rows))
                      for k in mha_keys}
               for name, t_rows, o_rows in (("fwd", train_fwd_rows, opt_fwd_rows),
                                            ("bwd", train_bwd_rows, opt_bwd_rows))}
    kernels = [{
        "name": "fused_mha_fwd",
        "route": "cuda",
        "source": "act3d_tpu_torch/csrc/fused_mha_fwd.cu",
        "replaces": "act3d_tpu/kernels/attention.py:212",
        "launches": launches["fused_mha_fwd"],
        "max_abs_err": max(r["max_abs_err"] for r in rows + train_fwd_rows + kp_fwd_rows
                           + opt_fwd_rows),
        **{k: fwd_total[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms", "bound_by",
                                     "tc_bound_ms")},
        "per": "one serving keystep plus one ChainedDiffuser training step plus one Act3D "
               "training step: sum over their launches of the per-call device time at each "
               "shape (serve, train and keypose_train below apart)",
        "serve": dict(serve, launches=serve_launches, keysteps=latencies, **memory),
        "train": dict(train, launches=train_fwd),
        "keypose_train": dict(kp_fwd, launches=kp_launches[0]),
        "options_train": dict(options["fwd"], launches_per_step=19 * OPTION_BLOCKS,
                              per="one training step of the 3-scale x 2-round head"),
        "shapes": rows + train_fwd_rows + kp_fwd_rows + opt_fwd_rows,
        "card": card,
    }, {
        "name": "fused_mha_bwd",
        "route": "cuda",
        "source": "act3d_tpu_torch/csrc/fused_mha_bwd.cu",
        "replaces": "act3d_tpu/kernels/attention.py:289",
        "launches": launches["fused_mha_bwd"],
        "max_abs_err": max(r["max_abs_err"] for r in train_bwd_rows + kp_bwd_rows
                           + opt_bwd_rows),
        **{k: bwd_total[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms", "bound_by",
                                     "tc_bound_ms")},
        "per": "one ChainedDiffuser training step plus one Act3D training step: sum over "
               "their launches of the per-call device time at each shape; library_ms is "
               "SDPA's forward + backward minus its forward",
        "train": dict(bwd, launches=train_bwd, train_steps=train_steps, **train_memory),
        "keypose_train": dict(kp_bwd, launches=kp_launches[1]),
        "options_train": dict(options["bwd"], launches_per_step=19 * OPTION_BLOCKS,
                              per="one training step of the 3-scale x 2-round head"),
        "shapes": train_bwd_rows + kp_bwd_rows + opt_bwd_rows,
        "card": card,
    }]
    for name, source, replaces, per_step in (
            ("scatter_rows_sorted", "act3d_tpu_torch/csrc/scatter_rows.cu",
             "act3d_tpu/kernels/gather.py:132", KEYPOSE_LEVELS - 1),
            ("scatter_rows", "act3d_tpu_torch/csrc/scatter_rows.cu",
             "act3d_tpu/kernels/gather.py:71", 0)):
        (row,) = gather_rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": row["max_abs_err"],
            **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "per": "one call at the Act3D fine-level shape (B=16, K=3072, C=60, P=49152); "
                   f"{per_step} calls per Act3D training step"
                   + ("" if per_step else " (no model path in the JAX package: the adjoint "
                      "of gather_tokens(sorted_indices=False))"),
            "per_step_ms": row["ms"] * per_step,
            "shapes": [row],
            "card": card,
        })
    kernels[2].update(keypose_train_steps=kp_steps, **kp_memory)
    core = total({k: per_unit(core_rows, (k, "per_step")) for k in mha_keys})
    kernels.append({
        "name": "attention_core", "route": "cuda",
        "source": "act3d_tpu_torch/csrc/fused_mha_fwd.cu",
        "replaces": "act3d_tpu/kernels/attention.py:823",
        "launches": launches["attention_core"],
        "max_abs_err": max(r["max_abs_err"] for r in core_rows),
        **{k: core[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms", "bound_by",
                                "tc_bound_ms")},
        "per": "no model path (as in JAX): the attention forwards of one ChainedDiffuser "
               "and one Act3D training step flattened to (B*H, L, 15), summed over their "
               "per-step launch counts; the fused forward kernel at H = 1 without stats; "
               "library_ms is SDPA",
        "shapes": core_rows,
        "card": card,
    })
    kernels.append({
        "name": "scatter_rows_chunked", "route": "cuda",
        "source": "act3d_tpu_torch/csrc/scatter_rows.cu",
        "replaces": "act3d_tpu/kernels/gather.py:236",
        "launches": launches["scatter_rows_chunked"],
        **{k: chunked_row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                       "library_ms")},
        "per": "one call at the Act3D fine-level shape (B=16, K=3072, C=60, P=49152) at "
               "JAX's p_tile=256, n_chunks=4; no model path (as in JAX)",
        "grid": chunked_row["grid"],
        "shapes": [chunked_row],
        "card": card,
    })
    bf16_sources = {"fused_mha_fwd": ("csrc/fused_mha_fwd.cu", "attention.py:212"),
                    "fused_mha_bwd": ("csrc/fused_mha_bwd.cu", "attention.py:289"),
                    "attention_core": ("csrc/fused_mha_fwd.cu", "attention.py:823"),
                    "scatter_rows_sorted": ("csrc/scatter_rows.cu", "gather.py:132"),
                    "scatter_rows": ("csrc/scatter_rows.cu", "gather.py:71"),
                    "scatter_rows_chunked": ("csrc/scatter_rows.cu", "gather.py:236")}
    bf16_per = {
        "fused_mha_fwd": "one ChainedDiffuser plus one Act3D training step in bf16: sum over "
                         "their launches of the per-call device time at each shape",
        "fused_mha_bwd": "the same; library_ms is SDPA's bf16 forward + backward minus its "
                         "forward",
        "attention_core": "no model path (as in JAX): the forwards of both training steps "
                          "flattened to (B*H, L, 15) in bf16, summed over their per-step "
                          "counts; library_ms is SDPA in bf16",
        "scatter_rows_sorted": "one call at the Act3D fine-level shape (B=16, K=3072, C=60, "
                               "P=49152) in bf16; 2 calls per Act3D training step",
        "scatter_rows": "one call at the Act3D fine-level shape in bf16; no model path",
        "scatter_rows_chunked": "one call at the Act3D fine-level shape in bf16 at JAX's "
                                "p_tile=256, n_chunks=4; no model path"}
    for base, (source, replaces) in bf16_sources.items():
        name = f"{base}_bf16"
        shape_rows = bf16_rows[name]
        if len(shape_rows) == 1:
            unit = {k: shape_rows[0][k] for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                                                  "ops_ms", "bytes_ms")}
        else:
            unit = {k: per_unit(shape_rows, (k, "per_step"))
                    for k in ("ms", "plain_ms", "bound_ms", "library_ms", "ops_ms", "bytes_ms")}
        kernels.append({
            "name": name, "route": "cuda", "source": f"act3d_tpu_torch/{source}",
            "replaces": f"act3d_tpu/kernels/{replaces}", "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in shape_rows),
            "kernel_vs_f32": max(r.get("kernel_vs_f32", 0.0) for r in shape_rows),
            "plain_vs_f32": max(r.get("plain_vs_f32", 0.0) for r in shape_rows),
            **unit, "bound_by": "operations" if unit["ops_ms"] >= unit["bytes_ms"] else "bytes",
            "dtype": "bfloat16", "per": bf16_per[base], "shapes": shape_rows, "card": card,
        })
    kernels[6].update(train_bf16=dict(zip(("launches", "steps", "memory"), bf16_train)),
                      train_act3d_bf16=dict(zip(("launches", "steps", "memory"), bf16_act3d)))
    for kernel in kernels:
        kernel["main_path_launches"] = {phase: c[kernel["name"]]
                                        for phase, c in main_path.items()}
    kernels[0].update(cli_keypose=cli_kp, cli_trajectory=cli_traj, cli_eval=cli_eval,
                      cli_trajectory_options=cli_traj_opt, cli_trajectory_quat=cli_traj_quat,
                      cli_keypose_options=cli_kp_opt,
                      cli_keypose_host_path=dict(cli_kp_hp, workers=workers),
                      cli_trajectory_host_path=dict(cli_traj_hp, workers=workers),
                      host_path=host, dp_equal=dp_equal, cli_dp=cli_dp,
                      kernels_dropout_offset_seconds=offset_s)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cli_child"]:  # one rank of phase_cli_dp's launched CLIs
        sys.exit(cli_child(sys.argv[2]))
    try:
        code = main()
    finally:  # also when a phase failed
        stop_helper_processes()
    sys.exit(code)
