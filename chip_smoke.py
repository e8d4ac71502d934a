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
Every main-path phase (serve, train, train_act3d and the two CLIs) runs
with all launch counts set to 0 just before it and read just after.
The second-to-last line is a JSON object of kernel numbers (six kernels);
the last is {"ok": true, "device": {...}}.  Without a card it exits
non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import gc
import json
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from act3d_tpu_torch.data.feeder import DeviceFeeder
from act3d_tpu_torch.data.fixtures import make_dataset_tree, make_instructions
from act3d_tpu_torch.device import float32_precision, resolve_device
from act3d_tpu_torch.eval.actioner import Actioner
from act3d_tpu_torch.kernels import _build
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
    diffusion_loss_fn,
    keypose_loss_fn,
    keypose_metrics_fn,
    make_diffusion_model,
    make_keypose_model,
)
from act3d_tpu_torch.train.losses import KeyposeLossAndMetrics
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
# Every kernel of the port, by the name the kernel line gives it.
KERNELS = {"fused_mha_fwd": fused_mha_forward, "fused_mha_bwd": fused_mha_backward,
           "scatter_rows_sorted": scatter_rows_sorted, "scatter_rows": scatter_rows,
           "scatter_rows_chunked": scatter_rows_chunked, "attention_core": attention_core}
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


def planner_sites_per_denoise() -> int:
    """Attention cores of one DiffusionHead.denoise: vl_attention +
    traj_lang_attention + (cross + self) per layer of the traj
    (query_layers - 2), pos (2) and rot (2) stacks."""
    p = PLANNER_CFG
    return (p["num_vis_ins_attn_layers"] + 1
            + 2 * (p["num_query_cross_attn_layers"] - 2) + 2 * 2 + 2 * 2)


def expected_launches_per_keystep() -> int:
    a, p = ACT3D_CFG, PLANNER_CFG
    act3d = a["num_sampling_level"] * (
        a["num_vis_ins_attn_layers"] + a["num_ghost_point_cross_attn_layers"]
        + a["num_query_cross_attn_layers"])
    return act3d + p["diffusion_timesteps"] * planner_sites_per_denoise()


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


def phase_train(dev, card):
    """Trainer steps of the flagship ChainedDiffuser at batch 16."""
    torch.manual_seed(SEED)
    model = make_diffusion_model(device=dev)
    batch = synthetic_trajectory_batch(TRAIN_B, NCAM, (256, 256), TRAJ_LEN, seed=SEED,
                                       device=dev)
    trainer = Trainer(diffusion_loss_fn(model), model, lr=1e-4, weight_decay=5e-4, seed=SEED)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    per_step = planner_sites_per_denoise()
    assert per_step == sum(r[-1] for r in TRAIN_SHAPES) == 19, per_step
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    steps = []
    for i in range(TRAIN_STEPS):
        fwd0, bwd0 = fused_mha_forward.launches, fused_mha_backward.launches
        t0 = time.perf_counter()
        loss = trainer.step(batch)["loss"].item()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = (fused_mha_forward.launches - fwd0, fused_mha_backward.launches - bwd0)
        assert np.isfinite(loss), loss
        assert launched == (per_step, per_step), launched
        steps.append(dict(step=i, seconds=seconds, loss=loss, fwd_launches=launched[0],
                          bwd_launches=launched[1]))
        print(f"train step {i}: {seconds * 1e3:.1f} ms, loss {loss:.4f}, {launched[0]} "
              f"fused_mha_fwd + {launched[1]} fused_mha_bwd launches | {card}", flush=True)
    launches = (fused_mha_forward.launches, fused_mha_backward.launches)
    assert scatter_rows_sorted.launches == scatter_rows.launches == 0
    peak = torch.cuda.max_memory_allocated()
    changed, unchanged = 0, []
    for n, p in model.named_parameters():
        if "backbone" in n:
            assert torch.equal(p, before[n]), n
        elif torch.equal(p, before[n]):
            unchanged.append(n)
        else:
            changed += 1
    # only the biases of FPN levels the model does not read (zero gradient,
    # no decay) may stay as they were
    assert changed and all("feature_pyramid" in n and n.endswith("bias")
                           for n in unchanged), unchanged
    warm = [s["seconds"] for s in steps[1:]]
    print(f"train: warm step {np.mean(warm) * 1e3:.1f} ms (mean of steps 1-{TRAIN_STEPS - 1}; "
          f"min {min(warm) * 1e3:.1f}, max {max(warm) * 1e3:.1f}); peak memory "
          f"{peak / 2**20:.1f} MiB, resident before the first step {resident / 2**20:.1f} MiB; "
          f"{changed} trainable tensors changed, backbone unchanged | {card}", flush=True)
    return launches, steps, dict(peak_memory_bytes=peak, resident_memory_bytes=resident)


def phase_train_act3d(dev, card):
    """Trainer steps of the flagship Act3D keypose model at batch 16, then
    one evaluation at 10000 ghost points."""
    torch.manual_seed(SEED)
    model = make_keypose_model(device=dev)
    batch = synthetic_keypose_batch(TRAIN_B, NCAM, (256, 256), seed=SEED, device=dev)
    criterion = KeyposeLossAndMetrics()
    trainer = Trainer(keypose_loss_fn(model, criterion), model,
                      metrics_fn=keypose_metrics_fn(model, criterion), lr=1e-4,
                      weight_decay=5e-4, seed=SEED)
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
        start = [fn.launches for fn in counters]
        t0 = time.perf_counter()
        out = trainer.step(batch)
        loss = out["loss"].item()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = tuple(fn.launches - n for fn, n in zip(counters, start))
        assert np.isfinite(loss), loss
        assert launched == (per_step, per_step, gathers, 0), launched
        steps.append(dict(step=i, seconds=seconds, loss=loss, fwd_launches=launched[0],
                          bwd_launches=launched[1], gather_launches=launched[2]))
        parts = ", ".join(f"{k} {v.item():.4f}" for k, v in out.items() if k != "loss")
        print(f"train_act3d step {i}: {seconds * 1e3:.1f} ms, loss {loss:.4f} ({parts}); "
              f"{launched[0]} fused_mha_fwd + {launched[1]} fused_mha_bwd + {launched[2]} "
              f"scatter_rows_sorted launches | {card}", flush=True)
    launches = tuple(fn.launches for fn in counters)
    peak = torch.cuda.max_memory_allocated()
    changed, unchanged = 0, []
    for n, p in model.named_parameters():
        if "backbone" in n:
            assert torch.equal(p, before[n]), n
        elif torch.equal(p, before[n]):
            unchanged.append(n)
        else:
            changed += 1
    # only the biases of FPN levels the model does not read (zero gradient,
    # no decay) may stay as they were
    assert changed and all("feature_pyramid" in n and n.endswith("bias")
                           for n in unchanged), unchanged
    warm = [st["seconds"] for st in steps[1:]]
    print(f"train_act3d: warm step {np.mean(warm) * 1e3:.1f} ms (mean of steps "
          f"1-{TRAIN_STEPS - 1}; min {min(warm) * 1e3:.1f}, max {max(warm) * 1e3:.1f}); "
          f"peak memory {peak / 2**20:.1f} MiB, resident before the first step "
          f"{resident / 2**20:.1f} MiB; {changed} trainable tensors changed, backbone "
          f"unchanged | {card}", flush=True)

    eval_batch = {k: v[:KEYPOSE_EVAL_B] for k, v in batch.items()}
    start = [fn.launches for fn in counters]
    t0 = time.perf_counter()
    metrics = trainer.evaluate([eval_batch])
    seconds = time.perf_counter() - t0
    launched = tuple(fn.launches - n for fn, n in zip(counters, start))
    assert launched == (per_step, 0, 0, 0), launched
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    print(f"train_act3d evaluate: batch {KEYPOSE_EVAL_B}, "
          f"{ACT3D_CFG['num_ghost_points_val']} ghost points, {seconds * 1e3:.1f} ms; "
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
        start = [fn.launches for fn in KERNELS.values()]
        number = self.step_count
        t0 = time.perf_counter()
        out = step(self, batch)
        loss = out["loss"].item()
        torch.cuda.synchronize()
        records.append(dict(
            step=number, loss=loss, step_s=time.perf_counter() - t0,
            data_wait_s=waits[-1] if waits else 0.0,
            launches=tuple(fn.launches - n for fn, n in zip(KERNELS.values(), start))))
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
                  f"launches {dict(zip(KERNELS, st['launches']))} | {card}", flush=True)
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
    print(f"{name}: warm step {np.mean(warm) * 1e3:.1f} ms (mean of steps 1-{iters - 1}; "
          f"min {min(warm) * 1e3:.1f}, max {max(warm) * 1e3:.1f}); feeder wait per step "
          f"mean {np.mean(waits) * 1e3:.1f} ms (steps 1-: {np.mean(waits[1:]) * 1e3:.1f} ms), "
          f"max {max(waits) * 1e3:.1f} ms; peak memory {peak / 2**20:.1f} MiB; evaluations "
          + ", ".join(f"{ev['seconds']:.2f} s ({metric} {ev['val'][metric]:.4f})"
                      for ev in evals)
          + f"; resumed at step {iters}; whole run {seconds:.1f} s, fixture tree "
          f"{write_s:.1f} s | {card}", flush=True)
    return dict(steps=steps, evals=[dict(step=ev["step"], seconds=ev["seconds"],
                                         metric=ev["val"][metric]) for ev in evals],
                warm_step_ms=np.mean(warm) * 1e3, data_wait_ms=np.mean(waits) * 1e3,
                peak_memory_bytes=peak, seconds=seconds, launches_per_step=per_step)


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
        before it, and read the counts just after."""
        for kernel in KERNELS.values():
            kernel.launches = 0
        out = fn(*args)
        main_path[phase] = {name: kernel.launches for name, kernel in KERNELS.items()}
        return out

    rows = phase_kernels(dev, card, sm_mhz)
    phase_small_keystep(dev)
    serve_launches, latencies, memory = drive("serve", phase_serve, dev, card)
    train_fwd_rows, train_bwd_rows = phase_train_kernels(
        dev, card, TRAIN_SHAPES, PLANNER_CFG["embedding_dim"], 8, SEED + 1, sm_mhz)
    kp_fwd_rows, kp_bwd_rows = phase_train_kernels(
        dev, card, KEYPOSE_SHAPES, ACT3D_CFG["embedding_dim"], ACT3D_CFG["num_attn_heads"],
        SEED + 2, sm_mhz)
    print_plans(rows, train_fwd_rows, train_bwd_rows, kp_fwd_rows, kp_bwd_rows)
    gather_rows = phase_gather_kernels(dev, card)
    core_rows = phase_attention_core(dev, card, sm_mhz)
    chunked_row = phase_chunked(dev, card)
    phase_small_train(dev)
    phase_small_keypose(dev)
    (train_fwd, train_bwd), train_steps, train_memory = drive("train", phase_train, dev, card)
    kp_launches, kp_steps, kp_memory = drive("train_act3d", phase_train_act3d, dev, card)
    per_step_kp = (18, 18, KEYPOSE_LEVELS - 1, 0, 0, 0)  # in KERNELS order
    per_step_traj = (19, 19, 0, 0, 0, 0)
    cli_kp = drive("cli_keypose", phase_cli, dev, card, "cli_keypose", main_keypose.main,
                   KEYPOSE_CLI_FLAGS, 6, 3, per_step_kp, "mean/pos_l2_final")
    cli_traj = drive("cli_trajectory", phase_cli, dev, card, "cli_trajectory",
                     main_trajectory.main, TRAJECTORY_CLI_FLAGS, 4, 4, per_step_traj,
                     "traj_action_mse")
    for phase, counts in main_path.items():
        print(f"main path {phase}: launches {counts}", flush=True)
        assert counts["attention_core"] == counts["scatter_rows_chunked"] == 0, counts
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
    kernels = [{
        "name": "fused_mha_fwd",
        "route": "cuda",
        "source": "act3d_tpu_torch/csrc/fused_mha_fwd.cu",
        "replaces": "act3d_tpu/kernels/attention.py:212",
        "launches": launches["fused_mha_fwd"],
        "max_abs_err": max(r["max_abs_err"] for r in rows + train_fwd_rows + kp_fwd_rows),
        **{k: fwd_total[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms", "bound_by",
                                     "tc_bound_ms")},
        "per": "one serving keystep plus one ChainedDiffuser training step plus one Act3D "
               "training step: sum over their launches of the per-call device time at each "
               "shape (serve, train and keypose_train below apart)",
        "serve": dict(serve, launches=serve_launches, keysteps=latencies, **memory),
        "train": dict(train, launches=train_fwd),
        "keypose_train": dict(kp_fwd, launches=kp_launches[0]),
        "shapes": rows + train_fwd_rows + kp_fwd_rows,
        "card": card,
    }, {
        "name": "fused_mha_bwd",
        "route": "cuda",
        "source": "act3d_tpu_torch/csrc/fused_mha_bwd.cu",
        "replaces": "act3d_tpu/kernels/attention.py:289",
        "launches": launches["fused_mha_bwd"],
        "max_abs_err": max(r["max_abs_err"] for r in train_bwd_rows + kp_bwd_rows),
        **{k: bwd_total[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms", "bound_by",
                                     "tc_bound_ms")},
        "per": "one ChainedDiffuser training step plus one Act3D training step: sum over "
               "their launches of the per-call device time at each shape; library_ms is "
               "SDPA's forward + backward minus its forward",
        "train": dict(bwd, launches=train_bwd, train_steps=train_steps, **train_memory),
        "keypose_train": dict(kp_bwd, launches=kp_launches[1]),
        "shapes": train_bwd_rows + kp_bwd_rows,
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
    for kernel in kernels:
        kernel["main_path_launches"] = {phase: c[kernel["name"]]
                                        for phase, c in main_path.items()}
    kernels[0].update(cli_keypose=cli_kp, cli_trajectory=cli_traj)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
