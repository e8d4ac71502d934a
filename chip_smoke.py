"""On-card smoke test of the PyTorch/CUDA port (act3d_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero):
  1. device: torch/CUDA versions, the card's name and power limit; TF32
     is switched off for matmuls and convolutions.
  2. build: nvcc builds every CUDA source of the port for sm_90a.
  3. kernel: the fused-MHA forward kernel against its plain PyTorch
     version at every attention shape of the serving keystep (plus a
     padded-key mask and a fully masked row), atol 2e-5 / rtol 1e-4 on
     out and stats; device times (calls replayed from a CUDA graph) of
     the kernel, the plain version and torch's
     scaled_dot_product_attention (timing yardstick only), and the
     kernel's time per eager call from Python.
  4. small keystep: the chained Actioner at a small size on the card
     against the same weights and injected samples on the CPU.
  5. serve: the Actioner at the reference widths (Act3D emb 60 / 3
     levels / 10000 ghost points; DiffusionPlanner emb 120 / 6 layers /
     100 steps; 3 cameras at 256^2; trajectory length 50), seeded random
     weights, 3 keysteps; checks shapes, finiteness, unit quaternions and
     that every attention site launched the forward kernel (1918 per
     keystep) and none the backward.
  6. training kernels: the fused-MHA forward with dropout (rate 0.1) and
     the fused-MHA backward against their plain versions at every
     attention shape of the ChainedDiffuser training step (B=16), plus a
     padded-key mask, a fully masked row and rate 0; the keep fraction of
     the hash mask; device times of both kernels, their plain versions and
     SDPA (forward, and backward through autograd as forward + backward
     minus forward, at dropout_p=0: timing yardstick only).
  7. small training step: loss and every trainable gradient on the card
     against the CPU (same weights, injected noise and timesteps, dropout
     off); a dropout-on step run twice gives identical gradients.
  8. train: the flagship ChainedDiffuser (emb 120, 8 heads, 6 query
     layers, dropout 0.1, 3 cameras at 256^2, trajectory length 50) takes
     5 Trainer steps at batch 16 on a seeded synthetic batch; checks finite
     losses, changed trainable params, a bit-identical backbone and 19
     forward + 19 backward kernel launches per step; prints step times and
     peak memory.
The second-to-last line is a JSON object of kernel numbers; the last is
{"ok": true, "device": {...}}.  Without a card it exits non-zero before
printing any result.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from act3d_tpu_torch.eval.actioner import Actioner
from act3d_tpu_torch.kernels import _build
from act3d_tpu_torch.kernels.attention import (
    dropout_keep,
    fused_mha_backward,
    fused_mha_backward_reference,
    fused_mha_forward,
    fused_mha_forward_reference,
)
from act3d_tpu_torch.models import Act3D, DiffusionPlanner
from act3d_tpu_torch.nn.dropout import Generators
from act3d_tpu_torch.train.engine import Trainer
from act3d_tpu_torch.train.flagship import diffusion_loss_fn, make_diffusion_model
from act3d_tpu_torch.utils.testing import synthetic_trajectory_batch

ATOL, RTOL = 2e-5, 1e-4
# backward kernel vs its plain version: float32 sums over up to 3072 rows
# (dk, dv) or 3074 keys (dq) taken in another order than the plain
# version's matmuls; the expected error is ~1e-5 at these magnitudes
BWD_ATOL, BWD_RTOL = 1e-4, 1e-3
PEAK_F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
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


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


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


def bound(l, s, e, h, b, masked):
    flops = 4.0 * b * l * s * e
    nbytes = 4.0 * (2 * b * l * e + 2 * b * s * e + 2 * b * l * h) + (b * s if masked else 0)
    return flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


def bound_bwd(l, s, e, h, b, masked):
    """Five (L, S, d) products per head; the wrapper reads q, out, dO, k,
    v, stats (and the mask) and writes dq, dk, dv, each byte once."""
    flops = 10.0 * b * l * s * e
    nbytes = 4.0 * (4 * b * l * e + 4 * b * s * e + 2 * b * l * h) + (b * s if masked else 0)
    return flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


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


def phase_kernels(dev, card):
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
                   ops_ms=t_ops, bytes_ms=t_bytes)
        rows.append(row)
        print(f"kernel {site:24s} B={b} L={l} S={s} E={e} H={h} mask={kind}: "
              f"max_abs {err:.3e} max_rel {rel:.3e} | kernel {ms:.4f} ms (eager call "
              f"{kernel_eager_ms:.4f} ms), plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, "
              f"bound {row['bound_ms']:.5f} ms ({row['bound_by']}) | {card}", flush=True)
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


def phase_train_kernels(dev, card):
    """Both kernels at the training shapes, with dropout, against their
    plain versions; device times beside the bound, plain and SDPA."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    side = torch.cuda.Stream()
    b, e, h = TRAIN_B, PLANNER_CFG["embedding_dim"], 8
    d = e // h
    fwd_rows, bwd_rows = [], []
    for i, (site, l, s, kind, rate, per_step) in enumerate(TRAIN_SHAPES):
        mask = train_mask(kind, b, s, dev)
        seed = 1000 + i if rate else None
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
                             library_ms=lib_fwd, **_bound_row(*bound(l, s, e, h, b, kind))))
        bwd_rows.append(dict(common, max_abs_err=bwd_err[0], max_rel_err=bwd_err[1],
                             ms=bwd_ms, plain_ms=bwd_plain, library_ms=lib_bwd,
                             library_fwd_bwd_ms=lib_fwd_bwd,
                             **_bound_row(*bound_bwd(l, s, e, h, b, kind))))
        print(f"train kernel {site:28s} fwd {fwd_ms:.4f} ms (plain {fwd_plain:.4f}, sdpa "
              f"{lib_fwd:.4f}, bound {fwd_rows[-1]['bound_ms']:.5f} "
              f"{fwd_rows[-1]['bound_by']}) | bwd {bwd_ms:.4f} ms (plain {bwd_plain:.4f}, "
              f"sdpa {lib_bwd:.4f}, bound {bwd_rows[-1]['bound_ms']:.5f} "
              f"{bwd_rows[-1]['bound_by']}) | {card}", flush=True)
    return fwd_rows, bwd_rows


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
    fused_mha_forward.launches = 0
    fused_mha_backward.launches = 0
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
    fused_mha_forward.launches = 0
    fused_mha_backward.launches = 0
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
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    print(f"device: torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    print(card, flush=True)
    print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn {torch.backends.cudnn.allow_tf32}", flush=True)

    t0 = time.perf_counter()
    paths = _build.build()
    print(f"build: {len(paths)} CUDA source(s) in {time.perf_counter() - t0:.1f} s", flush=True)
    for src, path in paths.items():
        log = path.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"ptxas {src}: {line.strip()}", flush=True)

    rows = phase_kernels(dev, card)
    phase_small_keystep(dev)
    serve_launches, latencies, memory = phase_serve(dev, card)
    train_fwd_rows, train_bwd_rows = phase_train_kernels(dev, card)
    phase_small_train(dev)
    (train_fwd, train_bwd), train_steps, train_memory = phase_train(dev, card)

    def per_unit(shape_rows, key):
        """Σ over one keystep's (or training step's) launches of the
        per-call numbers at each shape."""
        return sum(r[key[0]] * r[key[1]] for r in shape_rows if r[key[1]])

    serve = {k: per_unit(rows, (k, "per_keystep"))
             for k in ("ms", "plain_ms", "bound_ms", "library_ms", "eager_ms", "ops_ms",
                       "bytes_ms")}
    train = {k: per_unit(train_fwd_rows, (k, "per_step"))
             for k in ("ms", "plain_ms", "bound_ms", "library_ms", "ops_ms", "bytes_ms")}
    bwd = {k: per_unit(train_bwd_rows, (k, "per_step"))
           for k in ("ms", "plain_ms", "bound_ms", "library_ms", "ops_ms", "bytes_ms")}
    kernels = [{
        "name": "fused_mha_fwd",
        "route": "cuda",
        "source": "act3d_tpu_torch/csrc/fused_mha_fwd.cu",
        "replaces": "act3d_tpu/kernels/attention.py:212",
        "launches": serve_launches + train_fwd,
        "max_abs_err": max(r["max_abs_err"] for r in rows + train_fwd_rows),
        **{k: serve[k] + train[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "bound_by": ("operations" if serve["ops_ms"] + train["ops_ms"]
                     >= serve["bytes_ms"] + train["bytes_ms"] else "bytes"),
        "per": "one serving keystep plus one training step: sum over their launches of "
               "the per-call device time at each shape (serve and train below apart)",
        "serve": dict(serve, launches=serve_launches, keysteps=latencies, **memory),
        "train": dict(train, launches=train_fwd),
        "shapes": rows + train_fwd_rows,
        "card": card,
    }, {
        "name": "fused_mha_bwd",
        "route": "cuda",
        "source": "act3d_tpu_torch/csrc/fused_mha_bwd.cu",
        "replaces": "act3d_tpu/kernels/attention.py:289",
        "launches": train_bwd,
        "max_abs_err": max(r["max_abs_err"] for r in train_bwd_rows),
        **{k: bwd[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "bound_by": "operations" if bwd["ops_ms"] >= bwd["bytes_ms"] else "bytes",
        "per": "one training step: sum over its launches of the per-call device time at "
               "each shape; library_ms is SDPA's forward + backward minus its forward",
        "train_steps": train_steps,
        **train_memory,
        "shapes": train_bwd_rows,
        "card": card,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
