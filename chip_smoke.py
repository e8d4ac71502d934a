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
     that every attention site launched the kernel.
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
from act3d_tpu_torch.kernels.attention import fused_mha_forward, fused_mha_forward_reference
from act3d_tpu_torch.models import Act3D, DiffusionPlanner

ATOL, RTOL = 2e-5, 1e-4
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


def expected_launches_per_keystep() -> int:
    a, p = ACT3D_CFG, PLANNER_CFG
    act3d = a["num_sampling_level"] * (
        a["num_vis_ins_attn_layers"] + a["num_ghost_point_cross_attn_layers"]
        + a["num_query_cross_attn_layers"])
    # vl_attention + traj_lang_attention + (cross + self) per layer of the
    # traj (query_layers - 2), pos (2) and rot (2) stacks
    per_step = (p["num_vis_ins_attn_layers"] + 1
                + 2 * (p["num_query_cross_attn_layers"] - 2) + 2 * 2 + 2 * 2)
    return act3d + p["diffusion_timesteps"] * per_step


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
    launches, latencies, memory = phase_serve(dev, card)

    on_path = [r for r in rows if r["per_keystep"]]
    ops = sum(r["per_keystep"] * r["ops_ms"] for r in on_path)
    nbytes = sum(r["per_keystep"] * r["bytes_ms"] for r in on_path)
    kernels = [{
        "name": "fused_mha_fwd",
        "route": "cuda",
        "source": "act3d_tpu_torch/csrc/fused_mha_fwd.cu",
        "replaces": "act3d_tpu/kernels/attention.py:212",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["per_keystep"] * r["ms"] for r in on_path),
        "plain_ms": sum(r["per_keystep"] * r["plain_ms"] for r in on_path),
        "bound_ms": sum(r["per_keystep"] * r["bound_ms"] for r in on_path),
        "bound_by": "operations" if ops >= nbytes else "bytes",
        "library_ms": sum(r["per_keystep"] * r["library_ms"] for r in on_path),
        "eager_ms": sum(r["per_keystep"] * r["eager_ms"] for r in on_path),
        "per": "one keystep: sum over its launches at the shapes below; ms, plain_ms and "
               "library_ms are device times, eager_ms includes host dispatch",
        "shapes": rows,
        "keysteps": latencies,
        **memory,
        "card": card,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
