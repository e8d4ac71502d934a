"""Same-call A/B of the port's float32 policy against PyTorch's default.

PyTorch runs cuDNN convolutions in TF32 (about 10 mantissa bits) unless
told otherwise; the port's entry points pin float32 matmuls and
convolutions (``act3d_tpu_torch.device.pin_float32``, applied by
``resolve_device``).  This script measures what the policy costs and what
it buys on one card, in one process, by swapping the function that
``resolve_device`` applies:

* step time: both training CLIs at their reference scripts' flags over a
  fixture tree (``chip_smoke.phase_cli``: host-clock step to a
  synchronized end, feeder wait, peak memory), in turns default, float32,
  float32, default;
* accuracy: one training step of each flagship model at its reference
  widths (batch ACCURACY_B; Act3D with injected ghost-point draws,
  ChainedDiffuser with injected noise and timesteps and dropout off) on the
  card in each mode against the same step on the CPU: the loss's relative
  gap, the non-backbone gradients' largest absolute error (and the tensor
  it is in) and their normwise relative error taken over all of them as one
  vector, and for Act3D the predicted positions that differ from the
  CPU's.

PyTorch reads cuDNN's heuristic mode once per process, at its first
convolution, so the port's choice of it (heuristic mode B, part of
``pin_float32``) is set here before anything runs and holds in both modes;
the modes differ in ``fp32_precision`` alone.

Run from the repository root on a machine with one NVIDIA H100:

    python3 scripts/ab_precision.py --out chiprun_out/ab_precision.json

Prints one line per measurement and, last, one JSON object of all of them
(also written to ``--out``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as smoke  # noqa: E402
from act3d_tpu_torch import device as device_mod  # noqa: E402
from act3d_tpu_torch.kernels import _build  # noqa: E402
from act3d_tpu_torch.train import main_keypose, main_trajectory  # noqa: E402
from act3d_tpu_torch.train.flagship import make_diffusion_model, make_keypose_model  # noqa: E402
from act3d_tpu_torch.train.losses import KeyposeLossAndMetrics  # noqa: E402
from act3d_tpu_torch.utils.testing import (  # noqa: E402
    synthetic_keypose_batch,
    synthetic_trajectory_batch,
)

PORT_PIN = device_mod.pin_float32
ACCURACY_B = 8  # the CPU takes ~10 s for one such step of either model
# steps per CLI run; the first is cold, the evaluation runs after the last
CLI_ITERS = {"cli_keypose": 20, "cli_trajectory": 12}


def use(mode: str, default: dict) -> dict:
    """Make ``resolve_device`` apply ``mode``: "float32" (the port's
    policy) or "default" (PyTorch's own values, read at start)."""
    if mode == "float32":
        pin = PORT_PIN
    else:
        def pin():
            torch.backends.cuda.matmul.fp32_precision = default["matmul"]
            torch.backends.cudnn.conv.fp32_precision = default["conv"]
    device_mod.pin_float32 = pin
    pin()
    return device_mod.float32_precision()


def keypose_step(model, batch, uniforms, device):
    model.zero_grad(set_to_none=True)
    criterion = KeyposeLossAndMetrics()
    action = batch["action"].to(device)
    pred = model(*(batch[k].to(device) for k in smoke.KEYPOSE_KEYS), gt_action=action,
                 ghost_uniforms=[u.to(device) for u in uniforms])
    loss = sum(criterion.compute_loss(pred, action).values())
    loss.backward()
    return (loss.item(), _grads(model),
            [p.detach().cpu() for p in pred["position_pyramid"]])


def diffusion_step(model, batch, noise, timesteps, device):
    model.zero_grad(set_to_none=True)
    loss = model(*(batch[k].to(device) for k in smoke.SMALL_KEYS), noise=noise.to(device),
                 timesteps=timesteps.to(device))
    loss.backward()
    return loss.item(), _grads(model), []


def _grads(model):
    return {n: p.grad.detach().cpu() for n, p in model.named_parameters()
            if p.grad is not None and "backbone" not in n}


def accuracy(dev, b, default):
    """Each flagship model's training step on the CPU, then on the card in
    each mode from the same weights and inputs."""
    rng = np.random.default_rng(smoke.SEED)
    n = 1000 // smoke.KEYPOSE_LEVELS
    uniforms = [torch.from_numpy(rng.uniform(size=(b, n if i == 0 else 4 * n, 3))
                                 .astype(np.float32)) for i in range(smoke.KEYPOSE_LEVELS)]
    noise = torch.from_numpy(rng.normal(size=(b, smoke.TRAJ_LEN, 9)).astype(np.float32))
    timesteps = torch.from_numpy(rng.integers(0, 100, size=b))
    models = {
        "act3d": (make_keypose_model, synthetic_keypose_batch(
            b, smoke.NCAM, (256, 256), seed=smoke.SEED),
            lambda m, batch, d: keypose_step(m.train(), batch, uniforms, d)),
        "chained_diffuser": (make_diffusion_model, synthetic_trajectory_batch(
            b, smoke.NCAM, (256, 256), smoke.TRAJ_LEN, seed=smoke.SEED),
            lambda m, batch, d: diffusion_step(m.eval(), batch, noise, timesteps, d)),
    }
    out = {}
    for name, (make, batch, step) in models.items():
        torch.manual_seed(smoke.SEED)
        cpu_model = make(device="cpu")
        t0 = time.perf_counter()
        cpu_loss, cpu_grads, cpu_pos = step(cpu_model, batch, "cpu")
        print(f"accuracy {name}: CPU step {time.perf_counter() - t0:.1f} s, loss "
              f"{cpu_loss:.8f}", flush=True)
        for mode in ("default", "float32"):
            precision = use(mode, default)
            card_model = make(device=dev)
            card_model.load_state_dict(cpu_model.state_dict())
            loss, grads, pos = step(card_model, batch, dev)
            assert grads.keys() == cpu_grads.keys()
            errs = {k: float((grads[k] - cpu_grads[k]).abs().max()) for k in cpu_grads}
            worst = max(errs, key=errs.get)
            norm_rel = float(torch.cat([(grads[k] - cpu_grads[k]).flatten() for k in cpu_grads])
                             .norm() / torch.cat([g.flatten() for g in cpu_grads.values()])
                             .norm())
            flips = [int((~torch.isclose(p, q, atol=1e-4, rtol=0).all(-1)).sum())
                     for p, q in zip(pos, cpu_pos)]
            row = dict(precision=precision, loss=loss, cpu_loss=cpu_loss,
                       loss_rel_gap=abs(loss - cpu_loss) / abs(cpu_loss),
                       grad_max_abs=errs[worst], grad_max_abs_in=worst,
                       grad_norm_rel=norm_rel, n_grads=len(grads),
                       positions_off_per_level=flips)
            out[f"{name}.{mode}"] = row
            print(f"accuracy {name} {mode} (matmul {precision['matmul']}, conv "
                  f"{precision['conv']}): loss {loss:.8f}, card vs CPU relative gap "
                  f"{row['loss_rel_gap']:.3e}; {len(grads)} gradients max_abs "
                  f"{errs[worst]:.3e} (in {worst}), normwise relative {norm_rel:.3e}"
                  + (f"; positions off the CPU's per level {flips} of {b}" if flips else ""),
                  flush=True)
            del card_model
            torch.cuda.empty_cache()
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=REPO / "profiles" / "ab_precision.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("ab_precision: no CUDA device", file=sys.stderr)
        return 1
    default = device_mod.float32_precision()  # before any entry point pins
    os.environ[device_mod.CUDNN_HEURISTIC_MODE_B] = "1"  # before the first convolution
    dev = torch.device("cuda")
    card = smoke.nvidia_smi()
    print(card, flush=True)
    print(f"PyTorch's default fp32_precision: {default}", flush=True)
    _build.build()

    per_kp = smoke.per_unit_launches(fused_mha_fwd=18, fused_mha_bwd=18,
                                     scatter_rows_sorted=smoke.KEYPOSE_LEVELS - 1)
    per_traj = smoke.per_unit_launches(fused_mha_fwd=19, fused_mha_bwd=19)
    clis = {"cli_keypose": (main_keypose.main, smoke.KEYPOSE_CLI_FLAGS, per_kp,
                            "mean/pos_l2_final"),
            "cli_trajectory": (main_trajectory.main, smoke.TRAJECTORY_CLI_FLAGS, per_traj,
                               "traj_action_mse")}
    runs = []
    for turn, mode in enumerate(("default", "float32", "float32", "default")):
        precision = use(mode, default)
        for name, (main_fn, flags, per_step, metric) in clis.items():
            print(f"turn {turn} {mode} {precision}: {name}", flush=True)
            iters = CLI_ITERS[name]
            res = smoke.phase_cli(dev, card, name, main_fn, flags, iters, iters, per_step,
                                  metric)
            assert device_mod.float32_precision() == precision
            warm = [st["step_s"] * 1e3 for st in res["steps"][1:]]
            runs.append(dict(turn=turn, mode=mode, precision=precision, cli=name,
                             warm_step_ms_mean=float(np.mean(warm)),
                             warm_step_ms_median=float(np.median(warm)),
                             warm_step_ms=warm, losses=[st["loss"] for st in res["steps"]],
                             data_wait_ms=res["data_wait_ms"],
                             peak_memory_bytes=res["peak_memory_bytes"],
                             eval_metric=[ev["metric"] for ev in res["evals"]]))
    for name in clis:
        mine = [r for r in runs if r["cli"] == name]
        print(f"{name}: warm step median ms per turn (default, float32, float32, default) "
              + " / ".join(f"{r['warm_step_ms_median']:.1f}" for r in mine)
              + "; step-0 loss " + " / ".join(f"{r['losses'][0]:.6f}" for r in mine)
              + "; peak MiB " + " / ".join(f"{r['peak_memory_bytes'] / 2**20:.1f}"
                                           for r in mine) + f" | {card}", flush=True)

    result = dict(card=card, default=default, cli=runs,
                  accuracy=accuracy(dev, ACCURACY_B, default))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
