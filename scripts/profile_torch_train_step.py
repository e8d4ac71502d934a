"""Where the time and memory of one training step of the PyTorch port go,
on the card.

Builds the flagship model and batch of one of chip_smoke.py's training
phases (seeded random weights, batch 16, 3 cameras at 256^2):
  * ``--model diffusion`` (phase train): the ChainedDiffuser, emb 120, 6
    query layers, dropout 0.1, trajectory length 50;
  * ``--model keypose`` (phase train_act3d): Act3D, emb 60, 1000 training
    ghost points over 3 levels, gt-biased fine sampling, the keypose loss;
in float32, or with ``--mixed_precision 1`` in bf16 as the CLIs' flag
trains (``compute_dtype=torch.bfloat16``: bf16 copies of the params and
inputs, the kernels' bf16 entries, float32 master state); takes two
warm-up Trainer steps, then one step under torch.profiler, and prints:
  * the step's host-clock time, device busy time (the union of kernel
    intervals) and the device's idle share;
  * kernel time by name (top 15) and by kind (convolution, attention,
    row scatter, GEMM, other), the kernel launch count, and the device time
    of the port's kernels (fused_mha_fwd, fused_mha_bwd, and for Act3D the
    row-scatter kernels);
  * the device busy time of the step's spans (train.step, train.forward,
    train.backward, train.optimizer: train/profiling.py::span_times);
  * peak device memory of the frozen visual trunk alone (no grad), of the
    loss forward, and of forward + backward + AdamW.
The Chrome trace goes to <out>/<model>[_bf16]_train_step_trace.json.gz
(default out dir: profiles/, listed in .gitignore).

Run from the repository root on the card:
    python3 scripts/profile_torch_train_step.py [--model diffusion|keypose]
        [--mixed_precision 0|1] [--out DIR]
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

import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

from act3d_tpu_torch.train.engine import Trainer  # noqa: E402
from act3d_tpu_torch.train.flagship import (  # noqa: E402
    cast_params,
    diffusion_loss_fn,
    keypose_loss_fn,
    make_diffusion_model,
    make_keypose_model,
)
from act3d_tpu_torch.train.losses import KeyposeLossAndMetrics  # noqa: E402
from act3d_tpu_torch.train.profiling import span_times, union_us  # noqa: E402
from act3d_tpu_torch.utils.testing import (  # noqa: E402
    synthetic_keypose_batch,
    synthetic_trajectory_batch,
)


# kernel-name fragments of each kind of device work (cuDNN's convolution
# kernels: implicit GEMM, FFT, Winograd and their filter flips)
KINDS = (
    ("attention", ("mha_",)),
    ("row_scatter", ("scatter_rows", "slot_map")),
    ("convolution", ("fprop", "dgrad", "wgrad", "fft", "complex", "winograd", "convolve",
                     "flip_filter")),
    ("gemm", ("gemm",)),
)


def kind_of(name: str) -> str:
    for kind, fragments in KINDS:
        if any(f in name for f in fragments):
            return kind
    return "other"


def _peak_mib(fn) -> float:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**20


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", choices=("diffusion", "keypose"), default="diffusion",
                        help="which flagship training step to profile")
    parser.add_argument("--mixed_precision", type=int, default=0,
                        help="1: the bf16 step of --mixed_precision 1")
    parser.add_argument("--out", default=str(REPO / "profiles"),
                        help="directory for the Chrome trace")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_train_step: no CUDA device", file=sys.stderr)
        return 1
    card = cs.nvidia_smi()
    print(card, flush=True)
    dtype = torch.bfloat16 if args.mixed_precision else None
    tag = f"{args.model}_bf16" if dtype else args.model

    def run_trunk(visual, rgbs, pcds):
        if dtype is None:
            return visual(rgbs, pcds)
        return torch.func.functional_call(visual, cast_params(visual, dtype),
                                          (rgbs.to(dtype), pcds.to(dtype)))

    torch.manual_seed(cs.SEED)
    if args.model == "diffusion":
        model = make_diffusion_model(device="cuda")
        batch = synthetic_trajectory_batch(cs.TRAIN_B, cs.NCAM, (256, 256), cs.TRAJ_LEN,
                                           seed=cs.SEED, device="cuda")
        loss_fn = diffusion_loss_fn(model, dtype)

        def trunk():
            run_trunk(model.prediction_head.visual, batch["rgbs"],
                      model._normalize_pcd(batch["pcds"]))
    else:
        model = make_keypose_model(device="cuda")
        batch = synthetic_keypose_batch(cs.TRAIN_B, cs.NCAM, (256, 256), seed=cs.SEED,
                                        device="cuda")
        loss_fn = keypose_loss_fn(model, KeyposeLossAndMetrics(), dtype)

        def trunk():
            run_trunk(model.visual, batch["rgbs"], batch["pcds"])
    trainer = Trainer(loss_fn, model, seed=cs.SEED)
    for _ in range(2):
        trainer.step(batch)["loss"].item()

    with torch.no_grad():
        trunk_mib = _peak_mib(trunk)
    losses = []
    forward_mib = _peak_mib(lambda: losses.append(loss_fn(batch, trainer.generators)[0]))
    losses.clear()
    model.zero_grad(set_to_none=True)
    step_mib = _peak_mib(lambda: trainer.step(batch))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step(batch)["loss"].item()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    by_name = defaultdict(lambda: [0, 0.0])
    intervals = []
    for e in prof.events():
        # device kernels, memsets and copies; not the GPU-side ranges of
        # record_function annotations (Optimizer.step#AdamW.step)
        if e.device_type != torch.autograd.DeviceType.CUDA or e.is_user_annotation:
            continue
        start, end = e.time_range.start, e.time_range.end
        intervals.append((start, end))
        by_name[e.name][0] += 1
        by_name[e.name][1] += end - start
    busy_us = union_us(intervals)
    casts = [e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CPU and e.name == "aten::_to_copy"]

    def kernel_ms(tag):
        return sum(t for name, (_, t) in by_name.items() if tag in name) / 1e3

    by_kind = defaultdict(float)
    for name, (_, t) in by_name.items():
        by_kind[kind_of(name)] += t / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    summary = {
        "model": args.model,
        "mixed_precision": args.mixed_precision,
        "card": card,
        "step_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / wall_us,
        "device_kernel_events": sum(c for c, _ in by_name.values()),
        # dtype casts issued by the host (forward; their backward copies run
        # as ToCopyBackward): the params' bf16 copies under --mixed_precision 1
        "host_casts": len(casts),
        "host_cast_ms": sum(e.cpu_time_total for e in casts) / 1e3,
        "fused_mha_fwd_ms": kernel_ms("mha_fwd"),
        "fused_mha_bwd_ms": kernel_ms("mha_bwd"),
        "scatter_rows_ms": kernel_ms("scatter_rows"),
        "kernel_ms_by_kind": dict(by_kind),
        "peak_mib_visual_trunk_no_grad": trunk_mib,
        "peak_mib_loss_forward": forward_mib,
        "peak_mib_train_step": step_mib,
        "top_kernels": [{"name": n[:90], "count": c, "ms": t / 1e3} for n, (c, t) in top],
    }
    for row in summary["top_kernels"]:
        print(f"{row['ms']:9.3f} ms {row['count']:6d}x  {row['name']}")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    trace = out / f"{tag}_train_step_trace.json"
    prof.export_chrome_trace(str(trace))
    by_span = span_times(trace).by_span
    summary["device_ms_by_span"] = {name: row["busy_us"] / 1e3 for name, row in by_span.items()
                                    if name.startswith("train.")}
    with open(trace, "rb") as src, gzip.open(f"{trace}.gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    trace.unlink()
    print(json.dumps({k: v for k, v in summary.items() if k != "top_kernels"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
