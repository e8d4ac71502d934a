"""What sets the float32 peak device memory, and what brings it down.

Two workloads at the reference widths, in the port's float32 mode
(``resolve_device``: matmuls and cuDNN convolutions in full float32):

* ``train``: the flagship ChainedDiffuser (``make_diffusion_model``) takes
  ``TRAIN_STEPS`` Trainer steps at batch 16 (``chip_smoke.py`` phase train);
* ``trajectory``: ``compute_trajectory`` at batch 4 at the trajectory CLI's
  widths (the CLI's sampler evaluation).

Each (workload, variant) runs in a process of its own, so that no cuDNN
plan cache, allocator pool or environment variable leaks from one into the
next.  The variants are ways to run the same float32 computation:

* ``port``: the port as it stands (``resolve_device`` sets cuDNN's
  heuristic mode B);
* ``instant``: cuDNN's instant heuristics, PyTorch's default (the port's
  float32 policy before heuristic mode B: ``TORCH_CUDNN_USE_HEURISTIC_MODE_B=0``
  once the model is built, before the first convolution reads it);
* ``channels_last_trunk``: the trunk's weights and activations in
  ``torch.channels_last`` (set from outside the model; the FPN then runs on
  NHWC activations too);
* ``channels_last``: the trunk's and the FPN's weights and activations in
  ``torch.channels_last``;
* ``wscap``: ``CUDNN_CONV_WSCAP_DBG`` (MiB) in the environment (the name
  is absent from some builds of torch; the script lists the cuDNN names
  the installed one holds);
* ``slices``: the trunk run over the (B * n_cam) images in slices of
  ``SLICE`` images;
* ``benchmark``: ``torch.backends.cudnn.benchmark = True``;
* ``deterministic``: ``torch.backends.cudnn.deterministic = True``;
* ``v7``: ``TORCH_CUDNN_V8_API_DISABLED=1`` (cuDNN's legacy API);
* ``tf32``: PyTorch's TF32 convolutions, as a yardstick only (not a remedy:
  the port's policy is float32).

Flags are set after the model is built: every entry point, the model's
constructor too, applies the port's policy through ``resolve_device``.

The ``port`` run of each workload records a CUDA memory snapshot
(``torch.cuda.memory._record_memory_history``), dumps it into
``profiles/conv_memory/`` (``torch.cuda.memory._dump_snapshot``; open it at
pytorch.org/memory_viz) and replays its trace: the blocks live at the peak, largest first, with the
Python frames that allocated them and how many allocator events later they
were freed.  Every run then measures each convolution's transient memory
over one more run (the peak inside a ``Conv2d`` forward above what was
allocated before it and the output it returns: cuDNN's workspace).

Run from the repository root on a machine with one NVIDIA H100:

    python3 scripts/conv_memory.py --out profiles/conv_memory

Prints one line per measurement and, last, one JSON object of all of them
(also written to ``--out``/conv_memory.json).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
TRAIN_B, TRAIN_STEPS, TRAJ_B, NCAM, TRAJ_LEN = 16, 3, 4, 3, 50
SLICE = 12
SNAPSHOTS = REPO / "profiles" / "conv_memory"
VARIANTS = ("port", "instant", "channels_last_trunk", "channels_last", "wscap", "slices",
            "benchmark", "deterministic", "v7", "tf32")
ENV = {"wscap": {"CUDNN_CONV_WSCAP_DBG": "256"}, "v7": {"TORCH_CUDNN_V8_API_DISABLED": "1"}}


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0]


def _cudnn_env_names(torch_dir: Path) -> list:
    """The CUDNN_* / TORCH_CUDNN_* names compiled into torch's CUDA library."""
    names = set()
    for lib in sorted((torch_dir / "lib").glob("libtorch_cuda*.so")):
        names |= set(re.findall(rb"(?:TORCH_)?CUDNN_[A-Z0-9_]{3,}", lib.read_bytes()))
    return sorted(n.decode() for n in names if b"WS" in n or n.startswith(b"TORCH_"))


def replay_peak(snapshot, top: int = 8) -> dict:
    """The blocks live at the peak of the recorded trace, largest first."""
    (trace,) = [t for t in snapshot["device_traces"] if t] or [[]]
    frees = {"free_completed"} if any(e["action"] == "free_completed" for e in trace) else {
        "free_requested"}
    live, total, peak, at = {}, 0, 0, 0
    freed_at = {}
    for i, ev in enumerate(trace):
        if ev["action"] == "alloc":
            live[ev["addr"]] = (i, ev)
            total += ev["size"]
            if total > peak:
                peak, at = total, i
        elif ev["action"] in frees and ev["addr"] in live:
            j, a = live.pop(ev["addr"])
            freed_at[j] = i
            total -= a["size"]
    live, total = {}, 0
    for i, ev in enumerate(trace[:at + 1]):
        if ev["action"] == "alloc":
            live[ev["addr"]] = (i, ev)
        elif ev["action"] in frees and ev["addr"] in live:
            live.pop(ev["addr"])
    blocks = []
    for i, ev in sorted(live.values(), key=lambda p: -p[1]["size"])[:top]:
        frames = [f"{Path(f['filename']).name}:{f['line']} {f['name']}"
                  for f in ev.get("frames", [])
                  if "act3d_tpu_torch" in f["filename"] or "scripts" in f["filename"]]
        blocks.append(dict(mib=ev["size"] / 2**20, frames=frames[:4],
                           freed_after_events=freed_at.get(i, -1) - i
                           if i in freed_at else None))
    return dict(trace_peak_mib=peak / 2**20, events=len(trace), at_event=at,
                live_blocks=len(live), top=blocks)


def child(workload: str, variant: str, out: Path) -> dict:
    import torch

    sys.path.insert(0, str(REPO))
    from act3d_tpu_torch.device import CUDNN_HEURISTIC_MODE_B, float32_precision, resolve_device
    from act3d_tpu_torch.kernels import _build
    from act3d_tpu_torch.models import compute_trajectory
    from act3d_tpu_torch.train.engine import Trainer
    from act3d_tpu_torch.train.flagship import diffusion_loss_fn, make_diffusion_model
    from act3d_tpu_torch.utils.testing import synthetic_trajectory_batch

    dev = resolve_device("cuda")
    _build.build()
    torch.manual_seed(0)
    model = make_diffusion_model(device=dev)
    if variant == "tf32":
        torch.backends.cudnn.conv.fp32_precision = "tf32"
    if variant != "port":  # the variants change one thing of PyTorch's defaults
        os.environ[CUDNN_HEURISTIC_MODE_B] = "0"
    torch.backends.cudnn.benchmark = variant == "benchmark"
    torch.backends.cudnn.deterministic = variant == "deterministic"
    visual = next(m for n, m in model.named_modules() if n.endswith("visual"))
    trunk = visual.backbone
    if variant in ("channels_last", "channels_last_trunk"):
        (visual if variant == "channels_last" else trunk).to(memory_format=torch.channels_last)
        trunk.register_forward_pre_hook(
            lambda m, args: (args[0].contiguous(memory_format=torch.channels_last),))
    if variant == "slices":
        inner = trunk.forward

        def sliced(x):
            parts = [inner(x[i:i + SLICE]) for i in range(0, x.shape[0], SLICE)]
            return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        trunk.forward = sliced

    if workload == "train":
        batch = synthetic_trajectory_batch(TRAIN_B, NCAM, (256, 256), TRAJ_LEN, seed=0,
                                           device=dev)
        trainer = Trainer(diffusion_loss_fn(model), model, lr=1e-4, weight_decay=5e-4, seed=0)

        def run():
            return trainer.step(batch)["loss"].reshape(1)
        repeats = TRAIN_STEPS
    else:
        batch = synthetic_trajectory_batch(TRAJ_B, NCAM, (256, 256), TRAJ_LEN, seed=0,
                                           device=dev)
        model.eval()

        def run():
            gen = torch.Generator(device=dev).manual_seed(0)
            return compute_trajectory(model, batch["trajectory_mask"], batch["rgbs"],
                                      batch["pcds"], batch["instr"], batch["curr_gripper"],
                                      batch["action"], generator=gen)
        repeats = 2

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    record = variant in ("port", "instant")
    if record:
        torch.cuda.memory._record_memory_history(max_entries=2_000_000, stacks="python")
    times, outputs = [], []
    for _ in range(repeats):
        t0 = time.perf_counter()
        outputs.append(run().detach().float().cpu())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    row = dict(workload=workload, variant=variant, precision=float32_precision(),
               peak_mib=peak / 2**20, resident_mib=resident / 2**20,
               reserved_mib=torch.cuda.max_memory_reserved() / 2**20,
               times_ms=[t * 1e3 for t in times],
               env={k: os.environ[k] for k in [CUDNN_HEURISTIC_MODE_B]
                    + [k for v in ENV.values() for k in v] if k in os.environ},
               flags=dict(benchmark=torch.backends.cudnn.benchmark,
                          deterministic=torch.backends.cudnn.deterministic))
    torch.save(outputs, out / f"{workload}.{variant}.pt")
    if record:
        snap = torch.cuda.memory._snapshot()
        SNAPSHOTS.mkdir(parents=True, exist_ok=True)
        torch.cuda.memory._dump_snapshot(str(SNAPSHOTS / f"{workload}.{variant}.pickle"))
        torch.cuda.memory._record_memory_history(enabled=None)
        row["replay"] = replay_peak(snap)
    row["convs"] = conv_transients(model, run)
    return row


def conv_transients(model, run) -> list:
    """Each Conv2d call's peak above what was allocated before it plus its
    output (cuDNN's workspace), largest first, over one more run."""
    import torch
    import torch.nn as nn

    rows = defaultdict(float)
    hooks = []
    for name, m in model.named_modules():
        if not isinstance(m, nn.Conv2d):
            continue

        def pre(mod, args):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            mod._before = torch.cuda.memory_allocated()

        def post(mod, args, output, name=name):
            torch.cuda.synchronize()
            extra = torch.cuda.max_memory_allocated() - mod._before \
                - output.numel() * output.element_size()
            x = args[0]
            nhwc = x.is_contiguous(memory_format=torch.channels_last) and not x.is_contiguous()
            key = f"{name} in {tuple(x.shape)} {'NHWC' if nhwc else 'NCHW'}"
            rows[key] = max(rows[key], extra / 2**20)
        hooks += [m.register_forward_pre_hook(pre), m.register_forward_hook(post)]
    run()
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    return [dict(conv=k, transient_mib=v)
            for k, v in sorted(rows.items(), key=lambda kv: -kv[1])[:12]]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=REPO / "profiles" / "conv_memory")
    parser.add_argument("--workloads", nargs="*", default=["train", "trajectory"])
    parser.add_argument("--variants", nargs="*", default=list(VARIANTS))
    parser.add_argument("--child", nargs=2, metavar=("WORKLOAD", "VARIANT"))
    args = parser.parse_args()
    args.out.mkdir(parents=True, exist_ok=True)
    if args.child:
        print("ROW " + json.dumps(child(*args.child, args.out)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("conv_memory: no CUDA device", file=sys.stderr)
        return 1
    card = _card()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} cudnn "
          f"{torch.backends.cudnn.version()}", flush=True)
    names = _cudnn_env_names(Path(torch.__file__).parent)
    print(f"cuDNN environment names in libtorch_cuda: {names}", flush=True)
    rows = []
    for workload in args.workloads:
        for variant in args.variants:
            env = dict(os.environ, **ENV.get(variant, {}))
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, __file__, "--out", str(args.out),
                                   "--child", workload, variant], env=env,
                                  capture_output=True, text=True, timeout=600)
            got = [json.loads(line[4:]) for line in proc.stdout.splitlines()
                   if line.startswith("ROW ")]
            if proc.returncode or not got:
                print(f"{workload} {variant}: FAILED rc {proc.returncode}\n"
                      f"{proc.stderr[-3000:]}", flush=True)
                rows.append(dict(workload=workload, variant=variant, failed=proc.returncode))
                continue
            row = got[0]
            row["process_s"] = time.perf_counter() - t0
            import torch as _t

            ref = _t.load(args.out / f"{workload}.port.pt")
            mine = _t.load(args.out / f"{workload}.{variant}.pt")
            row["max_abs_vs_port"] = max(float((a - b).abs().max()) for a, b in zip(ref, mine))
            rows.append(row)
            print(f"{workload} {variant}: peak {row['peak_mib']:.1f} MiB (resident "
                  f"{row['resident_mib']:.1f}, reserved {row['reserved_mib']:.1f}); times ms "
                  + ", ".join(f"{t:.1f}" for t in row["times_ms"])
                  + f"; max |out - port's| {row['max_abs_vs_port']:.3e}; precision "
                  f"{row['precision']} | {card}", flush=True)
            for key in ("replay", "convs"):
                if key in row:
                    print(f"  {key}: {json.dumps(row[key][:6] if key == 'convs' else row[key])}",
                          flush=True)
    result = dict(card=card, torch=torch.__version__, cudnn=torch.backends.cudnn.version(),
                  env_names=names, rows=rows)
    (args.out / "conv_memory.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0 if all("failed" not in r for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
