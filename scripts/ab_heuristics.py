"""Same-call A/B of cuDNN's heuristic mode B against its instant heuristics.

The port's float32 policy (``act3d_tpu_torch.device.pin_float32``) sets
``TORCH_CUDNN_USE_HEURISTIC_MODE_B=1``; PyTorch reads it once per process,
at the first convolution, so each turn runs in a process of its own:
``mode_b`` (the port as it is) or ``instant`` (``pin_float32`` wrapped to
set the variable to 0, PyTorch's default heuristics).  Turns alternate
(mode_b, instant, instant, mode_b) ``--rounds`` times.  Each process runs
``chip_smoke.py``'s phases:

* ``train``: the flagship ChainedDiffuser, 5 Trainer steps at batch 16,
  float32;
* ``train_act3d_bf16``: the flagship Act3D, 5 steps at batch 16 in bf16;
* ``cli_keypose_host_path``: the keypose CLI with 4 workers and the
  host-path flags, ``--mixed_precision 1``, 24 steps.

and reports each phase's first step, the median of its later steps (host
clock to a synchronized end) and its peak device memory.

Run from the repository root on a machine with one NVIDIA H100:

    python3 scripts/ab_heuristics.py --out profiles/ab_heuristics.json

Prints one line per process and per phase, then the medians over the turns
of each mode, and writes all rows to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
MODES = ("mode_b", "instant")
PHASES = ("train", "train_act3d_bf16", "cli_keypose_host_path")


def child(mode: str) -> dict:
    import numpy as np
    import torch

    sys.path.insert(0, str(REPO))
    from act3d_tpu_torch import device as device_mod

    if mode == "instant":
        pin = device_mod.pin_float32

        def pin_instant():
            pin()
            os.environ[device_mod.CUDNN_HEURISTIC_MODE_B] = "0"
        device_mod.pin_float32 = pin_instant
    import chip_smoke as smoke

    dev = device_mod.resolve_device("cuda")
    card = smoke.nvidia_smi()
    smoke._build.build()
    out = dict(mode=mode, heuristic_mode_b=os.environ[device_mod.CUDNN_HEURISTIC_MODE_B])

    def summary(seconds, peak):
        return dict(first_ms=seconds[0] * 1e3, median_ms=float(np.median(seconds[1:])) * 1e3,
                    peak_mib=peak / 2**20)

    _, steps, memory = smoke.phase_train(dev, card)
    out["train"] = summary([s["seconds"] for s in steps], memory["peak_memory_bytes"])
    _, steps, memory = smoke.phase_train_act3d(dev, card, torch.bfloat16)
    out["train_act3d_bf16"] = summary([s["seconds"] for s in steps],
                                      memory["peak_memory_bytes"])
    workers = smoke.host_workers()
    per_step = smoke.per_unit_launches(fused_mha_fwd_bf16=18, fused_mha_bwd_bf16=18,
                                       scatter_rows_sorted_bf16=smoke.KEYPOSE_LEVELS - 1)
    res = smoke.phase_cli(dev, card, "cli_keypose_host_path", smoke.main_keypose.main,
                          smoke.KEYPOSE_CLI_FLAGS + smoke.keypose_host_path_flags(workers)
                          + smoke.BF16_CLI_FLAGS, smoke.HOST_PATH_CLI_ITERS,
                          smoke.HOST_PATH_CLI_ITERS, per_step, "mean/pos_l2_final")
    out["cli_keypose_host_path"] = summary([s["step_s"] for s in res["steps"]],
                                           res["peak_memory_bytes"])
    smoke.stop_helper_processes()
    out["card"] = card
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=REPO / "profiles" / "ab_heuristics.json")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--child", choices=MODES)
    args = parser.parse_args()
    if args.child:
        print("ROW " + json.dumps(child(args.child)), flush=True)
        return 0
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ab_heuristics: no CUDA device", file=sys.stderr)
        return 1
    rows = []
    for turn, mode in enumerate(("mode_b", "instant", "instant", "mode_b") * args.rounds):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, __file__, "--child", mode], cwd=REPO,
                              capture_output=True, text=True, timeout=900)
        got = [json.loads(line[4:]) for line in proc.stdout.splitlines()
               if line.startswith("ROW ")]
        if proc.returncode or not got:
            print(f"turn {turn} {mode}: FAILED rc {proc.returncode}\n{proc.stderr[-3000:]}",
                  flush=True)
            return 1
        row = dict(got[0], turn=turn, process_s=time.perf_counter() - t0)
        rows.append(row)
        print(f"turn {turn} {mode} (TORCH_CUDNN_USE_HEURISTIC_MODE_B={row['heuristic_mode_b']}, "
              f"{row['process_s']:.1f} s): " + "; ".join(
                  f"{p} first {row[p]['first_ms']:.1f} ms, median {row[p]['median_ms']:.1f} "
                  f"ms, peak {row[p]['peak_mib']:.1f} MiB" for p in PHASES)
              + f" | {row['card']}", flush=True)
    for phase in PHASES:
        print(f"{phase}: median of later steps per turn "
              + ", ".join(f"{r['mode']} {r[phase]['median_ms']:.1f}" for r in rows)
              + "; medians over the turns " + ", ".join(
                  f"{m} {np.median([r[phase]['median_ms'] for r in rows if r['mode'] == m]):.1f}"
                  for m in MODES) + " ms", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
