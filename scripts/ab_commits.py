"""Same-call comparison of two trees of the repository on the card.

Run from the repository root on a machine with one NVIDIA H100, with the
other tree unpacked into a git-ignored directory, e.g.

    git archive HEAD~1 | tar -x -C _archive/parent
    python3 scripts/ab_commits.py _archive/parent . --out profiles/ab_commits.json

runs ``python3 chip_smoke.py`` from each tree in turns (A, B, B, A), one
process at a time, keeps each run's output beside ``--out``, and
reads the kernel line (the second-to-last line) of every run.  Prints, for
each kernel and each timed site, the per-call device time of every run
side by side, and the sums per unit; then each training phase's warm step
time (host clock to a synchronized end, mean of the steps after the first)
and peak device memory in every run; writes every run's kernel line to
``--out``.  Exits non-zero if a run fails.

With ``--phases`` each run is not the whole smoke but the attention
kernels' phases of each tree's own ``chip_smoke.py``: both training steps'
float32 kernel sites, ``kernels_bf16`` (every bf16 entry at the bf16 sites)
and the two bf16 flagship training phases (``train_bf16``,
``train_act3d_bf16``), a few minutes a run:

    python3 scripts/ab_commits.py _archive/parent . --phases --out profiles/ab_phases.json
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
UNITS = ("per_keystep", "per_step")


# run from a tree's root with --phases: its own chip_smoke's attention phases,
# one JSON line at the end (phase_kernels_bf16 took no sm_mhz before the
# bf16 bound counted exponentials)
PHASES_DRIVER = """
import inspect, json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from act3d_tpu_torch.device import resolve_device
from act3d_tpu_torch.kernels import _build
dev = resolve_device("cuda")
card, sm = cs.nvidia_smi(), cs.sm_clock_mhz()
_build.build()
out = dict(card=card)
f, b = cs.phase_train_kernels(dev, card, cs.TRAIN_SHAPES, cs.PLANNER_CFG["embedding_dim"], 8,
                              cs.SEED + 1, sm)
kf, kb = cs.phase_train_kernels(dev, card, cs.KEYPOSE_SHAPES, cs.ACT3D_CFG["embedding_dim"],
                                cs.ACT3D_CFG["num_attn_heads"], cs.SEED + 2, sm)
extra = (sm,) if len(inspect.signature(cs.phase_kernels_bf16).parameters) == 3 else ()
bf = cs.phase_kernels_bf16(dev, card, *extra)
out.update(fused_mha_fwd=f + kf, fused_mha_bwd=b + kb,
           **{k: bf[k] for k in ("fused_mha_fwd_bf16", "fused_mha_bwd_bf16",
                                 "attention_core_bf16")})
for phase, fn in (("train_bf16", cs.phase_train), ("train_act3d_bf16", cs.phase_train_act3d)):
    for wrapper, attr in cs.KERNELS.values():
        setattr(wrapper, attr, 0)
    out[phase] = fn(dev, card, torch.bfloat16)[1:]
print(json.dumps(out, default=float))
"""


def run(tree: Path, tag: str, log_dir: Path, phases: bool = False) -> dict:
    t0 = time.perf_counter()
    cmd = ["-c", PHASES_DRIVER] if phases else ["chip_smoke.py"]
    proc = subprocess.run([sys.executable, *cmd], cwd=tree, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    (log_dir / f"{tag}.out").write_text(proc.stdout)
    (log_dir / f"{tag}.err").write_text(proc.stderr)
    print(f"{tag}: {tree} exit {proc.returncode} in {seconds:.1f} s", flush=True)
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"{tag}: chip_smoke.py failed")
    lines = proc.stdout.strip().splitlines()
    if phases:
        return dict(json.loads(lines[-1]), seconds=seconds)
    return dict(json.loads(lines[-2]), card=lines[1] if len(lines) > 1 else "", seconds=seconds)


def site_table(runs: dict, tags: list, name: str, rows_of) -> None:
    """One kernel's per-call device time at every site in every run, and
    the sums per step over each site's launches."""
    per_run = {t: {r["site"]: r for r in rows_of(runs[t])} for t in tags}
    sites = list(per_run[tags[1]])
    units = {t: {} for t in tags}
    for t in tags:
        for r in per_run[t].values():
            unit = "act3d_step" if r["site"].startswith("keypose") else "diffuser_step"
            units[t][unit] = units[t].get(unit, 0.0) + r["ms"] * r.get("per_step", 0)
    print(f"{name}: ms per step " + "; ".join(
        f"{t} " + ", ".join(f"{u} {ms:.4f}" for u, ms in units[t].items()) for t in tags))
    for site in sites:
        times = " / ".join(f"{per_run[t][site]['ms'] * 1e3:.1f}" if site in per_run[t] else "-"
                           for t in tags)
        row = per_run[tags[1]][site]
        extra = f" sdpa {row['library_ms'] * 1e3:.1f}" if "library_ms" in row else ""
        extra += f" bound {row['bound_ms'] * 1e3:.2f}" if "bound_ms" in row else ""
        print(f"  {site:34s} x{row.get('per_step', 0):<4d} us per call {times} |{extra}"
              f" ({tags[1]}) body {row.get('body', '-')}")


def report_phases(runs: dict, tags: list) -> None:
    print("card: " + " | ".join(f"{t} {runs[t]['card']}" for t in tags))
    for name in ("fused_mha_fwd", "fused_mha_bwd", "fused_mha_fwd_bf16", "fused_mha_bwd_bf16",
                 "attention_core_bf16"):
        site_table(runs, tags, name, lambda run, name=name: run[name])
    for phase in ("train_bf16", "train_act3d_bf16"):
        cells = []
        for t in tags:
            steps, memory = runs[t][phase]
            warm = [st["seconds"] * 1e3 for st in steps[1:]]
            cells.append(f"{t} {sum(warm) / len(warm):.1f} / {memory['peak_memory_bytes'] / 2**20:.1f}")
        print(f"{phase}: warm step ms / peak MiB " + ", ".join(cells))


def site_times(kernel: dict) -> dict:
    """{site: (per-call ms, launches per unit)} of one kernel entry."""
    out = {}
    for row in kernel.get("shapes", []):
        per = next((row[u] for u in UNITS if u in row), 0)
        out[row["site"]] = (row["ms"], per)
    return out


def phase_steps(kernels: list) -> dict:
    """{phase: (warm step ms, peak MiB)} of the training phases in a kernel
    line: the flagship steps (train, train_act3d) and every CLI phase."""
    by_name = {k["name"]: k for k in kernels}
    out = {}
    for phase, kernel, steps_key, memory in (
            ("train", "fused_mha_bwd", "train_steps", "train"),
            ("train_act3d", "scatter_rows_sorted", "keypose_train_steps", None)):
        entry = by_name.get(kernel, {})
        holder = entry.get(memory, {}) if memory else entry
        steps = holder.get(steps_key, [])
        if len(steps) > 1:
            warm = [st["seconds"] * 1e3 for st in steps[1:]]
            out[phase] = (sum(warm) / len(warm), holder.get("peak_memory_bytes", 0) / 2**20)
    for phase, value in by_name.get("fused_mha_fwd", {}).items():
        if isinstance(value, dict) and "warm_step_ms" in value:
            out[phase] = (value["warm_step_ms"], value.get("peak_memory_bytes", 0) / 2**20)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("a", type=Path, help="tree A (run first and last)")
    parser.add_argument("b", type=Path, help="tree B (run second and third)")
    parser.add_argument("--out", type=Path, default=REPO / "profiles" / "ab_commits.json")
    parser.add_argument("--phases", action="store_true",
                        help="the attention kernels' phases only, not the whole smoke")
    args = parser.parse_args()
    log_dir = args.out.parent
    log_dir.mkdir(parents=True, exist_ok=True)
    order = [("A1", args.a), ("B1", args.b), ("B2", args.b), ("A2", args.a)]
    runs = {tag: run(tree.resolve(), tag, log_dir, args.phases) for tag, tree in order}
    args.out.write_text(json.dumps(runs))
    tags = [tag for tag, _ in order]
    if args.phases:
        report_phases(runs, tags)
        return 0
    print("card: " + " | ".join(f"{t} {runs[t]['card']}" for t in tags))
    names = [k["name"] for k in runs["B1"]["kernels"]]
    for name in names:
        per_run = {t: next((k for k in runs[t]["kernels"] if k["name"] == name), None)
                   for t in tags}
        sites = {t: site_times(k) if k else {} for t, k in per_run.items()}
        print(f"{name}: ms per unit " + ", ".join(
            f"{t} {per_run[t]['ms']:.4f}" for t in tags if per_run[t]))
        for site in sites["B1"]:
            times = " / ".join(f"{sites[t][site][0] * 1e3:.1f}" if site in sites[t] else "-"
                               for t in tags)
            print(f"  {site:34s} x{sites['B1'][site][1]:<4d} us per call {times}")
    steps = {t: phase_steps(runs[t]["kernels"]) for t in tags}
    for phase in steps["B1"]:
        print(f"{phase}: warm step ms / peak MiB " + ", ".join(
            f"{t} {steps[t][phase][0]:.1f} / {steps[t][phase][1]:.1f}" if phase in steps[t]
            else f"{t} -" for t in tags))
    return 0


if __name__ == "__main__":
    sys.exit(main())
