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


def run(tree: Path, tag: str, log_dir: Path) -> dict:
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree, capture_output=True,
                          text=True)
    seconds = time.perf_counter() - t0
    (log_dir / f"{tag}.out").write_text(proc.stdout)
    (log_dir / f"{tag}.err").write_text(proc.stderr)
    print(f"{tag}: {tree} exit {proc.returncode} in {seconds:.1f} s", flush=True)
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"{tag}: chip_smoke.py failed")
    lines = proc.stdout.strip().splitlines()
    return dict(json.loads(lines[-2]), card=lines[1] if len(lines) > 1 else "", seconds=seconds)


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
    args = parser.parse_args()
    log_dir = args.out.parent
    log_dir.mkdir(parents=True, exist_ok=True)
    order = [("A1", args.a), ("B1", args.b), ("B2", args.b), ("A2", args.a)]
    runs = {tag: run(tree.resolve(), tag, log_dir) for tag, tree in order}
    args.out.write_text(json.dumps(runs))
    tags = [tag for tag, _ in order]
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
