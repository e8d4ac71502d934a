"""Same-call comparison of two trees of the repository on the card.

Run from the repository root on a machine with one NVIDIA H100, with the
other tree unpacked into a git-ignored directory, e.g.

    git archive HEAD~1 | tar -x -C _archive/parent
    python3 scripts/ab_commits.py _archive/parent . --out profiles/ab_commits.json

runs ``python3 chip_smoke.py`` from each tree in turns (A, B, B, A), one
process at a time, keeps each run's output beside ``--out``, and
reads the kernel line (the second-to-last line) of every run.  Prints, for
each kernel and each timed site, the per-call device time of every run
side by side, and the sums per unit; writes every run's kernel line to
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
