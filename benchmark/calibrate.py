#!/usr/bin/env python3
"""Readings that the limits of a cell's check are set from, several seeds
in one process (so the set-up's process start is paid once).

    python3 benchmark/calibrate.py --workload <name> --seeds 11,12,13 --seconds 5 [--control]

Without ``--control`` each seed runs the cell as ``run.py`` does (set-up, a
window of ``--seconds``, the check) and prints the numbers the check
compared: the lower readings.  With ``--control`` each seed runs the
control in the system's place (the reference in TF32, the precision below
the configuration's float32) through the same comparison: the upper
readings.  With ``--fault NAME`` each seed runs the cell with that fault of
benchmark/faults.py planted in the system.  One JSON line per seed on standard output, also appended to
``--out``.  The benchmark's own runs never run the control.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent
if sys.path and sys.path[0] and Path(sys.path[0]).resolve() == ROOT / "benchmark":
    sys.path[0] = str(ROOT)


def main(argv=None, root: Path = ROOT, device: str = "cuda") -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None, help="plant one of benchmark/faults.py's faults")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from benchmark import faults, harness, run

    for var, sub in run.CACHE_DIRS.items():
        import os

        os.environ[var] = str(run.CACHE_ROOT / sub)
    cell = harness.Cell(root, args.workload)
    drv = harness.driver(cell.traffic["driver"])
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = SimpleNamespace(cell=cell, config=cell.config, traffic=cell.traffic, seed=seed,
                              seconds=args.seconds, trace=False, device=device,
                              t0=time.perf_counter())
        t0 = time.perf_counter()
        if args.control:
            row = {"side": "control", **drv.control(ctx)}
        else:
            planted = faults.FAULTS[args.fault]() if args.fault else contextlib.nullcontext()
            with planted:
                outcome = drv.run(ctx)
            row = {"side": args.fault or "program", "attempted": outcome.attempted, "failed": outcome.failed,
                   **{c.name: c.value for c in outcome.checks}, **outcome.end_to_end,
                   **outcome.layer.get("readings", {})}
        row.update(workload=args.workload, seed=seed, seconds=time.perf_counter() - t0)
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return rows


if __name__ == "__main__":
    main()
