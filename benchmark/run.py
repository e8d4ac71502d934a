#!/usr/bin/env python3
"""The benchmark of act3d_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Reads the cell from ``BENCHMARK.json``, runs its traffic file's driver on
the card (set-up, a measured window of ``--seconds``, then the check of
what the window produced against the plain reference), and prints one
JSON line: with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics read from a profiled stretch of the
window.  The numbers the check compared follow, each beside its limit, as
the last lines on standard error and under ``checks``, the line's last key.
Exits non-zero without a result when no card (or fewer than the cell
asks) is present, and when a JAX module is loaded once the window closed.
"""

import time

T0 = time.perf_counter()  # the set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# run as a script, this folder heads sys.path; its modules are imported as
# benchmark.*, never under top-level names that could shadow others
if sys.path and sys.path[0] and Path(sys.path[0]).resolve() == ROOT / "benchmark":
    sys.path[0] = str(ROOT)
# build and kernel caches at fixed paths inside the checkout
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
              "CUDA_CACHE_PATH": "nv"}
CACHE_ROOT = ROOT / ".bench_cache"


def _number(x):
    x = float(x)
    return x if math.isfinite(x) else repr(x)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, root: Path = ROOT, device: str = "cuda") -> int:
    """One run.  ``device="cpu"`` (tests only) skips the look for a card."""
    args = parse(argv)
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(CACHE_ROOT / sub)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmark import harness

    cell = harness.Cell(root, args.workload)
    import torch

    chips = int(cell.workload["chips"])
    if device == "cuda" and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {chips} CUDA device(s), {found} present; "
              "no result", file=sys.stderr)
        return 2
    ctx = SimpleNamespace(cell=cell, config=cell.config, traffic=cell.traffic, seed=args.seed,
                          seconds=args.seconds, trace=bool(args.trace), device=device, t0=T0)
    outcome = harness.driver(cell.traffic["driver"]).run(ctx)

    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: JAX modules loaded in the measured process: {bad}; no result",
              file=sys.stderr)
        return 3
    metrics = {}
    if not args.trace:
        for m in cell.metrics("end_to_end"):
            metrics[m["name"]] = {"value": _number(outcome.end_to_end[m["name"]]), "unit": m["unit"]}
    else:
        reading = SimpleNamespace(cell=cell, config=cell.config, traffic=cell.traffic,
                                  layer=outcome.layer, traced=outcome.traced)
        for m in cell.metrics("per_layer"):
            value = harness.read_metric(m["name"], reading)
            if value is not None:
                metrics[m["name"]] = {"value": _number(value), "unit": m["unit"]}
    if device == "cuda":
        dev = harness.device_info(chips)
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": chips}
    dev["memory_peak_bytes"] = int(outcome.memory_peak_bytes)
    result = {"correct": bool(outcome.attempted > 0 and outcome.failed == 0
                              and all(c.ok for c in outcome.checks)),
              "attempted": outcome.attempted, "failed": outcome.failed,
              "metrics": metrics, "device": dev}
    if args.trace and outcome.traced is not None:
        dev["busy_s"] = outcome.traced.busy_s
        dev["window_s"] = outcome.traced.window_s
        result["breakdown"] = {"device_ops": outcome.traced.device_ops(),
                               "idle_gaps": outcome.traced.idle_gaps()}
    result["checks"] = {c.name: {"value": _number(c.value), "limit": c.limit}
                        for c in outcome.checks}
    for c in outcome.checks:
        print(f"check {c.name}: {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
