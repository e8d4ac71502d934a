"""Device time by span of the benchmark's keystep and training step, and
what a span costs on the host.

For each cell named (``--keystep``, ``--train``), builds the program the
benchmark's driver builds (weights, inputs and batches drawn from
``--seed``), runs the cell's warm-up, times ``--host`` keysteps or steps
on the host clock, then runs the cell's ``trace_keysteps`` /
``trace_steps`` under torch.profiler and credits each device event to the
spans open at its launch (``train/profiling.py::span_times``).  Prints one
JSON object, also written to ``<out>/spans.json``:
  * ``span_cost_ns``: one ``with span(...)`` with no profiler running
    ("off"), under a running profiler ("profiled"), and an empty loop
    iteration ("loop"), three repeats each;
  * per cell: host ms a keystep or step; device busy ms a keystep or step
    (the union of device intervals) and the share of it no span owns; the
    share the phase spans own together (keystep: ``keystep.act3d``,
    ``sampler.encode``, ``sampler.denoise_step``; step: ``train.forward``,
    ``train.backward``, ``train.optimizer``); per span its count, busy ms a
    span and a keystep or step, and its top 5 device events; for the
    keystep, ``multi_head_attention`` calls and fused-MHA kernel launches a
    keystep; for a training cell, ``find_traj_nn`` selections and
    ``denoise`` evaluations a step; for the multi-scale head
    (``--train chained_diffuser_ms.train_b22``) the rows of
    ``planner.block.scale{n}`` (each block's forward, per scale) and
    ``planner.knn`` (the selections and their gathers), and
    ``forward_share_by_scale``: each scale's share of the forward's busy
    time (the backward runs under ``train.backward``, on autograd's thread);
  * the loader's ``NVCC_SECONDS`` and ``LOAD_SECONDS``.

Run from the repository root on the card:
    python3 scripts/profile_torch_spans.py [--seed N] [--host N] [--out DIR]
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from act3d_tpu_torch.eval.actioner import Actioner  # noqa: E402
from act3d_tpu_torch.kernels import _build  # noqa: E402
from act3d_tpu_torch.kernels.attention import fused_mha_forward  # noqa: E402
from act3d_tpu_torch.models.diffusion_head import DiffusionHead  # noqa: E402
from act3d_tpu_torch.ops.attention import multi_head_attention  # noqa: E402
from act3d_tpu_torch.ops.geometry import find_traj_nn  # noqa: E402
from act3d_tpu_torch.train.profiling import span_times  # noqa: E402
from act3d_tpu_torch.utils.spans import span  # noqa: E402
from benchmark import harness, models  # noqa: E402
from benchmark.drivers import keystep as keystep_driver  # noqa: E402
from benchmark.drivers import train as train_driver  # noqa: E402
from benchmark.harness import derive  # noqa: E402

PHASES = {"keystep": ("keystep.act3d", "sampler.encode", "sampler.denoise_step"),
          "train": ("train.forward", "train.backward", "train.optimizer")}


def _sync(dev):
    if dev == "cuda":
        torch.cuda.synchronize()


def span_cost_ns(dev, n: int) -> dict:
    """ns per ``with span("x")`` off and under a running profiler, and per
    empty loop iteration."""

    def spans(count):
        t0 = time.perf_counter_ns()
        for _ in range(count):
            with span("x"):
                pass
        return (time.perf_counter_ns() - t0) / count

    def loop(count):
        t0 = time.perf_counter_ns()
        for _ in range(count):
            pass
        return (time.perf_counter_ns() - t0) / count

    cost = {"loop": [], "off": [], "profiled": []}
    for _ in range(3):
        cost["loop"].append(loop(n))
        cost["off"].append(spans(n))
        with _profile(dev):
            cost["profiled"].append(spans(n // 50))
    return cost


def _profile(dev):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _traced(dev, run, units: int, kind: str) -> dict:
    """``run`` under the profiler, its device time by span over ``units``
    keysteps or steps."""
    _sync(dev)
    with _profile(dev) as prof:
        run()
        _sync(dev)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="spans_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        st = span_times(path)
    finally:
        Path(path).unlink(missing_ok=True)
    rows = {}
    for name, row in st.by_span.items():
        top = sorted(row["kernels"].items(), key=lambda kv: -kv[1])[:5]
        rows[name] = {"count": row["count"],
                      "busy_ms_a_span": row["busy_us"] / 1e3 / row["count"],
                      "busy_ms_a_unit": row["busy_us"] / 1e3 / units,
                      "top5_ms_a_unit": [[k, us / 1e3 / units] for k, us in top]}
    phases = sum(st.by_span.get(n, {"busy_us": 0.0})["busy_us"] for n in PHASES[kind])
    return {"busy_ms_a_unit": st.busy_us / 1e3 / units,
            "unowned_share": st.unowned_us / st.busy_us if st.busy_us else None,
            "phases_share": phases / st.busy_us if st.busy_us else None,
            "spans": rows}


def keystep_cell(cell, seed, dev, n_host: int) -> dict:
    cfg, tr = cell.config, cell.traffic
    inputs = keystep_driver.Inputs(cfg, tr, seed, dev)
    act3d = models.program("act3d", cfg, derive(seed, "weights.act3d"), dev)
    planner = models.program("planner", cfg, derive(seed, "weights.planner"), dev)
    actioner = Actioner(act3d, planner, instructions=inputs.instructions(),
                        seed=derive(seed, "actioner"), device=dev)
    k = 0

    def keysteps(n):
        nonlocal k
        for _ in range(n):
            if k % inputs.episode == 0:
                actioner.load_episode(inputs.task(k), 0)
            (rgb, pcd, grip), _, ghosts, noise = inputs.of(k)
            actioner.predict(rgb, pcd, grip, trajectory_mask=inputs.mask,
                             ghost_points_override=ghosts, noise=noise)
            k += 1

    keysteps(tr["warmup_keysteps"])
    calls, launches = (multi_head_attention.calls,
                       fused_mha_forward.launches + fused_mha_forward.launches_bf16)
    t0 = time.perf_counter()
    keysteps(n_host)
    host_ms = (time.perf_counter() - t0) * 1e3 / n_host
    out = {"host_ms_a_keystep": host_ms,
           "attn_calls_a_keystep": (multi_head_attention.calls - calls) / n_host,
           "fused_mha_launches_a_keystep": (fused_mha_forward.launches
                                            + fused_mha_forward.launches_bf16 - launches) / n_host}
    out.update(_traced(dev, lambda: keysteps(tr["trace_keysteps"]), tr["trace_keysteps"],
                       "keystep"))
    return out


def train_cell(cell, seed, dev, n_host: int) -> dict:
    cfg, tr = cell.config, cell.traffic
    batches = train_driver.make_batches(cfg, tr, seed, dev)
    _, trainer = train_driver.trainer_for(cfg["train_model"], cfg, seed, dev)
    s = 0

    def steps(n):
        nonlocal s
        for _ in range(n):
            trainer.step(batches[s % len(batches)])
            s += 1

    steps(tr["warmup_steps"])
    _sync(dev)
    calls, evaluations = find_traj_nn.calls, DiffusionHead.evaluations
    t0 = time.perf_counter()
    steps(n_host)
    _sync(dev)
    out = {"host_ms_a_step": (time.perf_counter() - t0) * 1e3 / n_host,
           "selections_a_step": (find_traj_nn.calls - calls) / n_host,
           "evaluations_a_step": (DiffusionHead.evaluations - evaluations) / n_host}
    out.update(_traced(dev, lambda: steps(tr["trace_steps"]), tr["trace_steps"], "train"))
    spans = out["spans"]
    forward = spans.get("train.forward", {}).get("busy_ms_a_unit")
    if forward:
        out["forward_share_by_scale"] = {
            name: row["busy_ms_a_unit"] / forward for name, row in sorted(spans.items())
            if name.startswith("planner.block.scale") or name == "planner.knn"}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(REPO), help="checkout whose BENCHMARK.json "
                        "names the cells")
    parser.add_argument("--keystep", default="chained_diffuser.keystep",
                        help="keystep cell ('' for none)")
    parser.add_argument("--train", default="chained_diffuser.train_b22",
                        help="training cell ('' for none)")
    parser.add_argument("--seed", type=int, default=2718281829)
    parser.add_argument("--host", type=int, default=6, help="keysteps or steps host-timed")
    parser.add_argument("--loops", type=int, default=1_000_000,
                        help="spans timed off (a fiftieth of them profiled)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default=str(REPO / "profiles"))
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("profile_torch_spans: no CUDA device", file=sys.stderr)
        return 1
    root, dev = Path(args.root), args.device
    result = {"card": harness.device_info(1) if dev == "cuda" else {"platform": "cpu"},
              "seed": args.seed, "span_cost_ns": span_cost_ns(dev, args.loops)}
    for key, name, fn in (("keystep", args.keystep, keystep_cell),
                          ("train", args.train, train_cell)):
        if name:
            result[key] = {"cell": name, **fn(harness.Cell(root, name), args.seed, dev,
                                              args.host)}
            gc.collect()
            if dev == "cuda":
                torch.cuda.empty_cache()
    result["loader"] = {"NVCC_SECONDS": _build.NVCC_SECONDS,
                        "LOAD_SECONDS": _build.LOAD_SECONDS}
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "spans.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
