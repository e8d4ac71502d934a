"""Step timing and tracing (PyTorch).

Counterpart of ``act3d_tpu/train/profiling.py``: ``StepTimer`` records
per-step wall times and the throughput they give, and ``trace`` captures a
device trace of a step window, here through ``torch.profiler`` as a Chrome
trace.  ``kernel_times`` / ``top_kernels`` read such a trace back (the
port's counterpart of ``act3d_tpu/utils/xplane.py::op_self_times`` /
``top_ops`` for its own trace format): per event name, the summed duration
and the number of events of one category, the device kernels
(``"kernel"``) by default.

The port's spans (``utils/spans.py::span``, re-exported here) are
``user_annotation`` events of such a trace while a profiler runs;
``span_times`` credits each device event to the spans open at its launch.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from ..utils.spans import NO_SPAN, span

__all__ = ["StepTimer", "trace", "TRACE_FILE", "kernel_times", "top_kernels", "span",
           "NO_SPAN", "span_times", "SpanTimes", "union_us"]

TRACE_FILE = "trace.json"  # the Chrome trace ``trace`` writes into its log_dir


class StepTimer:
    """Rolling step-time statistics (call ``tick`` once per step)."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times = []
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self._times.append(dt)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now
        return dt

    @property
    def mean_step_time(self) -> Optional[float]:
        if not self._times:
            return None
        return sum(self._times) / len(self._times)

    def throughput(self, batch_size: int) -> Optional[float]:
        mst = self.mean_step_time
        return batch_size / mst if mst else None

    def summary(self, batch_size: int) -> dict:
        return {
            "mean_step_time_s": self.mean_step_time,
            "samples_per_sec": self.throughput(batch_size),
            "steps_measured": len(self._times),
        }


@contextlib.contextmanager
def trace(log_dir, *, first_step_done=True):
    """Capture a ``torch.profiler`` trace (host ops, and the card's kernels
    when there is a card) around a step window, written to
    ``log_dir/trace.json`` with ``TRACE_INFO.json`` beside it.

    Usage:
        with trace(log_dir):
            for _ in range(5):
                trainer.step(batch)
    View in chrome://tracing or Perfetto; read with :func:`kernel_times`.
    ``first_step_done`` is accepted for the JAX signature and unused, as there.
    """
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(str(log_dir / TRACE_FILE))
        (log_dir / "TRACE_INFO.json").write_text(json.dumps(
            {"captured_at": time.time(), "trace": TRACE_FILE,
             "activities": [a.name for a in activities]}))


def kernel_times(trace_path, category: str = "kernel") -> Dict[str, Dict[str, float]]:
    """{event name: {"us": summed duration in microseconds, "count": events}}
    over the complete events of ``category`` in a Chrome trace ("kernel" for
    device kernels, "cpu_op" for host operators)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    totals: Dict[str, Dict[str, float]] = defaultdict(lambda: {"us": 0.0, "count": 0})
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") == category:
            row = totals[ev["name"]]
            row["us"] += float(ev.get("dur", 0.0))
            row["count"] += 1
    return dict(totals)


def top_kernels(trace_path, k: int = 20, category: str = "kernel") -> List[Tuple[str, float, int]]:
    """The top-k event names by summed duration: [(name, ms, count)]."""
    ranked = sorted(kernel_times(trace_path, category).items(), key=lambda kv: -kv[1]["us"])
    return [(name, row["us"] / 1e3, row["count"]) for name, row in ranked[:k]]


# ---------------------------------------------------------------- spans

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


class SpanTimes(NamedTuple):
    """``span_times``'s reading (microseconds): ``by_span`` maps a span name
    to {"count": spans of that name, "busy_us": the union of the device
    intervals its spans own, "kernels": {device event name: summed us}};
    ``busy_us`` is the union of every device interval, ``unowned_us`` the
    union of those no span owns."""

    by_span: Dict[str, Dict]
    busy_us: float
    unowned_us: float


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def span_times(trace, exclude=()) -> SpanTimes:
    """Device time by span of a Chrome trace (a path, or its events).

    The spans are the ``user_annotation`` events (``span``'s
    ``record_function`` ranges) not named in ``exclude``.  A device event
    (kernel, copy, memset) belongs to every span whose host interval holds
    the host time of its launch call: the ``cuda_runtime`` or
    ``cuda_driver`` event with the same ``args.correlation``, on whatever
    thread it ran (autograd's thread launches the backward while the
    caller's span is open).  Host and device events share the trace's
    clock."""
    if isinstance(trace, (str, Path)):
        with open(trace) as f:
            trace = json.load(f)["traceEvents"]
    launch, marks, device = {}, [], []
    for ev in trace:
        if ev.get("ph") != "X":
            continue
        cat, ts = ev.get("cat"), float(ev.get("ts", 0.0))
        if cat in LAUNCH_CATEGORIES:
            corr = (ev.get("args") or {}).get("correlation")
            if corr is not None:
                launch[corr] = ts
        elif cat == "user_annotation" and ev["name"] not in exclude:
            marks.append((ts, ts + float(ev.get("dur", 0.0)), ev["name"]))
        elif cat in DEVICE_CATEGORIES:
            device.append((ev, ts, ts + float(ev.get("dur", 0.0))))
    by_span: Dict[str, Dict] = {}
    for _, _, name in marks:
        row = by_span.setdefault(name, {"count": 0, "busy_us": 0.0, "kernels": defaultdict(float)})
        row["count"] += 1
    owned: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    unowned: List[Tuple[float, float]] = []
    # launches in time order against the spans in start order, keeping the open ones
    marks.sort()
    keyed = sorted(((launch.get((ev.get("args") or {}).get("correlation")), i)
                    for i, (ev, _, _) in enumerate(device)),
                   key=lambda x: (x[0] is None, x[0] or 0.0))
    active: List[Tuple[float, float, str]] = []
    nxt = 0
    for t, i in keyed:
        ev, start, end = device[i]
        names = set()
        if t is not None:
            while nxt < len(marks) and marks[nxt][0] <= t:
                active.append(marks[nxt])
                nxt += 1
            active = [m for m in active if m[1] >= t]
            names = {m[2] for m in active}
        for name in names:
            owned[name].append((start, end))
            by_span[name]["kernels"][ev["name"]] += end - start
        if not names:
            unowned.append((start, end))
    for name, row in by_span.items():
        row["busy_us"] = union_us(owned[name])
        row["kernels"] = dict(row["kernels"])
    return SpanTimes(by_span, union_us([(s, e) for _, s, e in device]), union_us(unowned))
