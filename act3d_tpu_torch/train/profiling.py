"""Step timing and tracing (PyTorch).

Counterpart of ``act3d_tpu/train/profiling.py``: ``StepTimer`` records
per-step wall times and the throughput they give, and ``trace`` captures a
device trace of a step window, here through ``torch.profiler`` as a Chrome
trace.  ``kernel_times`` / ``top_kernels`` read such a trace back (the
port's counterpart of ``act3d_tpu/utils/xplane.py::op_self_times`` /
``top_ops`` for its own trace format): per event name, the summed duration
and the number of events of one category, the device kernels
(``"kernel"``) by default.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

__all__ = ["StepTimer", "trace", "TRACE_FILE", "kernel_times", "top_kernels"]

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
