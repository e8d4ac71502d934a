"""The traced stretch of a run: a ``torch.profiler`` trace of host ops and
device kernels, written under TMPDIR, read back and deleted.

The reader is a frozen copy of ``act3d_tpu_torch/train/profiling.py::
kernel_times`` (complete events of one category, summed by name), with
what the benchmark adds: the union of device intervals inside the traced
window (busy time), and the idle gaps between them named by the innermost
host event open on the dispatching thread when each gap began.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Tuple

import torch

WINDOW = "benchmark_traced_window"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


def kernel_times(events, category: str = "kernel") -> Dict[str, Dict[str, float]]:
    """{name: {"us": summed duration, "count": events}} over the complete
    events of ``category``."""
    totals: Dict[str, Dict[str, float]] = defaultdict(lambda: {"us": 0.0, "count": 0})
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") == category:
            row = totals[ev["name"]]
            row["us"] += float(ev.get("dur", 0.0))
            row["count"] += 1
    return dict(totals)


class Traced:
    """What a traced stretch gives the per-layer metrics: the window's host
    span, device busy time, kernel events and times by name, idle gaps by
    host event (seconds throughout)."""

    def __init__(self, events: List[dict]):
        window = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"
                  and e.get("cat") == "user_annotation"]
        if not window:
            raise RuntimeError("the trace holds no traced-window annotation")
        w0 = float(window[0]["ts"])
        w1 = w0 + float(window[0]["dur"])
        self.window_s = (w1 - w0) / 1e6
        device = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                        for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES
                        and w0 <= float(e["ts"]) < w1)
        merged: List[List[float]] = []
        for start, end in device:
            end = min(end, w1)
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        self.busy_s = sum(end - start for start, end in merged) / 1e6
        inside = [e for e in events if w0 <= float(e.get("ts", -1)) < w1]
        self.kernels = kernel_times(inside, "kernel")
        self.kernel_events = sum(r["count"] for r in self.kernels.values())
        gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
        if merged:
            gaps = [(w0, merged[0][0])] + gaps + [(merged[-1][1], w1)]
        self.gaps_by_host = self._name_gaps(events, gaps)

    @staticmethod
    def _name_gaps(events, gaps) -> Dict[str, float]:
        """Seconds of device idleness by the innermost host event open on the
        busiest host thread at each gap's start ("no host op" where none)."""
        host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATEGORIES
                and e.get("name") != WINDOW]
        if not host:
            return {}
        threads = defaultdict(int)
        for e in host:
            threads[e.get("tid")] += 1
        main = max(threads, key=threads.get)
        # parents before the children that start with them
        spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
                        for e in host if e.get("tid") == main), key=lambda s: (s[0], -s[1]))
        starts = [s[0] for s in spans]
        out: Dict[str, float] = defaultdict(float)
        stack: List[Tuple[float, float, str]] = []
        nxt = 0
        for g0, g1 in sorted(gaps):
            if g1 <= g0:
                continue
            upto = bisect.bisect_right(starts, g0)
            while nxt < upto:
                span = spans[nxt]
                while stack and stack[-1][1] <= span[0]:
                    stack.pop()
                stack.append(span)
                nxt += 1
            while stack and stack[-1][1] <= g0:
                stack.pop()
            out[stack[-1][2] if stack else "no host op"] += (g1 - g0) / 1e6
        return dict(out)

    def device_ops(self, k: int = 10) -> List[List]:
        ranked = sorted(self.kernels.items(), key=lambda kv: -kv[1]["us"])[:k]
        return [[name, row["us"] / 1e6] for name, row in ranked]

    def idle_gaps(self, k: int = 10) -> List[List]:
        ranked = sorted(self.gaps_by_host.items(), key=lambda kv: -kv[1])[:k]
        return [[name, seconds] for name, seconds in ranked]

    def kernel_seconds(self, patterns) -> float:
        """Summed device seconds of the kernels whose name holds any of
        ``patterns``."""
        return sum(row["us"] for name, row in self.kernels.items()
                   if any(p in name for p in patterns)) / 1e6


class Session:
    """A profiled stretch: :meth:`start` and :meth:`stop` around it (the
    span between them is the traced window), :meth:`read` once the
    measured window has closed.  The trace goes to a file under TMPDIR,
    deleted once read."""

    def __init__(self):
        self._prof = None
        self._window = None

    def start(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()

    def stop(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self._prof.stop()

    def read(self) -> Traced:
        fd, path = tempfile.mkstemp(suffix=".json", prefix="benchmark_trace_")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            self._prof = None
            with open(path) as f:
                events = json.load(f)["traceEvents"]
            return Traced(events)
        finally:
            Path(path).unlink(missing_ok=True)
