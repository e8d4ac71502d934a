"""The port's step timer and trace against the JAX package's, on the CPU.

``StepTimer`` sees the same tick times on both sides (a patched
``time.perf_counter``); ``trace`` writes a Chrome trace that
``kernel_times`` / ``top_kernels`` read back, here with host operators
only (the card's kernels are read the same way, under category "kernel":
``chip_smoke.py`` phase profile).
"""

import json
import time

import pytest
import torch

from act3d_tpu.train import profiling as jprofiling
from act3d_tpu_torch.train import profiling


def _ticks(monkeypatch, times):
    it = iter(times)
    monkeypatch.setattr(time, "perf_counter", lambda: next(it))


@pytest.mark.parametrize("window", [3, 50])
def test_step_timer_equals_jax(monkeypatch, window):
    times = [0.0, 0.5, 1.25, 1.5, 3.0, 3.125, 4.0]
    timers = {}
    for name, mod in (("jax", jprofiling), ("port", profiling)):
        _ticks(monkeypatch, times)
        timer = mod.StepTimer(window=window)
        assert timer.mean_step_time is None and timer.throughput(8) is None
        dts = [timer.tick() for _ in times]
        timers[name] = (dts, timer.mean_step_time, timer.throughput(8), timer.summary(8))
    assert timers["port"] == timers["jax"]
    assert timers["port"][0][0] is None
    assert timers["port"][3]["steps_measured"] == min(window, len(times) - 1)


def test_trace_writes_a_trace_the_reader_reads(tmp_path):
    a = torch.randn(64, 64)
    with profiling.trace(tmp_path / "trace", first_step_done=True):
        for _ in range(3):
            b = torch.relu(a @ a)
    assert torch.isfinite(b).all()
    info = json.loads((tmp_path / "trace" / "TRACE_INFO.json").read_text())
    assert info["trace"] == profiling.TRACE_FILE and "CPU" in info["activities"]
    path = tmp_path / "trace" / profiling.TRACE_FILE
    ops = profiling.kernel_times(path, category="cpu_op")
    assert ops["aten::mm"]["count"] == 3 and ops["aten::relu"]["count"] == 3
    assert all(row["us"] >= 0 for row in ops.values())
    top = profiling.top_kernels(path, k=50, category="cpu_op")
    assert {name for name, _, _ in top} >= {"aten::mm", "aten::relu"}
    assert [ms for _, ms, _ in top] == sorted((ms for _, ms, _ in top), reverse=True)
    assert profiling.kernel_times(path) == {}  # no card: no device kernels


def test_kernel_times_sums_device_kernels_of_a_chrome_trace(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "name": "void mha_fwd_kernel<true>(float const*)",
         "ts": 0, "dur": 2.5},
        {"ph": "X", "cat": "kernel", "name": "void mha_fwd_kernel<true>(float const*)",
         "ts": 5, "dur": 1.5},
        {"ph": "X", "cat": "kernel", "name": "mha_fwd_combine_kernel", "ts": 9, "dur": 0.5},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 40.0},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 1},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = profiling.kernel_times(path)
    assert got == {"void mha_fwd_kernel<true>(float const*)": {"us": 4.0, "count": 2},
                   "mha_fwd_combine_kernel": {"us": 0.5, "count": 1}}
    assert profiling.top_kernels(path, k=1) == [
        ("void mha_fwd_kernel<true>(float const*)", 0.004, 2)]
