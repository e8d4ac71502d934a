"""The program's spans inside the traced stretch, and the readers of the
program's counters (``kernel_load_s``, ``kernel_build_s``,
``attn_calls_per_keystep``).

The spans reach the trace as ``user_annotation`` events (and their
GPU-side copies): every reading of ``benchmark/trace.py``'s ``Traced``
stays what it is without them, but the idle gaps no host op held take the
innermost span's name.  The readers return None where the program keeps no
such count, as a program without the spans and counters does.
"""

import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from benchmark.trace import WINDOW, Traced
from tiny import run_tiny, tiny_root

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


def _trace(with_spans: bool):
    events = [_x("user_annotation", WINDOW, 0, 1000),
              _x("cpu_op", "aten::mm", 10, 20), _x("cuda_runtime", "cudaLaunchKernel", 20, 5,
                                                   correlation=1),
              _x("kernel", "k1", 100, 50, tid=7, correlation=1),
              _x("cpu_op", "aten::add", 200, 10), _x("cuda_runtime", "cudaLaunchKernel", 205, 2,
                                                     correlation=2),
              _x("kernel", "k2", 300, 20, tid=7, correlation=2),
              _x("gpu_memcpy", "Memcpy DtoH", 500, 5, tid=7, correlation=3)]
    if with_spans:
        events += [_x("user_annotation", "keystep", 0, 900),
                   _x("user_annotation", "sampler.denoise_step", 120, 280),
                   _x("gpu_user_annotation", "keystep", 100, 405, tid=7),
                   _x("gpu_user_annotation", "sampler.denoise_step", 100, 220, tid=7)]
    return events


def test_traced_reads_the_same_with_and_without_span_events():
    plain, spanned = Traced(_trace(False)), Traced(_trace(True))
    for attr in ("window_s", "busy_s", "kernels", "kernel_events"):
        assert getattr(spanned, attr) == getattr(plain, attr), attr
    assert spanned.device_ops() == plain.device_ops()
    assert spanned.kernel_seconds(["k"]) == plain.kernel_seconds(["k"]) == pytest.approx(70e-6)
    assert sum(spanned.gaps_by_host.values()) == pytest.approx(sum(plain.gaps_by_host.values()))
    # the gaps no host op held: named by the innermost span open at their start
    assert set(plain.gaps_by_host) == {"no host op"}
    assert spanned.gaps_by_host == pytest.approx({"keystep": 100e-6 + 495e-6,
                                                  "sampler.denoise_step": 150e-6 + 180e-6})


def _reader(name):
    spec = importlib.util.spec_from_file_location(f"reader_{name}", METRICS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


RUN = SimpleNamespace(layer={}, traced=None)


@pytest.mark.parametrize("name, counter", [("kernel_load_s", "LOAD_SECONDS"),
                                           ("kernel_build_s", "NVCC_SECONDS")])
def test_loader_readers_read_their_counter(monkeypatch, name, counter):
    from act3d_tpu_torch.kernels import _build

    read = _reader(name)
    monkeypatch.setattr(_build, counter, 36.5)
    assert read(RUN) == 36.5
    monkeypatch.delattr(_build, counter)
    assert read(RUN) is None


def test_attn_calls_per_keystep_reads_the_call_counter(monkeypatch):
    from act3d_tpu_torch.eval.actioner import Actioner
    from act3d_tpu_torch.ops.attention import multi_head_attention

    read = _reader("attn_calls_per_keystep")
    monkeypatch.setattr(multi_head_attention, "calls", 5 * 1918)
    monkeypatch.setattr(Actioner, "keysteps", 5)
    assert read(RUN) == 1918.0
    monkeypatch.setattr(Actioner, "keysteps", 0)
    assert read(RUN) is None
    monkeypatch.delattr(Actioner, "keysteps")
    assert read(RUN) is None
    monkeypatch.setattr(Actioner, "keysteps", 5, raising=False)
    monkeypatch.delattr(multi_head_attention, "calls")
    assert read(RUN) is None


@pytest.mark.parametrize("workload", ["tiny.keystep", "tiny.train"])
def test_traced_run_reports_the_counters(tmp_path, monkeypatch, workload):
    """On the CPU nothing is built or loaded; every keystep makes the same
    attention calls (counted from this run's start)."""
    from act3d_tpu_torch.eval.actioner import Actioner
    from act3d_tpu_torch.ops.attention import multi_head_attention

    monkeypatch.setattr(multi_head_attention, "calls", 0)
    monkeypatch.setattr(Actioner, "keysteps", 0)
    rc, result = run_tiny(tiny_root(tmp_path), workload, trace=1)
    assert rc == 0 and result["correct"], result
    assert result["metrics"]["kernel_load_s"]["value"] == 0.0
    assert result["metrics"]["kernel_build_s"]["value"] == 0.0
    if workload == "tiny.keystep":
        calls = result["metrics"]["attn_calls_per_keystep"]["value"]
        assert calls > 0 and calls == int(calls)
    else:
        assert "attn_calls_per_keystep" not in result["metrics"]


def test_profile_script_reads_spans_of_both_cells(tmp_path):
    """``scripts/profile_torch_spans.py`` on the tiny cells, on the CPU (no
    device events, so no busy time)."""
    path = Path(__file__).resolve().parents[2] / "scripts" / "profile_torch_spans.py"
    spec = importlib.util.spec_from_file_location("profile_torch_spans", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    assert script.main(["--root", str(tiny_root(tmp_path)), "--keystep", "tiny.keystep",
                        "--train", "tiny.train", "--device", "cpu", "--loops", "5000",
                        "--host", "1", "--out", str(tmp_path / "out")]) == 0
    got = json.loads((tmp_path / "out" / "spans.json").read_text())
    assert set(got["span_cost_ns"]) == {"loop", "off", "profiled"}
    keystep, train = got["keystep"], got["train"]
    assert keystep["attn_calls_a_keystep"] > 0 and keystep["fused_mha_launches_a_keystep"] == 0
    counts = {n: row["count"] for n, row in keystep["spans"].items()}
    # trace_keysteps 2, diffusion_timesteps 5
    assert counts == {"keystep": 2, "keystep.act3d": 2, "keystep.sampler": 2,
                      "sampler.encode": 2, "sampler.denoise_step": 10}
    counts = {n: row["count"] for n, row in train["spans"].items() if n.startswith("train.")}
    assert counts == dict.fromkeys(["train.step", "train.forward", "train.backward",
                                    "train.optimizer"], 2)  # trace_steps 2
    assert got["loader"] == {"NVCC_SECONDS": 0.0, "LOAD_SECONDS": 0.0}
