"""The port's spans (``utils/spans.py``), its counters and its span reader
(``train/profiling.py``) on the CPU.

``span`` off is the shared no-op; under ``torch.profiler`` each span is a
``user_annotation`` event of the trace.  A tiny chained keystep and a tiny
training step open the spans the layers are read from, and give the same
bits with and without the profiler.  The loader counts nvcc's seconds
apart from its own; ``multi_head_attention`` counts its calls on every
core.  ``span_times`` credits device events of small synthetic Chrome
traces to the spans open at their launch.
"""

import json
import os
import stat
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from act3d_tpu_torch.eval.actioner import Actioner
from act3d_tpu_torch.kernels import _build
from act3d_tpu_torch.models import Act3D, DiffusionPlanner
from act3d_tpu_torch.ops.attention import AttentionParams, multi_head_attention
from act3d_tpu_torch.train import profiling
from act3d_tpu_torch.train.engine import Trainer
from act3d_tpu_torch.train.flagship import diffusion_loss_fn
from act3d_tpu_torch.utils.spans import NO_SPAN, span
from act3d_tpu_torch.utils.testing import BOUNDS, synthetic_trajectory_batch

NCAM, IMAGE, N_INSTR, LENGTH, STEPS = 2, 64, 7, 8, 5
ACT3D_CFG = dict(image_size=(IMAGE, IMAGE), embedding_dim=24, num_attn_heads=4,
                 num_sampling_level=2, use_instruction=True, num_ghost_points_val=60,
                 gripper_loc_bounds=BOUNDS)
PLANNER_CFG = dict(image_size=(IMAGE, IMAGE), embedding_dim=24, output_dim=7,
                   num_query_cross_attn_layers=3, num_vis_ins_attn_layers=1,
                   use_instruction=True, use_goal=True, diffusion_timesteps=STEPS,
                   gripper_loc_bounds=BOUNDS)
KEYSTEP_SPANS = {"keystep": None, "keystep.act3d": "keystep", "keystep.sampler": "keystep",
                 "sampler.encode": "keystep.sampler",
                 "sampler.denoise_step": "keystep.sampler"}
TRAIN_SPANS = {"train.step": None, "train.forward": "train.step",
               "train.backward": "train.step", "train.optimizer": "train.step"}


def _cpu_profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _annotations(prof, tmp_path, names):
    """The trace's user_annotation events of ``names`` (torch annotates its
    optimizers too), parents before the children that start with them."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((e for e in events if e.get("cat") == "user_annotation"
                   and e["name"] in names),
                  key=lambda e: (float(e["ts"]), -float(e["dur"])))


def _inside(child, parent):
    return (float(parent["ts"]) <= float(child["ts"]) and float(child["ts"]) + float(
        child["dur"]) <= float(parent["ts"]) + float(parent["dur"]))


def _check_tree(events, tree):
    """Each event inside an event named as its parent in ``tree``, the
    outermost ones inside none; one thread."""
    assert len({e["tid"] for e in events}) == 1
    for e in events:
        want = tree[e["name"]]
        parents = [p for p in events if p is not e and _inside(e, p)]
        if want is None:
            assert not parents, e["name"]
        else:
            assert want in {p["name"] for p in parents}, e["name"]


def _nested():
    """a ( b, c ( d ) ), e"""
    with span("a"):
        with span("b"):
            torch.ones(4).sum()
        with span("c"):
            with span("d"):
                torch.ones(4).sum()
    with span("e"):
        torch.ones(4).sum()


def test_span_off_is_the_shared_no_op():
    s = span("keystep")
    assert s is NO_SPAN and span("other") is s
    assert profiling.span is span and profiling.NO_SPAN is NO_SPAN
    with s as entered:
        assert entered is None
    with s:  # reentered: nothing kept between uses
        pass


def test_spans_under_the_profiler_are_user_annotations_nested_as_opened(tmp_path):
    with _cpu_profile() as prof:
        _nested()
    events = _annotations(prof, tmp_path, "abcde")
    assert [e["name"] for e in events] == ["a", "b", "c", "d", "e"]
    _check_tree(events, {"a": None, "b": "a", "c": "a", "d": "c", "e": None})
    a, b, c, d, e = events
    assert not _inside(c, b) and not _inside(d, b)
    assert span("x") is NO_SPAN  # the profiler has stopped


def test_a_span_left_by_an_exception_is_closed(tmp_path):
    with _cpu_profile() as prof:
        with pytest.raises(ValueError):
            with span("outer"):
                with span("inner"):
                    raise ValueError
        with span("next"):
            pass
    events = _annotations(prof, tmp_path, {"outer", "inner", "next"})
    assert [e["name"] for e in events] == ["outer", "inner", "next"]
    _check_tree(events, {"outer": None, "inner": "outer", "next": None})


# ------------------------------------------------ the keystep and the step


@pytest.fixture(scope="module")
def actioner():
    torch.manual_seed(0)
    act3d = Act3D(**ACT3D_CFG, device="cpu")
    planner = DiffusionPlanner(**PLANNER_CFG, device="cpu")
    instr = np.random.default_rng(0).normal(size=(N_INSTR, 512)).astype(np.float32)
    actioner = Actioner(act3d, planner, instructions={"task": {0: [instr]}}, device="cpu")
    actioner.load_episode("task", 0)
    return actioner


def _keystep(actioner):
    """One keystep on fixed inputs: ghost points and noise handed in, so
    repeats see the same numbers."""
    rng = np.random.default_rng(1)
    lo, hi = np.asarray(BOUNDS, np.float32)
    rgb = rng.uniform(-1, 1, (1, NCAM, 3, IMAGE, IMAGE)).astype(np.float32)
    pcd = rng.uniform(lo, hi, (1, NCAM, IMAGE, IMAGE, 3)).astype(np.float32)
    pcd = np.ascontiguousarray(pcd.transpose(0, 1, 4, 2, 3))
    quat = rng.normal(size=4)
    gripper = np.concatenate([rng.uniform(lo, hi), quat / np.linalg.norm(quat), [1.0]])
    ghosts = [torch.as_tensor(rng.uniform(lo, hi, (1, 10, 3)).astype(np.float32))
              for _ in range(2)]
    d = actioner.traj_model.internal_dim
    gen = torch.Generator().manual_seed(2)
    noise = (torch.randn(1, LENGTH, d, generator=gen),
             torch.randn(STEPS, 1, LENGTH, d, generator=gen))
    return actioner.predict(rgb, pcd, gripper[None].astype(np.float32),
                            trajectory_mask=np.zeros((1, LENGTH), bool),
                            ghost_points_override=ghosts, noise=noise)


def test_keystep_opens_its_phases_and_each_denoising_step(actioner, tmp_path):
    before = Actioner.keysteps
    with _cpu_profile() as prof:
        _keystep(actioner)
    events = _annotations(prof, tmp_path, KEYSTEP_SPANS)
    names = [e["name"] for e in events]
    assert names[:4] == ["keystep", "keystep.act3d", "keystep.sampler", "sampler.encode"]
    assert names[4:] == ["sampler.denoise_step"] * STEPS
    _check_tree(events, KEYSTEP_SPANS)
    assert Actioner.keysteps == before + 1


@pytest.fixture(scope="module")
def training():
    batch = synthetic_trajectory_batch(2, NCAM, (IMAGE, IMAGE), LENGTH, seed=3)
    batch["instr"] = batch["instr"][:, :N_INSTR]
    torch.manual_seed(1)
    state = DiffusionPlanner(**PLANNER_CFG, device="cpu").state_dict()

    def step(n=1):
        """A fresh Trainer from the same state: the losses of ``n`` steps
        and the parameters after them."""
        model = DiffusionPlanner(**PLANNER_CFG, device="cpu")
        model.load_state_dict(state)
        trainer = Trainer(diffusion_loss_fn(model), model, lr=1e-3, seed=4)
        losses = [trainer.step(batch)["loss"] for _ in range(n)]
        return losses, {k: v.detach().clone() for k, v in model.state_dict().items()}

    return step


def test_training_step_opens_forward_backward_and_optimizer(training, tmp_path):
    with _cpu_profile() as prof:
        training(2)
    events = _annotations(prof, tmp_path, TRAIN_SPANS)
    assert [e["name"] for e in events] == ["train.step", "train.forward", "train.backward",
                                           "train.optimizer"] * 2
    _check_tree(events, TRAIN_SPANS)
    assert not _inside(events[4], events[0])  # two steps, one after the other


@pytest.mark.parametrize("work", ["keystep", "train"])
def test_outputs_are_bit_identical_with_and_without_the_profiler(actioner, training, work,
                                                                   tmp_path):
    loads = (_build.NVCC_SECONDS, _build.LOAD_SECONDS)
    run = (lambda: _keystep(actioner)) if work == "keystep" else training
    off = run()
    with _cpu_profile() as prof:
        on = run()
    if work == "keystep":
        for key in off:
            np.testing.assert_array_equal(on[key], off[key])
    else:
        assert [float(x) for x in on[0]] == [float(x) for x in off[0]]
        for name, value in off[1].items():
            assert torch.equal(on[1][name], value), name
    names = {e["name"] for e in _annotations(prof, tmp_path, {**KEYSTEP_SPANS, **TRAIN_SPANS})}
    assert names == set(KEYSTEP_SPANS if work == "keystep" else TRAIN_SPANS)
    # the CPU paths load no CUDA source
    assert (_build.NVCC_SECONDS, _build.LOAD_SECONDS) == loads


@pytest.mark.parametrize("built", [True, False], ids=["built", "nvcc"])
def test_loader_counts_nvcc_apart_from_its_own_seconds(monkeypatch, tmp_path, built):
    """A fake nvcc that sleeps 0.3 s, then writes its output."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nsleep 0.3\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    ': > "$2"\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "library_path", lambda s: tmp_path / f"{s}.so")
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "ctypes", SimpleNamespace(CDLL=lambda path: ("lib", path)))
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "NVCC_SECONDS", 0.0)
    monkeypatch.setattr(_build, "LOAD_SECONDS", 0.0)
    if built:
        (tmp_path / "x.cu.so").write_bytes(b"")
    assert _build.load("x.cu") == ("lib", str(tmp_path / "x.cu.so"))
    assert os.path.exists(tmp_path / "x.cu.so")
    if built:
        assert _build.NVCC_SECONDS == 0.0
    else:
        assert _build.NVCC_SECONDS >= 0.3
    assert 0.0 < _build.LOAD_SECONDS < 0.3
    counts = (_build.NVCC_SECONDS, _build.LOAD_SECONDS)
    _build.load("x.cu")  # loaded already: nothing counted
    assert (_build.NVCC_SECONDS, _build.LOAD_SECONDS) == counts


@pytest.mark.parametrize("slot_competition", [False, True], ids=["fused", "slot_competition"])
def test_multi_head_attention_counts_every_call(slot_competition):
    e, heads = 8, 2
    gen = torch.Generator().manual_seed(5)
    params = AttentionParams(*(torch.randn(e, e, generator=gen) for _ in range(4)))
    x = torch.randn(1, 3, e, generator=gen)
    before = multi_head_attention.calls
    for _ in range(2):
        multi_head_attention(params, x, x, x, heads, slot_competition=slot_competition)
    assert multi_head_attention.calls == before + 2


# ------------------------------------------------------- span_times


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


def _launch(ts, corr, tid=1, cat="cuda_runtime", name="cudaLaunchKernel"):
    return _x(cat, name, ts, 2, tid, correlation=corr)


def _kernel(name, ts, dur, corr, cat="kernel"):
    return _x(cat, name, ts, dur, tid=7, correlation=corr)


def _keystep_trace():
    """keystep [0, 100] holding two denoising steps; launches inside each
    step, inside the keystep alone, and outside every span; a kernel with
    no launch event; the GPU-side copy of an annotation."""
    return [
        _x("user_annotation", "keystep", 0, 100),
        _x("user_annotation", "sampler.denoise_step", 10, 30),
        _x("user_annotation", "sampler.denoise_step", 50, 30),
        _launch(15, 1), _launch(55, 2), _launch(60, 3, cat="cuda_driver", name="cuLaunchKernel"),
        _launch(90, 4), _launch(120, 5),
        _kernel("k1", 200, 10, 1), _kernel("k2", 215, 15, 2), _kernel("copy", 232, 3, 3,
                                                                     cat="gpu_memcpy"),
        _kernel("k1", 240, 5, 4), _kernel("k3", 250, 10, 5), _kernel("k4", 300, 4, 6),
        _x("gpu_user_annotation", "sampler.denoise_step", 200, 35, tid=7),
    ]


def test_span_times_credits_each_kernel_to_every_span_open_at_its_launch(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": _keystep_trace()}))
    got = profiling.span_times(path)
    step = got.by_span["sampler.denoise_step"]
    assert step == {"count": 2, "busy_us": 28.0, "kernels": {"k1": 10.0, "k2": 15.0, "copy": 3.0}}
    keystep = got.by_span["keystep"]
    assert keystep["count"] == 1 and keystep["busy_us"] == 33.0
    assert keystep["kernels"] == {"k1": 15.0, "k2": 15.0, "copy": 3.0}
    assert got.busy_us == 47.0 and got.unowned_us == 14.0  # k3 launched outside, k4 unlaunched
    assert profiling.span_times(_keystep_trace()) == got


def test_span_times_credits_a_launch_on_another_thread_to_the_open_span():
    events = [_x("user_annotation", "train.step", 0, 100),
              _x("user_annotation", "train.backward", 40, 50),
              _launch(20, 1), _launch(60, 2, tid=9), _launch(95, 3, tid=9),
              _kernel("fwd", 100, 10, 1), _kernel("bwd", 110, 20, 2), _kernel("adam", 130, 5, 3)]
    got = profiling.span_times(events)
    assert got.by_span["train.backward"]["kernels"] == {"bwd": 20.0}
    assert got.by_span["train.step"]["busy_us"] == 35.0 and got.unowned_us == 0.0


@pytest.mark.parametrize("exclude", [(), ("benchmark_traced_window",)], ids=["kept", "excluded"])
def test_span_times_leaves_out_excluded_annotations(exclude):
    events = [_x("user_annotation", "benchmark_traced_window", -10, 1000)] + _keystep_trace()
    got = profiling.span_times(events, exclude=exclude)
    if exclude:
        assert "benchmark_traced_window" not in got.by_span and got.unowned_us == 14.0
    else:
        assert got.by_span["benchmark_traced_window"]["busy_us"] == 43.0 and got.unowned_us == 4.0


@pytest.mark.parametrize("intervals, want", [
    ([], 0.0), ([(0, 10)], 10.0), ([(0, 10), (5, 15)], 15.0), ([(20, 30), (0, 10)], 20.0),
    ([(0, 100), (10, 20), (30, 40)], 100.0)])
def test_union_us(intervals, want):
    assert profiling.union_us(intervals) == want
