"""The port's CUDA-graph mechanics (``utils/graphs.py``) on the CPU.

A body run under the registry's counting leaves every registered counter
where it was and records what it counted, nonzero differences only; a
replay adds them back.  Every counter named ``calls``, ``evaluations``,
``launches`` or ``launches_bf16`` on a public callable of the ops, the
kernels and the diffusion head is registered, so a counter added without
registration fails here instead of under-counting replayed steps on the
card.  ``device.graph_stream`` is None on the CPU.
"""

import importlib
import pkgutil
from types import SimpleNamespace

import pytest
import torch

from act3d_tpu_torch.device import graph_stream
from act3d_tpu_torch.ops.attention import AttentionParams, multi_head_attention
from act3d_tpu_torch.ops.geometry import find_traj_nn
from act3d_tpu_torch.utils import graphs

COUNTER_NAMES = ("calls", "evaluations", "launches", "launches_bf16")
OWNERS = ("act3d_tpu_torch.ops", "act3d_tpu_torch.kernels",
          "act3d_tpu_torch.models.diffusion_head")


def _body(attention_calls, selections):
    """Attention and selections on the CPU: the calls and selections count,
    the kernels launch nothing."""
    e, heads = 8, 2
    gen = torch.Generator().manual_seed(5)
    params = AttentionParams(*(torch.randn(e, e, generator=gen) for _ in range(4)))
    x = torch.randn(1, 3, e, generator=gen)
    for _ in range(attention_calls):
        multi_head_attention(params, x, x, x, heads)
    for _ in range(selections):
        find_traj_nn(torch.rand(1, 2, 3, generator=gen), torch.rand(1, 9, 3, generator=gen),
                     nn_per_step=2)


def _values():
    return [getattr(owner, name) for owner, name in graphs.COUNTERS]


def test_a_counted_body_leaves_the_counters_and_a_replay_adds_what_it_counted():
    before, calls = _values(), multi_head_attention.calls
    with graphs.uncounted() as counts:
        _body(2, 3)
        assert multi_head_attention.calls == calls + 2
    assert _values() == before
    # the kernels' launches moved by 0 on the CPU: not kept
    assert len(counts) == 2 and {(owner, name): n for owner, name, n in counts} == {
        (multi_head_attention, "calls"): 2, (find_traj_nn, "calls"): 3}
    captured = graphs.Captured(SimpleNamespace(replay=lambda: None), tuple(counts), None)
    for k in (1, 2):
        captured.replay()
        moved = {(owner, name): v - b for (owner, name), v, b in
                 zip(graphs.COUNTERS, _values(), before) if v != b}
        assert moved == {(multi_head_attention, "calls"): 2 * k, (find_traj_nn, "calls"): 3 * k}
    for (owner, name), b in zip(graphs.COUNTERS, before):
        setattr(owner, name, b)


def test_a_body_that_raises_leaves_the_counters_and_records_nothing():
    before = _values()
    with pytest.raises(ValueError, match="mid-body"):
        with graphs.uncounted() as counts:
            _body(1, 1)
            raise ValueError("mid-body")
    assert _values() == before and counts == []


def test_counted_zeroes_and_registers_each_attribute_once(monkeypatch):
    monkeypatch.setattr(graphs, "COUNTERS", [])
    owner = SimpleNamespace(hits=5)
    graphs.counted(owner, "hits", "misses")
    assert (owner.hits, owner.misses) == (0, 0)
    owner.hits = 3
    graphs.counted(owner, "hits")
    assert owner.hits == 0 and graphs.COUNTERS == [(owner, "hits"), (owner, "misses")]


def _public_callables():
    for root in OWNERS:
        package = importlib.import_module(root)
        names = [root] + [f"{root}.{m.name}"
                          for m in pkgutil.iter_modules(getattr(package, "__path__", []))]
        for module in map(importlib.import_module, names):
            for attr, obj in vars(module).items():
                if (not attr.startswith("_") and callable(obj)
                        and getattr(obj, "__module__", None) == module.__name__):
                    yield obj


def test_every_counter_of_the_ops_kernels_and_head_is_registered():
    found = {(obj, name) for obj in _public_callables() for name in COUNTER_NAMES
             if name in vars(obj)}
    missing = sorted(f"{obj.__module__}.{obj.__qualname__}.{name}" for obj, name in found
                     if (obj, name) not in graphs.COUNTERS)
    assert not missing, f"counters not registered with utils.graphs.counted: {missing}"
    # the walk reaches every counter a graph body moves today
    assert {(obj.__name__, name) for obj, name in found} >= {
        ("multi_head_attention", "calls"), ("find_traj_nn", "calls"),
        ("DiffusionHead", "evaluations"), ("fused_mha_forward", "launches_bf16"),
        ("scatter_rows_chunked", "launches")}
    assert len(found) == 15


def test_graph_stream_is_none_on_the_cpu():
    assert graph_stream(torch.device("cpu")) is None
