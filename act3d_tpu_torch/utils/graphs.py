"""How the port captures and replays CUDA graphs (``models/sampler_graph.py``,
``train/step_graph.py``): the registry of counters, one capture routine.

A replay runs no Python, so a counter of calls, launches or selections would
miss every replayed one.  Each is registered once, where it is defined
(:func:`counted`); a capture restores every registered counter and keeps what
its body counted, which each replay adds back.  The graphs' own counters
(``compute_trajectory`` and ``Trainer``'s ``eager_steps`` / ``replayed_steps``
/ ``captures``) stay with their users.  Imports only torch: any layer may use it.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

__all__ = ["COUNTERS", "ENTRIES", "Captured", "capture", "counted", "uncounted"]

ENTRIES = 4  # keys a user keeps graphs for (a demo's padded length changes a signature)

COUNTERS: List[Tuple[Any, str]] = []  # (owner, attribute) of every registered counter


def counted(owner, *names: str):
    """Set each attribute ``names`` of ``owner`` to 0 and register it as a
    counter that graph bodies move."""
    for name in names:
        setattr(owner, name, 0)
        if (owner, name) not in COUNTERS:
            COUNTERS.append((owner, name))


@contextlib.contextmanager
def uncounted():
    """Run the block with every registered counter restored at its end.
    Yields a list that, once the block ends cleanly, holds the nonzero
    differences it made as (owner, attribute, difference)."""
    counters = list(COUNTERS)
    before = [getattr(owner, name) for owner, name in counters]
    counts: list = []
    try:
        yield counts
        counts.extend((owner, name, getattr(owner, name) - b)
                      for (owner, name), b in zip(counters, before)
                      if getattr(owner, name) != b)
    finally:
        for (owner, name), b in zip(counters, before):
            setattr(owner, name, b)


class Captured(NamedTuple):
    """A captured body: its graph, what it counted and what it returned
    (tensors in the graph's memory, rewritten by each replay)."""

    graph: "torch.cuda.CUDAGraph"
    counts: Tuple[Tuple[Any, str, int], ...]
    out: Any

    def replay(self):
        self.graph.replay()
        for owner, name, n in self.counts:
            setattr(owner, name, getattr(owner, name) + n)


@contextlib.contextmanager
def _capturing(generators: Sequence[torch.Generator], pool=None):
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        graph.register_generator_state(g)
    graph.capture_begin(pool=pool, capture_error_mode="thread_local")
    try:
        yield graph
    finally:
        graph.capture_end()


def capture(body: Callable[[], Any], pool=None,
            generators: Sequence[torch.Generator] = ()) -> Optional[Captured]:
    """Capture ``body()`` on the current stream (``device.py::graph_stream``)
    chained onto ``pool`` (a graph's ``pool()``; None: a new one), with the
    CUDA ones of the ``generators`` it draws from registered.  Unlike
    ``torch.cuda.graph``: no device-wide synchronize, no ``empty_cache``.
    Nothing is counted.  Where the capture raises: a warning names the
    error, the generators are left where they were, and None comes back."""
    states = [g.get_state() for g in generators]
    cuda = [g for g in generators if g.device.type == "cuda"]
    try:
        with uncounted() as counts, _capturing(cuda, pool) as graph:
            out = body()
    except Exception as e:
        warnings.warn(f"CUDA graph not captured, runs eagerly: {type(e).__name__}: {e}")
        # a registered generator stays in capture mode (torch 2.11: its eager
        # draws raise "Offset increment outside graph capture encountered
        # unexpectedly"); a capture that ends cleanly takes it out
        flag = torch.zeros(1, device=torch.cuda.current_stream().device)
        with _capturing(cuda):
            flag.add_(1)
        for g, state in zip(generators, states):
            g.set_state(state)
        return None
    return Captured(graph, tuple(counts), out)
