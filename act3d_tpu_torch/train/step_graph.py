"""CUDA graphs of the training step's forward and backward.

Eager, a ChainedDiffuser step dispatches 3264 kernels (15242 with the
3-scale x 2-round head) from Python and autograd's thread, and the device
waits on the host.  :class:`TrainStepGraphs` captures the loss and its
backward once per set of batch tensors and replays them: the same kernels
on the same element values, one host call a step.  AdamW stays outside the
graph and runs eagerly after the replay.

The key is the batch's identity (:func:`batch_key`): each tensor's place
in the batch, data pointer, shape, strides, dtype and device.  A graph
reads the caller's tensors in place, so it is right whenever the key
matches, and no copy of the batch is made.  A key is captured at its
second sighting among the last ``SEEN`` steps' keys: where the caller
hands fresh tensors each step and their addresses do not recur, no step
pays for a capture or keeps a graph's memory.  The graphs read the model's
parameters and write their gradients in place: the gradients are
allocated before the first capture, outside the graphs' memory, and zeroed
in place after every optimizer step (``optim.GradientAccumulator``).  A
replay first checks that each parameter and its gradient are the tensors
the graphs were captured over; where one was moved, replaced or set to
None, every graph is dropped and the step runs eagerly.

Randomness follows the eager step draw for draw.  Each dropout call of a
capture draws its int31 seed from the host generator as it does eagerly,
and the kernels read it from a slot of the step's :class:`SeedTape`;
before each replay the tape's slots are filled with the draws of that
many eager calls.  The device generator is registered with the graph, so
each replay draws the masks, noise and timesteps the eager step at that
position draws.

Counters: a replay adds to ``multi_head_attention.calls``, the kernels'
launch counters, ``DiffusionHead.evaluations`` and ``find_traj_nn.calls``
what its capture counted, so they count the calls, launches and
selections that run, replayed or not.  ``train/engine.py`` decides which
steps may be graphed and counts them.
"""

from __future__ import annotations

import collections
import contextlib
import warnings
from typing import Dict, List, Optional

import torch

from ..kernels.attention import attention_core, fused_mha_backward
from ..kernels.gather import scatter_rows, scatter_rows_chunked, scatter_rows_sorted
from ..models.sampler_graph import COUNTERS as SAMPLER_COUNTERS
from ..nn.dropout import Generators
from ..ops.attention import SeedTape

__all__ = ["ENTRIES", "SEEN", "TrainStepGraphs", "batch_key"]

ENTRIES = 4  # sets of batch tensors with a graph (the sampler keeps as many)
SEEN = 16  # the steps whose keys are remembered for a second sighting

# the counters a training step moves
COUNTERS = SAMPLER_COUNTERS + tuple(
    (fn, name) for fn in (fused_mha_backward, attention_core, scatter_rows_sorted,
                          scatter_rows, scatter_rows_chunked)
    for name in ("launches", "launches_bf16"))


def _counts() -> List[int]:
    return [getattr(obj, name) for obj, name in COUNTERS]


class _Unkeyed(Exception):
    pass


def _leaves(x, path, out):
    if isinstance(x, torch.Tensor):
        out.append((path, x.data_ptr(), tuple(x.shape), x.stride(), x.dtype, x.device,
                    x.requires_grad))
    elif isinstance(x, dict):
        out.append((path, dict, tuple(x)))
        for k, v in x.items():
            _leaves(v, path + (k,), out)
    elif isinstance(x, (list, tuple)):
        out.append((path, type(x), len(x)))
        for i, v in enumerate(x):
            _leaves(v, path + (i,), out)
    else:
        try:
            hash(x)
        except TypeError:
            raise _Unkeyed from None
        out.append((path, type(x), x))


def batch_key(batch) -> Optional[tuple]:
    """The batch's identity as a graph reads it: for each tensor its place
    in the (nested dict / list / tuple) batch, data pointer, shape,
    strides, dtype, device and ``requires_grad``; any other leaf by value.
    None where a leaf is neither a tensor nor hashable."""
    out: list = []
    try:
        _leaves(batch, (), out)
    except _Unkeyed:
        return None
    return tuple(out)


@contextlib.contextmanager
def _capturing(graph, pool, stream):
    """Capture into ``graph`` on ``stream``, the current stream, as
    ``torch.cuda.graph`` does but without its device-wide synchronize and
    ``empty_cache``: the regular pool keeps its cached blocks for the eager
    work around the replays."""
    graph.capture_begin(pool=pool, capture_error_mode="thread_local")
    try:
        yield
    finally:
        graph.capture_end()


def _release(generator: torch.Generator, stream):
    """After a failed capture, a registered generator stays in capture mode
    (torch 2.11: its eager draws raise "Offset increment outside graph
    capture encountered unexpectedly"); a capture that ends cleanly takes
    it out."""
    flag = torch.zeros(1, device=generator.device)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(generator)
    with _capturing(graph, None, stream):
        flag.add_(1)


class _Step:
    """One captured forward and backward: the graph, its outputs, its seed
    tape and what its capture added to ``COUNTERS``."""

    def __init__(self, graph, loss, aux, tape: SeedTape, counted: List[int]):
        self.graph, self.loss, self.aux, self.tape, self.counted = graph, loss, aux, tape, counted

    def replay(self, generators: Generators) -> Dict[str, torch.Tensor]:
        self.tape.load(generators.host)
        self.graph.replay()
        for (obj, name), n in zip(COUNTERS, self.counted):
            setattr(obj, name, getattr(obj, name) + n)
        # copies: the caller may keep every step's loss, and the next replay
        # overwrites the graph's outputs
        return {"loss": self.loss.clone(),
                **{k: v.clone() if isinstance(v, torch.Tensor) else v
                   for k, v in self.aux.items()}}


class TrainStepGraphs:
    """The captured steps of one Trainer over the trainable ``params``, at
    most ``ENTRIES`` keys, sharing one memory pool (one replays at a time,
    and each capture frees its temporaries by its end).  A key whose
    capture raised maps to None and runs eagerly from then on, with a
    warning that names the error."""

    def __init__(self, params):
        self._params = list(params)
        self._steps: Dict[tuple, Optional[_Step]] = {}
        self._pool = None
        self._bound: List[tuple] = []  # (param, its gradient, its address) as captured
        self._seen = collections.deque(maxlen=SEEN)

    def sighted(self, key) -> bool:
        """Whether ``key`` (None: no key) has a graph or is among the last
        ``SEEN`` keys noted here; notes it."""
        if key is None:
            return False
        again = key in self._steps or key in self._seen
        self._seen.append(key)
        return again

    def __contains__(self, key) -> bool:
        return key in self._steps

    def __len__(self) -> int:
        return len(self._steps)

    def clear(self):
        self._steps.clear()
        self._pool = None
        self._bound = []

    def _unmoved(self) -> bool:
        return all(p.grad is g and p.data_ptr() == ptr for p, g, ptr in self._bound)

    def capture(self, key, forward_backward, generators: Generators) -> bool:
        """Capture ``forward_backward(generators) -> (loss, aux)`` (the loss
        already backpropagated) on the current stream under ``key``.
        Nothing runs; the generators are where they were unless the capture
        succeeded, when the host generator has made the step's seed draws
        (the first replay uses them).  False where the capture raised.
        Gradients are allocated first where a parameter has none."""
        if not self._bound:
            for p in self._params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            self._bound = [(p, p.grad, p.data_ptr()) for p in self._params]
        host, device = generators.host.get_state(), generators.device.get_state()
        before = _counts()
        stream = torch.cuda.current_stream()
        tape = SeedTape(generators.device.device)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(generators.device)
        try:
            with tape.recording(), _capturing(graph, self._pool, stream):
                loss, aux = forward_backward(generators)
            counted = [a - b for a, b in zip(_counts(), before)]
        except Exception as e:  # the step runs eagerly, from where it would have
            warnings.warn(f"training step not captured, runs eagerly: {type(e).__name__}: {e}")
            _release(generators.device, stream)
            generators.host.set_state(host)
            generators.device.set_state(device)
            self._steps[key] = None
            return False
        finally:
            for (obj, name), count in zip(COUNTERS, before):
                setattr(obj, name, count)  # a capture runs nothing
        self._pool = graph.pool()
        self._steps[key] = _Step(graph, loss.detach(), dict(aux or {}), tape, counted)
        return True

    def replay(self, key, generators: Generators) -> Optional[Dict[str, torch.Tensor]]:
        """The outputs of a replay of ``key``'s graph (copies), or None where
        its capture failed or a parameter or gradient is not the tensor the
        graphs were captured over (every graph is then dropped)."""
        step = self._steps[key]
        if step is None:
            return None
        if not self._unmoved():
            self.clear()
            return None
        return step.replay(generators)
