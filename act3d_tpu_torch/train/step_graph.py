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

Counters: a replay adds what its capture counted (``utils/graphs.py``).
``train/engine.py`` decides which steps may be graphed and counts them.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional

import torch

from ..nn.dropout import Generators
from ..ops.attention import SeedTape
from ..utils.graphs import ENTRIES, Captured, capture

__all__ = ["ENTRIES", "SEEN", "TrainStepGraphs", "batch_key"]

SEEN = 16  # the steps whose keys are remembered for a second sighting


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


class TrainStepGraphs:
    """The captured steps of one Trainer over the trainable ``params``, at
    most ``ENTRIES`` keys, sharing one memory pool (one replays at a time,
    and each capture frees its temporaries by its end).  A key whose
    capture raised maps to None and runs eagerly from then on."""

    def __init__(self, params):
        self._params = list(params)
        # per key: the captured forward and backward, out = (loss, aux, seed tape)
        self._steps: Dict[tuple, Optional[Captured]] = {}
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
        already backpropagated) under ``key`` (``utils.graphs.capture``);
        False where it raised.  Once captured, the host generator has made
        the step's seed draws, which the first replay uses.  Gradients are
        allocated first where a parameter has none."""
        if not self._bound:
            for p in self._params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            self._bound = [(p, p.grad, p.data_ptr()) for p in self._params]
        tape = SeedTape(generators.device.device)

        def body():
            with tape.recording():
                loss, aux = forward_backward(generators)
            return loss.detach(), dict(aux or {}), tape

        captured = self._steps[key] = capture(body, self._pool,
                                              (generators.host, generators.device))
        if captured is None:  # the step runs eagerly, from where it would have
            return False
        self._pool = captured.graph.pool()
        return True

    def replay(self, key, generators: Generators) -> Optional[Dict[str, torch.Tensor]]:
        """The outputs of a replay of ``key``'s graph (copies), or None where
        its capture failed or a parameter or gradient is not the tensor the
        graphs were captured over (every graph is then dropped)."""
        captured = self._steps[key]
        if captured is None:
            return None
        if not self._unmoved():
            self.clear()
            return None
        loss, aux, tape = captured.out
        tape.load(generators.host)
        captured.replay()
        # copies: the caller may keep every step's loss, and the next replay
        # overwrites the graph's outputs
        return {"loss": loss.clone(),
                **{k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in aux.items()}}
