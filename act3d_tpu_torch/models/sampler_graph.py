"""CUDA graphs of the sampler's denoising step, for the serving keystep.

Eager, each of a keystep's 100 denoising steps dispatches ~820 kernels from
Python, and the device waits on the host.  :class:`SamplerGraphs` captures
``diffusion_planner.reverse_step`` twice per input signature, over static
buffers: the step t > 0, which reads its step index, its noise row and its
coefficients from the device and advances the index, and the final step.
A keystep then fills the buffers and replays the first graph 99 times and
the second once: the same kernels on the same element values as the eager
loop, one host call a step.

On the first keystep of a signature the first step runs eagerly through the
same body (it warms cuBLAS, the kernel loader and the allocator), both steps
are captured, and the rest replay.  A signature whose step cannot be
captured runs its steps eagerly from then on.  The capture and the eager
work run on the caller's current stream (``device.py::graph_stream``).

The graphs read the model's own parameter tensors: an in-place
``load_state_dict`` (the default) keeps them valid; moving or replacing the
parameters (``.to()`` another device, ``assign=True``) needs a new
``SamplerGraphs``.

Counters: ``compute_trajectory.eager_steps`` / ``.replayed_steps`` /
``.captures``; a replay adds what its capture counted (``utils/graphs.py``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..utils.graphs import ENTRIES, capture
from ..utils.spans import span
from .diffusion_planner import DiffusionPlanner, compute_trajectory, reverse_step

__all__ = ["SamplerGraphs"]


def _map(fn, context: Dict[str, object]) -> Dict[str, object]:
    return {k: None if v is None else [fn(x) for x in v] if isinstance(v, (list, tuple))
            else fn(v) for k, v in context.items()}


def _leaves(context: Dict[str, object]) -> List[torch.Tensor]:
    return [x for v in context.values() if v is not None
            for x in (v if isinstance(v, (list, tuple)) else [v])]


def _signature(x: Optional[torch.Tensor]):
    return None if x is None else (tuple(x.shape), x.dtype, x.device)


class _Step:
    """The static buffers of one input signature and its two graphs."""

    def __init__(self, model: DiffusionPlanner, trajectory, trajectory_mask, context,
                 cond_data, cond_mask, eps):
        self.model = model  # the graphs read its parameters: keep it alive
        self.inputs = [torch.empty_like(x)
                       for x in (trajectory, trajectory_mask, cond_data, cond_mask, eps)]
        self.context = _map(torch.empty_like, context)
        self.step = torch.zeros(1, dtype=torch.long, device=trajectory.device)
        self.graphs: Optional[tuple] = None  # (t > 0, final) once captured

    def load(self, trajectory, trajectory_mask, context, cond_data, cond_mask, eps):
        for dst, src in zip(self.inputs + _leaves(self.context),
                            [trajectory, trajectory_mask, cond_data, cond_mask, eps]
                            + _leaves(context)):
            dst.copy_(src)
        self.step.zero_()

    def body(self, final: bool):
        """One step on the buffers: the trajectory updated in place and, but
        after the final step, the step index advanced."""
        trajectory, mask, cond_data, cond_mask, eps = self.inputs
        out = reverse_step(self.model, trajectory, mask, self.step, self.context, cond_data,
                           cond_mask, None if final else eps[self.step][0])
        trajectory.copy_(out)
        if not final:
            self.step.add_(1)

    def capture(self):
        first = capture(lambda: self.body(False))
        # replayed one after the other: one pool
        final = first and capture(lambda: self.body(True), first.graph.pool())
        if final:  # else graphs stays None: the steps run eagerly
            self.graphs = (first, final)
            compute_trajectory.captures += 2

    def run(self, final: bool):
        with span("sampler.denoise_step"):
            if self.graphs is None:
                self.body(final)
                compute_trajectory.eager_steps += 1
                return
            self.graphs[final].replay()
        compute_trajectory.replayed_steps += 1


class SamplerGraphs:
    """The serving path's captured denoising steps, one entry per input
    signature: (B, L, D), the dtypes, the device, the shapes of the
    observation's context and the model (whose head fixes the step's
    configuration).  At most ``ENTRIES`` of them; the oldest goes first."""

    def __init__(self):
        self._steps: Dict[tuple, _Step] = {}

    def sample(self, model: DiffusionPlanner, trajectory, trajectory_mask, context, cond_data,
               cond_mask, eps) -> torch.Tensor:
        """The reverse process from ``trajectory`` (B, L, D) with step noises
        ``eps`` (T - 1, B, L, D): the final trajectory, as
        ``compute_trajectory``'s eager loop gives it, in a static buffer that
        the next call overwrites.  Empties the ``context`` dict it copies."""
        key = (id(model), tuple(map(_signature, (trajectory, trajectory_mask, cond_data,
                                                 cond_mask, eps))),
               tuple((k, tuple(map(_signature, v)) if isinstance(v, (list, tuple))
                      else _signature(v)) for k, v in context.items()))
        step = self._steps.get(key)
        first = step is None
        if first:
            if len(self._steps) >= ENTRIES:
                del self._steps[next(iter(self._steps))]
            step = self._steps[key] = _Step(model, trajectory, trajectory_mask, context,
                                            cond_data, cond_mask, eps)
        step.load(trajectory, trajectory_mask, context, cond_data, cond_mask, eps)
        context.clear()  # the buffers hold it now: no second copy stays alive
        n_steps = model.diffusion_timesteps
        for i in range(n_steps):
            step.run(final=i == n_steps - 1)
            if first and i == 0:  # warmed by the eager first step
                step.capture()
        return step.inputs[0]
