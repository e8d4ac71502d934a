"""Named spans of the port's host code: the keystep and its phases
(``eval/actioner.py``), the sampler's encode and each denoising step
(``models/diffusion_planner.py``), the training step's forward, backward
and optimizer (``train/engine.py``).

``span(name)`` is the shared no-op ``NO_SPAN`` unless a ``torch.profiler``
runs; then it is ``record_function(name)``, so the span lands in the Chrome
trace as a ``user_annotation`` event on the device kernels' timeline, where
``train/profiling.py::span_times`` credits each device event to the spans
open at its launch.  Off, it costs a flag test and a call.  The module
imports only torch, so every layer of the port can use it.
"""

from __future__ import annotations

import contextlib

from torch.autograd import profiler as _autograd_profiler

__all__ = ["NO_SPAN", "span"]

NO_SPAN = contextlib.nullcontext()  # what ``span`` returns while no profiler runs


def span(name: str):
    """A context manager around one stretch of host code: the shared
    ``NO_SPAN``, or ``record_function(name)`` while a profiler runs."""
    if _autograd_profiler._is_profiler_enabled:
        return _autograd_profiler.record_function(name)
    return NO_SPAN
