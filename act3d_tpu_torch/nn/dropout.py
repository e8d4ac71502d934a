"""Dropout of the training path, with explicit generators.

JAX threads a ``dropout`` key and a ``deterministic`` flag; the port
threads a :class:`Generators` pair and reads ``module.training``.  Two
generators because two kinds of draws exist:

* ``host`` (a CPU ``torch.Generator``) gives one int31 seed per attention
  call, handed to the kernels as a launch argument (no device sync);
* ``device`` (a generator on the activations' device) gives the
  elementwise masks of :func:`dropout` and the diffusion noise.

Neither touches PyTorch's global RNG.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class Generators(NamedTuple):
    host: torch.Generator
    device: torch.Generator

    @classmethod
    def from_seed(cls, seed: int, device) -> "Generators":
        device = torch.device(device)
        return cls(torch.Generator().manual_seed(seed),
                   torch.Generator(device=device).manual_seed(seed + 1))


def dropout(x: torch.Tensor, rate: float, generators: Optional[Generators]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate, scale kept
    values by 1/(1 - rate).  Identity when ``generators`` is None."""
    if generators is None or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generators.device, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)
