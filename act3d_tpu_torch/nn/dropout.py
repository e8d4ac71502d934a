"""Dropout of the training path, with explicit generators.

JAX threads a ``dropout`` key and a ``deterministic`` flag; the port
threads a :class:`Generators` pair and reads ``module.training``.  Two
generators because two kinds of draws exist:

* ``host`` (a CPU ``torch.Generator``) gives one int31 seed per attention
  call, handed to the kernels as a launch argument (no device sync);
* ``device`` (a generator on the activations' device) gives the
  elementwise masks of :func:`dropout`, the diffusion noise and
  timesteps, the ghost points and the device augmentation.

Neither touches PyTorch's global RNG.

Data parallelism: every rank seeds its generators alike and carries its
``rank`` among ``world`` ranks, each holding ``1/world`` of the global
batch.  :func:`draw` makes each batch-major draw at the global leading
dim and keeps this rank's rows, and the attention kernels key their masks
on the global row (``dropout_b0 = rank x local batch``), so every rank
draws for its rows what a one-device run of the global batch draws.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import torch


class Generators(NamedTuple):
    host: torch.Generator
    device: torch.Generator
    rank: int = 0
    world: int = 1

    @classmethod
    def from_seed(cls, seed: int, device, rank: int = 0, world: int = 1) -> "Generators":
        device = torch.device(device)
        return cls(torch.Generator().manual_seed(seed),
                   torch.Generator(device=device).manual_seed(seed + 1), rank, world)


def draw(generator: Union[Generators, torch.Generator, None], fn, shape: Sequence[int],
         device, **kwargs) -> torch.Tensor:
    """``fn(shape, generator=..., device=device, **kwargs)`` for a
    batch-major ``shape``; ``fn`` is ``torch.rand``, ``torch.randn`` or a
    ``functools.partial`` of ``torch.randint``.  :class:`Generators` draw
    from their device generator at the global leading dim
    (``world x shape[0]``) and keep rows ``rank x shape[0]`` on; a plain
    ``torch.Generator`` (or None, the global RNG) draws at ``shape``.  At
    world 1 both are the same draw."""
    shape = tuple(shape)
    if not isinstance(generator, Generators):
        return fn(shape, generator=generator, device=device, **kwargs)
    b = shape[0]
    full = fn((generator.world * b,) + shape[1:], generator=generator.device, device=device,
              **kwargs)
    return full[generator.rank * b:(generator.rank + 1) * b]


def dropout(x: torch.Tensor, rate: float, generators: Optional[Generators]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate, scale kept
    values by 1/(1 - rate).  Identity when ``generators`` is None."""
    if generators is None or rate <= 0.0:
        return x
    keep = draw(generators, torch.rand, x.shape, x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)
